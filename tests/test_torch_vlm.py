"""The port's VLM (``repro_torch.models.transformer``'s ``vlm_group``s:
``cross_attn_every - 1`` dense blocks, then a tanh-gated cross block a
group; family ``vlm``) against the JAX package on the CPU, on the same
weights (``repro_torch.bridge``) and the same inputs (numpy, seeded), at
the fp32 smoke size of llama-3.2-vision-90b (2 groups of 1 dense + 1
cross layer, 8 image tokens, GQA group 2).

The gates start at 0 in both packages, and tanh(0) = 0 hides the whole
cross path, so the weights here have ``xattn_gate`` 0.5 and ``xmlp_gate``
-0.7 in both (set in the JAX tree before bridging).

Tolerances (fp32 on both sides, summed in different orders; "scaled"
bounds hold the largest error to that many times max(1, the tensor's
largest |value|)):
  * the gated MLP op with ``silu`` against the JAX op's Pallas kernel in
    interpret mode: 3e-5 (the JAX package's kernel tests);
  * forward, prefill and decode logits: rtol 1e-4, atol 1e-5 (the
    transformer tests' bound); the loss 1e-5 scaled; each gradient leaf
    within 1e-4 of its largest |value|;
  * prefill, then 3 decode steps, against the no-cache forward: 2e-3
    (``tests/test_decode_consistency.py``).
Tokens are held exactly: ``Server`` greedy and sampled streams equal the
JAX server's on the same ``extra={"image_embeds": ...}``, scan == loop
under SIDEBAR and SIDEBAR_PIPELINED. Without image embeddings the cross
layers run as dense blocks, as in the JAX package. The card's cases (no
JAX there) are in ``tests/test_torch_capture.py``.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.configs.base import ShapeCell as JShapeCell
from repro.data import pipeline as jdata
from repro.kernels import ops as jops
from repro.launch.sampling import SamplingParams as JSP
from repro.launch.serve import Server as JaxServer
from repro.models import layers as jL
from repro.models import transformer as jT
from repro.models.registry import get_model as jget
from repro_torch import bridge
from repro_torch import configs as tcfg
from repro_torch.configs.base import ShapeCell
from repro_torch.core.modes import ExecutionMode, ExecutionPlan, LayerPlan
from repro_torch.data import pipeline
from repro_torch.kernels import ops as kops
from repro_torch.launch import graphs
from repro_torch.launch.sampling import SamplingParams
from repro_torch.launch.scheduler import (
    ContinuousBatchingServer,
    PagedContinuousBatchingServer,
)
from repro_torch.launch.serve import Server
from repro_torch.launch.train import value_and_grad
from repro_torch.models import transformer as T
from repro_torch.models.registry import get_model

ARCH = "llama-3.2-vision-90b"
TIGHT = 1e-5
LOGITS = dict(rtol=1e-4, atol=1e-5)
SP_KW = dict(temperature=0.9, top_k=50, top_p=0.95, seed=11)
GATES = {"xattn_gate": 0.5, "xmlp_gate": -0.7}


def with_gates(pj, gates=GATES):
    """JAX VLM params with the cross layers' gates set to ``gates``."""
    cross = dict(pj["blocks"]["vlm_group"]["cross"])
    for name, value in gates.items():
        cross[name] = jnp.full_like(cross[name], value)
    group = dict(pj["blocks"]["vlm_group"], cross=cross)
    return dict(pj, blocks=dict(pj["blocks"], vlm_group=group))


@pytest.fixture(scope="module")
def weights():
    cj = jcfg.get_smoke_config(ARCH)
    pj = with_gates(jax.jit(lambda k: jget(cj).init(k, cj))(
        jax.random.PRNGKey(0)))
    return pj, bridge.params_from_jax(jax.tree.map(np.asarray, pj),
                                      device="cpu")


def _cfgs(**kw):
    return (dataclasses.replace(jcfg.get_smoke_config(ARCH), **kw),
            dataclasses.replace(tcfg.get_smoke_config(ARCH), **kw))


def _close(got, want, tol=TIGHT):
    """``tol`` a float: the scaled bound; a dict: ``assert_allclose``'s."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    if isinstance(tol, dict):
        np.testing.assert_allclose(got, want, **tol)
        return
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def _images(seed, b, cfg):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)


def _batch(seed, b, s, cfg, images=True):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (b, s)).astype(np.int32)
    bj = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    bt = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}
    if images:
        img = _images(seed + 100, b, cfg)
        bj["image_embeds"] = jnp.asarray(img)
        bt["image_embeds"] = torch.from_numpy(img)
    return bj, bt


def test_layer_plan_and_params_mirror_jax(weights):
    """Groups of ``cross_attn_every - 1`` dense layers and one cross
    layer, the cross layer's extra weights and fp32 (1,) gates, in the
    JAX package's global layer order."""
    pj, pt = weights
    for get in ("get_config", "get_smoke_config"):
        cj, ct = getattr(jcfg, get)(ARCH), getattr(tcfg, get)(ARCH)
        assert T.layer_plan(ct) == jT._layer_plan(cj)
        for f in ("cross_attn_every", "num_image_tokens",
                  "is_encoder_decoder"):
            assert getattr(ct, f) == getattr(cj, f), (get, f)
    full = tcfg.get_config(ARCH)
    assert T.layer_plan(full) == [("vlm_group", 20)]
    assert T.layer_kinds(full) == (["dense"] * 4 + ["cross"]) * 20
    ct = tcfg.get_smoke_config(ARCH)
    assert T.layer_kinds(ct) == ["dense", "cross", "dense", "cross"]
    assert len(pt["layers"]) == 4 and "xattn" not in pt["layers"][2]
    shapes = T.param_shapes(ct)["layers"]
    for kind, layer, sh in zip(T.layer_kinds(ct), pt["layers"], shapes):
        assert set(layer) == set(sh)
        if kind == "cross":
            for gate in GATES:
                assert sh[gate] == ((1,), "zeros", torch.float32)
                assert layer[gate].dtype == torch.float32
    init = T.init(ct, seed=0, device="cpu")
    assert float(init["layers"][1]["xattn_gate"]) == 0.0
    assert get_model(ct).rowwise_decode_pos is True


def test_bridge_round_trips_params_and_cache(weights):
    pj, pt = weights
    cj, ct = _cfgs()
    want = jax.tree.map(np.asarray, pj)["blocks"]["vlm_group"]
    np.testing.assert_array_equal(pt["layers"][2]["attn"]["wq"].numpy(),
                                  want["self"]["attn"]["wq"][1, 0])
    np.testing.assert_array_equal(pt["layers"][3]["xattn"]["wv"].numpy(),
                                  want["cross"]["xattn"]["wv"][1])
    np.testing.assert_array_equal(pt["layers"][1]["xmlp_gate"].numpy(),
                                  want["cross"]["xmlp_gate"][0])
    rng = np.random.default_rng(3)
    cache = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        jax.tree.map(np.asarray, jget(cj).init_cache(cj, jL.HOST, 2, 8)))
    port = bridge.cache_from_jax(cache, device="cpu")
    assert len(port) == 4
    jax.tree.map(np.testing.assert_array_equal, cache,
                 bridge.cache_to_numpy(port, T.layer_kinds(ct)))
    for layer, sh in zip(port, T.cache_shapes(ct, 2, 8)):
        assert {k: tuple(v.shape) for k, v in layer.items()} == \
            {k: s for k, (s, _) in sh.items()}


@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "kernels"])
@pytest.mark.parametrize("images", [True, False], ids=["images", "none"])
def test_forward_and_loss_match_jax(weights, use_pallas, images):
    """With and without ``image_embeds``; with ``use_pallas`` every
    layer's MLP (the cross layers' too) is one ``sidebar_gated_mlp``
    dispatch."""
    cj, ct = _cfgs(use_pallas=use_pallas)
    pj, pt = weights
    bj, bt = _batch(1, 2, 12, ct, images)
    recs = []
    with torch.no_grad(), kops.record_dispatches(recs):
        got = T.forward(pt, ct, bt)
    _close(got, jget(cj).forward(pj, cj, bj), LOGITS)
    assert [r.op for r in recs] == (["sidebar_gated_mlp"] * 4
                                    if use_pallas else [])
    with torch.no_grad():
        _close(T.loss(pt, ct, bt), jget(cj).loss(pj, cj, bj))


def test_image_embeds_move_the_logits_and_gates_at_zero_hide_them(weights):
    """The cross path is live at nonzero gates: other image embeddings
    move the logits. At the init's zero gates (tanh(0) = 0) the images
    are invisible: any two give the same logits bit for bit."""
    _, ct = _cfgs()
    _, pt = weights
    _, one = _batch(2, 2, 8, ct)
    other = dict(one, image_embeds=torch.from_numpy(_images(9, 2, ct)))
    closed = {**pt, "layers": [
        {**layer, **{g: torch.zeros(1) for g in GATES if g in layer}}
        for layer in pt["layers"]]}
    with torch.no_grad():
        a, b = T.forward(pt, ct, one), T.forward(pt, ct, other)
        c, d = T.forward(closed, ct, one), T.forward(closed, ct, other)
    assert (a - b).abs().max() > 1e-3
    assert torch.equal(c, d)


def test_gated_mlp_op_matches_jax_pallas():
    """The gated MLP op with ``silu`` (the port's plain version on the
    CPU) against the JAX op's Pallas kernel in interpret mode."""
    rng = np.random.RandomState(4)
    ops = (rng.randn(16, 128).astype(np.float32),
           (rng.randn(128, 256) * 0.05).astype(np.float32),
           (rng.randn(128, 256) * 0.05).astype(np.float32),
           (rng.randn(256, 128) * 0.05).astype(np.float32))
    want = np.asarray(jops.sidebar_gated_mlp(
        *(jnp.asarray(a) for a in ops), "silu", interpret=True,
        use_kernel=True))
    got = kops.sidebar_gated_mlp(*(torch.from_numpy(a) for a in ops), "silu")
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_gradients_match_jax(weights, remat):
    """Gradients of every leaf, the gates included."""
    cj, ct = _cfgs(remat=remat)
    pj, pt = weights
    bj, bt = _batch(3, 2, 10, ct)
    lj, gj = jax.jit(lambda p, b: jax.value_and_grad(jget(cj).loss)(
        p, cj, b))(pj, bj)
    lt, gt = value_and_grad(lambda p, b: T.loss(p, ct, b), pt, bt)
    _close(lt, lj)
    want = bridge.params_from_jax(jax.tree.map(np.asarray, gj),
                                  device="cpu")
    from repro_torch import tree

    w_leaves = dict(tree.leaves_with_path(want))
    for path, g in tree.leaves_with_path(gt):
        w = w_leaves[path].numpy()
        scale = max(np.abs(w).max(), 1e-30)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * scale, (
            path, np.abs(g.numpy() - w).max(), scale)
    assert np.abs(w_leaves["['layers'][1]['xattn_gate']"].numpy()).max() > 0


@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "kernels"])
def test_prefill_and_decode_match_jax(weights, use_pallas):
    """Prefill (reading ``image_embeds``) then 3 greedy decode steps
    (``memory=``), at an int position and at a per-row one, and the KV
    slabs in the JAX nesting, against the JAX model; then prefill +
    decode against the port's own no-cache forward."""
    cj, ct = _cfgs(use_pallas=use_pallas)
    pj, pt = weights
    api = jget(cj)
    toks = np.random.RandomState(0).randint(0, ct.vocab_size, (2, 9))
    img = _images(5, 2, ct)
    cache_j = api.init_cache(cj, jL.HOST, 2, 32)
    cache_t = T.init_cache(ct, 2, 32, device="cpu")
    with torch.no_grad():
        lj, cache_j = api.prefill(pj, cj, {"tokens": jnp.asarray(toks),
                                           "image_embeds": jnp.asarray(img)},
                                  cache_j)
        lt, out = T.prefill(pt, ct, {"tokens": torch.from_numpy(toks),
                                     "image_embeds": torch.from_numpy(img)},
                            cache_t)
        assert out is cache_t
        _close(lt, lj, LOGITS)
        seq = [toks]
        for step in range(3):
            nxt = np.asarray(jnp.argmax(lj[:, -1], -1))[:, None]
            assert np.array_equal(torch.argmax(lt[:, -1], -1)[:, None]
                                  .numpy(), nxt), step
            seq.append(nxt)
            lj, cache_j = api.decode_step(pj, cj, jnp.asarray(nxt), cache_j,
                                          jnp.int32(9 + step),
                                          memory=jnp.asarray(img))
            pos = 9 + step if step % 2 else torch.full((2,), 9 + step)
            lt, cache_t = T.decode_step(
                pt, ct, torch.from_numpy(np.array(nxt)).long(), cache_t, pos,
                memory=torch.from_numpy(img))
            _close(lt, lj, LOGITS)
        got = bridge.cache_to_numpy(cache_t, T.layer_kinds(ct))
        jax.tree.map(lambda g, w: np.testing.assert_allclose(
            g, np.asarray(w), rtol=1e-4, atol=1e-5), got,
            jax.tree.map(np.asarray, cache_j))
        full = T.forward(pt, ct, {
            "tokens": torch.from_numpy(np.concatenate(seq, 1)),
            "image_embeds": torch.from_numpy(img)})
    np.testing.assert_allclose(lt[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=2e-3, atol=2e-3)


def test_make_batch_image_embeds_match_jax():
    cj, ct = _cfgs()
    for step in range(2):
        want = jdata.make_batch(cj, JShapeCell("s", 16, 2, "train"), step)
        got = pipeline.make_batch(ct, ShapeCell("s", 16, 2, "train"), step,
                                  device="cpu")
        assert set(got) == set(want) == {"tokens", "labels", "image_embeds"}
        for name in want:
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(want[name]))


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def _prompts(vocab, b=2, s=6, seed=1):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_server_matches_jax_server(weights, sampled):
    """The same prompts and image embeddings through both servers;
    scan == loop under SIDEBAR and SIDEBAR_PIPELINED at depth 2;
    temperature 0 == greedy; without ``extra`` the JAX server's
    image-free tokens."""
    cj, ct = _cfgs()
    pj, pt = weights
    prompts = _prompts(ct.vocab_size)
    img = _images(7, 2, ct)
    jsp = JSP(**SP_KW) if sampled else None
    jsrv = JaxServer(cj, pj, max_len=32)
    want = np.asarray(jsrv.generate(jnp.asarray(prompts), 8,
                                    {"image_embeds": jnp.asarray(img)},
                                    sample=jsp).tokens)
    sample = SamplingParams(**SP_KW) if sampled else None
    extra = {"image_embeds": torch.from_numpy(img)}
    for plan in (None, LayerPlan(ExecutionMode.SIDEBAR_PIPELINED, 2)):
        server = Server(ct, pt, max_len=32, plan=plan, device="cpu")
        scan = server.generate(prompts, 8, extra, decode="scan",
                               sample=sample)
        loop = server.generate(prompts, 8, extra, decode="loop",
                               sample=sample)
        assert np.array_equal(scan.tokens.numpy(), want), plan
        assert torch.equal(scan.tokens, loop.tokens), plan
    if sampled:
        return
    t0 = server.generate(prompts, 8, extra, sample=SamplingParams(
        temperature=0.0, seed=3))
    assert torch.equal(t0.tokens, scan.tokens)
    plain = np.asarray(jsrv.generate(jnp.asarray(prompts), 8).tokens)
    assert np.array_equal(server.generate(prompts, 8).tokens.numpy(), plain)


class _RerunGraph:
    """``graphs._Graph`` without a card: the capture records nothing, a
    replay runs the step again on the static inputs it copied in."""

    def __init__(self, fn, fixed, inputs, pool, device):
        self.fn, self.fixed = fn, fixed
        self.static = graphs._clone(inputs)
        self.launches = collections.Counter()

    def replay(self, inputs):
        graphs._copy_into(self.static, inputs)
        return self.fn(self.fixed, **self.static)


def test_server_replays_on_new_image_embeds(weights, monkeypatch):
    """The image embeddings are an input of the decode program: with a
    re-running stand-in for the CUDA graph (the replay runs the step on
    its fixed objects and the inputs copied into its buffers), a second
    ``generate`` on other embeddings replays the one capture and gives an
    eager server's tokens on them."""
    monkeypatch.setattr(graphs, "_Graph", _RerunGraph)
    monkeypatch.setattr(graphs.Program, "captured", property(
        lambda self: graphs.capture_enabled()))
    _, ct = _cfgs()
    _, pt = weights
    prompts = _prompts(ct.vocab_size, seed=4)
    server = Server(ct, pt, max_len=32, device="cpu")
    outs = [server.generate(prompts, 8, {"image_embeds": torch.from_numpy(
        _images(seed, 2, ct))}).tokens for seed in (1, 2)]
    prog = server._decode_scans[(7, None)]
    assert (prog.captures, prog.replays) == (1, 1)
    with graphs.disable_capture():
        eager = Server(ct, pt, max_len=32, device="cpu").generate(
            prompts, 8, {"image_embeds": torch.from_numpy(_images(2, 2, ct))}
        ).tokens
    assert torch.equal(outs[1], eager)
    assert not torch.equal(outs[0], outs[1])


def test_refusals_match_jax(weights):
    cj, ct = _cfgs()
    pj, pt = weights
    prompts = _prompts(ct.vocab_size, b=1, s=8)
    img = _images(2, 1, ct)
    with pytest.raises(ValueError, match="chunked prefill"):
        JaxServer(cj, pj, max_len=32).generate(
            jnp.asarray(prompts), 4, {"image_embeds": jnp.asarray(img)},
            prefill_chunk=4)
    with pytest.raises(ValueError, match="chunked prefill"):
        Server(ct, pt, max_len=32, device="cpu").generate(
            prompts, 4, {"image_embeds": torch.from_numpy(img)},
            prefill_chunk=4)
    hetero = ExecutionPlan(
        default=LayerPlan(ExecutionMode.SIDEBAR),
        layers={0: LayerPlan(ExecutionMode.SIDEBAR_PIPELINED, depth=4)})
    with pytest.raises(ValueError, match="heterogeneous"):
        Server(ct, pt, plan=hetero, device="cpu")
    for cls, kw in ((ContinuousBatchingServer, {}),
                    (PagedContinuousBatchingServer, {"block_size": 8})):
        with pytest.raises(ValueError, match="continuous batching"):
            cls(ct, pt, device="cpu", num_slots=1, max_len=32, **kw)


def test_serve_batch_serves_static_and_refuses_continuous(capsys):
    """``serve_batch --arch llama-3.2-vision-90b`` serves with seeded
    image embeddings (scan and loop give the same ids), and
    ``--continuous`` refuses."""
    from repro_torch.launch import serve_batch

    common = ["--device", "cpu", "--arch", ARCH, "--batch", "2",
              "--prompt-len", "8", "--gen", "4"]
    serve_batch.main(common)
    serve_batch.main(common + ["--decode", "loop"])
    out = capsys.readouterr().out
    assert out.count(f"arch={ARCH}-smoke") == 2
    assert out.count("generated 8 tokens") == 2
    ids = [line for line in out.splitlines()
           if line.startswith("sample continuation ids")]
    assert len(ids) == 2 and ids[0] == ids[1]
    with pytest.raises(ValueError, match="continuous batching"):
        serve_batch.main(common + ["--continuous"])
