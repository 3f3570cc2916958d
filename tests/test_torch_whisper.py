"""The port's whisper encoder-decoder (``repro_torch.models.whisper``,
family ``audio``) and cross-attention (``attention.gqa_attention(
memory=)``, non-causal ``_attend``) against the JAX package on the CPU,
on the same weights (``repro_torch.bridge``) and the same inputs (numpy,
seeded), at the fp32 smoke size of whisper-medium (2 + 2 layers, 24
frames).

Tolerances (fp32 on both sides, summed in different orders; "scaled"
bounds hold the largest error to that many times max(1, the tensor's
largest |value|)):
  * ``_attend`` (direct form, and the flash route at S = T = 128 against
    the Pallas kernel in interpret mode), ``gqa_attention`` with
    ``memory``, ``encode``: 1e-5 scaled;
  * the MLP op with ``gelu`` against the JAX op's Pallas kernel in
    interpret mode: 3e-5 (the JAX package's kernel tests);
  * forward, prefill and decode logits: rtol 1e-4, atol 1e-5 (the
    transformer tests' bound); the loss 1e-5 scaled; each gradient leaf
    within 1e-4 of its largest |value|;
  * prefill, then 3 decode steps, against the no-cache forward: 2e-3
    (``tests/test_decode_consistency.py``).
Tokens are held exactly: ``Server`` greedy and sampled streams equal the
JAX server's on the same ``extra={"frames": ...}``, scan == loop under
SIDEBAR and SIDEBAR_PIPELINED. The JAX refusals are reproduced. The
card's cases (no JAX there) are in ``tests/test_torch_capture.py``.
"""

import collections
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.configs.base import ShapeCell as JShapeCell
from repro.data import pipeline as jdata
from repro.launch.sampling import SamplingParams as JSP
from repro.launch.serve import Server as JaxServer
from repro.models import attention as jattn
from repro.models import layers as jL
from repro.models import whisper as jwhisper
from repro.models.registry import get_model as jget
from repro_torch import bridge
from repro_torch import configs as tcfg
from repro_torch.configs.base import ShapeCell
from repro_torch.core.modes import ExecutionMode, LayerPlan
from repro_torch.data import pipeline
from repro_torch.kernels import ops as kops
from repro_torch.kernels import sidebar_mlp as sm
from repro_torch.launch import graphs
from repro_torch.launch.sampling import SamplingParams
from repro_torch.launch.scheduler import (
    ContinuousBatchingServer,
    PagedContinuousBatchingServer,
)
from repro_torch.launch.serve import Server
from repro_torch.launch.train import value_and_grad
from repro_torch.models import attention as attn
from repro_torch.models import whisper
from repro_torch.models.registry import get_model

# the module, not the function of the same name repro.kernels exports
jmlp = importlib.import_module("repro.kernels.sidebar_mlp")

ARCH = "whisper-medium"
TIGHT = 1e-5
LOGITS = dict(rtol=1e-4, atol=1e-5)
SP_KW = dict(temperature=0.9, top_k=50, top_p=0.95, seed=11)


@pytest.fixture(scope="module")
def weights():
    cj = jcfg.get_smoke_config(ARCH)
    pj = jax.jit(lambda k: jget(cj).init(k, cj))(jax.random.PRNGKey(0))
    return pj, bridge.whisper_params_from_jax(jax.tree.map(np.asarray, pj),
                                              device="cpu")


def _cfgs(arch=ARCH, **kw):
    return (dataclasses.replace(jcfg.get_smoke_config(arch), **kw),
            dataclasses.replace(tcfg.get_smoke_config(arch), **kw))


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


def _frames(seed, b, cfg):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


def _batch(seed, b, s, cfg):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (b, s)).astype(np.int32)
    fr = _frames(seed + 100, b, cfg)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks),
             "frames": jnp.asarray(fr)},
            {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(toks),
             "frames": torch.from_numpy(fr)})


# ---------------------------------------------------------------------------
# Non-causal and cross attention
# ---------------------------------------------------------------------------


def _qkv(seed, b, h, hkv, s, t, dh):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, s, dh)).astype(np.float32),
            rng.standard_normal((b, hkv, t, dh)).astype(np.float32),
            rng.standard_normal((b, hkv, t, dh)).astype(np.float32))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s,t,use_pallas", [
    (1, 24, False), (7, 24, False), (24, 24, False), (5, 1500, False),
    (128, 128, True), (128, 256, True)],
    ids=["decode", "prefill", "encoder", "frames", "flash", "flash-long"])
def test_attend_matches_jax(s, t, use_pallas, causal):
    """The direct form, and with ``use_pallas`` at multiples of 128 the
    flash route (the Pallas kernel in interpret mode against the port's
    plain version), causal and not."""
    cj, ct = _cfgs(use_pallas=use_pallas)
    q, k, v = _qkv(s * 7 + t, 2, 4, 2, s, t, 16)
    want = jattn._attend(*(jnp.asarray(a) for a in (q, k, v)),
                         causal=causal, cfg=cj)
    recs = []
    with kops.record_dispatches(recs):
        got = attn._attend(*(torch.from_numpy(a) for a in (q, k, v)),
                           causal=causal, cfg=ct)
    _close(got, want)
    assert [r.op for r in recs] == (["flash_attention"] if use_pallas
                                    else [])


@pytest.mark.parametrize("arch", [ARCH, "llama-3.2-vision-90b"])
@pytest.mark.parametrize("memory", [False, True])
def test_gqa_attention_non_causal_and_memory_match_jax(arch, memory):
    """Whisper's encoder form (non-causal, rope on its own positions)
    and the cross form (K and V from ``memory``, no rope, no cache), at
    MHA (whisper) and GQA group 2 (the VLM)."""
    cj, ct = _cfgs(arch)
    rng = np.random.default_rng(5)
    pn = {name: (rng.standard_normal(sp.shape) / np.sqrt(sp.shape[0])
                 ).astype(np.float32)
          for name, sp in jattn.gqa_param_specs(cj, jL.HOST).items()}
    x = rng.standard_normal((2, 6, ct.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, 11, ct.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(6), (2, 6)).astype(np.int32)
    kw = dict(causal=False)
    want, cache_j = jattn.gqa_attention(
        {k: jnp.asarray(v) for k, v in pn.items()}, cj, jnp.asarray(x),
        jnp.asarray(pos), memory=jnp.asarray(mem) if memory else None, **kw)
    got, cache_t = attn.gqa_attention(
        {k: torch.from_numpy(v) for k, v in pn.items()}, ct,
        torch.from_numpy(x), torch.from_numpy(pos).long(),
        memory=torch.from_numpy(mem) if memory else None, **kw)
    _close(got, want)
    assert cache_j is None and cache_t is None


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


def test_encode_matches_jax(weights):
    cj, ct = _cfgs()
    pj, pt = weights
    fr = _frames(1, 2, ct)
    with torch.no_grad():
        got = whisper.encode(pt, ct, torch.from_numpy(fr))
    _close(got, jwhisper.encode(pj, cj, jnp.asarray(fr)))
    assert got.shape == (2, ct.encoder_seq, ct.d_model)


@pytest.mark.parametrize("act", ["gelu", "squared_relu"])
def test_mlp_op_matches_jax_pallas(act):
    """The MLP op with ``use_pallas`` (the port's plain version on the
    CPU) against the JAX op's Pallas kernel in interpret mode."""
    rng = np.random.RandomState(3)
    x = rng.randn(16, 128).astype(np.float32)
    w1 = (rng.randn(128, 256) / np.sqrt(128)).astype(np.float32)
    w2 = (rng.randn(256, 128) / np.sqrt(256)).astype(np.float32)
    want = np.asarray(jmlp.sidebar_mlp(*(jnp.asarray(a) for a in
                                         (x, w1, w2)), act, interpret=True))
    got = kops.sidebar_mlp(*(torch.from_numpy(a) for a in (x, w1, w2)), act)
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=3e-5)
    assert sm.route(*(torch.from_numpy(a) for a in (x, w1, w2))) == "fma"


@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "kernels"])
def test_forward_and_loss_match_jax(weights, use_pallas):
    """With ``use_pallas`` every MLP of both stacks is one ``sidebar_mlp``
    dispatch."""
    cj, ct = _cfgs(use_pallas=use_pallas)
    pj, pt = weights
    bj, bt = _batch(1, 2, 12, ct)
    recs = []
    with torch.no_grad(), kops.record_dispatches(recs):
        got = whisper.forward(pt, ct, bt)
    _close(got, jget(cj).forward(pj, cj, bj), LOGITS)
    n = ct.encoder_layers + ct.num_layers
    assert [r.op for r in recs] == (["sidebar_mlp"] * n if use_pallas
                                    else [])
    with torch.no_grad():
        _close(whisper.loss(pt, ct, bt), jget(cj).loss(pj, cj, bj))


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_gradients_match_jax(weights, remat):
    cj, ct = _cfgs(remat=remat)
    pj, pt = weights
    bj, bt = _batch(2, 2, 10, ct)
    lj, gj = jax.jit(lambda p, b: jax.value_and_grad(jget(cj).loss)(
        p, cj, b))(pj, bj)
    lt, gt = value_and_grad(lambda p, b: whisper.loss(p, ct, b), pt, bt)
    _close(lt, lj)
    got = bridge.whisper_params_to_numpy(gt)
    for path, w in jax.tree_util.tree_flatten_with_path(
            jax.tree.map(np.asarray, gj))[0]:
        g = got
        for key in path:
            g = g[key.key]
        scale = max(np.abs(w).max(), 1e-30)
        assert np.abs(g - w).max() <= 1e-4 * scale, (
            jax.tree_util.keystr(path), np.abs(g - w).max(), scale)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "kernels"])
def test_prefill_and_decode_match_jax(weights, use_pallas):
    """Prefill logits (it encodes the frames itself), then 3 greedy
    decode steps on the JAX encoder's memory, at an int position and at
    a per-row one, and the KV slabs, against the JAX model; then prefill
    + decode against the port's own no-cache forward."""
    cj, ct = _cfgs(use_pallas=use_pallas)
    pj, pt = weights
    api = jget(cj)
    toks = np.random.RandomState(0).randint(0, ct.vocab_size, (2, 9))
    fr = _frames(4, 2, ct)
    cache_j = api.init_cache(cj, jL.HOST, 2, 32)
    cache_t = whisper.init_cache(ct, 2, 32, device="cpu")
    with torch.no_grad():
        lj, cache_j = api.prefill(pj, cj, {"tokens": jnp.asarray(toks),
                                           "frames": jnp.asarray(fr)},
                                  cache_j)
        lt, out = whisper.prefill(pt, ct, {"tokens": torch.from_numpy(toks),
                                           "frames": torch.from_numpy(fr)},
                                  cache_t)
        assert out is cache_t
        _close(lt, lj, LOGITS)
        mem_j = jwhisper.encode(pj, cj, jnp.asarray(fr))
        mem_t = whisper.encode(pt, ct, torch.from_numpy(fr))
        seq = [toks]
        for step in range(3):
            nxt = np.asarray(jnp.argmax(lj[:, -1], -1))[:, None]
            assert np.array_equal(torch.argmax(lt[:, -1], -1)[:, None]
                                  .numpy(), nxt), step
            seq.append(nxt)
            lj, cache_j = api.decode_step(pj, cj, jnp.asarray(nxt), cache_j,
                                          jnp.int32(9 + step), memory=mem_j)
            pos = 9 + step if step % 2 else torch.full((2,), 9 + step)
            lt, cache_t = whisper.decode_step(
                pt, ct, torch.from_numpy(np.array(nxt)).long(), cache_t, pos,
                memory=mem_t)
            _close(lt, lj, LOGITS)
        got = bridge.cache_to_numpy(cache_t)["dense"]
        for name, want in cache_j.items():
            np.testing.assert_allclose(got[name], np.asarray(want),
                                       rtol=1e-4, atol=1e-5)
        full = whisper.forward(pt, ct, {
            "tokens": torch.from_numpy(np.concatenate(seq, 1)),
            "frames": torch.from_numpy(fr)})
    np.testing.assert_allclose(lt[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=2e-3, atol=2e-3)


def test_bridge_round_trips_and_config_mirrors_jax(weights):
    cj, ct = _cfgs()
    pj, pt = weights
    want = jax.tree.map(np.asarray, pj)
    jax.tree.map(np.testing.assert_array_equal, want,
                 bridge.whisper_params_to_numpy(pt))
    assert len(pt["encoder"]) == ct.encoder_layers
    assert len(pt["decoder"]) == ct.num_layers
    np.testing.assert_array_equal(pt["decoder"][1]["xattn"]["wk"].numpy(),
                                  want["decoder"]["xattn"]["wk"][1])
    shapes = whisper.param_shapes(ct)
    for stack in ("encoder", "decoder"):
        for path, arr in jax.tree_util.tree_flatten_with_path(
                want[stack])[0]:
            sh = shapes[stack][0]
            for key in path:
                sh = sh[key.key]
            assert (len(shapes[stack]), *sh[0]) == arr.shape, path
    for get in ("get_config", "get_smoke_config"):
        c_j, c_t = getattr(jcfg, get)(ARCH), getattr(tcfg, get)(ARCH)
        for f in ("encoder_layers", "encoder_seq", "is_encoder_decoder",
                  "num_layers", "d_model", "d_ff", "activation",
                  "gated_mlp", "vocab_size"):
            assert getattr(c_t, f) == getattr(c_j, f), (get, f)
    full = tcfg.get_config(ARCH)
    assert full.is_encoder_decoder and full.head_dim == 64
    assert get_model(full).rowwise_decode_pos is False


def test_make_batch_frames_match_jax():
    """``frames`` drawn after the tokens from the same generator, in the
    config's dtype: JAX's batch."""
    cj, ct = _cfgs()
    for step in range(2):
        want = jdata.make_batch(cj, JShapeCell("s", 16, 2, "train"), step)
        got = pipeline.make_batch(ct, ShapeCell("s", 16, 2, "train"), step,
                                  device="cpu")
        assert set(got) == set(want) == {"tokens", "labels", "frames"}
        for name in want:
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(want[name]))
        assert got["frames"].dtype == torch.float32


def test_train_step_hands_frames_to_the_loss(weights):
    """``make_train_step`` splits every key of the batch into its
    microbatches, ``frames`` included: its loss is ``whisper.loss`` of
    the batch (two microbatches of one row)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.train import make_train_step
    from repro_torch.optim.optimizer import init_state
    from repro_torch import tree

    _, ct = _cfgs()
    _, pt = weights
    pt = tree.map_leaves(lambda t: t.clone(), pt)
    cell = ShapeCell("s", 12, 2, "train")
    batch = pipeline.make_batch(ct, cell, 0, device="cpu")
    tcfg = TrainConfig(microbatch_per_device=1)
    step, n_micro, _ = make_train_step(ct, tcfg, get_model(ct), cell)
    assert n_micro == 2
    with torch.no_grad():
        want = np.mean([float(whisper.loss(pt, ct, {
            k: v[m::2] for k, v in batch.items()})) for m in range(2)])
    *_, stats = step(pt, init_state(pt, tcfg), None, batch)
    np.testing.assert_allclose(float(stats["loss"]), want, rtol=1e-5)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def _prompts(vocab, b=2, s=6, seed=1):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_server_matches_jax_server(weights, sampled):
    """The same prompts and frames through both servers; scan == loop
    under SIDEBAR and SIDEBAR_PIPELINED at depth 2; temperature 0 ==
    greedy."""
    cj, ct = _cfgs()
    pj, pt = weights
    prompts = _prompts(ct.vocab_size)
    fr = _frames(7, 2, ct)
    want = np.asarray(JaxServer(cj, pj, max_len=32).generate(
        jnp.asarray(prompts), 8, {"frames": jnp.asarray(fr)},
        sample=JSP(**SP_KW) if sampled else None).tokens)
    sample = SamplingParams(**SP_KW) if sampled else None
    extra = {"frames": torch.from_numpy(fr)}
    for plan in (None, LayerPlan(ExecutionMode.SIDEBAR_PIPELINED, 2)):
        server = Server(ct, pt, max_len=32, plan=plan, device="cpu")
        scan = server.generate(prompts, 8, extra, decode="scan",
                               sample=sample)
        loop = server.generate(prompts, 8, extra, decode="loop",
                               sample=sample)
        assert np.array_equal(scan.tokens.numpy(), want), plan
        assert torch.equal(scan.tokens, loop.tokens), plan
    if not sampled:
        t0 = server.generate(prompts, 8, extra, sample=SamplingParams(
            temperature=0.0, seed=3))
        assert torch.equal(t0.tokens, scan.tokens)


class _RerunGraph:
    """``graphs._Graph`` without a card: the capture records nothing, a
    replay runs the step again on the static inputs it copied in (so a
    replay sees exactly what a CUDA graph's would: the fixed objects it
    was captured on and the inputs copied into its buffers)."""

    def __init__(self, fn, fixed, inputs, pool, device):
        self.fn, self.fixed = fn, fixed
        self.static = graphs._clone(inputs)
        self.launches = collections.Counter()

    def replay(self, inputs):
        graphs._copy_into(self.static, inputs)
        return self.fn(self.fixed, **self.static)


def test_server_replays_on_new_frames(weights, monkeypatch):
    """The encoder memory is an input of the decode program, copied into
    its static buffer: with a re-running stand-in for the CUDA graph, a
    second and a third ``generate`` on other frames replay the one
    capture and give an eager server's tokens on those frames."""
    monkeypatch.setattr(graphs, "_Graph", _RerunGraph)
    monkeypatch.setattr(graphs.Program, "captured", property(
        lambda self: graphs.capture_enabled()))
    _, ct = _cfgs()
    _, pt = weights
    prompts = _prompts(ct.vocab_size, seed=3)
    server = Server(ct, pt, max_len=32, device="cpu")
    outs = [server.generate(prompts, 8, {"frames": torch.from_numpy(
        _frames(seed, 2, ct))}).tokens for seed in (1, 2, 1)]
    prog = server._decode_scans[(7, None)]
    assert (prog.captures, prog.replays) == (1, 2)
    with graphs.disable_capture():
        eager = [Server(ct, pt, max_len=32, device="cpu").generate(
            prompts, 8, {"frames": torch.from_numpy(_frames(seed, 2, ct))}
        ).tokens for seed in (1, 2)]
    assert torch.equal(outs[0], eager[0]) and torch.equal(outs[2], eager[0])
    assert torch.equal(outs[1], eager[1])
    assert not torch.equal(outs[0], outs[1])


def test_refusals_match_jax(weights):
    cj, ct = _cfgs()
    pj, pt = weights
    prompts = _prompts(ct.vocab_size, b=1, s=8)
    fr = _frames(2, 1, ct)
    with pytest.raises(ValueError, match="chunked prefill"):
        JaxServer(cj, pj, max_len=32).generate(
            jnp.asarray(prompts), 4, {"frames": jnp.asarray(fr)},
            prefill_chunk=4)
    with pytest.raises(ValueError, match="chunked prefill"):
        Server(ct, pt, max_len=32, device="cpu").generate(
            prompts, 4, {"frames": torch.from_numpy(fr)}, prefill_chunk=4)
    cache_j = jget(cj).init_cache(cj, jL.HOST, 1, 16)
    with pytest.raises(ValueError, match="encoder memory"):
        jwhisper.decode_step(pj, cj, jnp.zeros((1, 1), jnp.int32), cache_j,
                             jnp.int32(3))
    with pytest.raises(ValueError, match="encoder memory"):
        whisper.decode_step(pt, ct, torch.zeros((1, 1), dtype=torch.long),
                            whisper.init_cache(ct, 1, 16, device="cpu"), 3)
    with pytest.raises(ValueError, match="whole prompt"):
        whisper.prefill(pt, ct, {"tokens": torch.from_numpy(prompts),
                                 "frames": torch.from_numpy(fr)},
                        whisper.init_cache(ct, 1, 16, device="cpu"),
                        cache_pos=0)
    for cls, kw in ((ContinuousBatchingServer, {}),
                    (PagedContinuousBatchingServer, {"block_size": 8})):
        with pytest.raises(ValueError, match="continuous batching"):
            cls(ct, pt, device="cpu", num_slots=1, max_len=32, **kw)


def test_serve_batch_serves_static_and_refuses_continuous(capsys):
    """``serve_batch --arch whisper-medium`` serves with seeded frames
    (scan and loop give the same ids), and ``--continuous`` refuses."""
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
