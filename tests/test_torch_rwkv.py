"""The port's RWKV6 (``repro_torch.models.rwkv`` / ``rwkv_model``, family
``ssm``) against the JAX package on the CPU, on the same weights
(``repro_torch.bridge``) and the same inputs (numpy, seeded), at the
fp32 smoke size of rwkv6-7b.

Tolerances (fp32 on both sides, summed in different orders; "scaled"
bounds hold the largest error to that many times max(1, the tensor's
largest |value|)):
  * chunked WKV, the time-mix / channel-mix blocks and their states:
    1e-5 scaled;
  * the port's chunked WKV against its own step-by-step loop: 1e-5
    scaled;
  * forward, prefill and decode logits: rtol 1e-4, atol 1e-5 (the
    transformer tests' bound); the loss 1e-5; each gradient leaf within
    1e-4 of its largest |value|;
  * prefill, then 3 decode steps, against the no-cache forward: 2e-3
    (``tests/test_decode_consistency.py``).
``Server`` tokens, greedy and sampled, equal the JAX server's; scan ==
loop bit for bit; the JAX refusals (chunked prefill, a per-layer plan,
both schedulers) are reproduced. The card's case (no JAX there) is in
``tests/test_torch_capture.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.launch.sampling import SamplingParams as JSP
from repro.launch.serve import Server as JaxServer
from repro.models import layers as jL
from repro.models import rwkv as jrwkv
from repro.models.registry import get_model as jget
from repro_torch import bridge
from repro_torch import configs as tcfg
from repro_torch.core.function_table import DEFAULT_TABLE
from repro_torch.core.modes import ExecutionMode, ExecutionPlan, LayerPlan
from repro_torch.launch import graphs
from repro_torch.launch.sampling import SamplingParams
from repro_torch.launch.scheduler import (
    ContinuousBatchingServer,
    PagedContinuousBatchingServer,
)
from repro_torch.launch.serve import Server
from repro_torch.launch.train import value_and_grad
from repro_torch.models import rwkv, rwkv_model
from repro_torch.models.registry import get_model

from repro.core.function_table import DEFAULT_TABLE as JTABLE

ARCH = "rwkv6-7b"
TIGHT = 1e-5
LOGITS = dict(rtol=1e-4, atol=1e-5)
SP_KW = dict(temperature=0.9, top_k=50, top_p=0.95, seed=11)


@pytest.fixture(scope="module")
def weights():
    cj = jcfg.get_smoke_config(ARCH)
    pj = jax.jit(lambda k: jget(cj).init(k, cj))(jax.random.PRNGKey(0))
    return pj, bridge.rwkv_params_from_jax(jax.tree.map(np.asarray, pj),
                                           device="cpu")


def _cfgs(**kw):
    return (dataclasses.replace(jcfg.get_smoke_config(ARCH), **kw),
            dataclasses.replace(tcfg.get_smoke_config(ARCH), **kw))


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.asarray(a))


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


def _wkv_inputs(rng, b, t, h, k):
    r, kk, v = (rng.standard_normal((b, t, h, k)).astype(np.float32)
                for _ in range(3))
    logw = -rng.uniform(0.01, 3.0, (b, t, h, k)).astype(np.float32)
    u = rng.standard_normal((h, k)).astype(np.float32)
    s0 = (rng.standard_normal((b, h, k, k)) * 0.1).astype(np.float32)
    return r, kk, v, logw, u, s0


# chunks that divide t and chunks that do not (halved until they do)
CHUNKS = [(8, 4), (16, 16), (12, 8), (24, 16), (7, 4), (32, 64)]


@pytest.mark.parametrize("t,chunk", CHUNKS)
def test_wkv_chunked_matches_jax(t, chunk):
    args = _wkv_inputs(np.random.default_rng(t * 100 + chunk), 2, t, 3, 4)
    oj, sj = jrwkv.wkv_chunked(*(jnp.asarray(a) for a in args), chunk=chunk)
    ot, st = rwkv.wkv_chunked(*(torch.from_numpy(a) for a in args),
                              chunk=chunk)
    _close(ot, oj)
    _close(st, sj)


@pytest.mark.parametrize("t,chunk", CHUNKS)
def test_wkv_chunked_equals_step_loop(t, chunk):
    r, k, v, logw, u, s0 = (torch.from_numpy(a) for a in _wkv_inputs(
        np.random.default_rng(t + chunk), 2, t, 3, 4))
    o, s_final = rwkv.wkv_chunked(r, k, v, logw, u, s0, chunk=chunk)
    s = s0
    for i in range(t):
        oi, s = rwkv.wkv_step(r[:, i], k[:, i], v[:, i],
                              torch.exp(logw[:, i]), u, s)
        _close(oi, o[:, i].numpy())
    _close(s, s_final.numpy())


def test_chunk_rule_matches_jax():
    for t, chunk, q in ((8, 4, 4), (12, 8, 4), (7, 4, 1), (32, 64, 32),
                        (128, 64, 64)):
        assert rwkv.chunk_len(t, chunk) == q


def _state(cfg, rng, b, zero):
    h, k = rwkv.rwkv_dims(cfg)
    d = cfg.d_model
    if zero:
        return {"wkv": np.zeros((b, h, k, k), np.float32),
                "shift_tm": np.zeros((b, d), np.float32),
                "shift_cm": np.zeros((b, d), np.float32)}
    return {"wkv": (rng.standard_normal((b, h, k, k)) * 0.3
                    ).astype(np.float32),
            "shift_tm": rng.standard_normal((b, d)).astype(np.float32),
            "shift_cm": rng.standard_normal((b, d)).astype(np.float32)}


@pytest.mark.parametrize("s", [1, 5, 16])
@pytest.mark.parametrize("state", ["none", "zero", "random"])
def test_blocks_match_jax(weights, s, state):
    """Time-mix then channel-mix on layer 1's weights, with and without a
    state: outputs and new states."""
    cj, ct = _cfgs()
    pj, pt = weights
    pjl = jax.tree.map(lambda a: a[1], pj["blocks"])
    ptl = pt["layers"][1]
    rng = np.random.default_rng(s)
    xj, xt = _both(rng.standard_normal((2, s, ct.d_model)).astype(
        np.float32))
    sj = st = None
    if state != "none":
        st0 = _state(ct, rng, 2, state == "zero")
        sj = {k: jnp.asarray(v) for k, v in st0.items()}
        st = {k: torch.from_numpy(v) for k, v in st0.items()}
    yj, nj = jrwkv.rwkv_block(pjl, cj, xj, table=JTABLE, state=sj)
    yt, nt = rwkv.rwkv_block(ptl, ct, xt, table=DEFAULT_TABLE, state=st)
    _close(yt, yj)
    cmj, nj = jrwkv.rwkv_channel_mix(pjl, cj, yj, table=JTABLE, state=nj)
    cmt, nt = rwkv.rwkv_channel_mix(ptl, ct, yt, table=DEFAULT_TABLE,
                                    state=nt)
    _close(cmt, cmj)
    if state == "none":
        assert nj is None and nt is None
        return
    assert set(nt) == set(nj)
    for name in nj:
        _close(nt[name], nj[name])


def _batch(seed, b, s, vocab):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)},
            {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(toks)})


def test_forward_and_loss_match_jax(weights):
    cj, ct = _cfgs()
    pj, pt = weights
    bj, bt = _batch(1, 2, 24, ct.vocab_size)
    with torch.no_grad():
        _close(rwkv_model.forward(pt, ct, bt), jget(cj).forward(pj, cj, bj),
               LOGITS)
        _close(rwkv_model.loss(pt, ct, bt), jget(cj).loss(pj, cj, bj))


def _assert_grads_close(got, want, rel=1e-4):
    """Leaf by leaf: |got - want| <= rel x the leaf's largest |want|."""
    got, want = bridge.rwkv_params_to_numpy(got), jax.tree.map(np.asarray,
                                                               want)
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    for path, w in flat:
        g = got
        for key in path:
            g = g[key.key]
        scale = max(np.abs(w).max(), 1e-30)
        assert np.abs(g - w).max() <= rel * scale, (
            jax.tree_util.keystr(path), np.abs(g - w).max(), scale)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_gradients_match_jax(weights, remat):
    cj, ct = _cfgs(remat=remat)
    pj, pt = weights
    bj, bt = _batch(2, 2, 16, ct.vocab_size)
    lj, gj = jax.jit(lambda p, b: jax.value_and_grad(jget(cj).loss)(
        p, cj, b))(pj, bj)
    lt, gt = value_and_grad(lambda p, b: rwkv_model.loss(p, ct, b), pt, bt)
    _close(lt, lj)
    _assert_grads_close(gt, gj)


def test_prefill_and_decode_match_jax(weights):
    """Prefill logits and state, then 3 greedy decode steps' logits and
    states, against the JAX model; then prefill + decode against the
    port's own no-cache forward."""
    cj, ct = _cfgs()
    pj, pt = weights
    api = jget(cj)
    toks = np.random.RandomState(0).randint(0, ct.vocab_size, (2, 9))
    cache_j = api.init_cache(cj, jL.HOST, 2, 32)
    cache_t = rwkv_model.init_cache(ct, 2, 32, device="cpu")
    leaves = [t for layer in cache_t for t in layer.values()]
    with torch.no_grad():
        lj, cache_j = api.prefill(pj, cj, {"tokens": jnp.asarray(toks)},
                                  cache_j)
        lt, out = rwkv_model.prefill(pt, ct, {"tokens": torch.from_numpy(
            toks)}, cache_t)
        assert out is cache_t and all(
            a is b for a, b in zip(leaves, (t for layer in out
                                             for t in layer.values())))
        _close(lt, lj, LOGITS)
        seq = [toks]
        for step in range(3):
            nxt = np.asarray(jnp.argmax(lj[:, -1], -1))[:, None]
            assert np.array_equal(torch.argmax(lt[:, -1], -1)[:, None]
                                  .numpy(), nxt), step
            seq.append(nxt)
            lj, cache_j = api.decode_step(pj, cj, jnp.asarray(nxt), cache_j,
                                          jnp.int32(9 + step))
            lt, cache_t = rwkv_model.decode_step(
                pt, ct, torch.from_numpy(np.array(nxt)).long(), cache_t,
                9 + step)
            _close(lt, lj, LOGITS)
        got = bridge.state_to_numpy(cache_t)
        for name, want in jax.tree.map(np.asarray, cache_j).items():
            np.testing.assert_allclose(got[name], want, rtol=1e-4,
                                       atol=1e-5)
        full = rwkv_model.forward(pt, ct, {"tokens": torch.from_numpy(
            np.concatenate(seq, 1))})
    np.testing.assert_allclose(lt[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=2e-3, atol=2e-3)


def test_bridge_round_trips_params_and_state(weights):
    cj, ct = _cfgs()
    pj, pt = weights
    want = jax.tree.map(np.asarray, pj)
    jax.tree.map(np.testing.assert_array_equal, want,
                 bridge.rwkv_params_to_numpy(pt))
    rng = np.random.default_rng(3)
    state = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        jax.tree.map(np.asarray, jget(cj).init_cache(cj, jL.HOST, 2, 8)))
    port = bridge.state_from_jax(state, device="cpu")
    assert len(port) == ct.num_layers and set(port[0]) == set(state)
    jax.tree.map(np.testing.assert_array_equal, state,
                 bridge.state_to_numpy(port))


def _prompts(vocab, b=2, s=6, seed=1):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_server_matches_jax_server(weights, sampled):
    cj, ct = _cfgs()
    pj, pt = weights
    prompts = _prompts(ct.vocab_size)
    want = np.asarray(JaxServer(cj, pj, max_len=32).generate(
        jnp.asarray(prompts), 8,
        sample=JSP(**SP_KW) if sampled else None).tokens)
    server = Server(ct, pt, max_len=32, device="cpu")
    sample = SamplingParams(**SP_KW) if sampled else None
    scan = server.generate(prompts, 8, decode="scan", sample=sample)
    loop = server.generate(prompts, 8, decode="loop", sample=sample)
    assert np.array_equal(scan.tokens.numpy(), want)
    assert torch.equal(scan.tokens, loop.tokens)
    if not sampled:
        t0 = server.generate(prompts, 8, sample=SamplingParams(
            temperature=0.0, seed=3))
        assert torch.equal(t0.tokens, scan.tokens)


class _RerunGraph:
    """A stand-in capture whose replay re-runs the step on its static
    inputs and the fixed objects it was captured on."""

    def __init__(self, fn, fixed, inputs, pool, device):
        self.fn, self.fixed = fn, fixed
        self.static = graphs._clone(inputs)

    def replay(self, inputs):
        graphs._copy_into(self.static, inputs)
        return self.fn(self.fixed, **self.static)


def test_state_buffer_is_zeroed_and_the_capture_replays(weights,
                                                        monkeypatch):
    """The server keeps one state buffer a batch size and zeroes it
    before each request, so a second ``generate`` of the same shape
    replays the first one's graph (captured on that buffer) and gives
    the same tokens as a fresh server's loop."""
    monkeypatch.setattr(graphs, "_Graph", _RerunGraph)
    monkeypatch.setattr(graphs.Program, "captured", property(
        lambda self: graphs.capture_enabled()))
    _, ct = _cfgs()
    _, pt = weights
    server = Server(ct, pt, max_len=32, device="cpu")
    first = server.generate(_prompts(ct.vocab_size), 8).tokens
    pooled = server._cache_pool[2]
    other = server.generate(_prompts(ct.vocab_size, seed=5), 8).tokens
    again = server.generate(_prompts(ct.vocab_size), 8).tokens
    prog = server._decode_scans[(7, None)]
    assert (prog.captures, prog.replays) == (1, 2)
    assert server._cache_pool[2] is pooled
    assert torch.equal(first, again) and not torch.equal(first, other)
    with graphs.disable_capture():
        fresh = Server(ct, pt, max_len=32, device="cpu").generate(
            _prompts(ct.vocab_size, seed=5), 8, decode="loop").tokens
    assert torch.equal(other, fresh)


def test_refusals_match_jax(weights):
    cj, ct = _cfgs()
    pj, pt = weights
    prompts = _prompts(ct.vocab_size, b=1, s=8)
    with pytest.raises(ValueError, match="chunked prefill"):
        JaxServer(cj, pj, max_len=32).generate(jnp.asarray(prompts), 4,
                                               prefill_chunk=4)
    with pytest.raises(ValueError, match="chunked prefill"):
        Server(ct, pt, max_len=32, device="cpu").generate(
            prompts, 4, prefill_chunk=4)
    hetero = ExecutionPlan(
        default=LayerPlan(ExecutionMode.SIDEBAR),
        layers={0: LayerPlan(ExecutionMode.SIDEBAR_PIPELINED, depth=4)})
    with pytest.raises(ValueError, match="heterogeneous"):
        Server(ct, pt, plan=hetero, device="cpu")
    for cls, kw in ((ContinuousBatchingServer, {}),
                    (PagedContinuousBatchingServer, {"block_size": 8})):
        with pytest.raises(ValueError, match="continuous batching"):
            cls(ct, pt, device="cpu", num_slots=1, max_len=32, **kw)
    with pytest.raises(ValueError, match="whole prompt"):
        rwkv_model.prefill(pt, ct, {"tokens": torch.from_numpy(prompts)},
                           rwkv_model.init_cache(ct, 1, 32, device="cpu"),
                           cache_pos=4)
    assert get_model(ct).rowwise_decode_pos is False
    assert jget(cj).rowwise_decode_pos is False


def test_config_and_shapes_mirror_jax(weights):
    pj, pt = weights
    full = tcfg.get_config(ARCH)
    assert (full.num_layers, full.d_model, full.d_ff, full.vocab_size,
            full.rwkv_head_dim) == (32, 4096, 14336, 65536, 64)
    assert full.attention_free and full.subquadratic
    cj, ct = _cfgs()
    api = get_model(ct)
    shapes = api.param_shapes(ct)
    for name, arr in pj["blocks"].items():
        shape = shapes["layers"][0][name][0]
        assert (ct.num_layers, *shape) == arr.shape, name
        assert pt["layers"][0][name].dtype == (
            torch.float32 if arr.dtype == jnp.float32 else ct.dtype)
    for name, (shape, dtype) in rwkv.rwkv_state_shapes(full, 4).items():
        assert str(dtype).split(".")[-1] == jnp.dtype(
            jrwkv.rwkv_state_specs(jcfg.get_config(ARCH), jL.HOST, 4, 1)[
                name].dtype).name
        assert shape == jrwkv.rwkv_state_specs(
            jcfg.get_config(ARCH), jL.HOST, 4, 1)[name].shape[1:]


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-7b"])
def test_serve_batch_serves_static_and_refuses_continuous(arch, capsys):
    """``serve_batch --arch`` serves both recurrent families in static
    mode (scan and loop), and ``--continuous`` refuses them."""
    from repro_torch.launch import serve_batch

    common = ["--device", "cpu", "--arch", arch, "--batch", "2",
              "--prompt-len", "8", "--gen", "4"]
    serve_batch.main(common)
    serve_batch.main(common + ["--decode", "loop"])
    out = capsys.readouterr().out
    assert out.count(f"arch={arch}-smoke") == 2
    assert out.count("generated 8 tokens") == 2
    ids = [line for line in out.splitlines()
           if line.startswith("sample continuation ids")]
    assert len(ids) == 2 and ids[0] == ids[1]
    with pytest.raises(ValueError, match="continuous batching"):
        serve_batch.main(common + ["--continuous"])
