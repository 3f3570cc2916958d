"""The port's Mamba2 hybrid (``repro_torch.models.ssm`` / ``zamba``,
family ``hybrid``) against the JAX package on the CPU, on the same
weights (``repro_torch.bridge``) and the same inputs (numpy, seeded), at
the fp32 smoke size of zamba2-7b (7 layers: 2 groups of 3 and 1 tail
layer, the shared attention + MLP block after each group).

Tolerances (fp32 on both sides, summed in different orders; "scaled"
bounds hold the largest error to that many times max(1, the tensor's
largest |value|)):
  * chunked SSD, the causal conv, ``mamba2_block`` and its states: 1e-5
    scaled; the port's chunked SSD against its own step loop: 1e-5
    scaled;
  * forward, prefill and decode logits: rtol 1e-4, atol 1e-5 (the
    transformer tests' bound); the loss 1e-5 scaled; each gradient leaf
    within 1e-4 of its largest |value|;
  * prefill, then 3 decode steps, against the no-cache forward: 2e-3
    (``tests/test_decode_consistency.py``).
With ``use_pallas`` the shared block's MLP is one ``sidebar_gated_mlp``
dispatch an invocation (the plain version on the CPU), against the JAX
model's kernel route. ``Server`` tokens, greedy and sampled, equal the
JAX server's; scan == loop bit for bit; the JAX refusals are
reproduced. The card's case (no JAX there) is in
``tests/test_torch_capture.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.core import modes as jmodes
from repro.core.function_table import DEFAULT_TABLE as JTABLE
from repro.launch.sampling import SamplingParams as JSP
from repro.launch.serve import Server as JaxServer
from repro.models import layers as jL
from repro.models import ssm as jssm
from repro.models import zamba as jzamba
from repro.models.registry import get_model as jget
from repro_torch import bridge
from repro_torch import configs as tcfg
from repro_torch.core.function_table import DEFAULT_TABLE
from repro_torch.core.modes import ExecutionMode, ExecutionPlan, LayerPlan
from repro_torch.kernels import ops as kops
from repro_torch.launch.sampling import SamplingParams
from repro_torch.launch.scheduler import (
    ContinuousBatchingServer,
    PagedContinuousBatchingServer,
)
from repro_torch.launch.serve import Server
from repro_torch.launch.train import value_and_grad
from repro_torch.models import ssm, zamba
from repro_torch.models.registry import get_model

ARCH = "zamba2-7b"
TIGHT = 1e-5
LOGITS = dict(rtol=1e-4, atol=1e-5)
SP_KW = dict(temperature=0.9, top_k=50, top_p=0.95, seed=11)


@pytest.fixture(scope="module")
def weights():
    cj = jcfg.get_smoke_config(ARCH)
    pj = jax.jit(lambda k: jget(cj).init(k, cj))(jax.random.PRNGKey(0))
    return pj, bridge.zamba_params_from_jax(jax.tree.map(np.asarray, pj),
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


def _ssd_inputs(rng, b, t, h, p, n):
    x = rng.standard_normal((b, t, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (b, t, h)).astype(np.float32)
    a = -rng.uniform(0.1, 2.0, (h,)).astype(np.float32)
    bm, cm = (rng.standard_normal((b, t, n)).astype(np.float32)
              for _ in range(2))
    dsk = rng.standard_normal((h,)).astype(np.float32)
    h0 = (rng.standard_normal((b, h, n, p)) * 0.1).astype(np.float32)
    return x, dt, a, bm, cm, dsk, h0


# chunks that divide t and chunks that do not (halved until they do)
CHUNKS = [(8, 4), (16, 16), (12, 8), (24, 16), (7, 4), (32, 256)]


@pytest.mark.parametrize("t,chunk", CHUNKS)
def test_mamba2_chunked_matches_jax(t, chunk):
    args = _ssd_inputs(np.random.default_rng(t * 100 + chunk), 2, t, 3, 4,
                       5)
    yj, hj = jssm.mamba2_chunked(*(jnp.asarray(a) for a in args), chunk)
    yt, ht = ssm.mamba2_chunked(*(torch.from_numpy(a) for a in args), chunk)
    _close(yt, yj)
    _close(ht, hj)


@pytest.mark.parametrize("t,chunk", CHUNKS)
def test_mamba2_chunked_equals_step_loop(t, chunk):
    x, dt, a, bm, cm, dsk, h0 = (torch.from_numpy(v) for v in _ssd_inputs(
        np.random.default_rng(t + chunk), 2, t, 3, 4, 5))
    y, h_final = ssm.mamba2_chunked(x, dt, a, bm, cm, dsk, h0, chunk)
    h = h0
    for i in range(t):
        yi, h = ssm.mamba2_step(x[:, i], dt[:, i], a, bm[:, i], cm[:, i],
                                dsk, h)
        _close(yi, y[:, i].numpy())
    _close(h, h_final.numpy())


@pytest.mark.parametrize("t", [1, 2, 3, 9])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(t, with_state):
    rng = np.random.default_rng(t)
    x = rng.standard_normal((2, t, 6)).astype(np.float32)
    w = rng.standard_normal((ssm.CONV_K, 6)).astype(np.float32)
    st = (rng.standard_normal((2, ssm.CONV_K - 1, 6)).astype(np.float32)
          if with_state else None)
    yj, sj = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                               None if st is None else jnp.asarray(st))
    yt, s_t = ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                               None if st is None else torch.from_numpy(st))
    _close(yt, yj)
    _close(s_t, sj)


@pytest.mark.parametrize("s", [1, 5, 16])
@pytest.mark.parametrize("state", ["none", "zero", "random"])
def test_mamba2_block_matches_jax(weights, s, state):
    """Layer 4 (group 1, its second layer) with and without a state:
    output and new states."""
    cj, ct = _cfgs()
    pj, pt = weights
    pjl = jax.tree.map(lambda a: a[1, 1], pj["groups"])
    ptl = pt["layers"][4]
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, ct.d_model)).astype(np.float32)
    sj = st = None
    if state != "none":
        d_in, h, p = ssm.ssm_dims(ct)
        shapes = {"h": (2, h, ct.ssm_state, p),
                  "conv": (2, ssm.CONV_K - 1, d_in + 2 * ct.ssm_state)}
        st0 = {k: (np.zeros(v, np.float32) if state == "zero" else
                   (rng.standard_normal(v) * 0.3).astype(np.float32))
               for k, v in shapes.items()}
        sj = {k: jnp.asarray(v) for k, v in st0.items()}
        st = {k: torch.from_numpy(v) for k, v in st0.items()}
    yj, nj = jssm.mamba2_block(pjl, cj, jnp.asarray(x), table=JTABLE,
                               state=sj)
    yt, nt = ssm.mamba2_block(ptl, ct, torch.from_numpy(x),
                              table=DEFAULT_TABLE, state=st)
    _close(yt, yj)
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


@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "kernels"])
def test_forward_and_loss_match_jax(weights, use_pallas):
    """With ``use_pallas`` each of the 2 shared-block invocations is one
    ``sidebar_gated_mlp`` dispatch."""
    cj, ct = _cfgs(use_pallas=use_pallas)
    pj, pt = weights
    bj, bt = _batch(1, 2, 24, ct.vocab_size)
    recs = []
    with torch.no_grad(), kops.record_dispatches(recs):
        got = zamba.forward(pt, ct, bt)
    _close(got, jget(cj).forward(pj, cj, bj), LOGITS)
    assert [r.op for r in recs] == (["sidebar_gated_mlp"] * 2
                                    if use_pallas else [])
    with torch.no_grad():
        _close(zamba.loss(pt, ct, bt), jget(cj).loss(pj, cj, bj))


def _assert_grads_close(got, want, rel=1e-4):
    """Leaf by leaf: |got - want| <= rel x the leaf's largest |want|."""
    got = bridge.zamba_params_to_numpy(got, 3)
    for path, w in jax.tree_util.tree_flatten_with_path(
            jax.tree.map(np.asarray, want))[0]:
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
    lt, gt = value_and_grad(lambda p, b: zamba.loss(p, ct, b), pt, bt)
    _close(lt, lj)
    _assert_grads_close(gt, gj)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "kernels"])
def test_prefill_and_decode_match_jax(weights, use_pallas):
    """Prefill logits, then 3 greedy decode steps' logits, and the final
    Mamba2 states and KV slabs, against the JAX model (decode at an int
    position and at a per-row one); then prefill + decode against the
    port's own no-cache forward. With ``use_pallas`` every prefill and
    decode step dispatches ``sidebar_gated_mlp`` once a group."""
    cj, ct = _cfgs(use_pallas=use_pallas)
    pj, pt = weights
    api = jget(cj)
    toks = np.random.RandomState(0).randint(0, ct.vocab_size, (2, 9))
    cache_j = api.init_cache(cj, jL.HOST, 2, 32)
    cache_t = zamba.init_cache(ct, 2, 32, device="cpu")
    recs = []
    with torch.no_grad(), kops.record_dispatches(recs):
        lj, cache_j = api.prefill(pj, cj, {"tokens": jnp.asarray(toks)},
                                  cache_j)
        lt, out = zamba.prefill(pt, ct, {"tokens": torch.from_numpy(toks)},
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
                                          jnp.int32(9 + step))
            pos = 9 + step if step % 2 else torch.full((2,), 9 + step)
            lt, cache_t = zamba.decode_step(
                pt, ct, torch.from_numpy(np.array(nxt)).long(), cache_t, pos)
            _close(lt, lj, LOGITS)
        got = bridge.state_to_numpy(cache_t)
        want = jax.tree.map(np.asarray, cache_j)
        for part in ("ssm", "kv"):
            for name in want[part]:
                np.testing.assert_allclose(got[part][name], want[part][name],
                                           rtol=1e-4, atol=1e-5)
        full = zamba.forward(pt, ct, {"tokens": torch.from_numpy(
            np.concatenate(seq, 1))})
    np.testing.assert_allclose(lt[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=2e-3, atol=2e-3)
    n_groups = ct.num_layers // ct.attn_every
    assert sum(r.op == "sidebar_gated_mlp" for r in recs) == (
        (1 + 3 + 1) * n_groups if use_pallas else 0)


def test_plan_of_groups_mirrors_jax():
    for get in ("get_config", "get_smoke_config"):
        cj, ct = getattr(jcfg, get)(ARCH), getattr(tcfg, get)(ARCH)
        assert zamba._plan(ct) == jzamba._plan(cj)
    assert zamba._plan(tcfg.get_config(ARCH)) == (13, 3)
    assert zamba._plan(tcfg.get_smoke_config(ARCH)) == (2, 1)
    full = tcfg.get_config(ARCH)
    assert full.head_dim == 112 and ssm.ssm_dims(full) == (7168, 112, 64)
    assert full.subquadratic and not full.attention_free


def test_bridge_round_trips_params_and_state(weights):
    cj, ct = _cfgs()
    pj, pt = weights
    want = jax.tree.map(np.asarray, pj)
    jax.tree.map(np.testing.assert_array_equal, want,
                 bridge.zamba_params_to_numpy(pt, ct.attn_every))
    assert len(pt["layers"]) == ct.num_layers
    # layer order: group-major, then the tail
    np.testing.assert_array_equal(pt["layers"][4]["in_x"].numpy(),
                                  want["groups"]["in_x"][1, 1])
    np.testing.assert_array_equal(pt["layers"][6]["out"].numpy(),
                                  want["tail"]["out"][0])
    rng = np.random.default_rng(3)
    state = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        jax.tree.map(np.asarray, jget(cj).init_cache(cj, jL.HOST, 2, 8)))
    port = bridge.state_from_jax(state, device="cpu")
    assert len(port["ssm"]) == ct.num_layers and len(port["kv"]) == 2
    jax.tree.map(np.testing.assert_array_equal, state,
                 bridge.state_to_numpy(port))
    shapes = zamba.cache_shapes(ct, 2, 8)
    for part in ("ssm", "kv"):
        for name, arr in state[part].items():
            assert (len(shapes[part]), *shapes[part][0][name][0]) == \
                arr.shape, (part, name)


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
    for m, srv, params in ((jmodes, JaxServer, pj), (None, Server, pt)):
        plan_cls = m.ExecutionPlan if m else ExecutionPlan
        layer_cls = m.LayerPlan if m else LayerPlan
        mode = m.ExecutionMode if m else ExecutionMode
        hetero = plan_cls(
            default=layer_cls(mode.SIDEBAR),
            layers={0: layer_cls(mode.SIDEBAR_PIPELINED, depth=4)})
        kw = {} if m else {"device": "cpu"}
        with pytest.raises(ValueError, match="heterogeneous"):
            srv(cj if m else ct, params, plan=hetero, **kw)
    for cls, kw in ((ContinuousBatchingServer, {}),
                    (PagedContinuousBatchingServer, {"block_size": 8})):
        with pytest.raises(ValueError, match="continuous batching"):
            cls(ct, pt, device="cpu", num_slots=1, max_len=32, **kw)
    with pytest.raises(ValueError, match="whole prompt"):
        zamba.prefill(pt, ct, {"tokens": torch.from_numpy(prompts)},
                      zamba.init_cache(ct, 1, 32, device="cpu"),
                      block_tables=torch.zeros((1, 4), dtype=torch.int32))
    assert get_model(ct).rowwise_decode_pos is False
