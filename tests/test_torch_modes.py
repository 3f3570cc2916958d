"""The paper's execution modes in the port, held to the JAX package.

On the CPU every kernel wrapper takes its plain version. Across
frameworks, on inputs made from a seed with numpy (fp32, 2e-5 absolute
and relative — the frameworks sum contractions in different orders):

  * ``sidebar_matmul``'s and the activation's plain versions against the
    jnp references and the Pallas kernels in interpret mode;
  * the ring route (``SIDEBAR_PIPELINED``) at depths 1-4 against the
    Pallas ``sidebar_mlp_pipelined``, and the ``FLEXIBLE_DMA`` route
    against the JAX op under the same plan;
  * the JAX package's own per-layer plans (``test_paged_kernel.py``'s
    layer-1 ``FLEXIBLE_DMA`` plan, ``test_serving_scan.py``'s depths 2
    and 3) served by both frameworks' paged servers on bridged weights
    with ``use_pallas=True``: identical greedy streams.

Inside the port, bit-exact on the CPU: paged == slab == solo under those
plans, and every plan gives the tokens of ``SIDEBAR``.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.core import modes as jmodes
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.launch.scheduler import PagedContinuousBatchingServer as JaxServer
from repro.models.registry import get_model as jget
from repro_torch import bridge
from repro_torch import configs as tcfg
from repro_torch.core.function_table import DEFAULT_TABLE
from repro_torch.core.modes import ExecutionMode, ExecutionPlan, LayerPlan
from repro_torch.kernels import activations as ak
from repro_torch.kernels import ops as kops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import sidebar_matmul as smm
from repro_torch.kernels import sidebar_mlp as sm
from repro_torch.launch.scheduler import PagedContinuousBatchingServer
from repro_torch.launch.serve import generate

# the modules, not the functions of the same name repro.kernels exports
jmm = importlib.import_module("repro.kernels.sidebar_matmul")
jact = importlib.import_module("repro.kernels.activations")
jmlp = importlib.import_module("repro.kernels.sidebar_mlp")

TOL = dict(rtol=2e-5, atol=2e-5)
PIPELINED = ExecutionMode.SIDEBAR_PIPELINED
DMA = ExecutionMode.FLEXIBLE_DMA


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _mlp_problem(seed, m=16, d=128, f=512):
    rng = np.random.RandomState(seed)
    return (rng.randn(m, d).astype(np.float32),
            (rng.randn(d, f) / np.sqrt(d)).astype(np.float32),
            (rng.randn(f, d) / np.sqrt(f)).astype(np.float32))


# ---------------------------------------------------------------------------
# Kernel modules against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("act", ["identity", "relu", "squared_relu", "gelu",
                                 "sigmoid", "exp_decay"])
def test_sidebar_matmul_plain_matches_jax_ref_and_pallas(act):
    rng = np.random.RandomState(1)
    a = rng.randn(16, 256).astype(np.float32)
    b = (rng.randn(256, 384) / 16).astype(np.float32)
    got = smm.sidebar_matmul(_t(a), _t(b), act)
    ref = np.asarray(jref.sidebar_matmul_ref(jnp.asarray(a), jnp.asarray(b),
                                             act))
    pallas = np.asarray(jmm.sidebar_matmul(jnp.asarray(a), jnp.asarray(b),
                                           act, interpret=True))
    assert got.dtype == torch.float32 and got.shape == (16, 384)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    np.testing.assert_allclose(got.numpy(), pallas, **TOL)


def test_sidebar_matmul_rounds_once_to_a_dtype():
    """bf16 operands: fp32 product, the epilogue on it, one cast."""
    rng = np.random.RandomState(2)
    a, b = rng.randn(8, 64), rng.randn(64, 128) / 8
    got = smm.sidebar_matmul(_t(a).bfloat16(), _t(b).bfloat16(), "gelu")
    ref = jref.sidebar_matmul_ref(jnp.asarray(a, jnp.bfloat16),
                                  jnp.asarray(b, jnp.bfloat16), "gelu")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("m,k,n,act,want", [
    (4, 6144, 24576, "identity", 3072),     # producer at decode: 2 splits
    (4, 24576, 6144, "identity", 4096),     # consumer at decode: 6 splits
    (64, 24576, 6144, "identity", 12288),
    (4, 24576, 6144, "relu", 24576),        # never split under f != id
    (3, 100, 130, "identity", 64),
])
def test_matmul_k_range_splits_only_the_identity(m, k, n, act, want):
    assert smm.k_range(m, k, n, act == "identity") == want


@pytest.mark.parametrize("act", DEFAULT_TABLE.names())
def test_activation_plain_matches_jax_ref_and_pallas(act):
    """Every table entry, the rowwise softmax and rmsnorm included."""
    x = (np.random.RandomState(3).randn(8, 256) * 3).astype(np.float32)
    got = ak.activation_2d(_t(x), act)
    ref = np.asarray(jref.activation_ref(jnp.asarray(x), act))
    pallas = np.asarray(jact.activation_2d(jnp.asarray(x), act,
                                           interpret=True))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-5, atol=1e-6)


def test_activation_flattens_leading_dims():
    x = np.random.RandomState(4).randn(2, 3, 40).astype(np.float32)
    got = ak.activation(_t(x), "softmax")
    ref = jact.activation(jnp.asarray(x), "softmax", interpret=True)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_pipelined_route_matches_pallas_ring(depth):
    """The ring route at the plan's depth against the Pallas ring kernel
    (four 128-column F blocks, so every depth has a ring to fill)."""
    x, w1, w2 = _mlp_problem(5)
    with kops.execution_plan(LayerPlan(PIPELINED, depth)):
        got = kops.sidebar_mlp(_t(x), _t(w1), _t(w2), "squared_relu")
    pallas = jmlp.sidebar_mlp_pipelined(
        *(jnp.asarray(a) for a in (x, w1, w2)), "squared_relu",
        block_f=128, depth=depth, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    direct = sm.sidebar_mlp_pipelined(_t(x), _t(w1), _t(w2), "squared_relu",
                                      depth=depth)
    assert torch.equal(got, direct)


def test_dma_route_matches_jax_op_under_the_same_plan():
    x, w1, w2 = _mlp_problem(6)
    recs = []
    with kops.execution_plan(DMA), kops.record_dispatches(recs):
        got = kops.sidebar_mlp(_t(x), _t(w1), _t(w2), "squared_relu")
    jrecs = []
    with jops.execution_plan(jmodes.ExecutionMode.FLEXIBLE_DMA), \
            jops.record_dispatches(jrecs):
        want = jops.sidebar_mlp(*(jnp.asarray(a) for a in (x, w1, w2)),
                                "squared_relu", interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert [(r.variant, r.depth) for r in recs] == \
        [(r.variant, r.depth) for r in jrecs] == [("dma", 1)]


def test_dma_route_keeps_the_jax_rounding_points():
    """bf16: h and f(h) are rounded to x's type between the launches,
    as the JAX route does — a different function from the fused one,
    which keeps h in fp32."""
    x, w1, w2 = (a.astype(np.float32) for a in _mlp_problem(7, m=8, d=64,
                                                            f=128))
    bx, b1, b2 = (_t(a).bfloat16() for a in (x, w1, w2))
    with kops.execution_plan(DMA):
        got = kops.sidebar_mlp(bx, b1, b2, "squared_relu")
    with jops.execution_plan(jmodes.ExecutionMode.FLEXIBLE_DMA):
        want = jops.sidebar_mlp(*(jnp.asarray(a, jnp.bfloat16)
                                  for a in (x, w1, w2)), "squared_relu")
    h = smm.sidebar_matmul(bx, b1)
    manual = smm.sidebar_matmul(ak.activation_2d(h, "squared_relu"), b2)
    assert torch.equal(got, manual)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)


def test_pipelined_partition_ignores_depth():
    """The ring kernel's F partition depends on M and F only (what keeps
    its output bitwise equal across depths); the ring is capped at the
    sub-tiles a cluster (tc route) or block (fma route) owns (the tc
    launch caps it again at the slots its shared memory holds)."""
    # tc: 33 clusters of 4 blocks at decode (256-column sub-tiles), 8 of
    # 8 blocks for each of two 32-row panels at 64 rows (512 columns)
    assert sm.f_range_pipelined(4, 24576) == 768       # 3 sub-tiles
    assert sm.f_range_pipelined(64, 24576) == 3072     # 6 sub-tiles
    assert sm.f_range_pipelined(1, 100) == 256
    assert [sm.ring_slots(4, 24576, t) for t in (1, 2, 4, 9)] == [1, 2, 3, 3]
    assert [sm.ring_slots(16, 24576, t) for t in (1, 4, 7)] == [1, 3, 3]
    assert [sm.ring_slots(64, 24576, t) for t in (1, 4, 7)] == [1, 4, 6]
    # fma (plain FMA): 64-column sub-tiles, at least 4 a block
    assert sm.f_range_fma(4, 24576) == 256
    assert sm.f_range_fma(64, 24576) == 384
    assert sm.f_range_fma(1, 100) == 256
    assert [sm.ring_slots(4, 24576, t, "fma") for t in (1, 2, 4, 9)] == [
        1, 2, 4, 4]
    with pytest.raises(ValueError, match="depth"):
        sm.ring_slots(4, 24576, 0)


@pytest.mark.parametrize("m", [1, 4, 8, 9, 16, 17, 64, 130])
def test_pipelined_cluster_split(m):
    """The tc route's panels (8 token rows at decode, 16, 32 above 16 on
    clusters of 8), its clusters (one block per SM of 132 while the
    panels allow), whole sub-tiles of 64 columns a block, and the depth
    asked of the kernel at most the sub-tiles a cluster owns; no card
    needed."""
    f = 24576
    n, c = sm.tokens_per_panel(m), sm.cluster_size(m)
    assert n == (8 if m <= 8 else 16 if m <= 16 else 32)
    assert c == (8 if n == 32 else 4) and sm.subtile_f(m) == c * 64
    panels = -(-m // n)
    fr = sm.f_range_pipelined(m, f)
    clusters = panels * -(-f // fr)
    assert fr % sm.subtile_f(m) == 0
    assert clusters * c <= max(132, panels * c)
    if m <= 16:
        assert clusters * c == 128       # 32 clusters of 4
    if m == 64:
        assert clusters * c == 128       # 2 panels x 8 clusters of 8
    for depth in (1, 2, 3, 4, 9):
        assert sm.ring_slots(m, f, depth) == min(depth,
                                                 fr // sm.subtile_f(m))


@pytest.mark.parametrize("route", ["tc", "fma"])
@pytest.mark.parametrize("m", [1, 4, 8, 9, 16, 17, 64, 130, 4096])
def test_serial_partition_is_the_rings_at_depth_1(m, route):
    """The serial kernel (``sidebar_mlp``) is the ring with one f(h) slot
    on the ring's partition: panel rows, cluster size, F range and splits
    equal ``sidebar_mlp_pipelined``'s at depth 1 (and at every depth but
    for the slots), which makes its output the ring's, bit for bit, at
    every depth."""
    f = 24576
    serial = sm.serial_plan(m, f, route)
    assert serial == sm.ring_plan(m, f, 1, route)
    assert serial.slots == 1 and serial.route == route
    for depth in (2, 4, 9):
        ring = sm.ring_plan(m, f, depth, route)
        assert dataclasses.replace(ring, slots=1) == serial
    if route == "tc":
        assert serial.panel_rows == sm.tokens_per_panel(m)
        assert serial.cluster_size == sm.cluster_size(m)
        assert serial.f_range == sm.f_range_pipelined(m, f)
        assert serial.f_range % sm.subtile_f(m) == 0
    else:
        assert (serial.panel_rows, serial.cluster_size) == (16, 1)
        assert serial.f_range == sm.f_range_fma(m, f)
        assert serial.f_range % 64 == 0
    assert serial.splits == -(-f // serial.f_range)
    if (m, route) == (4096, "tc"):
        # the training forward: 128 panels of 32 rows, one cluster of 8
        # each, every panel walking all of F
        assert (serial.panel_rows, serial.cluster_size,
                serial.splits) == (32, 8, 1)


def test_pipelined_eligibility_rule():
    """The ring's route rule: bf16 operands with D, F and D2 multiples of
    8 at 16-byte aligned addresses take the tensor cores ("tc"), of any
    width (a D2 past what the consumers' registers hold is walked in
    passes); fp32, and bf16 of ragged widths or unaligned, take the FMA
    body ("fma"). Nothing raises: every shape computes."""
    def ops(d, f, d2, dtype=torch.bfloat16):
        return (torch.zeros(4, d, dtype=dtype), torch.zeros(d, f, dtype=dtype),
                torch.zeros(f, d2, dtype=dtype))

    assert sm.route(*ops(6144, 24576, 6144)) == "tc"
    assert sm.route(*ops(96, 200, 64)) == "tc"
    assert sm.route(*ops(96, 200, 12352)) == "tc"
    assert sm.route(*ops(7, 13, 6200, torch.float32)) == "fma"
    assert sm.route(*ops(96, 200, 64, torch.float32)) == "fma"
    for ragged in ((100, 200, 64), (96, 201, 64), (96, 200, 68),
                   (96, 200, 6156)):
        x, w1, w2 = ops(*ragged)
        assert sm.route(x, w1, w2) == "fma"
        out = sm.sidebar_mlp_pipelined(x, w1, w2, "squared_relu")
        assert out.shape == (4, ragged[2])


def test_gather_route_equals_the_plain_paged_version():
    """FLEXIBLE_DMA decode attention (gather + dense math, recorded
    "dma") equals the paged route bit for bit on the CPU and the JAX op
    under the same plan to 2e-5, fp and int8."""
    rng = np.random.RandomState(8)
    P, Hkv, bs, Dh, B, nb, G = 9, 2, 8, 16, 3, 4, 4
    tables = _t(rng.randint(1, P, size=(B, nb)).astype(np.int32))
    lengths = _t(np.array([5, 16, 32], np.int32))
    q = _t(rng.randn(B, Hkv * G, Dh).astype(np.float32))
    k, v = (_t(rng.randn(P, Hkv, bs, Dh).astype(np.float32))
            for _ in range(2))
    for scales in (None, tuple(_t(((rng.rand(P, Hkv, bs) + .5) / 127
                                   ).astype(np.float32)) for _ in range(2))):
        kk, vv = (k, v) if scales is None else (
            _t(rng.randint(-127, 128, (P, Hkv, bs, Dh)).astype(np.int8)),
            _t(rng.randint(-127, 128, (P, Hkv, bs, Dh)).astype(np.int8)))
        ks, vs = scales if scales is not None else (None, None)
        args = (q, kk, vv, tables, lengths)
        kw = dict(scale=0.25, k_scale=ks, v_scale=vs)
        recs, jrecs = [], []
        with kops.execution_plan(DMA), kops.record_dispatches(recs):
            a = kops.paged_attention_gqa(*args, **kw)
        b = kops.paged_attention_gqa(*args, **kw)
        assert torch.equal(a, b)
        assert torch.equal(a, pa.paged_gqa(*args, **kw))
        with jops.execution_plan(jmodes.ExecutionMode.FLEXIBLE_DMA), \
                jops.record_dispatches(jrecs):
            want = jops.paged_attention_gqa(
                *(jnp.asarray(t.numpy()) for t in args), scale=0.25,
                k_scale=None if ks is None else jnp.asarray(ks.numpy()),
                v_scale=None if vs is None else jnp.asarray(vs.numpy()))
        np.testing.assert_allclose(a.numpy(), np.asarray(want), **TOL)
        assert [r.variant for r in recs] == [r.variant for r in jrecs] \
            == ["dma"]


@pytest.mark.parametrize("spell", ["uniform", "by_index", "mixed"])
def test_execution_plan_helpers_match_jax(spell):
    def build(m):
        if spell == "uniform":
            return m.ExecutionPlan.uniform("sidebar_pipelined", 3)
        lp = [m.LayerPlan(m.ExecutionMode.SIDEBAR_PIPELINED, 2),
              m.LayerPlan(m.ExecutionMode.FLEXIBLE_DMA, 1),
              m.LayerPlan(m.ExecutionMode.SIDEBAR_PIPELINED, 2)]
        if spell == "by_index":
            return m.ExecutionPlan.by_index(lp)
        return m.ExecutionPlan(default=lp[0], layers={1: lp[1], "2": lp[0]})

    ours, theirs = build(importlib.import_module(
        "repro_torch.core.modes")), build(jmodes)

    def flat(lp):
        return (lp.mode.value, lp.depth, lp.fuse)

    assert ours.is_uniform == theirs.is_uniform
    assert flat(ours.default) == flat(theirs.default)
    for i in range(4):
        assert flat(ours.for_layer(i)) == flat(theirs.for_layer(i))
    key = ours.cache_key()
    assert hash(key) == hash(ours.cache_key())
    assert [(k, flat(v)) for k, v in key[1]] == \
        [(k, flat(v)) for k, v in theirs.cache_key()[1]]


# ---------------------------------------------------------------------------
# Plans through the paged servers
# ---------------------------------------------------------------------------

# test_paged_kernel.py:343-370: layer 1 FLEXIBLE_DMA on the nemotron smoke
# config; test_serving_scan.py:84-89: layers 0 and 1 pipelined at depths
# 2 and 3 on tileable widths, so the JAX MLP reaches its Pallas ring
PLANS = {
    "dma_layer1": lambda m: m.ExecutionPlan(
        default=m.LayerPlan(m.ExecutionMode.SIDEBAR, 2),
        layers={1: m.LayerPlan(m.ExecutionMode.FLEXIBLE_DMA, 2)}),
    "pipelined_d2_d3": lambda m: m.ExecutionPlan(
        default=m.LayerPlan(m.ExecutionMode.SIDEBAR),
        layers={0: m.LayerPlan(m.ExecutionMode.SIDEBAR_PIPELINED, depth=2),
                1: m.LayerPlan(m.ExecutionMode.SIDEBAR_PIPELINED,
                               depth=3)}),
}
WIDTHS = {"dma_layer1": {},
          "pipelined_d2_d3": dict(d_model=128, d_ff=128, num_heads=2,
                                  num_kv_heads=2)}
SERVER = dict(num_slots=3, max_len=48, block_size=8, segment=4)


@pytest.fixture(scope="module", params=list(PLANS))
def planned(request):
    name = request.param
    cj = dataclasses.replace(jcfg.get_smoke_config("nemotron-4-15b"),
                             use_pallas=True, **WIDTHS[name])
    ct = dataclasses.replace(tcfg.get_smoke_config("nemotron-4-15b"),
                             use_pallas=True, **WIDTHS[name])
    pj = jget(cj).init(jax.random.PRNGKey(0), cj)
    pt = bridge.params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    tmodes = importlib.import_module("repro_torch.core.modes")
    return name, cj, ct, pj, pt, PLANS[name](jmodes), PLANS[name](tmodes)


def _traffic(seed, vocab, n=4):
    """Prompts of 2..13 tokens; every other one opens with the same
    two-block prefix."""
    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, vocab, 16).astype(np.int32)
    out = []
    for i in range(n):
        p = rng.randint(0, vocab, rng.randint(2, 14)).astype(np.int32)
        if i % 2:
            p = np.concatenate([prefix, p[:4]])
        out.append((p, int(rng.randint(2, 7))))
    return out


def _serve(ct, pt, reqs, **kw):
    srv = PagedContinuousBatchingServer(ct, pt, device="cpu",
                                        **{**SERVER, **kw})
    recs = []
    with kops.record_dispatches(recs):
        rids = [srv.submit(p, g) for p, g in reqs]
        done = srv.run()
    assert [r.rid for r in done] == rids
    return done, recs


def test_plan_streams_match_jax_server(planned):
    _, cj, ct, pj, pt, jplan, tplan = planned
    reqs = _traffic(21, ct.vocab_size)
    js = JaxServer(cj, pj, plan=jplan, **SERVER)
    for p, g in reqs:
        js.submit(p, g)
    want = js.run()
    got, _ = _serve(ct, pt, reqs, plan=tplan)
    for a, b in zip(got, want):
        assert a.rid == b.rid and a.generated == b.generated
        np.testing.assert_array_equal(a.tokens, np.asarray(b.tokens),
                                      err_msg=f"rid {a.rid}")


def test_plan_paged_equals_slab_equals_solo_equals_sidebar(planned):
    """Bit-exact inside the port under the plan, and the plan's tokens
    are the default SIDEBAR plan's."""
    _, _, ct, _, pt, _, tplan = planned
    reqs = _traffic(22, ct.vocab_size)
    paged, _ = _serve(ct, pt, reqs, plan=tplan, kernel="paged")
    slab, _ = _serve(ct, pt, reqs, plan=tplan, kernel="slab")
    sidebar, _ = _serve(ct, pt, reqs)
    for a, b, c in zip(paged, slab, sidebar):
        prompt, gen = reqs[a.rid]
        with kops.execution_plan(tplan):
            solo = generate(ct, pt, _t(prompt)[None], gen, max_len=48,
                            device="cpu")[0, prompt.size:].numpy()
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(a.tokens, solo)
        np.testing.assert_array_equal(a.tokens, c.tokens)


def test_plan_dispatches_recorded_as_planned(planned):
    """Each MLP call records (layer, variant, depth) as planned, and every
    decode attention of a FLEXIBLE_DMA layer records "dma"."""
    name, _, ct, _, pt, _, tplan = planned
    _, recs = _serve(ct, pt, _traffic(23, ct.vocab_size), plan=tplan)
    mlp = {(r.layer, r.mode, r.variant, r.depth) for r in recs
           if r.op == "sidebar_mlp"}
    attn = {(r.layer, r.variant) for r in recs
            if r.op == "paged_attention"}
    if name == "dma_layer1":
        assert mlp == {(0, ExecutionMode.SIDEBAR, "ref", 1),
                       (1, DMA, "dma", 1)}
        assert attn == {(0, "ref"), (1, "dma")}
    else:
        assert mlp == {(0, PIPELINED, "ref", 2), (1, PIPELINED, "ref", 3)}
        assert attn == {(0, "ref"), (1, "ref")}
    assert not {"gather_blocks", "scatter_blocks"} & {r.op for r in recs}


@pytest.mark.parametrize("plan", [
    "flexible_dma", ExecutionMode.SIDEBAR_PIPELINED,
    LayerPlan(PIPELINED, 4), ExecutionPlan.uniform(DMA, 1),
    ExecutionPlan.by_index([LayerPlan(DMA, 1), LayerPlan(PIPELINED, 3)])])
def test_server_accepts_every_plan_spelling(plan):
    """Any mode name, mode, LayerPlan or ExecutionPlan, uniform or per
    layer: the server drains with the SIDEBAR plan's tokens."""
    ct = dataclasses.replace(tcfg.get_smoke_config("nemotron-4-15b"),
                             use_pallas=True)
    from repro_torch.models import transformer as T

    pt = T.init(ct, seed=3, device="cpu")
    reqs = _traffic(24, ct.vocab_size, n=3)
    got, recs = _serve(ct, pt, reqs, plan=plan)
    want, _ = _serve(ct, pt, reqs)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    assert {r.mode for r in recs if r.op == "sidebar_mlp"} <= {DMA, PIPELINED}

