"""The port's kernel modules against the JAX package's.

On the CPU every wrapper takes its plain PyTorch version; these tests
hold those plain versions to the jnp references and to the Pallas
kernels run in interpret mode, on inputs made from a seed with numpy.
Tolerances: fp32 throughout, 2e-5 absolute and relative — the two
frameworks sum the contractions in different orders.

The CUDA kernels themselves run only on the card, where there is no JAX:
their tests are in ``test_torch_isolation.py``.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.function_table import make_default_table as jax_table
from repro.kernels import ref as jref
from repro.launch import kvpool as jkvp
from repro_torch.core import function_table as ft
from repro_torch.core.modes import ExecutionMode
from repro_torch.kernels import ops as kops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import sidebar_mlp as sm

# the modules, not the functions of the same name repro.kernels exports
jpa = importlib.import_module("repro.kernels.paged_attention")
jmlp = importlib.import_module("repro.kernels.sidebar_mlp")

TOL = dict(rtol=2e-5, atol=2e-5)
ELEMENTWISE = [n for n in ft.DEFAULT_TABLE.names()
               if not ft.DEFAULT_TABLE[n].rowwise]


def test_function_table_mirrors_jax():
    """Same names and rowwise flags as make_default_table; every default
    entry has a distinct kernel-side id (csrc/activation.cuh): 0-12 for
    the elementwise entries, 13 and 14 for the rowwise softmax and
    rmsnorm, which only the standalone activation kernel takes."""
    jt, tt = jax_table(), ft.make_default_table()
    assert tt.names() == jt.names()
    for n in jt.names():
        assert tt[n].rowwise == jt[n].rowwise, n
        assert tt[n].device_id is not None, n
        assert (tt[n].device_id >= 13) == tt[n].rowwise, n
    ids = [tt[n].device_id for n in tt.names()]
    assert sorted(ids) == list(range(15))


@pytest.mark.parametrize("name", ft.DEFAULT_TABLE.names())
def test_function_table_entry_matches_jax(name):
    x = np.random.RandomState(0).randn(4, 32).astype(np.float32) * 3
    want = np.asarray(jax_table().lookup(name)(jnp.asarray(x)))
    got = ft.DEFAULT_TABLE.lookup(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _mlp_problem(seed, m=16, d=128, f=256):
    rng = np.random.RandomState(seed)
    x = rng.randn(m, d).astype(np.float32)
    w1 = (rng.randn(d, f) / np.sqrt(d)).astype(np.float32)
    w2 = (rng.randn(f, d) / np.sqrt(f)).astype(np.float32)
    return x, w1, w2


@pytest.mark.parametrize("act", ELEMENTWISE)
def test_sidebar_mlp_plain_matches_jax_ref_and_pallas(act):
    x, w1, w2 = _mlp_problem(1)
    got = sm.sidebar_mlp(*(torch.from_numpy(a) for a in (x, w1, w2)), act)
    jx = [jnp.asarray(a) for a in (x, w1, w2)]
    ref = np.asarray(jref.sidebar_mlp_ref(*jx, act))
    pallas = np.asarray(jmlp.sidebar_mlp(*jx, act, interpret=True))
    assert got.dtype == torch.float32 and got.shape == (16, 128)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    np.testing.assert_allclose(got.numpy(), pallas, **TOL)


@pytest.mark.parametrize("m", [1, 3, 130])
def test_sidebar_mlp_plain_any_row_count(m):
    """No TPU tile rule: ragged row counts take the same path."""
    x, w1, w2 = _mlp_problem(2, m=m, d=64, f=256)
    got = sm.sidebar_mlp(*(torch.from_numpy(a) for a in (x, w1, w2)),
                         "squared_relu")
    ref = jref.sidebar_mlp_ref(*(jnp.asarray(a) for a in (x, w1, w2)),
                               "squared_relu")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_sidebar_mlp_rounds_act_to_w2_dtype():
    """f(h) is cast to w2's type before the second product (ref.py:36):
    bf16 weights give the jnp reference's result to bf16 rounding."""
    x, w1, w2 = _mlp_problem(3, m=8, d=64, f=128)
    tx, t1, t2 = (torch.from_numpy(a).bfloat16() for a in (x, w1, w2))
    got = sm.sidebar_mlp(tx, t1, t2, "squared_relu")
    jx = [jnp.asarray(a, jnp.bfloat16) for a in (x, w1, w2)]
    ref = np.asarray(jref.sidebar_mlp_ref(*jx, "squared_relu"), np.float32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2e-2,
                               atol=2e-2)


def test_sidebar_mlp_shape_mismatch_raises():
    x, w1, w2 = (torch.zeros(s) for s in ((4, 8), (9, 16), (16, 8)))
    with pytest.raises(ValueError, match="shape"):
        sm.sidebar_mlp(x, w1, w2)


def _unaligned(shape, dtype):
    """A contiguous view whose data sits 2 bytes past a 16-byte
    boundary."""
    n = int(np.prod(shape))
    base = torch.zeros(n + 8, dtype=dtype)
    return base[1:n + 1].view(shape)


# (case, dims (D, F, D2), dtype, unaligned x, expected route)
ROUTE_CASES = [
    ("fp32", (64, 128, 64), torch.float32, False, "fma"),
    ("bf16", (64, 128, 64), torch.bfloat16, False, "tc"),
    ("bf16-ragged-d", (100, 128, 64), torch.bfloat16, False, "fma"),
    ("bf16-ragged-f", (64, 260, 64), torch.bfloat16, False, "fma"),
    ("bf16-ragged-d2", (64, 128, 68), torch.bfloat16, False, "fma"),
    ("bf16-unaligned", (64, 128, 64), torch.bfloat16, True, "fma"),
]


@pytest.mark.parametrize("wrapper", ["sidebar_mlp", "sidebar_mlp_pipelined",
                                     "sidebar_gated_mlp"])
@pytest.mark.parametrize("case", ROUTE_CASES, ids=lambda c: c[0])
def test_mlp_route_rule(wrapper, case):
    """One route rule (``sidebar_mlp.route``, a pure function of dtype,
    widths and alignment) for all three MLP wrappers: bf16 operands with
    D, F and D2 multiples of 8 at 16-byte aligned addresses take the
    tensor cores ("tc"); fp32, and bf16 of ragged widths or at an
    unaligned address, the FMA body ("fma"). No case raises: on the CPU
    every wrapper computes its plain version, within 2e-2 of the fp32
    one for bf16."""
    from repro_torch.kernels import sidebar_gated_mlp as sg

    _, (d, f, d2), dtype, unaligned, want = case
    rng = np.random.RandomState(31)
    x = torch.from_numpy(rng.randn(3, d).astype(np.float32)).to(dtype)
    if unaligned:
        x = _unaligned((3, d), dtype).copy_(x)
        assert x.data_ptr() % 16 and x.is_contiguous()
    w = [torch.from_numpy((rng.randn(*s) / np.sqrt(s[0])).astype(
        np.float32)).to(dtype) for s in ((d, f), (d, f), (f, d2))]
    if wrapper == "sidebar_gated_mlp":
        ops = (x, *w)
        got = sg.sidebar_gated_mlp(*ops, "silu")
        ref = sg.sidebar_gated_mlp_plain(*(t.float() for t in ops), "silu")
    else:
        ops = (x, w[0], w[2])
        got = getattr(sm, wrapper)(*ops, "squared_relu")
        ref = sm.sidebar_mlp_plain(*(t.float() for t in ops),
                                   "squared_relu")
    assert sm.route(*ops) == want
    assert got.shape == (3, d2) and got.dtype == dtype
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    np.testing.assert_allclose(got.float().numpy(), ref.numpy(), rtol=tol,
                               atol=tol)


def _pool_problem(seed=0, *, quantized=False):
    """test_paged_kernel.py's problem: duplicate table entries, a
    scratch-padded tail row, ragged lengths."""
    rng = np.random.RandomState(seed)
    P, Hkv, bs, Dh, B, nb, group = 9, 2, 8, 16, 3, 4, 4
    q = rng.randn(B, Hkv * group, Dh).astype(np.float32)
    tables = rng.randint(1, P, size=(B, nb)).astype(np.int32)
    tables[0, 1:] = jkvp.SCRATCH_BLOCK
    tables[1, 2] = tables[1, 1]
    lengths = np.array([5, bs * 2, bs * nb], np.int32)
    if quantized:
        k = rng.randint(-127, 128, (P, Hkv, bs, Dh)).astype(np.int8)
        v = rng.randint(-127, 128, (P, Hkv, bs, Dh)).astype(np.int8)
        ks = ((rng.rand(P, Hkv, bs) + .5) / 127).astype(np.float32)
        vs = ((rng.rand(P, Hkv, bs) + .5) / 127).astype(np.float32)
    else:
        k = rng.randn(P, Hkv, bs, Dh).astype(np.float32)
        v = rng.randn(P, Hkv, bs, Dh).astype(np.float32)
        ks = vs = None
    return q, k, v, ks, vs, tables, lengths, Dh ** -0.5


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_paged_gqa_plain_matches_jax_ref_and_pallas(quantized):
    q, k, v, ks, vs, tables, lengths, scale = _pool_problem(
        1, quantized=quantized)
    got = pa.paged_gqa(*(_t(a) for a in (q, k, v, tables, lengths)),
                       scale=scale, k_scale=_t(ks), v_scale=_t(vs))
    args = [_j(a) for a in (q, k, v, tables, lengths)]
    ref = jpa.paged_gqa_reference(*args, scale=scale, k_scale=_j(ks),
                                  v_scale=_j(vs))
    pallas = jpa.paged_gqa_kernel(*args, scale=scale, k_scale=_j(ks),
                                  v_scale=_j(vs), interpret=True)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)


def test_paged_gqa_plain_ignores_masked_tail():
    """Junk behind the mask and extra table width change no bit: masked
    logits are -1e30 and underflow to exactly 0 in fp32, and the plain
    version sums in a fixed order."""
    q, k, v, _, _, tables, lengths, scale = _pool_problem(2)
    lengths = np.minimum(lengths, 16)
    base = pa.paged_gqa(_t(q), _t(k), _t(v), _t(tables[:, :2].copy()),
                        _t(lengths), scale=scale)
    # two extra pool rows of junk, named only past each row's length
    p = k.shape[0]
    k2 = np.concatenate([k, np.full_like(k[:2], 1e3)])
    v2 = np.concatenate([v, np.full_like(v[:2], -1e3)])
    wide_tables = np.concatenate(
        [tables[:, :2], np.tile([[p, p + 1]], (3, 1))], axis=1
    ).astype(np.int32)
    wide = pa.paged_gqa(_t(q), _t(k2), _t(v2), _t(wide_tables),
                        _t(lengths), scale=scale)
    assert torch.equal(base, wide)


def test_ops_record_plain_route_on_cpu():
    q, k, v, _, _, tables, lengths, scale = _pool_problem(3)
    x, w1, w2 = _mlp_problem(4, m=4, d=64, f=128)
    recs = []
    with kops.record_dispatches(recs):
        kops.paged_attention_gqa(_t(q), _t(k), _t(v), _t(tables),
                                 _t(lengths), scale=scale)
        kops.sidebar_mlp(_t(x), _t(w1), _t(w2), "relu")
    assert [(r.op, r.variant, r.used_kernel) for r in recs] == [
        ("paged_attention", "ref", False), ("sidebar_mlp", "ref", False)]
    assert kops.launch_counts() == {
        "sidebar_mlp": 0, "paged_gqa": 0, "sidebar_mlp_pipelined": 0,
        "sidebar_matmul": 0, "activation": 0, "sidebar_gated_mlp": 0,
        "paged_mla": 0, "flash_attention": 0, "moe_grouped_mm": 0}


@pytest.mark.parametrize("mode", [ExecutionMode.SIDEBAR_PIPELINED,
                                  ExecutionMode.FLEXIBLE_DMA])
def test_unported_plans_raise(mode):
    """Both plans that raised before their kernels were ported now route:
    the ring kernel's plain version at the plan's depth, or the DMA
    three-step route, each the serial op's function bit for bit on the
    CPU, and each recorded as planned."""
    x, w1, w2 = _mlp_problem(5, m=4, d=64, f=128)
    recs = []
    with kops.execution_plan(mode), kops.record_dispatches(recs):
        got = kops.sidebar_mlp(_t(x), _t(w1), _t(w2), "relu")
    want = sm.sidebar_mlp(_t(x), _t(w1), _t(w2), "relu")
    assert torch.equal(got, want)
    variant, depth = (("ref", 2) if mode is ExecutionMode.SIDEBAR_PIPELINED
                      else ("dma", 1))
    assert [(r.op, r.mode, r.variant, r.depth, r.used_kernel)
            for r in recs] == [("sidebar_mlp", mode, variant, depth, False)]


def test_monolithic_plan_routes_like_sidebar():
    x, w1, w2 = _mlp_problem(6, m=4, d=64, f=128)
    with kops.execution_plan(ExecutionMode.MONOLITHIC):
        got = kops.sidebar_mlp(_t(x), _t(w1), _t(w2), "relu")
    want = sm.sidebar_mlp(_t(x), _t(w1), _t(w2), "relu")
    assert torch.equal(got, want)
