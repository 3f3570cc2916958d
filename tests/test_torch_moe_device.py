"""The MoE expert pass on the device (``models/moe.py``): no host read,
every shape fixed by the token count, JAX's semantics.

On the CPU:

  * ``moe()`` of deepseek-v3 and llama4-scout (smoke configs, dropping
    and no-drop capacity, plain and kernel forms of the expert pass)
    runs with ``Tensor.cpu``, ``.item``, ``.tolist``, ``.numpy`` and the
    scalar conversions patched to raise;
  * the ops it runs and the shapes they make are the same for two inputs
    of one token count that route differently;
  * the plain form (JAX's) and the kernel form give the same sum, bit
    for bit;
  * its outputs equal the JAX ``moe``'s (host path) to 1e-5, capacity
    drops included; a token's output is its own row's alone or in a
    batch, bit for bit;
  * ``grouped_mm``'s plain version against the products expert by
    expert in numpy, empty groups and rows past the groups included,
    and the pairs' order and groups.

On the card (``gpu``): a MoE decode step (llama4-scout's widths, 2
layers, bf16) captured in a CUDA graph and replayed equals the eager
step bit for bit, with the same launch counts; the plain form's bf16
products with an fp32 output have a gradient, which matches the fp32
product's.

JAX is imported inside the tests that compare with it: the card's
machine has none.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs as tcfg
from repro_torch.kernels import moe_experts as me
from repro_torch.models import moe
from repro_torch.models import transformer as T

ARCHS = ["deepseek-v3-671b", "llama4-scout-17b-a16e"]
HOST_READS = ("cpu", "item", "tolist", "numpy", "__bool__", "__int__",
              "__float__", "__index__")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cfg(arch, cf=None, kernel=False):
    ct = dataclasses.replace(tcfg.get_smoke_config(arch), use_pallas=kernel)
    return ct if cf is None else dataclasses.replace(ct, capacity_factor=cf)


def _layer(ct, seed=1):
    """The params of ``ct``'s first MoE layer (fp32, from a seed)."""
    params = T.init(ct, seed=seed, device="cpu")
    return next(p["moe"] for p in params["layers"] if "moe" in p)


@contextlib.contextmanager
def _no_host_reads(monkeypatch):
    calls = []

    def refuse(name):
        def f(self, *a, **k):
            calls.append(name)
            raise AssertionError(f"host read: Tensor.{name}")
        return f

    with monkeypatch.context() as m:
        for name in HOST_READS:
            m.setattr(torch.Tensor, name, refuse(name))
        yield calls


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("cf", [1.0, None], ids=["drop", "default"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_makes_no_host_read(monkeypatch, arch, cf, kernel):
    ct = _cfg(arch, cf, kernel)
    p = _layer(ct)
    x = _t(np.random.RandomState(2).randn(3, 7, ct.d_model).astype(
        np.float32))
    want = moe.moe(p, ct, x)
    with torch.no_grad(), _no_host_reads(monkeypatch) as calls:
        got = moe.moe(p, ct, x)
    assert not calls
    assert torch.equal(got, want)


class _Shapes(TorchDispatchMode):
    """Records (op, output shapes) of every op dispatched."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        self.seen.append((str(func), tuple(
            tuple(o.shape) for o in outs if isinstance(o, torch.Tensor))))
        return out


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("arch", ARCHS)
def test_expert_pass_shapes_depend_only_on_the_token_count(arch, kernel):
    """Two inputs of 24 tokens that route differently (and drop
    differently at capacity factor 1) make the same ops at the same
    shapes, in either form of the pass."""
    ct = _cfg(arch, 1.0, kernel)
    p = _layer(ct)
    runs, routes = [], []
    for seed in (3, 4):
        x = _t(np.random.RandomState(seed).randn(24, ct.d_model).astype(
            np.float32) * (1 + seed))
        w, ids = moe._route(x, p["router"], ct)
        routes.append(ids)
        with torch.no_grad(), _Shapes() as rec:
            moe._local_expert_pass(x, w, ids, p["w_gate"], p["w_up"],
                                   p["w_down"], ct, torch.nn.functional.silu)
        runs.append(rec.seen)
    assert not torch.equal(routes[0], routes[1])
    assert runs[0] == runs[1]


@pytest.mark.parametrize("cf", [1.0, 8.0], ids=["drop", "nodrop"])
@pytest.mark.parametrize("arch", ARCHS)
def test_plain_and_kernel_forms_agree_bit_for_bit(arch, cf):
    """The plain form (JAX's: every expert on its top-``cap`` tokens)
    and the kernel form (the kept pairs grouped by expert) give the same
    routed sum bit for bit: the same products a row, the same fixed
    order of the sum."""
    ct = _cfg(arch, cf)
    p = _layer(ct, seed=7)
    x = _t(np.random.RandomState(8).randn(40, ct.d_model).astype(
        np.float32))
    w, ids = moe._route(x, p["router"], ct)
    got = {}
    for kernel in (False, True):
        got[kernel] = moe._local_expert_pass(
            x, w, ids, p["w_gate"], p["w_up"], p["w_down"],
            dataclasses.replace(ct, use_pallas=kernel),
            torch.nn.functional.silu)
    assert torch.equal(got[False], got[True])


@pytest.fixture
def jx():
    return pytest.importorskip("jax")


@pytest.mark.parametrize("cf", [1.0, 8.0], ids=["drop", "nodrop"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_matches_jax(jx, arch, cf):
    from repro import configs as jcfg
    from repro.core.function_table import DEFAULT_TABLE as JTABLE
    from repro.models import layers as jL
    from repro.models import moe as jmoe
    from repro_torch import bridge

    cj = dataclasses.replace(jcfg.get_smoke_config(arch), capacity_factor=cf)
    ct = _cfg(arch, cf)
    pj = jL.materialize(jx.random.PRNGKey(7),
                        jmoe.moe_param_specs(cj, jL.HOST))
    pt = bridge._layer(jx.tree.map(lambda a: np.asarray(a)[None], pj), 0,
                       "cpu")
    x = np.random.RandomState(8).randn(4, 8, ct.d_model).astype(np.float32)
    want = jmoe.moe(pj, cj, jx.numpy.asarray(x), table=JTABLE,
                    minfo=jL.HOST, mesh=None)
    got = moe.moe(pt, ct, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    w, ids = moe._route(_t(x.reshape(32, -1)), pt["router"], ct)
    _, _, kept = moe._pairs(w, ids, moe._capacity(32, ct), ct.num_experts)
    # 32 tokens at factor 1: some expert gets more than its capacity
    assert bool(kept.all()) == (cf == 8.0)


def test_moe_row_result_does_not_depend_on_the_batch():
    """llama4-scout's (top-1, a shared expert); deepseek-v3's is held in
    ``tests/test_torch_mla_moe.py``."""
    ct = _cfg("llama4-scout-17b-a16e", 8.0)
    p = _layer(ct)
    x = _t(np.random.RandomState(9).randn(1, 6, ct.d_model).astype(
        np.float32))
    whole = moe.moe(p, ct, x)
    for i in range(6):
        assert torch.equal(moe.moe(p, ct, x[:, i:i + 1]), whole[:, i:i + 1])


def test_grouped_mm_plain_is_each_rows_expert_product():
    rng = np.random.RandomState(10)
    e, k, n, rows = 5, 24, 40, 13
    a = rng.randn(rows, k).astype(np.float32)
    w = rng.randn(e, k, n).astype(np.float32)
    counts = [3, 0, 4, 1, 0]                   # 8 grouped, 5 past them
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    got = me.grouped_mm(_t(a), _t(w), _t(offsets))
    assert torch.equal(got, me.grouped_mm_plain(_t(a), _t(w), _t(offsets)))
    for j in range(e):
        s, t = offsets[j], offsets[j + 1]
        np.testing.assert_allclose(got[s:t].numpy(), a[s:t] @ w[j],
                                   rtol=1e-5, atol=1e-5)
    assert not got[offsets[-1]:].any()
    assert me.group_of_rows(_t(offsets), rows).tolist() == [
        0, 0, 0, 2, 2, 2, 2, 3, 5, 5, 5, 5, 5]
    with pytest.raises(ValueError):
        me.grouped_mm(_t(a), _t(w), _t(offsets[:-1]))
    with pytest.raises(ValueError):
        me.grouped_mm(_t(a), _t(w), _t(offsets.astype(np.int64)))


def test_route_rule():
    bf = torch.zeros(4, 64, dtype=torch.bfloat16)
    wb = torch.zeros(2, 64, 32, dtype=torch.bfloat16)
    assert me.route(bf, wb) == "tc"
    assert me.route(bf.float(), wb.float()) == "fma"
    assert me.route(torch.zeros(4, 60, dtype=torch.bfloat16),
                    torch.zeros(2, 60, 32, dtype=torch.bfloat16)) == "fma"
    assert me.route(bf, torch.zeros(2, 64, 36, dtype=torch.bfloat16)) == "fma"


def test_pairs_group_by_expert_with_drops_last():
    """Top-2 of 4 experts over 6 tokens, capacity 2: expert 0 is every
    token's first choice, so 4 of its pairs drop, the lower weights
    first."""
    ids = _t(np.array([[0, 1], [0, 2], [0, 3], [0, 1], [0, 2], [0, 3]]))
    w = _t(np.array([[.9, .1], [.8, .2], [.7, .3], [.95, .05], [.6, .4],
                     [.85, .15]], np.float32))
    order, offsets, kept = moe._pairs(w, ids, 2, 4)
    assert kept[:, 0].tolist() == [True, False, False, True, False, False]
    assert kept[:, 1].all()
    assert offsets.tolist() == [0, 2, 4, 6, 8]
    key = torch.where(kept, ids, 4).reshape(-1)[order]
    assert key.tolist() == [0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 4, 4]
    # stable: within an expert, pairs in token order
    assert (order[:2] // 2).tolist() == [0, 3]


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_moe_decode_step_captured_equals_eager():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: capture runs only on the card")
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import graphs

    cfg = dataclasses.replace(tcfg.get_config("llama4-scout-17b-a16e"),
                              num_layers=2, use_pallas=True)
    params = T.init(cfg, seed=0, device="cuda")
    cache = T.init_cache(cfg, 4, 64, device="cuda")
    toks = torch.from_numpy(np.random.RandomState(11).randint(
        0, cfg.vocab_size, (4, 16))).cuda()
    with torch.no_grad():
        T.prefill(params, cfg, {"tokens": toks}, cache)

    def step(fixed, tok, pos):
        p, c = fixed
        logits, _ = T.decode_step(p, cfg, tok, c, pos)
        return logits

    tok = toks[:, -1:].clone()
    pos = torch.full((4,), 16, dtype=torch.int64, device="cuda")
    prog = graphs.Program(step, device=torch.device("cuda"))
    outs, counts = [], []
    with torch.no_grad():
        for ctx in (graphs.disable_capture, contextlib.nullcontext,
                    contextlib.nullcontext):
            kops.reset_launch_counts()
            with ctx():
                outs.append(prog((params, cache), tok=tok, pos=pos))
            torch.cuda.synchronize()
            counts.append(kops.launch_counts())
    assert (prog.captures, prog.replays) == (1, 1)
    assert counts[0]["moe_grouped_mm"] == 3 * cfg.num_layers
    for out, c in zip(outs[1:], counts[1:]):
        assert torch.equal(out, outs[0]) and c == counts[0]


@pytest.mark.gpu
def test_plain_form_bf16_products_have_a_gradient():
    """``moe._dot32`` on bf16 operands (one GEMM with an fp32 output,
    2-D and batched) gives the fp32 product's value and gradients to
    bf16's precision."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fp32-out GEMM is the card's")
    g = torch.Generator(device="cuda").manual_seed(0)
    for shape_a, shape_b in (((8, 64), (64, 32)), ((3, 8, 64), (3, 64, 32))):
        a = torch.randn(shape_a, device="cuda", generator=g).bfloat16()
        b = torch.randn(shape_b, device="cuda", generator=g).bfloat16()
        ct = torch.randn(*shape_a[:-1], 32, device="cuda", generator=g)
        grads = []
        for f in (moe._dot32, lambda x, y: x.float() @ y.float()):
            x, y = a.clone().requires_grad_(), b.clone().requires_grad_()
            out = f(x, y)
            assert out.dtype == torch.float32
            (out * ct).sum().backward()
            grads.append((out.detach(), x.grad.float(), y.grad.float()))
        for got, want in zip(*grads):
            torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-1)
