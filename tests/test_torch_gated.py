"""The llama-family gated MLP in the port, held to the JAX package.

Across frameworks, on inputs made from a seed with numpy and on weights
loaded through ``repro_torch.bridge``:

  * ``sidebar_gated_mlp``'s plain version (what its wrapper and its op
    take for a CPU tensor) against the JAX op running the Pallas kernel
    in interpret mode — 3e-5 at fp32 and 2e-2 at bf16, the tolerances of
    the JAX package's own kernel tests (``tests/test_kernels.py``);
  * the deepseek-7b smoke model's prefill and decode logits (fp32, 1e-4)
    and greedy tokens, with the MLP plain and through the op;
  * the port's paged server against the JAX server: identical greedy
    streams.

Inside the port, bit-exact on the CPU: paged == slab == solo, and every
plan gives the SIDEBAR plan's tokens — the gated MLP takes its one route
(recorded "ref" on the CPU) under every plan, and only decode attention
follows the plan ("dma" under FLEXIBLE_DMA).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.kernels import ops as jops
from repro.launch.scheduler import PagedContinuousBatchingServer as JaxServer
from repro.models import layers as jL
from repro.models.registry import get_model as jget
from repro_torch import bridge
from repro_torch import configs as tcfg
from repro_torch.core.modes import ExecutionMode, ExecutionPlan, LayerPlan
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sidebar_gated_mlp as sg
from repro_torch.kernels import sidebar_mlp as sm
from repro_torch.launch.scheduler import PagedContinuousBatchingServer
from repro_torch.launch.serve import generate
from repro_torch.models import transformer as T
from repro_torch.models.mlp import mlp

# the module, not the function of the same name repro.kernels exports
jgated = importlib.import_module("repro.kernels.sidebar_gated_mlp")

ARCH = "deepseek-7b"
TOL = dict(rtol=1e-4, atol=1e-4)
SERVER = dict(num_slots=3, max_len=48, block_size=8, segment=4)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _gated_problem(seed, m, d, f, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return (rng.randn(m, d).astype(dtype),
            (rng.randn(d, f) * 0.05).astype(dtype),
            (rng.randn(d, f) * 0.05).astype(dtype),
            (rng.randn(f, d) * 0.05).astype(dtype))


# ---------------------------------------------------------------------------
# The kernel module against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [8, 16, 64])
@pytest.mark.parametrize("f", [256, 384])
@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
def test_gated_plain_matches_jax_pallas(m, f, act):
    ops = _gated_problem(m * 7 + f, m, 128, f)
    got = sg.sidebar_gated_mlp(*(_t(a) for a in ops), act)
    want = np.asarray(jops.sidebar_gated_mlp(
        *(jnp.asarray(a) for a in ops), act, interpret=True,
        use_kernel=True))
    assert got.dtype == torch.float32 and got.shape == (m, 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=3e-5)


def test_gated_plain_matches_jax_pallas_bf16():
    """bf16 operands: h rounded to Wd's type, the output to x's."""
    ops = _gated_problem(3, 16, 128, 256)
    got = sg.sidebar_gated_mlp(
        *(_t(a).to(torch.bfloat16) for a in ops), "silu")
    want = jgated.sidebar_gated_mlp(
        *(jnp.asarray(a, jnp.bfloat16) for a in ops), "silu",
        interpret=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)


def test_gated_plain_is_the_reference_in_fp32():
    """The plain version is ``ref.sidebar_gated_mlp_ref`` and equals the
    model's non-kernel branch bit for bit (both fp32 on the CPU)."""
    ct = tcfg.get_smoke_config(ARCH)
    x, wg, wu, wd = (_t(a) for a in _gated_problem(4, 6, 64, 192))
    params = {"w_gate": wg, "w_up": wu, "w_down": wd}
    plain = sg.sidebar_gated_mlp_plain(x, wg, wu, wd, "silu")
    assert torch.equal(plain, tref.sidebar_gated_mlp_ref(x, wg, wu, wd))
    assert torch.equal(mlp(params, ct, x[None]), plain[None])
    kernel_cfg = dataclasses.replace(ct, use_pallas=True)
    assert torch.equal(mlp(params, kernel_cfg, x[None]), plain[None])


def test_gated_wrapper_checks_shapes():
    x, wg, wu, wd = (_t(a) for a in _gated_problem(5, 4, 64, 128))
    with pytest.raises(ValueError, match="shape mismatch"):
        sg.sidebar_gated_mlp(x, wg, wu[:, :64], wd)
    with pytest.raises(ValueError, match="shape mismatch"):
        sg.sidebar_gated_mlp(x, wg, wu, wd[:64])
    with pytest.raises(ValueError, match="2-D"):
        sg.sidebar_gated_mlp(x[None], wg, wu, wd)


@pytest.mark.parametrize("m,f,want", [(4, 11008, 64), (64, 11008, 192),
                                      (1, 192, 64), (130, 2048, 128),
                                      (4, 200, 64)])
def test_gated_f_range_fills_the_card_in_64_column_tiles(m, f, want):
    """deepseek-7b's F = 11008 = 172 x 64 gets 172 blocks at decode and
    four row panels x 58 splits in a 64-row staging round."""
    fr = sg.f_range(m, f)
    assert fr == want and fr % sg.BLOCK_N == 0
    if (m, f) == (4, 11008):
        assert -(-f // fr) == 172
    if (m, f) == (64, 11008):
        assert -(-m // sg.BLOCK_M) * -(-f // fr) == 232


@pytest.mark.parametrize("f", [11008, 18432], ids=["deepseek-7b",
                                                   "deepseek-v3"])
@pytest.mark.parametrize("m", [1, 4, 8, 9, 16, 17, 64, 130])
def test_gated_tc_partition_covers_f_in_even_shares(m, f):
    """The tc route's F partition (``gated_f_ranges``, the kernel's
    ``cluster_span``): it depends on M and F only, its ranges tile F
    exactly in order, every range is whole 64-column shares (the last
    one cut at F), and no two ranges differ by more than one share; the
    panels' clusters aim at one block per SM, so at decode deepseek-7b's
    172 shares (and deepseek-v3's 288) keep all 132 SMs busy, where whole
    256-column sub-tiles left 88 (96) of them."""
    ranges = sg.gated_f_ranges(m, f)
    assert ranges == sg.gated_f_ranges(m, f)
    assert len(ranges) == sg.gated_splits(m, f)
    begin = 0
    for b, n in ranges:
        assert b == begin and b % 64 == 0 and n > 0
        begin += n
    assert begin == f
    shares = [-(-n // 64) for _, n in ranges]
    assert max(shares) - min(shares) <= 1
    n_rows, c = sm.tokens_per_panel(m), sg.gated_cluster_size(m)
    assert c == (4 if n_rows == 8 else 8)
    panels = -(-m // n_rows)
    blocks = panels * len(ranges) * c
    assert blocks <= max(132, panels * c)
    if m <= 8:
        assert blocks == 132             # 33 clusters of 4
    if m in (9, 16):
        assert blocks == 128             # 16 clusters of 8
    if m == 64:
        assert blocks == 128             # 2 panels x 8 clusters of 8


# ---------------------------------------------------------------------------
# The deepseek-7b smoke model against the JAX package
# ---------------------------------------------------------------------------


def _cfgs(variant):
    cj = jcfg.get_smoke_config(ARCH)
    ct = tcfg.get_smoke_config(ARCH)
    if variant == "int8":
        cj = dataclasses.replace(cj, kv_cache_dtype=jnp.int8)
        ct = dataclasses.replace(ct, kv_cache_dtype=torch.int8)
    if variant == "kernels":
        cj = dataclasses.replace(cj, use_pallas=True)
        ct = dataclasses.replace(ct, use_pallas=True)
    return cj, ct


@pytest.fixture(scope="module")
def weights():
    cj, _ = _cfgs("fp32")
    pj = jget(cj).init(jax.random.PRNGKey(0), cj)
    return pj, bridge.params_from_jax(jax.tree.map(np.asarray, pj),
                                   device="cpu")


def test_deepseek_config_mirrors_jax():
    for get in ("get_config", "get_smoke_config"):
        cj = getattr(jcfg, get)(ARCH)
        ct = getattr(tcfg, get)(ARCH)
        for f in ("arch_id", "family", "num_layers", "d_model", "num_heads",
                  "num_kv_heads", "d_ff", "vocab_size", "head_dim",
                  "activation", "gated_mlp", "rope_theta", "norm_eps"):
            assert getattr(ct, f) == getattr(cj, f), (get, f)
        assert str(ct.dtype).split(".")[-1] == jnp.dtype(cj.dtype).name
    full = tcfg.get_config(ARCH)
    assert (full.num_layers, full.d_model, full.d_ff, full.head_dim) == \
        (30, 4096, 11008, 128)
    assert full.num_heads == full.num_kv_heads == 32 and full.gated_mlp


def test_params_from_jax_carries_w_gate(weights):
    pj, pt = weights
    stack = pj["blocks"]["dense"]["mlp"]
    assert set(pt["layers"][0]["mlp"]) == {"w_gate", "w_up", "w_down"}
    for i, layer in enumerate(pt["layers"]):
        for name in ("w_gate", "w_up", "w_down"):
            np.testing.assert_array_equal(layer["mlp"][name].numpy(),
                                          np.asarray(stack[name][i]))
    shapes = T.param_shapes(tcfg.get_smoke_config(ARCH))
    assert shapes["layers"][0]["mlp"]["w_gate"] == ((64, 192), "normal")


@pytest.mark.parametrize("variant", ["fp32", "int8", "kernels"])
def test_deepseek_prefill_and_decode_match_jax(variant, weights):
    """Prefill logits, decode-step logits and greedy tokens agree with
    the JAX model on the same weights (MHA: group 1)."""
    cj, ct = _cfgs(variant)
    pj, pt = weights
    api = jget(cj)
    cache_j = api.init_cache(cj, jL.HOST, 2, 24)
    cache_t = T.init_cache(ct, 2, 24, device="cpu")
    toks = np.random.RandomState(1).randint(0, 512, (2, 8)).astype(np.int32)
    lj, cache_j = api.prefill(pj, cj, {"tokens": jnp.asarray(toks)},
                              cache_j)
    lt, cache_t = T.prefill(pt, ct, {"tokens": _t(toks)}, cache_t)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    nj = np.asarray(jnp.argmax(lj[:, -1], -1))[:, None]
    nt = torch.argmax(lt[:, -1], -1)[:, None]
    for step in range(3):
        assert np.array_equal(nt.numpy(), nj), step
        lj, cache_j = api.decode_step(pj, cj, jnp.asarray(nj), cache_j,
                                      jnp.int32(8 + step))
        lt, cache_t = T.decode_step(pt, ct, nt, cache_t, 8 + step)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        nj = np.asarray(jnp.argmax(lj[:, -1], -1))[:, None]
        nt = torch.argmax(lt[:, -1], -1)[:, None]


# ---------------------------------------------------------------------------
# The paged server
# ---------------------------------------------------------------------------


def _traffic(seed, n=4, vocab=512):
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
    return srv, done, recs


def test_deepseek_streams_match_jax_server(weights):
    cj, ct = _cfgs("kernels")
    pj, pt = weights
    reqs = _traffic(31)
    js = JaxServer(cj, pj, **SERVER)
    for p, g in reqs:
        js.submit(p, g)
    want = js.run()
    srv, got, _ = _serve(ct, pt, reqs)
    for a, b in zip(got, want):
        assert a.rid == b.rid and a.generated == b.generated
        np.testing.assert_array_equal(a.tokens, np.asarray(b.tokens),
                                      err_msg=f"rid {a.rid}")
    assert srv.stats.prefix_block_hits > 0


def test_deepseek_paged_equals_slab_equals_solo_bit_exact(weights):
    _, ct = _cfgs("kernels")
    _, pt = weights
    reqs = _traffic(32)
    _, paged, recs = _serve(ct, pt, reqs, kernel="paged")
    _, slab, _ = _serve(ct, pt, reqs, kernel="slab")
    for a, b in zip(paged, slab):
        prompt, gen = reqs[a.rid]
        solo = generate(ct, pt, _t(prompt)[None], gen, max_len=48,
                        device="cpu")[0, prompt.size:].numpy()
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(a.tokens, solo)
    assert not {"gather_blocks", "scatter_blocks"} & {r.op for r in recs}


DMA = ExecutionMode.FLEXIBLE_DMA
PIPELINED = ExecutionMode.SIDEBAR_PIPELINED
PLANS = {
    "sidebar": ExecutionMode.SIDEBAR,
    "monolithic": ExecutionMode.MONOLITHIC,
    "pipelined_d3": LayerPlan(PIPELINED, 3),
    "flexible_dma": DMA,
    "per_layer_dma_pipelined": ExecutionPlan.by_index(
        [LayerPlan(DMA, 1), LayerPlan(PIPELINED, 2)]),
}


@pytest.mark.parametrize("name", list(PLANS))
def test_gated_mlp_takes_one_route_under_every_plan(name, weights):
    """Under every plan the gated MLP records "ref" on the CPU at depth 1
    with the layer's mode (the JAX op's one route), decode attention
    records "dma" exactly on FLEXIBLE_DMA layers, and the tokens are the
    SIDEBAR plan's bit for bit."""
    _, ct = _cfgs("kernels")
    _, pt = weights
    reqs = _traffic(33, n=3)
    plan = PLANS[name]
    srv, got, recs = _serve(ct, pt, reqs, plan=plan)
    _, want, _ = _serve(ct, pt, reqs)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    gated = [r for r in recs if r.op == "sidebar_gated_mlp"]
    attn = [r for r in recs if r.op == "paged_attention"]
    assert gated and attn
    assert not any(r.op == "sidebar_mlp" for r in recs)
    for r in gated:
        mode = srv.plan.for_layer(r.layer).mode \
            if isinstance(srv.plan, ExecutionPlan) else srv.plan.mode
        assert (r.mode, r.depth, r.variant, r.used_kernel) == \
            (mode, 1, "ref", False)
    for r in attn:
        mode = srv.plan.for_layer(r.layer).mode \
            if isinstance(srv.plan, ExecutionPlan) else srv.plan.mode
        assert r.variant == ("dma" if mode is DMA else "ref")
    assert {r.layer for r in gated} == set(range(ct.num_layers))


def test_gated_op_records_like_the_jax_op():
    """The JAX op's record for the same call: ("sidebar_gated_mlp",
    mode, depth 1), "ref" off the kernel; the port's says "ref" on the
    CPU."""
    ops = _gated_problem(6, 8, 128, 256)
    jrecs, trecs = [], []
    with jops.record_dispatches(jrecs), jops.execution_plan("flexible_dma"):
        jops.sidebar_gated_mlp(*(jnp.asarray(a) for a in ops), "silu",
                               use_kernel=False)
    with kops.record_dispatches(trecs), kops.execution_plan("flexible_dma"):
        kops.sidebar_gated_mlp(*(_t(a) for a in ops), "silu")
    assert [(r.op, r.mode.value, r.depth, r.variant) for r in trecs] == \
        [(r.op, r.mode.value, r.depth, r.variant) for r in jrecs] == \
        [("sidebar_gated_mlp", "flexible_dma", 1, "ref")]
    assert kops.launch_counts()["sidebar_gated_mlp"] == 0
