"""deepseek-v3's MLA + MoE family in the port, held to the JAX package.

Across frameworks, on inputs made from a seed with numpy and on weights
loaded through ``repro_torch.bridge`` (fp32):

  * ``paged_mla_reference`` (what ``paged_mla`` and its op take for a
    CPU tensor) against the JAX ``paged_mla_reference`` and against
    ``paged_mla_kernel`` in interpret mode, on the problem of the JAX
    package's own MLA kernel test (ragged lengths, a scratch-padded
    tail), to 1e-5;
  * ``moe`` against the JAX ``moe`` (host path, no mesh), with a
    dropping capacity factor (1.25) and without drops, to 1e-5;
  * the config mirror of all six transformer configs, the weight and
    cache bridge over dense + moe stacks, the pool's per-leaf length
    axes;
  * the smoke model's prefill and decode logits, on a slab and on the
    paged pool, to 1e-4, with identical greedy tokens;
  * the port's paged server against the JAX server on the same traffic
    (no-drop capacity, as the JAX package's own paged gates run it):
    identical greedy streams.

Inside the port, bit-exact on the CPU: paged == slab == solo; the paged
route records no ``gather_blocks``; under FLEXIBLE_DMA decode attention
records "dma" and the tokens stay SIDEBAR's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.core.function_table import DEFAULT_TABLE as JTABLE
from repro.kernels import ops as jops
from repro.kernels import paged_attention as jpa
from repro.launch.scheduler import PagedContinuousBatchingServer as JaxServer
from repro.models import layers as jL
from repro.models import moe as jmoe
from repro.models.registry import get_model as jget
from repro_torch import bridge
from repro_torch import configs as tcfg
from repro_torch.core.function_table import DEFAULT_TABLE as TTABLE
from repro_torch.core.modes import ExecutionMode, ExecutionPlan, LayerPlan
from repro_torch.kernels import ops as kops
from repro_torch.kernels import paged_attention as pa
from repro_torch.launch import kvpool as kvp
from repro_torch.launch.scheduler import PagedContinuousBatchingServer
from repro_torch.launch.serve import generate
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe
from repro_torch.models import transformer as T

ARCH = "deepseek-v3-671b"
TOL = dict(rtol=1e-4, atol=1e-4)
SERVER = dict(num_slots=3, max_len=48, block_size=8, segment=4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _nodrop(cfg):
    """No-drop capacity, as the JAX package's paged gates use it: chunk
    boundaries must not change expert routing."""
    return dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))


# ---------------------------------------------------------------------------
# The kernel module against the JAX package
# ---------------------------------------------------------------------------


def _mla_problem(seed, *, dup=False):
    """The problem of tests/test_paged_kernel.py::
    test_mla_kernel_matches_reference; ``dup`` adds a duplicated
    (prefix-shared) block."""
    rng = np.random.RandomState(seed)
    P, bs, B, nb, h, kvr, rope = 7, 8, 3, 4, 4, 32, 8
    ckv = rng.randn(P, bs, kvr).astype(np.float32)
    krope = rng.randn(P, bs, rope).astype(np.float32)
    ql = rng.randn(B, h, kvr).astype(np.float32)
    qr = rng.randn(B, h, rope).astype(np.float32)
    tables = rng.randint(1, P, size=(B, nb)).astype(np.int32)
    tables[2, 2:] = kvp.SCRATCH_BLOCK
    if dup:
        tables[1, 2] = tables[1, 1]
    lengths = np.array([3, bs * nb, bs + 1], np.int32)
    return ql, qr, ckv, krope, tables, lengths, (kvr + rope) ** -0.5


@pytest.mark.parametrize("dup", [False, True], ids=["distinct", "shared"])
def test_paged_mla_plain_matches_jax_reference_and_pallas(dup):
    *ops, scale = _mla_problem(2, dup=dup)
    got = pa.paged_mla(*(_t(a) for a in ops), scale=scale)
    want_ref = jpa.paged_mla_reference(*(jnp.asarray(a) for a in ops),
                                       scale=scale)
    want_kernel = jpa.paged_mla_kernel(*(jnp.asarray(a) for a in ops),
                                       scale=scale, interpret=True)
    assert got.dtype == torch.float32 and got.shape == (3, 4, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel),
                               rtol=1e-5, atol=1e-5)


def test_paged_mla_plain_is_the_slab_math_bit_for_bit():
    """The plain version is the slab path's absorbed math on the
    gathered view: masked positions add exact zeros, so junk behind the
    mask and the table's width change nothing."""
    ql, qr, ckv, krope, tables, lengths, scale = (
        _t(a) if isinstance(a, np.ndarray) else a for a in _mla_problem(3))
    got = pa.paged_mla_reference(ql, qr, ckv, krope, tables, lengths,
                                 scale=scale)
    for r in range(3):
        n = -(-int(lengths[r]) // 8)
        dense = pa.gather_lat(ckv, tables[r:r + 1, :n])
        dense_r = pa.gather_lat(krope, tables[r:r + 1, :n])
        one = pa.paged_mla_reference(ql[r:r + 1], qr[r:r + 1], ckv, krope,
                                     tables[r:r + 1, :n], lengths[r:r + 1],
                                     scale=scale)
        assert torch.equal(one, got[r:r + 1])
        assert dense.shape == (1, n * 8, 32) and dense_r.shape[-1] == 8


def test_paged_mla_op_records_like_the_jax_op():
    *ops, scale = _mla_problem(4)
    for plan, variant in (("sidebar", "ref"), ("flexible_dma", "dma")):
        jrecs, trecs = [], []
        with jops.record_dispatches(jrecs), jops.execution_plan(plan):
            want = jops.paged_attention_mla(
                *(jnp.asarray(a) for a in ops), scale=scale)
        with kops.record_dispatches(trecs), kops.execution_plan(plan):
            got = kops.paged_attention_mla(*(_t(a) for a in ops),
                                           scale=scale)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
        assert [(r.op, r.variant, r.used_kernel) for r in trecs] == \
            [(r.op, r.variant, r.used_kernel) for r in jrecs] == \
            [("paged_attention", variant, False)]
    assert kops.launch_counts()["paged_mla"] == 0


def test_paged_mla_wrapper_checks_shapes():
    ql, qr, ckv, krope, tables, lengths, scale = (
        _t(a) if isinstance(a, np.ndarray) else a for a in _mla_problem(5))
    with pytest.raises(ValueError, match="MLA shapes"):
        pa.paged_mla(ql, qr, ckv[..., :16], krope, tables, lengths,
                     scale=scale)
    with pytest.raises(ValueError, match="MLA shapes"):
        pa.paged_mla(ql, qr[:, :2], ckv, krope, tables, lengths, scale=scale)
    with pytest.raises(ValueError, match="3-D"):
        pa.paged_mla(ql[0], qr, ckv, krope, tables, lengths, scale=scale)


# ---------------------------------------------------------------------------
# MoE against the JAX package
# ---------------------------------------------------------------------------


def _moe_cfgs(capacity_factor):
    cj = dataclasses.replace(jcfg.get_smoke_config(ARCH),
                             capacity_factor=capacity_factor)
    ct = dataclasses.replace(tcfg.get_smoke_config(ARCH),
                             capacity_factor=capacity_factor)
    return cj, ct


@pytest.mark.parametrize("cf", [1.25, 8.0], ids=["drop", "nodrop"])
@pytest.mark.parametrize("tokens", [(2, 8), (1, 3)])
def test_moe_matches_jax(cf, tokens):
    cj, ct = _moe_cfgs(cf)
    pj = jL.materialize(jax.random.PRNGKey(3),
                        jmoe.moe_param_specs(cj, jL.HOST))
    pt = bridge._layer(jax.tree.map(lambda a: np.asarray(a)[None], pj), 0,
                       "cpu")
    x = np.random.RandomState(sum(tokens)).randn(*tokens, 64).astype(
        np.float32)
    want = jax.jit(lambda p, v: jmoe.moe(p, cj, v, table=JTABLE,
                                         minfo=jL.HOST, mesh=None))(
        pj, jnp.asarray(x))
    got = moe.moe(pt, ct, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    t = tokens[0] * tokens[1]
    assert moe._capacity(t, ct) == jmoe._capacity(t, cj)


def test_capacity_drops_the_same_tokens_as_jax():
    """A dropping factor at 24 tokens: cap 8 < the tokens some experts
    get, so tokens are dropped — the same ones, by routed weight."""
    cj, ct = _moe_cfgs(1.25)
    pj = jL.materialize(jax.random.PRNGKey(5),
                        jmoe.moe_param_specs(cj, jL.HOST))
    x = np.random.RandomState(6).randn(24, 64).astype(np.float32)
    wj, ij = jmoe._route(jnp.asarray(x), pj["router"], cj)
    wt, it = moe._route(_t(x), _t(pj["router"]), ct)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-6)
    per_expert = np.bincount(it.numpy().reshape(-1), minlength=8)
    assert moe._capacity(24, ct) == 8 and per_expert.max() > 8
    act = JTABLE.lookup("silu")
    want = jmoe._local_expert_pass(
        jnp.asarray(x), wj, ij, pj["w_gate"], pj["w_up"], pj["w_down"], 0,
        cj, act)
    got = moe._local_expert_pass(
        _t(x), wt, it, _t(pj["w_gate"]), _t(pj["w_up"]), _t(pj["w_down"]),
        ct, TTABLE.lookup("silu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_top_breaks_ties_toward_the_lower_index_like_jax():
    x = np.array([[0.5, 0.25, 0.5, 0.0, 0.25, 0.5],
                  [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]], np.float32)
    for k in (1, 3, 5):
        wj, ij = jax.lax.top_k(jnp.asarray(x), k)
        wt, it = moe._top(_t(x), k)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))


def test_moe_row_result_does_not_depend_on_the_batch():
    """No-drop capacity: each token's output is its own row's, bit for
    bit, alone or beside others (what paged == slab == solo needs)."""
    _, ct = _moe_cfgs(8.0)
    pt = T.init(dataclasses.replace(ct, num_layers=2), seed=1,
                device="cpu")["layers"][1]["moe"]
    x = _t(np.random.RandomState(7).randn(1, 6, 64).astype(np.float32))
    whole = moe.moe(pt, ct, x)
    for i in range(6):
        assert torch.equal(moe.moe(pt, ct, x[:, i:i + 1]), whole[:, i:i + 1])


def test_init_leaf_draws_expert_stacks_slice_by_slice():
    gen = torch.Generator().manual_seed(0)
    w = L.init_leaf((3, 64, 48), "normal", torch.bfloat16, generator=gen,
                    device=torch.device("cpu"))
    assert w.dtype == torch.bfloat16 and w.shape == (3, 64, 48)
    assert abs(w.float().std().item() - 64 ** -0.5) < 0.02
    assert not torch.equal(w[0], w[1])


# ---------------------------------------------------------------------------
# Config, bridge, pool layout
# ---------------------------------------------------------------------------

FIELDS = ("arch_id", "family", "num_layers", "d_model", "num_heads",
          "num_kv_heads", "d_ff", "vocab_size", "head_dim", "activation",
          "gated_mlp", "qk_norm", "rope_theta", "norm_eps", "num_experts",
          "experts_per_token", "num_shared_experts", "moe_d_ff",
          "capacity_factor", "first_dense_layers", "use_mla", "q_lora_rank",
          "kv_lora_rank", "rope_head_dim", "nope_head_dim", "v_head_dim")


@pytest.mark.parametrize("get", ["get_config", "get_smoke_config"])
def test_config_mirrors_jax(get):
    """Every transformer config of the JAX package, field for field (the
    dtypes by name), with its layer plan."""
    assert set(tcfg.ARCH_IDS) == {
        "nemotron-4-15b", "deepseek-7b", "deepseek-v3-671b", "qwen3-14b",
        "llama3-405b", "llama4-scout-17b-a16e"}
    for arch in tcfg.ARCH_IDS:
        cj = getattr(jcfg, get)(arch)
        ct = getattr(tcfg, get)(arch)
        for f in FIELDS:
            assert getattr(ct, f) == getattr(cj, f), (arch, get, f)
        for f in ("dtype", "kv_cache_dtype"):
            assert str(getattr(ct, f)).split(".")[-1] == jnp.dtype(
                getattr(cj, f)).name, (arch, get, f)
        assert T.layer_kinds(ct) == (
            ["dense"] * ct.first_dense_layers
            + ["moe"] * (ct.num_layers - ct.first_dense_layers)
            if ct.num_experts else ["dense"] * ct.num_layers)


@pytest.fixture(scope="module")
def weights():
    cj = jcfg.get_smoke_config(ARCH)
    # one compiled init (the eager one dispatches leaf by leaf)
    pj = jax.jit(lambda key: jget(cj).init(key, cj))(jax.random.PRNGKey(0))
    return pj, bridge.params_from_jax(jax.tree.map(np.asarray, pj),
                                   device="cpu")


def test_params_from_jax_over_dense_and_moe_stacks(weights):
    pj, pt = weights
    ct = tcfg.get_smoke_config(ARCH)
    shapes = T.param_shapes(ct)
    assert len(pt["layers"]) == 3
    for i, kind in enumerate(T.layer_kinds(ct)):
        layer = pt["layers"][i]
        stack = pj["blocks"][kind]
        j = i if kind == "dense" else i - ct.first_dense_layers
        assert set(layer) == set(shapes["layers"][i]) == set(stack)
        flat_t = jax.tree_util.tree_leaves_with_path(
            jax.tree.map(lambda a: a.numpy(), layer))
        flat_j = dict(jax.tree_util.tree_leaves_with_path(stack))
        for path, leaf in flat_t:
            np.testing.assert_array_equal(leaf, np.asarray(flat_j[path])[j])
    sh = shapes["layers"][1]["moe"]
    assert sh["w_gate"] == ((8, 64, 64), "normal")
    assert sh["shared"]["w_down"] == ((64, 64), "normal")
    assert shapes["layers"][0]["attn"]["w_uk"] == ((32, 4 * 16), "normal")


def test_cache_bridge_roundtrip_keeps_the_layer_plan():
    cj = jcfg.get_smoke_config(ARCH)
    ct = tcfg.get_smoke_config(ARCH)
    cache = jax.tree.map(np.asarray, jget(cj).init_cache(cj, jL.HOST, 2, 16))
    rng = np.random.RandomState(9)
    cache = jax.tree.map(lambda a: rng.randn(*a.shape).astype(a.dtype),
                         cache)
    mine = bridge.cache_from_jax(cache, device="cpu")
    assert [set(layer) for layer in mine] == [{"c_kv", "k_rope"}] * 3
    assert mine[0]["c_kv"].shape == (2, 16, 32)
    back = bridge.cache_to_numpy(mine, T.layer_kinds(ct))
    for kind in ("dense", "moe"):
        for name in ("c_kv", "k_rope"):
            np.testing.assert_array_equal(back[kind][name],
                                          cache[kind][name])


def test_pool_length_axes_and_gather_scatter_on_mla_leaves():
    ct = tcfg.get_smoke_config(ARCH)
    assert kvp.length_axes(T, ct) == [{"c_kv": 1, "k_rope": 1}] * 3
    gqa = tcfg.get_smoke_config("nemotron-4-15b")
    assert kvp.length_axes(T, dataclasses.replace(
        gqa, kv_cache_dtype=torch.int8))[0] == {
            "k": 2, "v": 2, "k_scale": 2, "v_scale": 2}
    pool = T.init_cache(ct, 7, 4, device="cpu")
    for layer in pool:
        for leaf in layer.values():
            leaf.copy_(torch.randn(leaf.shape))
    before = [{k: v.clone() for k, v in layer.items()} for layer in pool]
    tables = torch.tensor([[1, 3], [2, 5]])
    axes = kvp.length_axes(T, ct)
    dense = kvp.gather_blocks(pool, tables, axes)
    assert dense[0]["c_kv"].shape == (2, 8, 32)
    assert torch.equal(dense[2]["k_rope"][1, 4:], pool[2]["k_rope"][5])
    for layer in pool:
        for leaf in layer.values():
            leaf.zero_()
    kvp.scatter_blocks(pool, dense, tables, axes)
    for b, a in zip(before, pool):
        for name in a:
            assert torch.equal(a[name][[1, 2, 3, 5]], b[name][[1, 2, 3, 5]])


# ---------------------------------------------------------------------------
# The smoke model against the JAX package
# ---------------------------------------------------------------------------


def _paged_tables(b, nb):
    """Row r owns blocks 1 + r*nb .. (r+1)*nb of the pool."""
    return torch.arange(1, 1 + b * nb, dtype=torch.int32).reshape(b, nb)


STEPS = 4


@pytest.fixture(scope="module")
def jax_run(weights):
    """The JAX model on a slab cache: prefill of two 8-token prompts, then
    ``STEPS`` greedy decode steps; the logits of each call, the tokens
    fed, and the final cache."""
    cj = _nodrop(jcfg.get_smoke_config(ARCH))
    pj, _ = weights
    api = jget(cj)
    cache = api.init_cache(cj, jL.HOST, 2, 24)
    prefill = jax.jit(lambda p, b, c: api.prefill(p, cj, b, c))
    decode = jax.jit(lambda p, t, c, pos: api.decode_step(p, cj, t, c, pos))
    toks = np.random.RandomState(1).randint(0, 512, (2, 8)).astype(np.int32)
    logits, cache = prefill(pj, {"tokens": jnp.asarray(toks)}, cache)
    out, fed = [np.asarray(logits)], [toks]
    for step in range(STEPS):
        nxt = np.asarray(jnp.argmax(logits[:, -1], -1))[:, None]
        logits, cache = decode(pj, jnp.asarray(nxt), cache,
                               jnp.int32(8 + step))
        out.append(np.asarray(logits))
        fed.append(nxt)
    return out, fed, jax.tree.map(np.asarray, cache)


@pytest.mark.parametrize("route", ["slab", "paged"])
def test_prefill_and_decode_match_jax(route, weights, jax_run):
    """Prefill logits, decode-step logits and greedy tokens agree with
    the JAX model (slab cache) on the same weights, the port on a slab or
    on the paged pool (decode in place on it)."""
    ct = dataclasses.replace(_nodrop(tcfg.get_smoke_config(ARCH)),
                             use_pallas=True)
    _, pt = weights
    want, fed, cache_j = jax_run
    kw = {}
    if route == "paged":
        bs, nb = 8, 3
        cache_t = T.init_cache(ct, 2 * nb + 2, bs, device="cpu")
        kw["block_tables"] = _paged_tables(2, nb)
    else:
        cache_t = T.init_cache(ct, 2, 24, device="cpu")
    lt, cache_t = T.prefill(pt, ct, {"tokens": _t(fed[0])}, cache_t, **kw)
    np.testing.assert_allclose(lt.numpy(), want[0], **TOL)
    recs = []
    for step in range(STEPS):
        nt = torch.argmax(lt[:, -1], -1)[:, None]
        assert np.array_equal(nt.numpy(), fed[step + 1]), step
        with kops.record_dispatches(recs):
            lt, cache_t = T.decode_step(pt, ct, nt, cache_t, 8 + step, **kw)
        np.testing.assert_allclose(lt.numpy(), want[step + 1], **TOL)
    attn_recs = [r for r in recs if r.op == "paged_attention"]
    gated = [r for r in recs if r.op == "sidebar_gated_mlp"]
    assert len(attn_recs) == (3 * STEPS if route == "paged" else 0)
    assert {r.layer for r in gated} == {0}           # the dense layer
    if route == "slab":
        mine = bridge.cache_to_numpy(cache_t, T.layer_kinds(ct))
        for kind in ("dense", "moe"):
            np.testing.assert_allclose(mine[kind]["c_kv"][:, :, :12],
                                       cache_j[kind]["c_kv"][:, :, :12],
                                       **TOL)


def test_mla_decode_is_absorbed_and_prefill_naive_agree(weights):
    """The absorbed decode equals the naive (expanded) attention at the
    same position: decode one token on a slab vs prefill it as the
    chunk's last token."""
    ct = tcfg.get_smoke_config(ARCH)
    _, pt = weights
    p = pt["layers"][0]["attn"]
    x = _t(np.random.RandomState(2).randn(1, 6, 64).astype(np.float32))
    pos = torch.arange(6)[None]
    cache = T.init_cache(ct, 1, 8, device="cpu")[0]
    want, _ = attn.mla_attention(p, ct, x, pos, cache=cache, cache_pos=0)
    cache = T.init_cache(ct, 1, 8, device="cpu")[0]
    attn.mla_attention(p, ct, x[:, :5], pos[:, :5], cache=cache,
                       cache_pos=0)
    got, _ = attn.mla_attention(p, ct, x[:, 5:], pos[:, 5:], cache=cache,
                                cache_pos=5)
    np.testing.assert_allclose(got.numpy(), want[:, 5:].numpy(), **TOL)


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


def _server_cfg():
    return dataclasses.replace(_nodrop(tcfg.get_smoke_config(ARCH)),
                               use_pallas=True)


def test_streams_match_jax_server(weights):
    pj, pt = weights
    reqs = _traffic(41)
    js = JaxServer(_nodrop(jcfg.get_smoke_config(ARCH)), pj, **SERVER)
    for p, g in reqs:
        js.submit(p, g)
    want = js.run()
    srv, got, _ = _serve(_server_cfg(), pt, reqs)
    for a, b in zip(got, want):
        assert a.rid == b.rid and a.generated == b.generated
        np.testing.assert_array_equal(a.tokens, np.asarray(b.tokens),
                                      err_msg=f"rid {a.rid}")
    assert srv.stats.prefix_block_hits > 0


def test_paged_equals_slab_equals_solo_bit_exact(weights):
    ct = _server_cfg()
    _, pt = weights
    reqs = _traffic(42)
    _, paged, recs = _serve(ct, pt, reqs, kernel="paged")
    _, slab, slab_recs = _serve(ct, pt, reqs, kernel="slab")
    for a, b in zip(paged, slab):
        prompt, gen = reqs[a.rid]
        solo = generate(ct, pt, _t(prompt)[None], gen, max_len=48,
                        device="cpu")[0, prompt.size:].numpy()
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(a.tokens, solo)
    ops = {r.op for r in recs}
    assert not {"gather_blocks", "scatter_blocks"} & ops
    assert "paged_attention" in ops
    assert {"gather_blocks", "scatter_blocks"} <= {r.op for r in slab_recs}


PLANS = {
    "flexible_dma": ExecutionMode.FLEXIBLE_DMA,
    "per_layer_dma": ExecutionPlan.by_index(
        [LayerPlan(ExecutionMode.SIDEBAR, 1),
         LayerPlan(ExecutionMode.FLEXIBLE_DMA, 1),
         LayerPlan(ExecutionMode.SIDEBAR_PIPELINED, 2)]),
}


@pytest.mark.parametrize("name", list(PLANS))
def test_dma_plans_route_decode_attention_through_the_gather(name,
                                                             weights):
    """Decode attention records "dma" exactly on FLEXIBLE_DMA layers
    ("ref" elsewhere on the CPU), the gated MLP runs only on the dense
    layer, and the tokens are the SIDEBAR plan's bit for bit."""
    ct = _server_cfg()
    _, pt = weights
    reqs = _traffic(43, n=3)
    srv, got, recs = _serve(ct, pt, reqs, plan=PLANS[name])
    _, want, _ = _serve(ct, pt, reqs)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    attn_recs = [r for r in recs if r.op == "paged_attention"]
    assert {r.layer for r in attn_recs} == {0, 1, 2}
    for r in attn_recs:
        mode = srv.plan.for_layer(r.layer).mode \
            if isinstance(srv.plan, ExecutionPlan) else srv.plan.mode
        assert r.variant == ("dma" if mode is ExecutionMode.FLEXIBLE_DMA
                             else "ref")
    assert {r.layer for r in recs if r.op == "sidebar_gated_mlp"} == {0}
    assert not {"gather_blocks", "scatter_blocks"} & {r.op for r in recs}
