"""The port's paged continuous-batching server.

Across frameworks: the same traffic (shared-prefix prompts included)
gives the same greedy streams as the JAX ``PagedContinuousBatchingServer``
on the same weights (loaded through ``repro_torch.bridge``), fp32 and
int8 KV. Inside the port, bit-exact: ``kernel="paged"`` ==
``kernel="slab"`` == solo ``serve.generate`` — the CPU plain paths sum in
a fixed order (``kernels.ref``). Also the safety rails: table
validation, the drop sink for out-of-table writes, span checks, and the
host-side block allocator against the JAX one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.launch import kvpool as jkvp
from repro.launch.scheduler import PagedContinuousBatchingServer as JaxServer
from repro.models import attention as jattn
from repro.models.registry import get_model as jget
from repro_torch import bridge
from repro_torch import configs as tcfg
from repro_torch.core.modes import ExecutionMode, LayerPlan
from repro_torch.kernels import ops as kops
from repro_torch.launch import kvpool as kvp
from repro_torch.launch.sampling import SamplingParams
from repro_torch.launch.scheduler import PagedContinuousBatchingServer
from repro_torch.launch.serve import generate
from repro_torch.models import attention as attn
from repro_torch.models import transformer as T

VARIANTS = ["fp32", "int8"]
SERVER = dict(device="cpu", num_slots=3, max_len=48, block_size=8,
              segment=4)


@pytest.fixture(scope="module")
def models():
    cj = jcfg.get_smoke_config("nemotron-4-15b")
    ct = tcfg.get_smoke_config("nemotron-4-15b")
    pj = jget(cj).init(jax.random.PRNGKey(0), cj)
    pt = bridge.params_from_jax(jax.tree.map(np.asarray, pj))
    return {
        "fp32": (cj, ct, pj, pt),
        "int8": (dataclasses.replace(cj, kv_cache_dtype=jnp.int8),
                 dataclasses.replace(ct, kv_cache_dtype=torch.int8), pj, pt),
    }


def _traffic(seed, n=6, vocab=512):
    """Prompts of 2..21 tokens; every other one opens with the same
    16-token (two-block) prefix."""
    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, vocab, 16).astype(np.int32)
    out = []
    for i in range(n):
        p = rng.randint(0, vocab, rng.randint(2, 14)).astype(np.int32)
        if i % 2:
            p = np.concatenate([prefix, p[:5]])
        out.append((p, int(rng.randint(1, 9))))
    return out


def _serve(ct, pt, reqs, **kw):
    srv = PagedContinuousBatchingServer(ct, pt, **{**SERVER, **kw})
    recs = []
    with kops.record_dispatches(recs):
        rids = [srv.submit(p, g) for p, g in reqs]
        done = srv.run()
    assert [r.rid for r in done] == rids
    return srv, done, recs


@pytest.mark.parametrize("variant", VARIANTS)
def test_streams_match_jax_server(variant, models):
    cj, ct, pj, pt = models[variant]
    reqs = _traffic(3)
    js = JaxServer(cj, pj, num_slots=3, max_len=48, block_size=8,
                   segment=4)
    for p, g in reqs:
        js.submit(p, g)
    want = js.run()
    srv, got, _ = _serve(ct, pt, reqs)
    for a, b in zip(got, want):
        assert a.rid == b.rid and a.generated == b.generated
        np.testing.assert_array_equal(a.tokens, np.asarray(b.tokens),
                                      err_msg=f"rid {a.rid}")
    assert srv.stats.prefix_block_hits > 0


@pytest.mark.parametrize("variant", VARIANTS)
def test_paged_equals_slab_equals_solo_bit_exact(variant, models):
    _, ct, _, pt = models[variant]
    reqs = _traffic(5)
    _, paged, paged_recs = _serve(ct, pt, reqs, kernel="paged")
    _, slab, slab_recs = _serve(ct, pt, reqs, kernel="slab")
    for a, b in zip(paged, slab):
        prompt, gen = reqs[a.rid]
        solo = generate(ct, pt, torch.from_numpy(prompt)[None], gen,
                        max_len=48, device="cpu")[0, prompt.size:].numpy()
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(a.tokens, solo)
    ops = {r.op for r in paged_recs}
    assert "gather_blocks" not in ops and "scatter_blocks" not in ops
    assert "paged_attention" in ops
    slab_ops = {r.op for r in slab_recs}
    assert {"gather_blocks", "scatter_blocks"} <= slab_ops
    assert "paged_attention" not in slab_ops


def test_paged_route_runs_attention_per_layer_per_step(models):
    _, ct, _, pt = models["fp32"]
    srv, done, recs = _serve(ct, pt, [(np.arange(5, dtype=np.int32), 6)])
    paged = [r for r in recs if r.op == "paged_attention"]
    assert len(paged) == ct.num_layers * 6          # one decode per token
    assert {r.layer for r in paged} == set(range(ct.num_layers))
    assert all(r.variant == "ref" and not r.used_kernel for r in paged)


def test_use_pallas_route_is_bit_exact_on_cpu(models):
    """cfg.use_pallas sends every MLP call through kops.sidebar_mlp (the
    plain version on the CPU): the same rounding points as the two
    linears, so the same tokens."""
    _, ct, _, pt = models["fp32"]
    reqs = _traffic(7, n=4)
    _, plain, _ = _serve(ct, pt, reqs)
    _, fused, recs = _serve(dataclasses.replace(ct, use_pallas=True), pt,
                            reqs)
    for a, b in zip(plain, fused):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    mlps = [r for r in recs if r.op == "sidebar_mlp"]
    assert mlps and all(r.variant == "ref" for r in mlps)


def test_pool_is_clean_after_drain(models):
    _, ct, _, pt = models["fp32"]
    srv, _, _ = _serve(ct, pt, _traffic(9))
    assert srv.mgr.alloc.in_use == 0
    assert not srv._staging and all(s.free for s in srv.slots)
    assert (srv._tables == kvp.SCRATCH_BLOCK).all()


def test_unused_tail_table_entries_are_inert(models):
    """Short requests against a long max_len: the segment's table is
    sliced to the frontier, and tokens still equal solo decode."""
    _, ct, _, pt = models["fp32"]
    reqs = [(np.asarray([5, 3], np.int32), 3),
            (np.asarray([9], np.int32), 4)]
    srv = PagedContinuousBatchingServer(ct, pt, device="cpu", num_slots=2,
                                        max_len=48, block_size=4,
                                        segment=4)
    widths = []
    orig = srv._run_segment

    def spy(steps, pos, aligned, tables):
        widths.append(tables.shape[1])
        return orig(steps, pos, aligned, tables)

    srv._run_segment = spy
    for p, g in reqs:
        srv.submit(p, g)
    for r in srv.run():
        prompt, gen = reqs[r.rid]
        solo = generate(ct, pt, torch.from_numpy(prompt)[None], gen,
                        max_len=48, device="cpu")[0, prompt.size:]
        np.testing.assert_array_equal(r.tokens, solo.numpy())
    assert widths and max(widths) < srv.blocks_per_table


def test_cancel_releases_blocks(models):
    _, ct, _, pt = models["fp32"]
    srv = PagedContinuousBatchingServer(ct, pt, **SERVER)
    keep = srv.submit(np.arange(10, dtype=np.int32), 4)
    gone = srv.submit(np.arange(20, dtype=np.int32), 8)
    srv.step()
    assert srv.cancel(gone) and not srv.cancel(999)
    done = srv.run()
    assert [r.rid for r in done] == [keep]
    assert srv.mgr.alloc.in_use == 0 and srv.stats.cancelled == 1


@pytest.mark.parametrize("kw", [
    dict(kernel="dense"), dict(mesh=object()), dict(spec=object()),
    dict(rag=object()), dict(faults=object()), dict(plan="sidebar_pipelined"),
])
def test_unsupported_server_arguments_raise(kw, models):
    """Arguments of features not ported raise. ``plan=`` no longer does:
    every mode is served, and a pipelined plan drains with the tokens of
    the default SIDEBAR plan, its MLP dispatches recorded as planned."""
    _, ct, _, pt = models["fp32"]
    if "plan" in kw:
        ct = dataclasses.replace(ct, use_pallas=True)
        reqs = _traffic(11, n=3)
        srv, got, recs = _serve(ct, pt, reqs, **kw)
        _, want, _ = _serve(ct, pt, reqs)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.tokens, b.tokens)
        assert srv.plan == LayerPlan(ExecutionMode.SIDEBAR_PIPELINED, 2)
        mlps = {(r.mode, r.depth) for r in recs if r.op == "sidebar_mlp"}
        assert mlps == {(ExecutionMode.SIDEBAR_PIPELINED, 2)}
        return
    err = ValueError if "kernel" in kw else NotImplementedError
    with pytest.raises(err):
        PagedContinuousBatchingServer(ct, pt, **{**SERVER, **kw})


def test_submit_rejects_what_is_not_ported(models):
    _, ct, _, pt = models["fp32"]
    srv = PagedContinuousBatchingServer(ct, pt, **SERVER)
    with pytest.raises(NotImplementedError, match="threefry"):
        srv.submit([1, 2], 3, SamplingParams(temperature=0.7))
    with pytest.raises(NotImplementedError, match="priorit"):
        srv.submit([1, 2], 3, priority=1)
    with pytest.raises(ValueError, match="max_len"):
        srv.submit(np.arange(40), 10)
    rid = srv.submit([1, 2], 3, SamplingParams(temperature=0.0))
    greedy = srv.submit([1, 2], 3)
    a, b = srv.run()
    assert (a.rid, b.rid) == (rid, greedy)
    np.testing.assert_array_equal(a.tokens, b.tokens)


# ---------------------------------------------------------------------------
# Safety rails
# ---------------------------------------------------------------------------


def test_validate_tables_rejects_out_of_pool_entries():
    kvp.validate_tables(np.asarray([[0, 2, 1]], np.int32), num_blocks=3)
    # 3 is the drop sink of a 3-block pool: never a valid table entry
    for bad in ([[0, 3, 1]], [[0, -1, 1]]):
        with pytest.raises(kvp.KVPoolError, match="table"):
            kvp.validate_tables(np.asarray(bad, np.int32), num_blocks=3)


def test_write_index_sends_out_of_table_positions_to_the_sink():
    bs, nb, num_blocks = 4, 2, 6
    tables = torch.tensor([[3, 5]], dtype=torch.int32)
    pb, off = attn.paged_write_index(tables, torch.tensor([bs * nb - 1]),
                                     1, bs, num_blocks)
    assert (int(pb[0]), int(off[0])) == (5, bs - 1)
    pb, _ = attn.paged_write_index(tables, torch.tensor([bs * nb]), 1, bs,
                                   num_blocks)
    assert int(pb[0]) == num_blocks
    pb, _ = attn.paged_write_index(tables, bs * nb - 2, 4, bs, num_blocks)
    assert pb[0].tolist() == [5, 5, num_blocks, num_blocks]
    jpb, _ = jattn._paged_write_index(jnp.asarray(tables.numpy()),
                                      jnp.int32(bs * nb - 2), 4, bs,
                                      num_blocks)
    assert np.asarray(jpb).tolist() == pb.tolist()


def test_out_of_table_writes_land_only_in_the_sink(models):
    """A decode position past a row's (sliced) table writes the pool's
    extra sink row and no real block — torch has no mode="drop"."""
    _, ct, _, pt = models["fp32"]
    pool = T.init_cache(ct, 5 + 1, 4, device="cpu")      # 5 blocks + sink
    tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    pos = torch.tensor([3, 9])                 # row 1: past its 8 slots
    T.decode_step(pt, ct, torch.tensor([[7], [8]]), pool, pos,
                  block_tables=tables)
    for layer in pool:
        k = layer["k"]
        assert k[1, :, 3].abs().sum() > 0                # row 0 wrote
        assert k[3:5].abs().sum() == 0                   # row 1 did not
        assert k[5].abs().sum() > 0                      # ... the sink did


def test_check_span_rejects_frontier_overrun(models):
    _, ct, _, pt = models["fp32"]
    srv = PagedContinuousBatchingServer(ct, pt, device="cpu", num_slots=1,
                                        max_len=32, block_size=8)
    rb = srv.mgr.begin_request(np.asarray([1, 2, 3], np.int32), 10)
    srv.mgr.check_span(rb, 16)
    with pytest.raises(kvp.KVPoolError, match="span"):
        srv.mgr.check_span(rb, 17)
    srv.mgr.release_request(rb)


def test_gather_scatter_roundtrip(models):
    _, ct, _, pt = models["fp32"]
    pool = T.init_cache(ct, 7, 4, device="cpu")
    for layer in pool:
        for leaf in layer.values():
            leaf.copy_(torch.randn(leaf.shape))
    before = [{k: v.clone() for k, v in layer.items()} for layer in pool]
    tables = torch.tensor([[1, 3], [2, 5]])
    axes = kvp.length_axes(T, ct)
    dense = kvp.gather_blocks(pool, tables, axes)
    assert dense[0]["k"].shape == (2, ct.num_kv_heads, 8, ct.head_dim)
    assert torch.equal(dense[0]["k"][1, :, 4:], pool[0]["k"][5])
    for layer in pool:
        for leaf in layer.values():
            leaf.zero_()
    kvp.scatter_blocks(pool, dense, tables, axes)
    for b, a in zip(before, pool):
        for name in a:
            assert torch.equal(a[name][[1, 2, 3, 5]], b[name][[1, 2, 3, 5]])


# ---------------------------------------------------------------------------
# Host-side allocator: ported close to verbatim, held to the JAX one
# ---------------------------------------------------------------------------


def test_prefix_and_chunk_keys_match_jax():
    t = np.random.RandomState(0).randint(0, 1000, 40).astype(np.int32)
    assert kvp.chunk_keys(t, 4, 8) == jkvp.chunk_keys(t, 4, 8)
    assert kvp.prefix_key(t, 16) == jkvp.prefix_key(t, 16)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_matches_jax_on_random_interleavings(seed):
    """Same op sequence -> same ids, states, refcounts and counters."""
    rng = np.random.RandomState(seed)
    ours, theirs = kvp.BlockAllocator(9), jkvp.BlockAllocator(9)
    live: list[int] = []
    for step in range(200):
        op = rng.randint(4)
        if op == 0:
            results = []
            for a in (ours, theirs):
                try:
                    results.append(a.alloc())
                except (kvp.KVPoolError, jkvp.KVPoolError) as e:
                    results.append(type(e).__name__)
            assert results[0] == results[1], step
            if isinstance(results[0], int):
                live.append(results[0])
                ours.activate(results[0])
                theirs.activate(results[0])
        elif op == 1 and live:
            bid = live.pop(rng.randint(len(live)))
            ours.release(bid)
            theirs.release(bid)
        elif op == 2 and live:
            bid = live[rng.randint(len(live))]
            key = bytes([rng.randint(6)])
            assert ours.register(key, bid) == theirs.register(key, bid)
        elif op == 3:
            key = bytes([rng.randint(6)])
            a, b = ours.lookup_any([key]), theirs.lookup_any([key])
            assert a == b
            if a is not None:
                ours.retain(a)
                theirs.retain(a)
                live.append(a)
        for bid in range(1, 9):
            assert ours.state(bid).value == theirs.state(bid).value
            assert ours.refcount(bid) == theirs.refcount(bid)
    mine = dataclasses.asdict(ours.counters)
    ref = dataclasses.asdict(theirs.counters)
    assert mine == {k: ref[k] for k in mine}


def test_allocator_protocol_errors():
    a = kvp.BlockAllocator(3)
    bid = a.alloc()
    with pytest.raises(kvp.KVPoolError, match="register"):
        a.register(b"k", bid)                      # staged, not active
    a.activate(bid)
    with pytest.raises(kvp.KVPoolError, match="activate"):
        a.activate(bid)
    a.release(bid)
    with pytest.raises(kvp.KVPoolError, match="negative"):
        a.release(bid)
    with pytest.raises(kvp.KVPoolError, match="out of range"):
        a.retain(0)


def test_manager_prefix_splice_and_copy_on_write(models):
    _, ct, _, _ = models["fp32"]
    from repro_torch.models.registry import get_model

    mgr = kvp.PagedKVManager(get_model(ct), ct, num_blocks=12, block_size=4,
                             device="cpu")
    prompt = np.arange(13, dtype=np.int32)
    rb1 = mgr.begin_request(prompt, 16)
    mgr.publish_prompt(prompt, rb1)
    rb2 = mgr.begin_request(prompt, 16)
    assert rb2.prefix_hit_blocks == 3 and rb2.bids[:3] == rb1.bids[:3]
    assert mgr.counters.prefix_block_hits == 3
    mgr.pool.cache[0]["k"][rb1.bids[0]] = 1.0
    shared = rb2.bids[0]
    assert mgr.ensure_exclusive(rb2, 0)
    assert rb2.bids[0] != shared
    assert torch.equal(mgr.pool.cache[0]["k"][rb2.bids[0]],
                       mgr.pool.cache[0]["k"][shared])
    for rb in (rb1, rb2):
        mgr.release_request(rb)
    assert mgr.alloc.in_use == 0
    assert mgr.pool.cache[0]["k"].shape[0] == 13         # + the sink row
    assert mgr.counters.cow_copies == 1
