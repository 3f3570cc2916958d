"""Preemption, priorities and spill/restore in the port, held to the JAX
package on the CPU.

On nemotron-4-15b, its int8-KV variant and deepseek-v3-671b smoke
(no-drop capacity; the JAX weights carried by ``repro_torch.bridge``):
a pool too small for two grown spans makes lazy growth hit the wall
and the worse-scored request spill itself to the Sidebar spill region
(``core.sidebar.SidebarSpillRegion``) and come back. The port's tight
drains give the JAX tight server's tokens, greedy and sampled, and its
preemption / restore / unstage counts, and equal the port's solo
``generate``. Also: lazy growth block by block as JAX grows, the spill
region's protocol errors, an eviction storm while spilled, EDF and FIFO
orders under an injected clock, ``cancel`` in every state, default
traffic without preemption, the pool's host round trip in place, and
``ensure_span``'s atomic rollback.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.core.sidebar import SidebarProtocolError as JaxProtocolError
from repro.core.sidebar import SidebarSpillRegion as JaxRegion
from repro.launch.sampling import SamplingParams as JSP
from repro.launch.scheduler import PagedContinuousBatchingServer as JaxPaged
from repro.models.registry import get_model as jget
from repro_torch import bridge
from repro_torch import configs as tcfg
from repro_torch.core.sidebar import SidebarProtocolError, SidebarSpillRegion
from repro_torch.launch import kvpool as kvp
from repro_torch.launch.faults import FaultInjector
from repro_torch.launch.sampling import SamplingParams
from repro_torch.launch.scheduler import (
    ContinuousBatchingServer,
    PagedContinuousBatchingServer,
)
from repro_torch.launch.serve import generate
from repro_torch.models.registry import get_model

ARCHS = ["nemotron-4-15b", "nemotron-int8", "deepseek-v3-671b"]
SP_KW = dict(temperature=0.8, top_k=40, seed=13)
TIGHT = dict(num_slots=2, max_len=48, block_size=8, num_blocks=6,
             segment=4)   # 5 allocatable blocks < two 3-block spans
COUNTS = ("preemptions", "restores", "spilled_blocks", "restored_blocks",
          "unstaged")


def _cfgs(arch):
    base = "nemotron-4-15b" if arch == "nemotron-int8" else arch
    cj, ct = jcfg.get_smoke_config(base), tcfg.get_smoke_config(base)
    if arch == "nemotron-int8":
        cj = dataclasses.replace(cj, kv_cache_dtype=jnp.int8)
        ct = dataclasses.replace(ct, kv_cache_dtype=torch.int8)
    if cj.num_experts:
        # no-drop capacity: co-batched rows share expert capacity
        cj = dataclasses.replace(cj, capacity_factor=float(cj.num_experts))
        ct = dataclasses.replace(ct, capacity_factor=float(ct.num_experts))
    return cj, ct


@pytest.fixture(scope="module")
def models():
    """arch -> (JAX cfg, port cfg, JAX params, port params)."""
    out, weights = {}, {}
    for arch in ARCHS:
        cj, ct = _cfgs(arch)
        base = "nemotron" if arch.startswith("nemotron") else arch
        if base not in weights:
            pj = jget(cj).init(jax.random.PRNGKey(0), cj)
            weights[base] = (pj, bridge.params_from_jax(
                jax.tree.map(np.asarray, pj), device="cpu"))
        out[arch] = (cj, ct, *weights[base])
    return out


def _tight_traffic(vocab, n=2, seed=3, size=6):
    """Requests spanning 23 positions (3 blocks) each."""
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, vocab, size=size).astype(np.int32), 24 - size)
            for _ in range(n)]


def _paged(ct, pt, **kw):
    return PagedContinuousBatchingServer(ct, pt, device="cpu",
                                         **{**TIGHT, **kw})


def _solo(ct, pt, prompt, gen, sample=None):
    return generate(ct, pt, torch.from_numpy(prompt)[None], gen, max_len=48,
                    device="cpu", sample=sample)[0, prompt.size:].numpy()


def _check_solo(ct, pt, done, reqs, samples=None):
    for r in done:
        prompt, gen = reqs[r.rid]
        sample = None if samples is None else samples.get(r.rid)
        assert r.generated == gen
        np.testing.assert_array_equal(
            r.tokens, _solo(ct, pt, prompt, gen, sample),
            err_msg=f"rid {r.rid}: preempted != solo")


def _assert_quiescent(srv):
    alloc = srv.mgr.alloc
    assert alloc.in_use == 0
    assert alloc.num_free + alloc.num_evictable == alloc.capacity
    assert len(srv.spill) == 0 and srv.spill.in_use_bytes == 0


# ---------------------------------------------------------------------------
# The tight drain against the JAX package and against solo decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("arch", ARCHS)
def test_tight_drain_matches_jax_and_solo(arch, sampled, models):
    cj, ct, pj, pt = models[arch]
    reqs = _tight_traffic(ct.vocab_size)
    # the later (victim) request samples in the sampled case
    jsamples = {0: None, 1: JSP(**SP_KW) if sampled else None}
    tsamples = {0: None, 1: SamplingParams(**SP_KW) if sampled else None}
    js = JaxPaged(cj, pj, **TIGHT)
    for rid, (p, g) in enumerate(reqs):
        js.submit(p, g, jsamples[rid])
    want = js.run()
    srv = _paged(ct, pt)
    for rid, (p, g) in enumerate(reqs):
        srv.submit(p, g, tsamples[rid])
    got = srv.run()
    assert srv.stats.preemptions > 0 and srv.stats.restores > 0
    assert ({k: srv.stats[k] for k in COUNTS}
            == {k: js.stats[k] for k in COUNTS})
    assert srv.stats.unstaged == 0
    for a, b in zip(got, want):
        assert a.rid == b.rid
        np.testing.assert_array_equal(a.tokens, np.asarray(b.tokens),
                                      err_msg=f"{arch} rid {a.rid}")
    _check_solo(ct, pt, got, reqs, tsamples)
    _assert_quiescent(srv)
    assert srv.spill.spills == srv.stats.preemptions
    assert srv.spill.peak_bytes == js.spill.peak_bytes


def test_lazy_growth_takes_the_blocks_jax_takes(models):
    """Staging takes the prompt's blocks only; the span grows a block
    at a time as decode reaches it, step for step as in the JAX
    server."""
    cj, ct, pj, pt = models["nemotron-4-15b"]
    kw = dict(num_slots=2, max_len=48, block_size=8, segment=4)
    prompts = [(np.arange(1, 7, dtype=np.int32), 20),
               (np.arange(3, 14, dtype=np.int32), 9)]
    js = JaxPaged(cj, pj, **kw)
    srv = PagedContinuousBatchingServer(ct, pt, device="cpu", **kw)
    traces = []
    for s in (js, srv):
        for p, g in prompts:
            s.submit(p, g)
        trace = []
        while s._has_work():
            s.step(draining=True)
            trace.append((tuple(len(rb.bids) if rb is not None else 0
                                for rb in s._slot_rb), s.mgr.alloc.in_use))
        traces.append(trace)
    assert traces[0] == traces[1]
    full = srv.mgr.blocks_needed(prompts[0][0].size + 20 - 1)
    assert traces[1][0][0][0] < full          # not the whole span up front
    assert srv.stats.preemptions == 0


# ---------------------------------------------------------------------------
# The spill region
# ---------------------------------------------------------------------------


_MISUSE = {
    "commit_unstaged": lambda r: r.commit(1, None, 8),
    "fetch_unknown": lambda r: r.fetch(1),
    "fetch_staged": lambda r: (r.stage(1), r.fetch(1)),
    "stage_twice": lambda r: (r.stage(1), r.stage(1)),
    "stage_live": lambda r: (r.stage(1), r.commit(1, None, 8), r.stage(1)),
    "commit_twice": lambda r: (r.stage(1), r.commit(1, None, 8),
                               r.commit(1, None, 8)),
    "release_unknown": lambda r: r.release(1),
    "release_twice": lambda r: (r.stage(1), r.release(1), r.release(1)),
    "overflow": lambda r: (r.stage(1), r.commit(1, None, 60),
                           r.stage(2), r.commit(2, None, 60)),
}


@pytest.mark.parametrize("case", sorted(_MISUSE))
def test_spill_region_raises_where_jax_raises(case):
    for region, err in ((SidebarSpillRegion(100), SidebarProtocolError),
                        (JaxRegion(100), JaxProtocolError)):
        with pytest.raises(err):
            _MISUSE[case](region)


def test_spill_region_lifecycle_and_accounting():
    regions = [SidebarSpillRegion(), JaxRegion()]
    for r in regions:
        r.stage(7)
        r.commit(7, "payload", 48)
        r.stage(8)
        r.commit(8, "other", 16)
        assert r.fetch(7) == "payload" and 7 in r and len(r) == 2
        r.release(7)
        r.release(8)
    a, b = ((r.spills, r.restores, r.in_use_bytes, r.peak_bytes, len(r))
            for r in regions)
    assert a == b == (2, 1, 0, 64, 0)


def test_spill_region_given_is_the_one_used(models):
    _, ct, _, pt = models["nemotron-4-15b"]
    region = SidebarSpillRegion()
    srv = _paged(ct, pt, spill_region=region)
    for p, g in _tight_traffic(ct.vocab_size):
        srv.submit(p, g)
    assert len(srv.run()) == 2
    assert srv.spill is region
    assert region.spills == srv.stats.preemptions > 0
    assert region.restores > 0 and region.peak_bytes > 0
    assert region.in_use_bytes == 0 and len(region) == 0


def test_eviction_storm_while_spilled_still_restores(models):
    """Every cached block evicted while a request sits spilled (its
    published prompt block among them): the restore rewrites from the
    host copy instead of splicing."""
    _, ct, _, pt = models["nemotron-4-15b"]
    srv = _paged(ct, pt)
    reqs = _tight_traffic(ct.vocab_size, size=10)
    for p, g in reqs:
        srv.submit(p, g)
    done, stormed = [], False
    while srv._has_work():
        done.extend(srv.step(draining=True))
        if srv._spilled and not stormed:
            stormed = True
            assert srv.mgr.alloc.evict_cached() > 0
            assert srv.mgr.alloc.num_evictable == 0
    assert stormed and len(done) == len(reqs) and srv.stats.restores > 0
    _check_solo(ct, pt, done, reqs)
    _assert_quiescent(srv)


# ---------------------------------------------------------------------------
# Priorities, EDF and FIFO (an injected clock: no wall time)
# ---------------------------------------------------------------------------


def _orders(server, submits, clock_ticks):
    t = iter(clock_ticks)
    server._clock = lambda: next(t)
    for p, g, kw in submits:
        server.submit(p, g, **kw)
    order = []
    while server._has_work():
        order.extend(r.rid for r in server.step(draining=True))
    return order


@pytest.mark.parametrize("mode", ["edf", "fifo"])
def test_priority_order_matches_jax(mode, models):
    """One slot, a low-priority backlog, then a high-priority request:
    EDF stages and admits it ahead of the queued lows (behind the one
    already decoding); FIFO keeps arrival order."""
    cj, ct, pj, pt = models["nemotron-4-15b"]
    rng = np.random.RandomState(11)
    submits = [(rng.randint(0, ct.vocab_size, size=5).astype(np.int32), 4,
                dict(priority=int(rid == 3))) for rid in range(4)]
    kw = dict(num_slots=1, max_len=48, block_size=8, segment=4,
              scheduling=mode)
    ticks = np.arange(0.0, 1e4, 0.5).tolist()
    want = _orders(JaxPaged(cj, pj, **kw), submits, ticks)
    got = _orders(PagedContinuousBatchingServer(ct, pt, device="cpu", **kw),
                  submits, ticks)
    assert got == want
    if mode == "fifo":
        assert got == [0, 1, 2, 3]
    else:
        assert got.index(3) < got.index(1) and got.index(3) < got.index(2)


def test_edf_orders_by_deadline_inside_a_class_as_jax(models):
    cj, ct, pj, pt = models["nemotron-4-15b"]
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, ct.vocab_size, size=5).astype(np.int32)
               for _ in range(3)]
    submits = [(prompts[0], 3, {}),                       # best-effort
               (prompts[1], 3, dict(ttft_target=100.0)),
               (prompts[2], 3, dict(ttft_target=1.0))]    # tightest
    kw = dict(num_slots=1, max_len=48, block_size=8, segment=4)
    ticks = [0.0] * 10_000
    js = JaxPaged(cj, pj, **kw)
    srv = PagedContinuousBatchingServer(ct, pt, device="cpu", **kw)
    assert _orders(srv, submits, ticks) == _orders(js, submits, ticks) \
        == [2, 1, 0]
    assert len(srv.stats.ttft_s[0]) == 3 and len(srv.stats.itl_s[0]) == 3
    assert srv.stats.ttft_tail(q=95, priority=0) == 0.0


def test_latency_tails_are_kept_per_class(models):
    _, ct, _, pt = models["nemotron-4-15b"]
    srv = PagedContinuousBatchingServer(ct, pt, device="cpu", num_slots=2,
                                        max_len=48, block_size=8, segment=4)
    t = iter(np.arange(0.0, 1e4, 0.25).tolist())
    srv._clock = lambda: next(t)
    for i in range(4):
        srv.submit(np.arange(2, 8 + i, dtype=np.int32), 5,
                   priority=i % 2, itl_target=0.5)
    srv.run()
    assert sorted(srv.stats.ttft_s) == [0, 1]
    assert len(srv.stats.ttft_s[1]) == len(srv.stats.itl_s[1]) == 2
    assert srv.stats.ttft_tail(priority=1) > 0.0
    assert np.isnan(srv.stats.itl_tail(priority=2))


@pytest.mark.parametrize("server", ["slots", "paged"])
def test_scheduling_mode_is_validated(server, models):
    _, ct, _, pt = models["nemotron-4-15b"]
    cls = (ContinuousBatchingServer if server == "slots"
           else PagedContinuousBatchingServer)
    with pytest.raises(ValueError, match="scheduling"):
        cls(ct, pt, device="cpu", num_slots=1, max_len=48,
            scheduling="lifo")


# ---------------------------------------------------------------------------
# cancel() in every state
# ---------------------------------------------------------------------------


def test_cancel_in_pending_staging_active_and_spilled(models):
    """At the first spill, cancel the spilled request and the last
    pending one; then a staging entry when one shows, then an active
    row: the survivors finish solo-exact and the pool drains clean."""
    _, ct, _, pt = models["nemotron-4-15b"]
    srv = _paged(ct, pt, stage_ahead=1)
    reqs = _tight_traffic(ct.vocab_size, n=6, seed=5, size=10)
    for p, g in reqs:
        srv.submit(p, g)
    cancelled: dict[str, int] = {}
    done = []

    def cancel(state, rid):
        assert srv.cancel(rid) and not srv.cancel(rid), state
        cancelled[state] = rid

    while srv._has_work():
        done.extend(srv.step(draining=True))
        if "spilled" not in cancelled:
            if srv._spilled:
                cancel("spilled", srv._spilled[0].req.rid)
                assert cancelled["spilled"] not in srv.spill
                cancel("pending", srv.pending[-1].rid)
        elif "staging" not in cancelled:
            if srv._staging:
                cancel("staging", srv._staging[0].req.rid)
        elif "active" not in cancelled:
            cancel("active", next(s.rid for s in srv.slots if not s.free))
    assert sorted(cancelled) == ["active", "pending", "spilled", "staging"]
    assert {r.rid for r in done} == (set(range(len(reqs)))
                                     - set(cancelled.values()))
    assert srv.stats.cancelled == 4
    _check_solo(ct, pt, done, reqs)
    _assert_quiescent(srv)


def test_cancel_on_the_slot_server(models):
    _, ct, _, pt = models["nemotron-4-15b"]
    srv = ContinuousBatchingServer(ct, pt, device="cpu", num_slots=2,
                                   max_len=48, segment=4)
    rng = np.random.RandomState(9)
    reqs = [(rng.randint(0, ct.vocab_size, size=5).astype(np.int32), 8)
            for _ in range(4)]
    for p, g in reqs:
        srv.submit(p, g)
    srv.step()                          # rids 0, 1 active; 2, 3 pending
    assert srv.cancel(2) and srv.cancel(0)
    assert not srv.cancel(2) and not srv.cancel(99)
    done = srv.run()
    assert sorted(r.rid for r in done) == [1, 3]
    assert srv.stats.cancelled == 2
    _check_solo(ct, pt, done, reqs)


# ---------------------------------------------------------------------------
# Default traffic is untouched by the machinery
# ---------------------------------------------------------------------------


def test_default_traffic_sees_no_preemption(models):
    _, ct, _, pt = models["nemotron-4-15b"]
    srv = PagedContinuousBatchingServer(ct, pt, device="cpu", num_slots=2,
                                        max_len=48, block_size=8, segment=4)
    rng = np.random.RandomState(17)
    reqs = [(rng.randint(0, ct.vocab_size,
                         size=rng.randint(2, 12)).astype(np.int32),
             int(rng.randint(1, 9))) for _ in range(5)]
    for p, g in reqs:
        srv.submit(p, g)
    done = srv.run()
    st = srv.stats
    assert len(done) == 5
    assert (st.preemptions, st.restores, st.unstaged, st.cancelled,
            st.spilled_blocks, st.restored_blocks) == (0,) * 6
    assert len(srv.spill) == 0 and srv.spill.spills == 0
    _check_solo(ct, pt, done, reqs)


# ---------------------------------------------------------------------------
# The pool's host round trip and lazy growth's rollback
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_read_write_blocks_round_trip_in_place(arch, models):
    _, ct, _, pt = models[arch]
    mgr = kvp.PagedKVManager(get_model(ct), ct, num_blocks=7, block_size=8,
                             device="cpu")
    pool = mgr.pool
    g = torch.Generator().manual_seed(0)
    for layer in pool.cache:
        for leaf in layer.values():
            if leaf.dtype.is_floating_point:
                leaf.copy_(torch.randn(leaf.shape, generator=g))
            else:
                leaf.copy_(torch.randint(-128, 127, leaf.shape, generator=g))
    ptrs = [leaf.data_ptr() for layer in pool.cache for leaf in layer.values()]
    before = [{k: v.clone() for k, v in layer.items()} for layer in pool.cache]
    blocks = pool.read_blocks([2, 5])
    assert kvp.payload_nbytes(blocks) == sum(
        2 * v[0].numel() * v.element_size()
        for layer in pool.cache for v in layer.values())
    for block in blocks:
        for layer, ref in zip(block, pool.cache):
            assert {k: v.dtype for k, v in layer.items()} == \
                {k: v.dtype for k, v in ref.items()}
            assert all(v.device.type == "cpu" for v in layer.values())
    pool.write_blocks([6, 1], blocks)
    assert ptrs == [leaf.data_ptr() for layer in pool.cache
                    for leaf in layer.values()]
    for layer, old in zip(pool.cache, before):
        for name, leaf in layer.items():
            assert torch.equal(leaf[6], old[name][2])
            assert torch.equal(leaf[1], old[name][5])
            for j in (0, 2, 3, 4, 5, 7):     # 7 is the drop sink
                assert torch.equal(leaf[j], old[name][j])


def test_ensure_span_rolls_back_atomically(models):
    _, ct, _, pt = models["nemotron-4-15b"]
    srv = PagedContinuousBatchingServer(ct, pt, device="cpu", num_slots=1,
                                        max_len=48, block_size=8)
    mgr = srv.mgr
    rb = mgr.begin_request(np.arange(1, 7, dtype=np.int32), 5)
    assert len(rb.bids) == 1
    state = (list(rb.bids), rb.span, mgr.alloc.num_free, mgr.alloc.in_use)
    faults = FaultInjector(0, script={"alloc": [3]})
    mgr.alloc.fault_hook = lambda: faults.fire("alloc")
    assert not mgr.ensure_span(rb, 30)          # the 3rd alloc fails
    assert (list(rb.bids), rb.span, mgr.alloc.num_free,
            mgr.alloc.in_use) == state
    assert mgr.ensure_span(rb, 30) and len(rb.bids) == 4
    assert rb.span == 32
    assert mgr.alloc.occupancy == 4 / mgr.alloc.capacity
    assert not mgr.ensure_span(rb, 8 * (mgr.alloc.capacity + 1))
    assert len(rb.bids) == 4                    # exhaustion: unchanged
    mgr.release_request(rb)
    assert mgr.alloc.in_use == 0
