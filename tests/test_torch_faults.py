"""Fault injection and the replica router in the port, held to the JAX
package on the CPU.

``launch.faults.FaultInjector`` fires at the consultations where
``repro.launch.faults.FaultInjector`` fires (same seed, rates, scripts,
``max_per_site`` and order of consultation). A faulted paged drain on
nemotron-4-15b smoke (the JAX weights carried by ``repro_torch.bridge``)
gives the JAX faulted drain's tokens and fault log, equals the unfaulted
solo decode and leaks nothing; a scripted allocation failure rolls
staging back. ``launch.router.ReplicaRouter`` makes the JAX router's
choices: prefix-affinity and seeded random placement, quarantine with
exponential backoff on ``dispatch:i`` faults, work stealing of spilled
requests, fleet cancel and the summed ``FleetStats``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.launch.faults import FaultInjector as JaxInjector
from repro.launch.router import ReplicaRouter as JaxRouter
from repro.launch.scheduler import PagedContinuousBatchingServer as JaxPaged
from repro.models.registry import get_model as jget
from repro_torch import bridge
from repro_torch import configs as tcfg
from repro_torch.launch.faults import FaultInjector, FaultRecord
from repro_torch.launch.router import FleetStats, ReplicaRouter, sum_stats
from repro_torch.launch.scheduler import (
    PagedContinuousBatchingServer,
    SchedulerStats,
)
from repro_torch.launch.serve import generate

SMALL = dict(num_slots=2, max_len=48, block_size=8, segment=4)


@pytest.fixture(scope="module")
def nemotron():
    """(JAX cfg, port cfg, JAX params, port params)."""
    cj = jcfg.get_smoke_config("nemotron-4-15b")
    ct = tcfg.get_smoke_config("nemotron-4-15b")
    pj = jget(cj).init(jax.random.PRNGKey(0), cj)
    pt = bridge.params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    return cj, ct, pj, pt


def _traffic(vocab, n, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, vocab, size=rng.randint(3, 10)).astype(np.int32),
             int(rng.randint(2, 8))) for _ in range(n)]


def _check_solo(ct, pt, done, reqs, fids=None):
    for r in done:
        prompt, gen = reqs[r.rid if fids is None else fids.index(r.rid)]
        solo = generate(ct, pt, torch.from_numpy(prompt)[None], gen,
                        max_len=48, device="cpu")[0, prompt.size:].numpy()
        np.testing.assert_array_equal(r.tokens, solo,
                                      err_msg=f"rid {r.rid} != solo")


def _assert_quiescent(srv):
    alloc = srv.mgr.alloc
    assert alloc.in_use == 0
    assert alloc.num_free + alloc.num_evictable == alloc.capacity
    assert len(srv.spill) == 0 and srv.spill.in_use_bytes == 0


def _same_results(got, want):
    assert [r.rid for r in got] == [r.rid for r in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.tokens, np.asarray(b.tokens),
                                      err_msg=f"rid {a.rid}")


_COUNTERS = [f.name for f in dataclasses.fields(SchedulerStats)
             if f.name not in ("ttft_s", "itl_s")]


def _counters(stats) -> dict:
    return {k: stats[k] for k in _COUNTERS}


# ---------------------------------------------------------------------------
# The injector
# ---------------------------------------------------------------------------


_INJECTORS = {
    "rates": dict(seed=7, rates={"alloc": 0.3, "dispatch": 0.2}),
    "other_seed": dict(seed=8, rates={"alloc": 0.3, "dispatch": 0.2}),
    "exact_key_wins": dict(seed=1, rates={"dispatch": 0.5,
                                          "dispatch:1": 0.9}),
    "budget": dict(seed=0, rates={"alloc": 1.0, "stage_stall": 0.6},
                   max_per_site=3),
    "script": dict(seed=0, script={"alloc": [2, 5], "dispatch:0": [1]},
                   max_per_site=0),
    "script_and_rates": dict(seed=4, rates={"evict_storm": 0.4},
                             script={"evict_storm": [3], "alloc": [9]},
                             max_per_site=5),
}


@pytest.mark.parametrize("case", sorted(_INJECTORS))
def test_injector_fires_where_jax_fires(case):
    kw = dict(_INJECTORS[case])
    seed = kw.pop("seed")
    port, ref = FaultInjector(seed, **kw), JaxInjector(seed, **kw)
    sites = ["alloc", "evict_storm", "stage_stall", "dispatch:0",
             "dispatch:1", "dispatch:2"]
    order = np.random.RandomState(3).randint(0, len(sites), 400)
    got = [port.fire(sites[i]) for i in order]
    want = [ref.fire(sites[i]) for i in order]
    assert got == want
    assert [(r.site, r.call) for r in port.log] == \
        [(r.site, r.call) for r in ref.log]
    assert port.total_injected == ref.total_injected
    assert dict(port.calls) == dict(ref.calls)
    assert dict(port.injected) == dict(ref.injected)


def test_injector_script_and_budget():
    fi = FaultInjector(0, script={"alloc": [2, 5]})
    assert [fi.fire("alloc") for _ in range(6)] == \
        [False, True, False, False, True, False]
    assert fi.log == [FaultRecord("alloc", 2), FaultRecord("alloc", 5)]
    storm = FaultInjector(0, rates={"alloc": 1.0}, max_per_site=3)
    assert sum(storm.fire("alloc") for _ in range(50)) == 3
    assert FaultInjector(0, script={"alloc": [1]}, max_per_site=0).fire(
        "alloc")                        # scripts ignore the budget


# ---------------------------------------------------------------------------
# Faulted drains
# ---------------------------------------------------------------------------


_RATES = {"alloc": 0.10, "evict_storm": 0.15, "stage_stall": 0.15}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_faulted_drain_matches_jax_and_solo(seed, nemotron):
    """Allocation failures, eviction storms and staging stalls mid-run
    on a tight pool: the port's drain gives the JAX drain's tokens,
    fault log and counters, the unfaulted solo tokens, and leaks
    nothing."""
    cj, ct, pj, pt = nemotron
    reqs = _traffic(ct.vocab_size, 6, seed=seed + 10)
    runs = []
    for server, injector, params, cfg, kw in (
            (JaxPaged, JaxInjector, pj, cj, {}),
            (PagedContinuousBatchingServer, FaultInjector, pt, ct,
             dict(device="cpu"))):
        faults = injector(seed, rates=_RATES, max_per_site=8)
        srv = server(cfg, params, num_blocks=8, faults=faults,
                     **SMALL, **kw)
        for p, g in reqs:
            srv.submit(p, g)
        runs.append((srv, faults, srv.run()))
    (js, jf, want), (srv, faults, got) = runs
    assert faults.total_injected > 0, "no fault fired"
    assert [(r.site, r.call) for r in faults.log] == \
        [(r.site, r.call) for r in jf.log]
    assert _counters(srv.stats) == _counters(js.stats)
    _same_results(got, want)
    _check_solo(ct, pt, got, reqs)
    _assert_quiescent(srv)


def test_faulted_run_replays_exactly(nemotron):
    _, ct, _, pt = nemotron
    runs = []
    for _ in range(2):
        faults = FaultInjector(3, rates={"alloc": 0.2, "stage_stall": 0.2},
                               max_per_site=6)
        srv = PagedContinuousBatchingServer(ct, pt, device="cpu",
                                            num_blocks=8, faults=faults,
                                            **SMALL)
        for p, g in _traffic(ct.vocab_size, 5, seed=42):
            srv.submit(p, g)
        order = []
        while srv._has_work():
            order.extend(r.rid for r in srv.step(draining=True))
        runs.append((list(faults.log), order))
    assert runs[0] == runs[1] and runs[0][0]


def test_scripted_alloc_failure_rolls_staging_back(nemotron):
    """The very first allocation fails: that staging attempt unwinds
    (a stall, not a crash) and the next boundary stages it."""
    _, ct, _, pt = nemotron
    faults = FaultInjector(0, script={"alloc": [1]})
    srv = PagedContinuousBatchingServer(ct, pt, device="cpu", faults=faults,
                                        **SMALL)
    reqs = _traffic(ct.vocab_size, 3, seed=1)
    for p, g in reqs:
        srv.submit(p, g)
    srv.step()
    assert faults.log == [FaultRecord("alloc", 1)]
    assert srv.stats.stage_stalls == 1
    assert srv.mgr.alloc.in_use == sum(len(st.rb.bids) for st in
                                       srv._staging) + sum(
        len(rb.bids) for rb in srv._slot_rb if rb is not None)
    done = srv.run()                    # every request finished so far
    assert len(done) == 3
    _check_solo(ct, pt, done, reqs)
    _assert_quiescent(srv)


@pytest.mark.parametrize("seed", [11, 12])
def test_random_faulted_interleavings_match_jax(seed, nemotron):
    """Random traffic, random cancels, random fault rates, a step-wise
    drain: the port finishes what JAX finishes with its tokens, every
    survivor equals solo decode, and the pool and spill region end
    empty."""
    cj, ct, pj, pt = nemotron
    reqs = _traffic(ct.vocab_size, 8, seed=seed)
    rates = {"alloc": 0.08, "evict_storm": 0.1, "stage_stall": 0.1}
    runs = []
    for server, injector, params, cfg, kw in (
            (JaxPaged, JaxInjector, pj, cj, {}),
            (PagedContinuousBatchingServer, FaultInjector, pt, ct,
             dict(device="cpu"))):
        rng = np.random.RandomState(seed)
        faults = injector(seed, rates=rates, max_per_site=6)
        srv = server(cfg, params, num_blocks=8, faults=faults, **SMALL,
                     **kw)
        submitted, cancelled, finished = [], set(), []
        for p, g in reqs:
            submitted.append(srv.submit(p, g))
            if rng.rand() < 0.5:
                finished.extend(srv.step())
            if rng.rand() < 0.25:
                victim = submitted[int(rng.randint(len(submitted)))]
                if victim not in cancelled and srv.cancel(victim):
                    cancelled.add(victim)
        while srv._has_work():
            finished.extend(srv.step(draining=True))
        assert {r.rid for r in finished} == set(submitted) - cancelled
        runs.append((srv, sorted(finished, key=lambda r: r.rid),
                     cancelled))
    (js, want, jc), (srv, got, tc) = runs
    assert tc == jc
    _same_results(got, want)
    _check_solo(ct, pt, got, reqs)
    _assert_quiescent(srv)


# ---------------------------------------------------------------------------
# The router
# ---------------------------------------------------------------------------


def _fleets(nemotron, n=2, *, num_blocks=None, faults=None, **kw):
    """(port fleet, JAX fleet) of ``n`` replicas each, the port's
    sharing one params dict."""
    cj, ct, pj, pt = nemotron
    port = ReplicaRouter(
        [PagedContinuousBatchingServer(ct, pt, device="cpu",
                                       num_blocks=num_blocks, **SMALL)
         for _ in range(n)],
        faults=None if faults is None else FaultInjector(**faults), **kw)
    ref = JaxRouter(
        [JaxPaged(cj, pj, num_blocks=num_blocks, **SMALL)
         for _ in range(n)],
        faults=None if faults is None else JaxInjector(**faults), **kw)
    return port, ref


def _fleet_fields(stats) -> dict:
    return {f.name: getattr(stats, f.name)
            for f in dataclasses.fields(FleetStats) if f.name != "totals"}


def test_random_and_prefix_placement_match_jax(nemotron):
    cj, ct, pj, pt = nemotron
    rng = np.random.RandomState(6)
    head = rng.randint(0, ct.vocab_size, 17).astype(np.int32)
    prompts = [np.concatenate([head, rng.randint(0, ct.vocab_size, 4)])
               .astype(np.int32) if i % 3 else
               rng.randint(0, ct.vocab_size, 9).astype(np.int32)
               for i in range(9)]
    for policy in ("random", "prefix"):
        port, ref = _fleets(nemotron, 3, policy=policy, seed=5)
        for fleet in (port, ref):
            for i, p in enumerate(prompts):
                fleet.submit(p, 3)
                if i == 4:              # publish the first prompts' blocks
                    fleet.run()
        assert port._placement == ref._placement, policy
        assert _fleet_fields(port.stats) == _fleet_fields(ref.stats)
        got, want = port.run(), ref.run()
        _same_results(got, want)
        for rep in port.replicas:
            _assert_quiescent(rep)
    assert port.stats.affinity_routed > 0


def test_probes_have_no_side_effects(nemotron):
    _, ct, _, pt = nemotron
    srv = PagedContinuousBatchingServer(ct, pt, device="cpu", **SMALL)
    prompt = np.arange(1, 20, dtype=np.int32)
    srv.submit(prompt, 2)
    srv.run()
    before = dataclasses.asdict(srv.mgr.counters)
    evictable = list(srv.mgr.alloc._evictable)
    assert srv.mgr.prefix_affinity(prompt) == 2
    other = prompt.copy()
    other[:8] += 1                       # the leading block misses
    assert srv.mgr.prefix_affinity(other) == 0
    assert srv.mgr.chunk_affinity(other) == 0   # chained keys: no hit
    assert srv.mgr.chunk_affinity(prompt) == 2
    assert dataclasses.asdict(srv.mgr.counters) == before
    assert list(srv.mgr.alloc._evictable) == evictable
    # ``lookup`` is the counted probe
    key = srv.mgr._prompt_keys(prompt, 1)[0][0]
    assert srv.mgr.alloc.peek(key) == srv.mgr.alloc.lookup(key) is not None
    assert srv.mgr.counters.prefix_block_lookups == \
        before["prefix_block_lookups"] + 1
    assert srv.mgr.counters.prefix_block_hits == \
        before["prefix_block_hits"] + 1


def test_dispatch_faults_quarantine_with_backoff_as_jax(nemotron):
    """Three consecutive dispatch errors quarantine replica 0; a second
    burst during the reprobe doubles the backoff; its queued work
    finishes once the backoff expires — step for step as the JAX
    router."""
    _, ct, _, pt = nemotron
    port, ref = _fleets(nemotron, faults=dict(
        seed=0, script={"dispatch:0": [1, 2, 3, 4]}),
        quarantine_after=3, backoff_steps=2)
    reqs = _traffic(ct.vocab_size, 4, seed=2)
    trace = {}
    for name, fleet in (("port", port), ("jax", ref)):
        fids = [fleet.submit(p, g) for p, g in reqs]
        steps, done = [], []
        while any(r._has_work() for r in fleet.replicas):
            done.extend(fleet.step(draining=True))
            h = fleet._health[0]
            steps.append((fleet.quarantined, h.consecutive_errors,
                          h.backoff, h.quarantined_until))
        trace[name] = (fids, steps, _fleet_fields(fleet.stats),
                       sorted(done, key=lambda r: r.rid))
    assert trace["port"][:3] == trace["jax"][:3]
    _same_results(trace["port"][3], trace["jax"][3])
    assert port.stats.dispatch_errors == 4
    assert port.stats.quarantine_events >= 2
    assert port.quarantined == [] and port.load == 0
    _check_solo(ct, pt, trace["port"][3], reqs, trace["port"][0])


def test_work_stealing_matches_jax(nemotron):
    """Same-prefix traffic concentrates on one replica; its tight pool
    preempts and the router migrates the spilled request (its payload
    of CPU tensors as it is) to the idle sibling."""
    _, ct, _, pt = nemotron
    port, ref = _fleets(nemotron, num_blocks=6)
    rng = np.random.RandomState(4)
    head = rng.randint(0, ct.vocab_size, size=6).astype(np.int32)
    reqs = [(head.copy(), 18) for _ in range(3)]
    results = []
    for fleet in (port, ref):
        fids = [fleet.submit(p, g) for p, g in reqs]
        results.append((fids, fleet.run()))
    assert port.stats.totals.preemptions > 0 and port.stats.stolen > 0
    assert _fleet_fields(port.stats) == _fleet_fields(ref.stats)
    assert _counters(port.stats.totals) == _counters(ref.stats.totals)
    _same_results(results[0][1], results[1][1])
    _check_solo(ct, pt, results[0][1], reqs, results[0][0])
    assert port.load == 0
    for rep in port.replicas:
        _assert_quiescent(rep)
    assert port.replicas[0].params is port.replicas[1].params


def test_fleet_cancel_by_fleet_rid(nemotron):
    _, ct, _, pt = nemotron
    port, ref = _fleets(nemotron)
    reqs = _traffic(ct.vocab_size, 4, seed=5)
    results = []
    for fleet in (port, ref):
        fids = [fleet.submit(p, g) for p, g in reqs]
        assert fleet.cancel(fids[1])
        assert not fleet.cancel(fids[1]) and not fleet.cancel(999)
        results.append((fids, fleet.run()))
    (fids, done), (_, want) = results
    assert {r.rid for r in done} == set(fids) - {fids[1]}
    assert port.stats.totals.cancelled == 1
    assert _fleet_fields(port.stats) == _fleet_fields(ref.stats)
    assert _counters(port.stats.totals) == _counters(ref.stats.totals)
    _same_results(done, want)
    _check_solo(ct, pt, done, reqs, fids)


def test_healthy_fleet_and_sum_stats(nemotron):
    _, ct, _, pt = nemotron
    port = ReplicaRouter([PagedContinuousBatchingServer(
        ct, pt, device="cpu", **SMALL) for _ in range(2)])
    fids = [port.submit(p, g) for p, g in _traffic(ct.vocab_size, 4, 3)]
    assert len(port.run()) == len(fids)
    st = port.stats
    assert (st.dispatch_errors, st.quarantine_events, st.stolen) == (0,) * 3
    total = sum_stats([r.stats for r in port.replicas])
    assert total.admitted == 4 == st.totals.admitted
    assert sum(len(v) for v in total.ttft_s.values()) == 4
    assert "fleet: 4 requests" in st.summary()
    with pytest.raises(ValueError, match="policy"):
        ReplicaRouter(port.replicas, policy="round_robin")
    with pytest.raises(ValueError, match="replica"):
        ReplicaRouter([])
