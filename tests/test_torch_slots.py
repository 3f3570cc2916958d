"""The port's slot-cache ``ContinuousBatchingServer``, and sampled
requests through the paged server, held to the JAX package on the CPU
on the same weights (``repro_torch.bridge``).

Across frameworks: the slot-cache server's tokens equal JAX's on mixed
greedy and sampled traffic (``SP = SamplingParams(temperature=0.9,
top_k=50, top_p=0.95, seed=11)`` on every other request) for nemotron,
nemotron with int8 KV and deepseek-v3 (no-drop capacity), with JAX's
executable-cache counts.

Inside the port, the invariants of the JAX package's
``tests/test_continuous_batching.py``: slot == solo decode, slots reused
and the cache persistent, repeat traffic never recompiles, admission
into freed slots, bucketing pads without changing tokens,
``probe_batch_axes`` finds every leaf, buckets past ``max_len`` are
dropped, aligned == ragged, batched admission, hysteresis times out,
bad requests and families rejected; the stats' tails, summary and the
segment watchdog.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.launch.sampling import SamplingParams as JSP
from repro.launch.scheduler import ContinuousBatchingServer as JaxSlots
from repro.models.registry import get_model as jget
from repro_torch import bridge
from repro_torch import configs as tcfg
from repro_torch.launch import kvpool as kvp
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.sampling import SamplingParams
from repro_torch.launch.scheduler import (
    ContinuousBatchingServer,
    SchedulerStats,
    probe_batch_axes,
)
from repro_torch.launch.serve import Server
from repro_torch.models.registry import get_model

ARCHS = ["nemotron-4-15b", "nemotron-int8", "deepseek-v3-671b"]
SP_KW = dict(temperature=0.9, top_k=50, top_p=0.95, seed=11)
SP = SamplingParams(**SP_KW)


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
def served():
    """arch -> (JAX cfg, port cfg, JAX params, port params, port Server)."""
    out = {}
    weights = {}
    for arch in ARCHS:
        cj, ct = _cfgs(arch)
        base = "nemotron" if arch.startswith("nemotron") else arch
        if base not in weights:
            pj = jget(cj).init(jax.random.PRNGKey(0), cj)
            weights[base] = (pj, bridge.params_from_jax(
                jax.tree.map(np.asarray, pj), device="cpu"))
        pj, pt = weights[base]
        out[arch] = (cj, ct, pj, pt,
                     Server(ct, pt, max_len=48, device="cpu"))
    return out


# ---------------------------------------------------------------------------
# The slot-cache server
# ---------------------------------------------------------------------------


def _traffic(vocab, n, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, vocab, size=rng.randint(2, 14)).astype(np.int32),
             int(rng.randint(1, 9))) for _ in range(n)]


def _slots(ct, pt, **kw):
    return ContinuousBatchingServer(ct, pt, device="cpu", **{
        "num_slots": 2, "max_len": 48, "buckets": (8,), "segment": 4, **kw})


def _solo(server, prompt, gen, sample=None) -> np.ndarray:
    return server.generate(prompt[None], gen, decode="loop",
                           sample=sample).tokens[0, prompt.size:].numpy()


@pytest.mark.parametrize("arch", ARCHS)
def test_slot_server_matches_jax_greedy_and_sampled(served, arch):
    """Mixed traffic (every other request sampled with SP, the rest
    greedy) through bucketed batched admission and slot churn."""
    cj, ct, pj, pt, server = served[arch]
    reqs = _traffic(ct.vocab_size, 5, seed=3)
    js = JaxSlots(cj, pj, num_slots=2, max_len=48, buckets=(8, 16),
                  segment=4)
    ts = _slots(ct, pt, buckets=(8, 16))
    for i, (p, g) in enumerate(reqs):
        js.submit(p, g, sample=JSP(**SP_KW) if i % 2 == 0 else None)
        ts.submit(p, g, sample=SP if i % 2 == 0 else None)
    want, got = js.run(), ts.run()
    assert [r.rid for r in got] == [r.rid for r in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.tokens, np.asarray(b.tokens),
                                      err_msg=f"{arch} rid {a.rid}")
    # executable keys and counts as JAX's
    assert ts.stats.compiles == js.stats.compiles
    assert ts.stats.hits == js.stats.hits
    assert {k[:2] + k[3:4] for k in ts.executable_cache_keys()
            if k[0] == "segment"} == {
        k[:2] + k[3:4] for k in js.executable_cache_keys()
        if k[0] == "segment"}
    # and each request == solo row 0 of the port's Server
    for i, r in enumerate(got):
        p, g = reqs[r.rid]
        np.testing.assert_array_equal(
            r.tokens, _solo(server, p, g, SP if i % 2 == 0 else None))


@pytest.mark.parametrize("arch", ["nemotron-4-15b", "deepseek-v3-671b"])
def test_continuous_matches_solo_decode(served, arch):
    _, ct, _, pt, server = served[arch]
    sched = _slots(ct, pt, num_slots=3, buckets=(8, 16))
    reqs = _traffic(ct.vocab_size, 7, seed=3)
    rids = [sched.submit(p, g) for p, g in reqs]
    done = sched.run()
    assert [r.rid for r in done] == rids
    for r in done:
        prompt, gen = reqs[r.rid]
        assert r.generated == gen
        np.testing.assert_array_equal(r.tokens, _solo(server, prompt, gen))


def test_slots_are_reused_and_cache_is_persistent(served):
    _, ct, _, pt, _ = served["nemotron-4-15b"]
    sched = _slots(ct, pt)
    leaves = [leaf for layer in sched.cache for leaf in layer.values()]
    for p, g in _traffic(ct.vocab_size, 5, seed=4):
        sched.submit(p, g)
    assert len(sched.run()) == 5
    assert sched.stats["admitted"] == 5
    assert all(s.free for s in sched.slots)
    after = [leaf for layer in sched.cache for leaf in layer.values()]
    assert all(a is b for a, b in zip(leaves, after))   # never reallocated
    for layer, axes in zip(sched.cache, sched.axes):
        for name, leaf in layer.items():
            assert leaf.shape[axes[name]] == 2


def test_repeat_traffic_never_recompiles(served):
    _, ct, _, pt, _ = served["nemotron-4-15b"]
    sched = _slots(ct, pt, buckets=(8, 16))
    wave = _traffic(ct.vocab_size, 4, seed=5)
    for p, g in wave:
        sched.submit(p, g)
    first = [r.tokens for r in sched.run()]
    compiles, keys = sched.stats["compiles"], sched.executable_cache_keys()
    assert compiles == len(keys)
    assert {k[0] for k in keys} == {"prefill", "segment"}
    for p, g in wave:
        sched.submit(p, g)
    again = [r.tokens for r in sched.run()]
    assert sched.stats["compiles"] == compiles
    assert sched.executable_cache_keys() == keys
    assert sched.stats.exec_hit_rate > 0.5
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)


def test_admission_into_freed_slots_between_segments(served):
    _, ct, _, pt, _ = served["nemotron-4-15b"]
    sched = _slots(ct, pt, num_slots=1, segment=3)
    for p, g in _traffic(ct.vocab_size, 3, seed=6):
        sched.submit(p, g)
    seen = []
    while sched.pending or any(not s.free for s in sched.slots):
        seen += [r.rid for r in sched.step()]
    assert seen == [0, 1, 2]
    assert sched.stats["admitted"] == 3


def test_bucketing_pads_without_changing_tokens(served):
    _, ct, _, pt, server = served["nemotron-4-15b"]
    sched = _slots(ct, pt)
    rng = np.random.RandomState(9)
    prompts = [rng.randint(0, ct.vocab_size, size=n).astype(np.int32)
               for n in (3, 9, 1)]                # short, exact fit, single
    for p in prompts:
        sched.submit(p, 6)
    for r, p in zip(sched.run(), prompts):
        np.testing.assert_array_equal(r.tokens, _solo(server, p, 6))


@pytest.mark.parametrize("arch", ARCHS)
def test_probe_batch_axes_finds_every_leaf(served, arch):
    _, ct, *_ = served[arch]
    api = get_model(ct)
    axes = probe_batch_axes(api, ct, 32)
    for layer, ax in zip(api.cache_shapes(ct, 5, 32), axes):
        assert set(layer) == set(ax)
        for name, (shape, _) in layer.items():
            assert shape[ax[name]] == 5, (arch, name, shape)
    assert kvp.probe_batch_axes is probe_batch_axes


def test_buckets_longer_than_max_len_are_dropped(served):
    _, ct, _, pt, _ = served["nemotron-4-15b"]
    sched = _slots(ct, pt, num_slots=1, max_len=50,
                   buckets=(16, 32, 64, 128))
    assert sched.buckets == (16, 32)
    prompt = np.random.RandomState(11).randint(0, ct.vocab_size, 40).astype(
        np.int32)
    assert sched.bucket_for(prompt.size - 1) == 39
    sched.submit(prompt, 5)
    (r,) = sched.run()
    solo = Server(ct, pt, max_len=50, device="cpu")
    np.testing.assert_array_equal(r.tokens, _solo(solo, prompt, 5))


def test_aligned_segments_equal_ragged(served):
    """Every slot at one position keys the 'aligned' program, unaligned
    slots the 'ragged' one; both give solo decode's tokens."""
    _, ct, _, pt, server = served["nemotron-4-15b"]
    rng = np.random.RandomState(13)
    for lens, kind in (((6, 6), "aligned"), ((4, 9), "ragged")):
        sched = _slots(ct, pt)
        prompts = [rng.randint(0, ct.vocab_size, size=n).astype(np.int32)
                   for n in lens]
        for p in prompts:
            sched.submit(p, 6)
        done = sched.run()
        kinds = {k[3] for k in sched.executable_cache_keys()
                 if k[0] == "segment"}
        assert kind in kinds and (kind == "ragged" or kinds == {"aligned"})
        for r, p in zip(done, prompts):
            np.testing.assert_array_equal(r.tokens, _solo(server, p, 6))


def test_admission_rounds_are_batched(served):
    _, ct, _, pt, server = served["nemotron-4-15b"]
    sched = _slots(ct, pt, admit_batch=2)
    rng = np.random.RandomState(17)
    reqs = [(rng.randint(0, ct.vocab_size, size=rng.randint(2, 8)).astype(
        np.int32), 5) for _ in range(6)]
    for p, g in reqs:
        sched.submit(p, g)
    done = sched.run()
    assert {k[1] for k in sched.executable_cache_keys()
            if k[0] == "prefill"} == {2}
    for r in done:
        np.testing.assert_array_equal(r.tokens, _solo(server, *reqs[r.rid]))


def test_admission_hysteresis_times_out_behind_long_request(served):
    _, ct, _, pt, _ = served["nemotron-4-15b"]
    sched = _slots(ct, pt, max_len=64, admit_batch=2)
    rng = np.random.RandomState(19)
    long_p = rng.randint(0, ct.vocab_size, size=4).astype(np.int32)
    short_p = rng.randint(0, ct.vocab_size, size=4).astype(np.int32)
    sched.submit(long_p, 40)
    for _ in range(3):
        sched.submit(short_p, 3)
    drained, iterations = [], 0
    while len(drained) < 3:
        drained += [r.rid for r in sched.step()]
        iterations += 1
        assert iterations < 25
    assert drained == [1, 2, 3]
    assert sched.stats["admit_deferrals"] >= 1
    assert any(not s.free for s in sched.slots)
    assert 0 in {r.rid for r in sched.run()}


def test_slot_tokens_and_load(served):
    _, ct, _, pt, _ = served["nemotron-4-15b"]
    sched = _slots(ct, pt, num_slots=1, segment=3)
    sched.submit(np.arange(1, 6, dtype=np.int32), 7)
    sched.submit(np.arange(1, 4, dtype=np.int32), 2)
    assert sched.load == 2
    sched._advance()
    part = sched.slot_tokens(0)
    assert part.dtype == np.int32 and part.size == sched.slots[0].generated
    (r, _) = sched.run()
    np.testing.assert_array_equal(r.tokens[:part.size], part)
    assert r.generated == 7 and sched.load == 0


def test_scheduler_rejects_unsupported_family_and_bad_requests(served):
    _, ct, _, pt, _ = served["nemotron-4-15b"]
    sched = _slots(ct, pt, num_slots=1, max_len=16)
    with pytest.raises(ValueError, match="max_len"):
        sched.submit(np.arange(10, dtype=np.int32), 10)
    with pytest.raises(ValueError, match="max_new_tokens"):
        sched.submit(np.arange(4, dtype=np.int32), 0)
    with pytest.raises(ValueError, match="empty"):
        sched.submit(np.zeros((0,), np.int32), 4)
    # priorities and SLO targets are ported (ROADMAP Queue 1 item 4)
    rid = sched.submit(np.arange(4, dtype=np.int32), 2, priority=1,
                       ttft_target=5.0, itl_target=1.0)
    (done,) = sched.run()
    assert done.rid == rid and done.generated == 2
    assert list(sched.stats.ttft_s) == [1]
    with pytest.raises(ValueError, match="families"):
        _slots(dataclasses.replace(ct, family="audio"), pt)
    with pytest.raises(ValueError, match="scheduling"):
        _slots(ct, pt, scheduling="bogus")
    assert _slots(ct, pt, scheduling="fifo").scheduling == "fifo"
    # tensor parallelism is ported (ROADMAP Queue 1 item 6): an object
    # that is no mesh is refused by mesh_info's check, as in the JAX
    # package; a host mesh serves the meshless tokens
    with pytest.raises(ValueError, match="canonical"):
        _slots(ct, pt, mesh=object())
    meshed = _slots(ct, pt, mesh=make_host_mesh(device="cpu"))
    plain = _slots(ct, pt)
    for srv in (meshed, plain):
        srv.submit(np.arange(1, 7, dtype=np.int32), 4)
    (a,), (b,) = meshed.run(), plain.run()
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert all(k[-1] == ((1, 1), ("data", "model"))
               for k in meshed.executable_cache_keys())


# ---------------------------------------------------------------------------
# Stats and the watchdog
# ---------------------------------------------------------------------------


def test_stats_tails_summary_and_watchdog(served):
    _, ct, _, pt, _ = served["nemotron-4-15b"]
    sched = _slots(ct, pt)
    ticks = iter(np.arange(0.0, 1e4, 0.001).tolist())
    times = [0.01] * 10 + [5.0] + [0.01] * 40
    clock = iter(np.cumsum([t for pair in zip(times, times)
                            for t in (0.0, pair[0])]).tolist())
    sched._timer = lambda: next(clock)
    sched._clock = lambda: next(ticks)
    for p, g in _traffic(ct.vocab_size, 8, seed=21):
        sched.submit(p, g + 8)
    sched.run()
    st = sched.stats
    assert st.watchdog_events == 1 and len(sched.watchdog.events) == 1
    assert len(st.ttft_s[0]) == 8 and st.ttft_tail(50) > 0
    assert st.itl_tail(95, priority=0) == st.itl_tail(95)
    assert np.isnan(SchedulerStats().ttft_tail())
    assert 0 <= st.wasted_step_frac < 1
    text = st.summary()
    assert "executable cache" in text and "watchdog" in text
    assert st["segments"] == st.segments
