"""Speculative decoding in the port, held to the JAX package on the CPU.

On nemotron-4-15b, its int8-KV variant and deepseek-v3-671b smoke
(no-drop capacity; the JAX weights carried by ``repro_torch.bridge``),
mirroring ``tests/test_spec_decode.py``: the port's speculative paged
server gives the JAX speculative server's greedy and sampled tokens and
its spec counters, and equals the port's solo ``generate``; the oracle
draft is accepted whole; a rejected draft leaves the allocator's
counters as plain decode leaves them; a worthless draft still makes
progress and stays exact; ``k=0`` is plain decode with the plain
programs; ``SpecConfig.validate`` refuses what JAX refuses; the
tight-pool drain gives JAX's tokens and preemption counts; prefix hits
under speculation; and ``make_verify_step`` / ``make_draft_program``
against JAX's at the function level. One JAX drain a family and arm, in
a module fixture; the rest is held to the port's solo decode, which the
earlier test files hold to JAX. The captured programs and the card's
cases are in ``test_torch_spec_capture.py``, which imports no JAX.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.launch import spec as jspec
from repro.launch.sampling import SamplingParams as JSP
from repro.launch.scheduler import PagedContinuousBatchingServer as JaxPaged
from repro.launch.serve import make_verify_step as jax_verify_step
from repro.models import layers as JL
from repro.models.registry import get_model as jget
from repro_torch import bridge
from repro_torch import configs as tcfg
from repro_torch.kernels import ops as kops
from repro_torch.launch import kvpool as kvp
from repro_torch.launch.sampling import SamplingParams
from repro_torch.launch.scheduler import PagedContinuousBatchingServer
from repro_torch.launch.serve import generate, make_verify_step
from repro_torch.launch.spec import (
    SpecConfig,
    accepted_prefix,
    make_draft_program,
)
from repro_torch.models.registry import get_model

ARCHS = ["nemotron-4-15b", "nemotron-int8", "deepseek-v3-671b"]
SERVER = dict(num_slots=3, max_len=48, block_size=8, prefill_chunk=8,
              segment=4)
TIGHT = dict(SERVER, num_slots=2, num_blocks=6, scheduling="edf")
SPEC_COUNTS = ("spec_steps", "spec_drafted", "spec_accepted",
               "spec_commit_copies", "decode_steps", "wasted_steps",
               "segments")
PREEMPT_COUNTS = ("preemptions", "restores", "spilled_blocks",
                  "restored_blocks", "unstaged")


def _cfgs(arch):
    base = "nemotron-4-15b" if arch == "nemotron-int8" else arch
    cj, ct = jcfg.get_smoke_config(base), tcfg.get_smoke_config(base)
    if arch == "nemotron-int8":
        cj = dataclasses.replace(cj, kv_cache_dtype=jnp.int8)
        ct = dataclasses.replace(ct, kv_cache_dtype=torch.int8)
    if cj.num_experts:
        # no-drop capacity: co-verified positions share expert capacity
        cj = dataclasses.replace(cj, capacity_factor=float(cj.num_experts))
        ct = dataclasses.replace(ct, capacity_factor=float(ct.num_experts))
    return cj, ct


def _traffic(vocab, n, seed=0, max_prompt=14):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, vocab, size=rng.randint(2, max_prompt))
             .astype(np.int32), int(rng.randint(1, 9))) for _ in range(n)]


def _tight_traffic(vocab):
    """Two 6-token lows of 18 tokens, then (after one step) a 12-token
    high of 6 (``test_spec_decode.py``'s preemption drain)."""
    rng = np.random.RandomState(21)
    lows = [rng.randint(0, vocab, size=6).astype(np.int32)
            for _ in range(2)]
    high = rng.randint(0, vocab, size=12).astype(np.int32)
    return lows, high


def _sampled(i):
    """Every other request sampled."""
    return dict(temperature=0.9, seed=i) if i % 2 else None


def _drain(srv, reqs, sp_cls, sampled=True):
    for i, (p, g) in enumerate(reqs):
        kw = _sampled(i) if sampled else None
        srv.submit(p, g, None if kw is None else sp_cls(**kw))
    return srv.run()


def _tight_drain(srv, lows, high):
    for p in lows:
        srv.submit(p, 18, priority=0)
    srv.step()
    srv.submit(high, 6, priority=1, ttft_target=30.0)
    return srv.run()


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


@pytest.fixture(scope="module")
def jax_drains(models):
    """The JAX speculative servers' drains: per family the oracle draft
    (k=3) on mixed greedy / sampled traffic, and the tight drain on
    nemotron and deepseek-v3."""
    out = {}
    for arch in ARCHS:
        cj, _, pj, _ = models[arch]
        srv = JaxPaged(cj, pj, spec=jspec.SpecConfig(cj, pj, k=3), **SERVER)
        done = _drain(srv, _traffic(cj.vocab_size, 6, seed=5), JSP)
        out[arch] = (done, srv.stats, dataclasses.asdict(srv.mgr.counters))
        if arch != "nemotron-int8":
            srv = JaxPaged(cj, pj, spec=jspec.SpecConfig(cj, pj, k=3),
                           **TIGHT)
            out[arch, "tight"] = (
                _tight_drain(srv, *_tight_traffic(cj.vocab_size)), srv.stats)
    return out


def _server(ct, pt, spec, **kw):
    return PagedContinuousBatchingServer(ct, pt, device="cpu", spec=spec,
                                         **{**SERVER, **kw})


def _oracle(ct, pt, k=3):
    return SpecConfig(draft_cfg=ct, draft_params=pt, k=k)


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
            err_msg=f"rid {r.rid}: speculative != solo decode")


def _assert_quiescent(srv):
    alloc = srv.mgr.alloc
    assert alloc.in_use == 0
    assert alloc.num_free + alloc.num_evictable == alloc.capacity
    assert len(srv.spill) == 0


# ---------------------------------------------------------------------------
# The drains against the JAX package and against solo decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_drain_matches_jax_and_solo(arch, models, jax_drains):
    """Greedy and sampled rows in one drain: the JAX speculative server's
    tokens and spec counters, the port's solo decode, and the allocator
    counters of the port's plain drain."""
    _, ct, _, pt = models[arch]
    want, jstats, jcounters = jax_drains[arch]
    reqs = _traffic(ct.vocab_size, 6, seed=5)
    srv = _server(ct, pt, _oracle(ct, pt))
    got = _drain(srv, reqs, SamplingParams)
    assert [r.rid for r in got] == [r.rid for r in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.tokens, np.asarray(b.tokens),
                                      err_msg=f"{arch} rid {a.rid}")
    assert ({k: srv.stats[k] for k in SPEC_COUNTS}
            == {k: jstats[k] for k in SPEC_COUNTS})
    assert srv.stats.spec_steps > 0
    samples = {i: None if _sampled(i) is None
               else SamplingParams(**_sampled(i)) for i in range(len(reqs))}
    _check_solo(ct, pt, got, reqs, samples)
    counters = dataclasses.asdict(srv.mgr.counters)
    assert counters == jcounters
    # rejected drafts never reach the allocator: its traffic is the
    # plain drain's (the peak moves with when spans grow)
    plain = _server(ct, pt, None)
    _drain(plain, reqs, SamplingParams)
    want_counters = dataclasses.asdict(plain.mgr.counters)
    counters.pop("in_use_peak")
    want_counters.pop("in_use_peak")
    assert counters == want_counters
    _assert_quiescent(srv)
    assert "speculative" in srv.stats.summary()


@pytest.mark.parametrize("arch", ARCHS)
def test_oracle_draft_accepts_everything(arch, models):
    """The greedy oracle draft's dense-slab argmax equals the verifier's
    paged argmax at every position: acceptance exactly 1.0."""
    _, ct, _, pt = models[arch]
    reqs = _traffic(ct.vocab_size, 5, seed=7)
    srv = _server(ct, pt, _oracle(ct, pt))
    done = _drain(srv, reqs, SamplingParams, sampled=False)
    assert srv.stats.spec_drafted > 0
    assert srv.stats.spec_accepted == srv.stats.spec_drafted
    assert srv.stats.spec_acceptance_rate == 1.0
    _check_solo(ct, pt, done, reqs)


@pytest.mark.parametrize("arch", ["nemotron-4-15b", "deepseek-v3-671b"])
def test_tight_drain_matches_jax(arch, models, jax_drains):
    """A pool too small for two grown spans under priority traffic:
    speculative rows spill mid-stream (a row spilled between draft and
    commit discards its round); JAX's tokens, preemption and spec
    counts, solo decode, and a quiescent pool."""
    _, ct, _, pt = models[arch]
    want, jstats = jax_drains[arch, "tight"]
    lows, high = _tight_traffic(ct.vocab_size)
    srv = _server(ct, pt, _oracle(ct, pt), **TIGHT)
    got = _tight_drain(srv, lows, high)
    assert len(got) == 3
    for a, b in zip(got, want):
        assert a.rid == b.rid
        np.testing.assert_array_equal(a.tokens, np.asarray(b.tokens),
                                      err_msg=f"{arch} rid {a.rid}")
    counts = PREEMPT_COUNTS + SPEC_COUNTS
    assert ({k: srv.stats[k] for k in counts}
            == {k: jstats[k] for k in counts})
    assert srv.stats.preemptions > 0 and srv.stats.restores > 0
    _check_solo(ct, pt, got, {0: (lows[0], 18), 1: (lows[1], 18),
                              2: (high, 6)})
    _assert_quiescent(srv)


# ---------------------------------------------------------------------------
# Rejection, progress, degeneration, validation
# ---------------------------------------------------------------------------


def _worthless(models):
    """Another seed's weights (JAX's PRNGKey(7), bridged)."""
    cj, ct, _, _ = models["nemotron-4-15b"]
    bad = bridge.params_from_jax(jax.tree.map(
        np.asarray, jget(cj).init(jax.random.PRNGKey(7), cj)), device="cpu")
    return SpecConfig(draft_cfg=ct, draft_params=bad, k=3)


def test_rejected_drafts_never_touch_the_pool(models):
    """A worthless draft is rejected nearly always, yet the stream equals
    solo decode and the allocator records exactly the plain drain's
    block traffic: rejected spans are never committed or copied."""
    _, ct, _, pt = models["nemotron-4-15b"]
    reqs = _traffic(ct.vocab_size, 5, seed=9)
    plain = _server(ct, pt, None)
    _drain(plain, reqs, SamplingParams, sampled=False)
    srv = _server(ct, pt, _worthless(models))
    rec: list = []
    with kops.record_dispatches(rec):
        done = _drain(srv, reqs, SamplingParams, sampled=False)
    _check_solo(ct, pt, done, reqs)
    assert srv.stats.spec_acceptance_rate < 0.5
    assert srv.mgr.counters.allocs == plain.mgr.counters.allocs
    assert srv.stats.spec_commit_copies == 0
    assert not [d for d in rec if d.op == "spec_commit_copy"]


def test_full_rejection_steps_make_progress(models):
    """Every step emits at least one token (the target's own), so a
    lone row takes at most as many steps as tokens."""
    _, ct, _, pt = models["nemotron-4-15b"]
    srv = _server(ct, pt, _worthless(models), num_slots=1)
    srv.submit(np.arange(1, 8, dtype=np.int32), 6)
    (r,) = srv.run()
    assert r.generated == 6
    assert srv.stats.spec_steps <= 6
    assert srv.stats.decode_steps == 6
    np.testing.assert_array_equal(
        r.tokens, _solo(ct, pt, np.arange(1, 8, dtype=np.int32), 6))


@pytest.mark.parametrize("drafts,target", [
    ([1, 2, 3], [1, 2, 3, 9]), ([1, 5, 3], [1, 2, 3, 9]),
    ([4, 2, 3], [1, 2, 3, 9]), ([], [7])])
def test_accepted_prefix_is_jax_s(drafts, target):
    d, t = np.asarray(drafts, np.int32), np.asarray(target, np.int32)
    assert accepted_prefix(d, t) == jspec.accepted_prefix(d, t)
    m = accepted_prefix(d, t)
    assert (d[:m] == t[:m]).all() and (m == d.size or d[m] != t[m])


def test_spec_k0_is_plain_decode(models):
    """k=0: the plain server's tokens and the plain programs' keys — no
    draft or verify program, no spare rows."""
    _, ct, _, pt = models["nemotron-4-15b"]
    reqs = _traffic(ct.vocab_size, 5, seed=13)
    plain = _server(ct, pt, None)
    want = _drain(plain, reqs, SamplingParams)
    srv = _server(ct, pt, SpecConfig(draft_cfg=ct, draft_params=pt, k=0))
    got = _drain(srv, reqs, SamplingParams)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    assert srv.executable_cache_keys() == plain.executable_cache_keys()
    assert srv.stats.spec_steps == 0
    assert srv.mgr.spare_blocks == 0
    assert srv.mgr.pool.num_blocks == srv.mgr.alloc.num_blocks


def test_spec_config_validation_refuses_what_jax_refuses(models):
    cj, ct, pj, pt = models["nemotron-4-15b"]
    for spec_cls, cfg, params in ((SpecConfig, ct, pt),
                                  (jspec.SpecConfig, cj, pj)):
        with pytest.raises(ValueError, match="k must be >= 0"):
            spec_cls(draft_cfg=cfg, draft_params=params, k=-1)
        small = dataclasses.replace(cfg, vocab_size=cfg.vocab_size // 2)
        with pytest.raises(ValueError, match="vocab_size"):
            spec_cls(draft_cfg=small, draft_params=params, k=2).validate(cfg)
        other = dataclasses.replace(cfg, family="ssm")
        with pytest.raises(ValueError, match="rowwise multi-token"):
            spec_cls(draft_cfg=other, draft_params=params,
                     k=2).validate(cfg)
    small = dataclasses.replace(ct, vocab_size=ct.vocab_size // 2)
    with pytest.raises(ValueError, match="vocab_size"):
        _server(ct, pt, SpecConfig(draft_cfg=small, draft_params=pt, k=2))


def test_spec_with_prefix_cache_hits(models):
    """Shared-prefix waves: spliced prefix blocks and scratch-verified
    drafts still give solo decode's tokens, and the index hit."""
    _, ct, _, pt = models["nemotron-4-15b"]
    srv = _server(ct, pt, _oracle(ct, pt), num_slots=2, block_size=4,
                  prefill_chunk=4)
    rng = np.random.RandomState(17)
    system = rng.randint(0, ct.vocab_size, size=9).astype(np.int32)
    reqs = {}
    for i in range(4):
        tail = rng.randint(0, ct.vocab_size, size=3 + i).astype(np.int32)
        p = np.concatenate([system, tail])
        reqs[srv.submit(p, 4)] = (p, 4)
    done = srv.run()
    _check_solo(ct, pt, done, reqs)
    assert srv.stats.prefix_block_hits > 0


def test_spare_rows_sit_past_the_allocator(models):
    """The pool has ``num_blocks + spare`` physical rows, the allocator
    ``num_blocks``; every slot owns ceil(k / block_size) spare rows,
    tables may name them, and the allocator never hands one out."""
    _, ct, _, pt = models["nemotron-4-15b"]
    srv = _server(ct, pt, _oracle(ct, pt, k=10), num_blocks=20)
    mgr = srv.mgr
    assert mgr.alloc.num_blocks == 20 and mgr.spare_blocks == 3 * 2
    assert mgr.pool.num_blocks == 26
    assert list(mgr.spare_ids) == list(range(20, 26))
    assert srv._scratch == [[20, 21], [22, 23], [24, 25]]
    leaf = mgr.pool.cache[0]["k"]
    assert leaf.shape[0] == 26 + 1                 # + the drop sink
    srv._validated(np.asarray([[25, 1]], np.int32))
    with pytest.raises(kvp.KVPoolError):
        srv._validated(np.asarray([[26]], np.int32))
    got = [mgr.alloc.alloc() for _ in range(mgr.alloc.capacity)]
    assert max(got) < 20


# ---------------------------------------------------------------------------
# The programs against JAX's at the function level
# ---------------------------------------------------------------------------


def _port_layers(jcache):
    """The JAX cache (stacked leaves) as the port's per-layer dicts."""
    return bridge.cache_from_jax(jax.tree.map(np.asarray, jcache),
                                 device="cpu")


def _assert_caches_close(jcache, tcache, what, rows=None):
    for i, (lj, lt) in enumerate(zip(_port_layers(jcache), tcache)):
        for name, leaf in lt.items():
            got, want = leaf.float().numpy(), lj[name].float().numpy()
            if rows is not None:
                got, want = got[rows], want[rows]
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                       err_msg=f"{what} layer {i} {name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_verify_step_matches_jax(arch, models):
    """One verify chunk of k + 1 = 4 tokens a row through block tables,
    on a pool a prompt prefill wrote first, greedy (no sampling state)
    and then with a greedy row among sampled ones: the same target
    tokens, the same logits to fp32 tolerance, the same pool blocks."""
    from repro.launch import sampling as jsampling
    from repro.launch.serve import make_prefill_step as jprefill
    from repro_torch.launch import sampling as tsampling
    from repro_torch.launch.serve import make_prefill_step
    from repro_torch.models import transformer as T

    cj, ct, pj, pt = models[arch]
    japi = jget(cj)
    bs, nb = 4, 16
    rng = np.random.RandomState(3)
    tables = np.arange(1, nb, dtype=np.int32).reshape(3, 5)
    pos = np.asarray([9, 13, 2], np.int32)
    prompt = rng.randint(0, ct.vocab_size, (3, 14)).astype(np.int32)
    chunk = rng.randint(0, ct.vocab_size, (3, 4)).astype(np.int32)
    # both pools have nb + 1 rows; the port's last is its drop sink
    jpool = japi.init_cache(cj, JL.HOST, nb + 1, bs)
    tpool = get_model(ct).init_cache(ct, nb + 1, bs, device="cpu")
    zeros = np.zeros((3,), np.int32)
    _, jpool = jax.jit(jprefill(cj, japi, JL.HOST, None))(
        pj, {"tokens": jnp.asarray(prompt)}, jpool, None,
        jnp.asarray(zeros), jnp.asarray(tables))
    make_prefill_step(ct, get_model(ct))(
        pt, {"tokens": torch.from_numpy(prompt).long()}, tpool, None,
        torch.from_numpy(zeros).long(), torch.from_numpy(tables))
    rows = [(7, 0.0), (8, 1.1), (9, 0.7)]
    jstate = jsampling.merge_rows(
        [(jsampling.request_key(sd), JSP(temperature=t, seed=sd))
         for sd, t in rows])
    tstate = tsampling.merge_rows(
        [(tsampling.request_key(sd), SamplingParams(temperature=t, seed=sd))
         for sd, t in rows], torch.device("cpu"))
    jv = jax.jit(jax_verify_step(cj, japi, JL.HOST, None))
    tv = make_verify_step(ct, get_model(ct))
    # a second verify of the same chunk rewrites the same KV
    for js, ts in ((None, None), (jstate, tstate)):
        want, jpool = jv(pj, jnp.asarray(chunk), jpool, jnp.asarray(pos),
                         jnp.asarray(tables), js)
        got = tv(pt, torch.from_numpy(chunk).long(), tpool,
                 torch.from_numpy(pos).long(), torch.from_numpy(tables), ts)
        assert got.shape == (3, 4) and got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _assert_caches_close(jpool, tpool, f"{arch} pool", rows=slice(1, nb))
    # the logits the targets came from
    lj, _ = japi.prefill(pj, cj, {"tokens": jnp.asarray(chunk)}, jpool,
                         minfo=JL.HOST, mesh=None,
                         cache_pos=jnp.asarray(pos),
                         block_tables=jnp.asarray(tables), all_logits=True)
    lt, _ = T.prefill(pt, ct, {"tokens": torch.from_numpy(chunk).long()},
                      tpool, cache_pos=torch.from_numpy(pos).long(),
                      block_tables=torch.from_numpy(tables),
                      all_logits=True)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_draft_program_matches_jax(arch, models):
    """The ingest-and-draft program, k=3 on a dense slot cache: a
    catch-up round (full chunks), then rows at mixed lags, one idle row
    at ``max_len - 1`` whose pad writes drop off the slab: the same
    drafts and the same cache as JAX's."""
    cj, ct, pj, pt = models[arch]
    k, max_len = 3, 24
    rng = np.random.RandomState(11)
    jfn = jax.jit(jspec.make_draft_program(cj, jget(cj), k, max_len))
    tfn = make_draft_program(ct, get_model(ct), k, max_len)
    jcache = jget(cj).init_cache(cj, JL.HOST, 3, max_len)
    tcache = get_model(ct).init_cache(ct, 3, max_len, device="cpu")
    rounds = [(np.asarray([4, 4, 1]), np.asarray([0, 0, max_len - 1])),
              (np.asarray([4, 2, 1]), np.asarray([4, 4, max_len - 1])),
              (np.asarray([1, 3, 4]), np.asarray([8, 6, 20]))]
    for clen, start in rounds:
        chunk = rng.randint(0, ct.vocab_size, (3, k + 1)).astype(np.int32)
        want, jcache = jfn(pj, jnp.asarray(chunk),
                           jnp.asarray(clen, jnp.int32),
                           jnp.asarray(start, jnp.int32), jcache)
        got = tfn(pt, torch.from_numpy(chunk).long(),
                  torch.from_numpy(clen), torch.from_numpy(start), tcache)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"{arch} drafts")
    _assert_caches_close(jcache, tcache, f"{arch} draft cache")
