"""The speculative decoder's draft and verify programs captured
(``PagedContinuousBatchingServer._draft_tokens`` / ``_advance_spec``).

Without a card: the stand-in graph of ``test_torch_stage_capture.py``,
whose replay runs the step again on its static input buffers. On the
smoke configs of nemotron-4-15b and deepseek-v3-671b, a speculative
drain (greedy and sampled rows, several verify table widths) gives the
eager drain's tokens and counters bit for bit under the same
executable-cache keys (``("draft", n, k)``, ``("specv", n, k, width,
sampled|greedy, plan)``); the draft key is captured once and replayed
on every later round, each verify key at its first call.

On the card (``gpu``): the speculative drain captured == eager at two
layers of nemotron-4-15b's and deepseek-v3-671b's published widths (the
same tokens, launch counts and spec counters), and the scratch -> pool
commit copies in place (no pool or draft-cache leaf moves). This file
imports no JAX.
"""

import collections
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import ops as kops
from repro_torch.launch import graphs
from repro_torch.launch.sampling import SamplingParams
from repro_torch.launch.scheduler import PagedContinuousBatchingServer
from repro_torch.launch.spec import SpecConfig
from repro_torch.models import transformer as T

SPEC_COUNTS = ("spec_steps", "spec_drafted", "spec_accepted",
               "spec_commit_copies", "decode_steps", "wasted_steps",
               "segments", "compiles", "hits")


class _RerunGraph:
    """``graphs._Graph`` without a card: the capture records nothing, a
    replay runs the step again on the static inputs it copied in."""

    def __init__(self, fn, fixed, inputs, pool, device):
        self.fn, self.fixed = fn, fixed
        self.static = graphs._clone(inputs)
        self.launches = collections.Counter()

    def replay(self, inputs):
        graphs._copy_into(self.static, inputs)
        return self.fn(self.fixed, **self.static)


@pytest.fixture
def rerun(monkeypatch):
    monkeypatch.setattr(graphs, "_Graph", _RerunGraph)
    monkeypatch.setattr(graphs.Program, "captured", property(
        lambda self: graphs.capture_enabled()))


def _cfg(arch):
    cfg = configs.get_smoke_config(arch)
    if cfg.num_experts:
        # no-drop capacity: co-verified positions share expert capacity
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
    return cfg


def _reqs(vocab, seed=2, n=5):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, vocab, rng.randint(3, 30)).astype(np.int32),
             int(rng.randint(4, 14)),
             SamplingParams(temperature=0.9, seed=i) if i % 2 else None)
            for i in range(n)]


def _drain(srv, reqs):
    for p, g, sp in reqs:
        srv.submit(p, g, sample=sp)
    return [r.tokens for r in srv.run()]


@pytest.mark.parametrize("arch", ["nemotron-4-15b", "deepseek-v3-671b"])
def test_spec_programs_capture_and_replay_like_eager(rerun, arch):
    cfg = _cfg(arch)
    params = T.init(cfg, seed=0, device="cpu")
    reqs = _reqs(cfg.vocab_size)
    runs = {}
    for name, ctx in (("eager", graphs.disable_capture),
                      ("captured", contextlib.nullcontext)):
        srv = PagedContinuousBatchingServer(
            cfg, params, device="cpu", num_slots=2, max_len=64,
            block_size=4, prefill_chunk=8, segment=4,
            spec=SpecConfig(cfg, params, k=3))
        with ctx():
            toks = _drain(srv, reqs)
        runs[name] = (srv, toks)
    (eager, want), (cap, got) = runs["eager"], runs["captured"]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert cap.executable_cache_keys() == eager.executable_cache_keys()
    assert ({k: cap.stats[k] for k in SPEC_COUNTS}
            == {k: eager.stats[k] for k in SPEC_COUNTS})
    progs = {k: p for k, p in cap._exec.items()
             if k[0] in ("draft", "specv")}
    (draft,) = [p for k, p in progs.items() if k[0] == "draft"]
    verify = {k: p for k, p in progs.items() if k[0] == "specv"}
    assert len(verify) >= 2                     # several table widths
    assert (draft.eager_calls, draft.captures) == (1, 1)
    assert draft.replays > cap.stats.spec_steps    # catch-up rounds
    (graph,) = draft._graphs.values()
    assert set(graph.static) == {"chunk", "chunk_len", "start"}
    assert graph.static["chunk"].shape == (2, 4)
    for key, prog in verify.items():
        assert key[1:3] == (2, 3)
        assert (prog.eager_calls, prog.captures) == (1, 1)
        (graph,) = prog._graphs.values()
        assert set(graph.static) == {"tokens", "pos", "tables", "sample"}
        assert graph.static["tables"].shape == (2, key[3])
    assert sum(p.replays for p in verify.values()) > 0
    assert all(p.captures == 0 for p in eager.programs())


def test_spare_rows_feed_the_verify_table():
    """A frontier on a block boundary: the verify table splices the
    slot's spare rows past its span; the commit copies exactly the
    accepted blocks from them."""
    cfg = _cfg("nemotron-4-15b")
    params = T.init(cfg, seed=0, device="cpu")
    srv = PagedContinuousBatchingServer(
        cfg, params, device="cpu", num_slots=1, max_len=32, block_size=2,
        prefill_chunk=2, segment=4, spec=SpecConfig(cfg, params, k=3))
    assert srv._scratch == [list(srv.mgr.spare_ids)]
    assert len(srv._scratch[0]) == 2           # ceil(3 / 2)
    tables = []
    validated = srv._validated

    def spy(t):
        tables.append(np.array(t))
        return validated(t)

    srv._validated = spy
    prompt = np.arange(1, 6, dtype=np.int32)     # 5 tokens
    srv.submit(prompt, 8)
    (r,) = srv.run()
    plain = PagedContinuousBatchingServer(
        cfg, params, device="cpu", num_slots=1, max_len=32, block_size=2,
        prefill_chunk=2, segment=4)
    plain.submit(prompt, 8)
    (want,) = plain.run()
    np.testing.assert_array_equal(r.tokens, want.tokens)
    spare = set(srv.mgr.spare_ids)
    verify_tables = [t for t in tables if spare & set(t.ravel().tolist())]
    assert verify_tables, "no verify table named a spare row"
    assert srv.stats.spec_commit_copies > 0
    assert srv.mgr.alloc.in_use == 0


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: capture runs only on the card")
    return torch.device("cuda")


def _card_model(arch):
    cfg = dataclasses.replace(configs.get_config(arch), num_layers=2,
                              use_pallas=True)
    if cfg.first_dense_layers:
        cfg = dataclasses.replace(cfg, first_dense_layers=1)
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
    torch.cuda.empty_cache()
    return cfg, T.init(cfg, seed=0, device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["nemotron-4-15b", "deepseek-v3-671b"])
def test_spec_captured_equals_eager(cuda, arch):
    """The speculative drain with its draft and verify programs replayed
    as CUDA graphs gives the eager drain's tokens, launch counts and
    spec counters bit for bit (two layers of the config's full widths,
    fresh servers)."""
    cfg, params = _card_model(arch)
    reqs = _reqs(cfg.vocab_size)
    outs, srvs = [], []
    for ctx in (graphs.disable_capture, contextlib.nullcontext):
        srv = PagedContinuousBatchingServer(
            cfg, params, device=cuda, num_slots=2, max_len=128,
            block_size=16, segment=4, spec=SpecConfig(cfg, params, k=3))
        srvs.append(srv)
        kops.reset_launch_counts()
        with ctx():
            toks = _drain(srv, reqs)
        torch.cuda.synchronize()
        outs.append((toks, kops.launch_counts(),
                     {k: srv.stats[k] for k in SPEC_COUNTS}))
    (want, counts, st), (got, c, st2) = outs
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert c == counts and st == st2
    assert counts["paged_gqa"] == 0 and counts["paged_mla"] == 0
    progs = {k[0]: p for k, p in srvs[1]._exec.items()
             if k[0] in ("draft", "specv")}
    assert set(progs) == {"draft", "specv"}
    assert all(p.captures > 0 for p in progs.values())
    assert progs["draft"].replays > 0


@pytest.mark.gpu
def test_commit_copy_stays_in_place(cuda):
    """The scratch -> pool commit writes into the pool's leaves in place:
    no pool or draft-cache leaf moves over a drain that commits (the
    replayed programs hold the addresses)."""
    cfg, params = _card_model("nemotron-4-15b")
    srv = PagedContinuousBatchingServer(
        cfg, params, device=cuda, num_slots=2, max_len=128, block_size=4,
        segment=4, spec=SpecConfig(cfg, params, k=4))

    def ptrs(cache):
        return [leaf.data_ptr() for layer in cache
                for leaf in layer.values()]

    pool, draft = ptrs(srv.mgr.pool.cache), ptrs(srv._draft_cache)
    rng = np.random.RandomState(4)
    for n in (30, 21, 9):
        srv.submit(rng.randint(0, cfg.vocab_size, n).astype(np.int32), 20)
    assert len(srv.run()) == 3
    assert srv.stats.spec_commit_copies > 0
    assert ptrs(srv.mgr.pool.cache) == pool
    assert ptrs(srv._draft_cache) == draft
