"""Staging rounds of the paged server as captured programs
(``PagedContinuousBatchingServer._stage_round``).

Without a card: a stand-in for the CUDA graph whose replay runs the step
function again on its static input buffers (so a replay computes what
the graph would, from the inputs copied in, and a step that kept a value
of its first call outside those buffers would go wrong). On the smoke
configs of nemotron-4-15b, deepseek-v3-671b and llama4-scout (MoE: its
routing stays on the device), a drain with staging rounds of several
keys gives the eager drain's tokens bit for bit, under the same
executable-cache keys (``("stage", rows, chunk, table width, plan)``)
and the same compile and hit counts; each stage key is captured once, at
its ``stage_capture_after``-th round, and replayed on every later round
of that key, across drains of one server.

On the card (``gpu``): staged prefill captured == eager for nemotron-
4-15b, deepseek-7b and deepseek-v3-671b at their published widths cut to
2 layers (deepseek-v3: one dense and one MoE layer), bf16 weights from a
seed, on fresh servers: the same tokens bit for bit and the same launch
counts, the stage programs captured and replayed. This file imports no JAX.
"""

import collections
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import ops as kops
from repro_torch.launch import graphs, scheduler
from repro_torch.launch.scheduler import PagedContinuousBatchingServer
from repro_torch.models import transformer as T


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


def _traffic(vocab, seed=0, n=5):
    """Prompts of 3..40 tokens, every other one opening with one shared
    16-token prefix: staging rounds of 1..3 rows, several chunks."""
    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, vocab, 16).astype(np.int32)
    out = []
    for i in range(n):
        p = rng.randint(0, vocab, rng.randint(3, 25)).astype(np.int32)
        if i % 2:
            p = np.concatenate([prefix, p])
        out.append((p, int(rng.randint(2, 6))))
    return out


def _cfg(arch):
    cfg = configs.get_smoke_config(arch)
    if cfg.num_experts:
        # no-drop capacity: chunking must not change routing
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
    return cfg


@pytest.mark.parametrize("arch", ["nemotron-4-15b", "deepseek-v3-671b",
                                  "llama4-scout-17b-a16e"])
def test_staging_rounds_capture_and_replay_like_eager(rerun, arch):
    cfg = _cfg(arch)
    params = T.init(cfg, seed=0, device="cpu")
    reqs = _traffic(cfg.vocab_size)
    runs = {}
    for name, ctx in (("eager", graphs.disable_capture),
                      ("captured", contextlib.nullcontext)):
        srv = PagedContinuousBatchingServer(
            cfg, params, device="cpu", num_slots=2, max_len=64,
            block_size=8, prefill_chunk=8, segment=4,
            stage_capture_after=1)
        with ctx():
            for p, g in reqs:
                srv.submit(p, g)
            done = srv.run()
        runs[name] = (srv, [r.tokens for r in done])
    (eager, want), (cap, got) = runs["eager"], runs["captured"]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert cap.executable_cache_keys() == eager.executable_cache_keys()
    assert (cap.stats.compiles, cap.stats.hits) == (
        eager.stats.compiles, eager.stats.hits)
    stage = {k: p for k, p in cap._exec.items() if k[0] == "stage"}
    assert len(stage) >= 2
    for key, prog in stage.items():
        assert key[2:4] == (8, cap.blocks_per_table)
        assert (prog.eager_calls, prog.captures) == (1, 1)
    # as many rounds as the eager drain ran, most of them replays
    assert sum(p.eager_calls + p.replays for p in stage.values()) == sum(
        p.eager_calls for k, p in eager._exec.items() if k[0] == "stage")
    assert sum(p.replays for p in stage.values()) > 0
    assert all(p.captures == 0 for k, p in eager._exec.items()
               if isinstance(p, graphs.Program))


def test_a_stage_round_takes_its_tables_as_inputs(rerun):
    """Two requests staged one at a time, one round of one key each: the
    second round (a replay) prefills where its own tokens, positions and
    tables say, and decodes the eager server's tokens."""
    cfg = _cfg("nemotron-4-15b")
    params = T.init(cfg, seed=0, device="cpu")
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, cfg.vocab_size, 9).astype(np.int32)
               for _ in range(2)]
    out = []
    for ctx in (graphs.disable_capture, contextlib.nullcontext):
        srv = PagedContinuousBatchingServer(
            cfg, params, device="cpu", num_slots=2, max_len=32,
            block_size=8, prefill_chunk=8, stage_ahead=1,
            stage_capture_after=1)
        with ctx():
            for p in prompts:
                srv.submit(p, 3)
            out.append([r.tokens for r in srv.run()])
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
    (prog,) = [p for k, p in srv._exec.items() if k[0] == "stage"]
    assert (prog.captures, prog.replays) == (1, 1)
    (graph,) = prog._graphs.values()
    assert set(graph.static) == {"tokens", "pos", "tables"}
    assert graph.static["tokens"].shape == (1, 8)
    assert graph.static["tables"].shape == (1, srv.blocks_per_table)


@pytest.mark.parametrize("after", [3, scheduler.STAGE_CAPTURE_AFTER])
def test_a_stage_key_is_captured_at_its_nth_round(rerun, after):
    """With ``stage_capture_after=N`` a stage key runs eagerly for its
    first N - 1 rounds, is captured at the N-th and replayed after; the
    tokens stay the eager drain's. Two drains on one server: the second
    (warm) one goes on counting the first one's rounds."""
    cfg = _cfg("nemotron-4-15b")
    params = T.init(cfg, seed=0, device="cpu")
    reqs = _traffic(cfg.vocab_size, seed=3)
    want = []
    with graphs.disable_capture():
        srv = PagedContinuousBatchingServer(
            cfg, params, device="cpu", num_slots=2, max_len=64,
            block_size=8, prefill_chunk=8, segment=4)
        for _ in range(2):
            for p, g in reqs:
                srv.submit(p, g)
            want.append([r.tokens for r in srv.run()])
    srv = PagedContinuousBatchingServer(
        cfg, params, device="cpu", num_slots=2, max_len=64, block_size=8,
        prefill_chunk=8, segment=4, stage_capture_after=after)
    assert srv.stage_capture_after == after
    rounds = collections.Counter()
    for drain in range(2):
        for p, g in reqs:
            srv.submit(p, g)
        got = [r.tokens for r in srv.run()]
        for a, b in zip(got, want[drain]):
            np.testing.assert_array_equal(a, b)
        for key, prog in srv._exec.items():
            if key[0] == "stage":
                rounds[key] = prog.eager_calls + prog.replays
    stage = {k: p for k, p in srv._exec.items() if k[0] == "stage"}
    assert len(stage) >= 2
    for key, prog in stage.items():
        n = rounds[key]
        assert prog.captures == int(n >= after)
        assert prog.eager_calls == min(n, after)
        assert prog.replays == max(n - after, 0)
    assert any(rounds[k] >= 3 for k in stage)


def test_capture_after_must_be_positive():
    with pytest.raises(ValueError, match="capture_after"):
        graphs.Program(lambda fixed: None, device="cpu", capture_after=0)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: capture runs only on the card")
    return torch.device("cuda")


def _model(arch):
    cfg = dataclasses.replace(configs.get_config(arch), num_layers=2,
                              use_pallas=True)
    if cfg.first_dense_layers:
        cfg = dataclasses.replace(cfg, first_dense_layers=1)
    torch.cuda.empty_cache()
    return cfg, T.init(cfg, seed=0, device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["nemotron-4-15b", "deepseek-7b",
                                  "deepseek-v3-671b"])
def test_staged_prefill_captured_equals_eager(cuda, arch):
    cfg, params = _model(arch)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in (70, 33, 100, 16)]
    outs = []
    for ctx in (graphs.disable_capture, contextlib.nullcontext):
        # a fresh server each: the same staging rounds, row counts and
        # shapes (a warm one would splice the published prefixes)
        srv = PagedContinuousBatchingServer(cfg, params, device=cuda,
                                            num_slots=2, max_len=256,
                                            block_size=16, segment=4,
                                            stage_capture_after=1)
        kops.reset_launch_counts()
        with ctx():
            for p in prompts:
                srv.submit(p, 6)
            toks = [r.tokens for r in srv.run()]
        torch.cuda.synchronize()
        outs.append((toks, kops.launch_counts()))
    (want, counts), (got, c) = outs
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert c == counts
    stage = [p for k, p in srv._exec.items() if k[0] == "stage"]
    assert stage and sum(p.captures for p in stage) > 0
    assert sum(p.replays for p in stage) > 0
    del params
    torch.cuda.empty_cache()
