"""Captured step programs (``repro_torch.launch.graphs``).

Without a card: the bookkeeping of a capture, with a stand-in for the
CUDA graph and its capture — a program's first call runs eagerly and then
captures, later calls copy their inputs into the static buffers and
replay; the launch counts and dispatch records a capture makes are
taken back out of the ambient ones and added again at each replay, so
a captured run counts what an eager one counts; a graph is keyed by its
input shapes and fixed objects, and new parameters recapture; a failed
capture raises and leaves the counts as they were; ``disable_capture()``
runs eagerly; every config's servers capture (no model syncs with the
host). This file imports no JAX (the card's machine has none).

On the card (``gpu``): for ``Server``, the slot-cache server and the
paged server at nemotron-4-15b's and deepseek-7b's published widths cut
to 2 layers (bf16 weights from a seed), captured == eager
(``disable_capture()``) bit for bit, greedy and sampled, under SIDEBAR
and SIDEBAR_PIPELINED at depth 2 (and FLEXIBLE_DMA on the paged server),
with equal launch counts and dispatch records; and a capture with a
host sync raises.
"""

import contextlib
import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core.modes import ExecutionMode, LayerPlan
from repro_torch.kernels import build
from repro_torch.kernels import ops as kops
from repro_torch.launch import graphs
from repro_torch.launch.sampling import SamplingParams
from repro_torch.launch.scheduler import (
    ContinuousBatchingServer,
    PagedContinuousBatchingServer,
)
from repro_torch.launch.serve import Server
from repro_torch.models import transformer as T


class _StandInGraph:
    """``torch.cuda.CUDAGraph`` without a card: replay runs nothing."""

    def replay(self):
        pass


@contextlib.contextmanager
def _stand_in_capture(graph, pool, device):
    yield


@pytest.fixture
def stand_in(monkeypatch):
    """Programs on the CPU that capture and replay as on the card; the
    capture runs the function once (its results stand in the static
    outputs), a replay runs nothing."""
    monkeypatch.setattr(graphs.torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(graphs, "_capturing", _stand_in_capture)
    monkeypatch.setattr(graphs.Program, "captured", property(
        lambda self: graphs.capture_enabled()))
    build.launches.clear()
    yield
    build.launches.clear()


def _step(fixed, x, scale=None):
    """A step that 'launches' one kernel, records one dispatch, and
    reads its fixed weight."""
    build.launches["sidebar_mlp"] += 1
    kops.record_dispatch("gather_blocks", "dma")
    out = x * fixed[0]["w"]
    return out if scale is None else {"y": out, "s": scale + 1}


def test_capture_counts_like_eager_and_replays(stand_in):
    prog = graphs.Program(_step, device="cpu")
    params = {"w": torch.tensor(2.0)}
    recs = []
    with kops.record_dispatches(recs):
        out = prog((params,), x=torch.ones(3))
        # the first call is eager; its capture counted nothing
        assert torch.equal(out, torch.full((3,), 2.0))
        assert (prog.eager_calls, prog.captures, prog.replays) == (1, 1, 0)
        assert build.launches["sidebar_mlp"] == 1 and len(recs) == 1
        out = prog((params,), x=torch.full((3,), 5.0))
        assert (prog.captures, prog.replays) == (1, 1)
        assert build.launches["sidebar_mlp"] == 2 and len(recs) == 2
        assert recs[0] == recs[1]
        (graph,) = prog._graphs.values()
        # the inputs went into the static buffers; the output is a copy
        assert torch.equal(graph.static["x"], torch.full((3,), 5.0))
        assert out is not graph.out and torch.equal(out, graph.out)
        assert graph.launches == {"sidebar_mlp": 1}


def test_graphs_keyed_by_shapes_and_params(stand_in):
    prog = graphs.Program(_step, device="cpu")
    params = {"w": torch.tensor(2.0)}
    prog((params,), x=torch.ones(3))
    prog((params,), x=torch.ones(4))           # a new shape: a new graph
    prog((params,), x=torch.ones(3), scale=torch.ones(1))
    prog((params,), x=torch.ones(3))
    assert (prog.captures, prog.replays) == (3, 1)
    assert len(prog._graphs) == 3
    new = {"w": torch.tensor(3.0)}             # new parameters: recapture
    out = prog((new,), x=torch.ones(3))
    assert torch.equal(out, torch.full((3,), 3.0))
    assert prog.captures == 4 and len(prog._graphs) == 1
    assert build.launches["sidebar_mlp"] == 5  # one a call, as eager


def test_failed_capture_raises_and_leaves_counts(stand_in):
    calls = []

    def step(fixed, x):
        calls.append(1)
        build.launches["paged_gqa"] += 1
        if len(calls) == 2:                    # the capture's run
            raise RuntimeError("operation not permitted when capturing")
        return x

    prog = graphs.Program(step, device="cpu")
    with pytest.raises(RuntimeError, match="capturing"):
        prog((), x=torch.ones(2))
    assert build.launches["paged_gqa"] == 1 and not prog._graphs


def test_disable_capture_runs_eagerly_and_nests(stand_in):
    prog = graphs.Program(_step, device="cpu")
    params = {"w": torch.tensor(2.0)}
    assert graphs.capture_enabled()
    with graphs.disable_capture():
        assert not graphs.capture_enabled() and not prog.captured
        with graphs.disable_capture():
            pass
        assert not graphs.capture_enabled()
        prog((params,), x=torch.ones(3))
        prog((params,), x=torch.ones(3))
    assert graphs.capture_enabled() and prog.captured
    assert (prog.eager_calls, prog.captures) == (2, 0)


def test_off_the_card_programs_run_eagerly():
    prog = graphs.Program(_step, device="cpu")
    assert not prog.captured and graphs.new_pool(torch.device("cpu")) is None
    prog(({"w": torch.tensor(1.0)},), x=torch.ones(2))
    assert (prog.eager_calls, prog.captures, prog.replays) == (1, 0, 0)


def test_servers_capture_only_models_without_a_host_sync():
    """No ported model syncs with the host any more (the MoE layer keeps
    its routing on the card), so every config's servers capture on the
    card and run eagerly on the CPU or under ``disable_capture()``."""
    assert not hasattr(graphs, "syncs_with_host")
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert graphs.captures(cuda) and not graphs.captures(cpu)
    with graphs.disable_capture():
        assert not graphs.captures(cuda)
    assert len(configs.ARCH_IDS) == 6
    for arch in configs.ARCH_IDS:
        cfg = configs.get_smoke_config(arch)
        params = T.init(cfg, device="cpu")
        solo = Server(cfg, params, max_len=32, device="cpu")
        slots = (ContinuousBatchingServer(cfg, params, device="cpu",
                                          num_slots=1, max_len=32),
                 PagedContinuousBatchingServer(cfg, params, device="cpu",
                                               num_slots=1, max_len=32,
                                               block_size=8))
        for srv in (solo, *slots):
            assert srv.captured is False    # the CPU runs eagerly
        for prog in (solo._decode_scan(3),
                     *(srv._program(_step) for srv in slots)):
            assert prog.captured is False
            with mock.patch.object(graphs, "captures",
                                   lambda device: True):
                assert prog.captured        # as on the card


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: capture runs only on the card")
    return torch.device("cuda")


_WEIGHTS: dict = {}


def _model(arch):
    """``arch`` at its published widths, 2 layers, bf16 weights from
    seed 0, the MLP through its kernel (cached: one model on the card at
    a time)."""
    if arch not in _WEIGHTS:
        _WEIGHTS.clear()
        torch.cuda.empty_cache()
        cfg = dataclasses.replace(configs.get_config(arch), num_layers=2,
                                  use_pallas=True)
        _WEIGHTS[arch] = (cfg, T.init(cfg, seed=0, device="cuda"))
    return _WEIGHTS[arch]


PLANS = {"sidebar": None,
         "sidebar_pipelined_d2": LayerPlan(ExecutionMode.SIDEBAR_PIPELINED,
                                           2),
         "flexible_dma": ExecutionMode.FLEXIBLE_DMA}
SP = SamplingParams(temperature=0.9, top_k=50, top_p=0.95, seed=11)


def _both(run):
    """``run()`` eager, then captured twice (capture, then replay): the
    outputs, launch counts and dispatch records of each."""
    out = []
    for ctx in (graphs.disable_capture, contextlib.nullcontext,
                contextlib.nullcontext):
        recs = []
        kops.reset_launch_counts()
        with ctx(), kops.record_dispatches(recs):
            got = run()
        torch.cuda.synchronize()
        out.append((got, kops.launch_counts(), recs))
    return out


def _assert_same(runs, what):
    (eager, counts, recs), *captured = runs
    for got, c, r in captured:
        for a, b in zip(eager, got):
            np.testing.assert_array_equal(a, b, err_msg=what)
        assert c == counts, f"{what}: launches {c} != eager {counts}"
        assert r == recs, f"{what}: dispatch records differ"
    assert sum(counts.values()) > 0, f"{what}: no kernel launched"


def _traffic(vocab, n=4, seed=3):
    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, vocab, 32)
    return [np.concatenate([prefix, rng.randint(0, vocab, rng.randint(
        8, 40))]).astype(np.int32) if i % 2 else rng.randint(
        0, vocab, rng.randint(16, 64)).astype(np.int32) for i in range(n)]


@pytest.mark.gpu
@pytest.mark.parametrize("sample", [None, SP], ids=["greedy", "sampled"])
@pytest.mark.parametrize("plan", ["sidebar", "sidebar_pipelined_d2"])
@pytest.mark.parametrize("arch", ["nemotron-4-15b", "deepseek-7b"])
def test_server_captured_equals_eager(cuda, arch, plan, sample):
    cfg, params = _model(arch)
    srv = Server(cfg, params, max_len=128, device=cuda,
                 plan=PLANS[plan] or ExecutionMode.SIDEBAR)
    prompts = np.random.RandomState(1).randint(0, cfg.vocab_size, (4, 32))
    runs = _both(lambda: [srv.generate(prompts, 12, sample=sample)
                          .tokens.cpu().numpy()])
    _assert_same(runs, f"Server {arch} {plan}")
    prog = srv._decode_scans[(11, None)]
    assert (prog.captures, prog.replays) == (1, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("plan", ["sidebar", "sidebar_pipelined_d2"])
@pytest.mark.parametrize("arch", ["nemotron-4-15b", "deepseek-7b"])
def test_slot_server_captured_equals_eager(cuda, arch, plan):
    cfg, params = _model(arch)
    prompts = _traffic(cfg.vocab_size)

    def run():
        srv = ContinuousBatchingServer(
            cfg, params, device=cuda, num_slots=2, max_len=128,
            buckets=(32, 64), segment=4, plan=PLANS[plan])
        for i, p in enumerate(prompts):
            srv.submit(p, 10, sample=SP if i % 2 else None)
        return [r.tokens for r in srv.run()]

    _assert_same(_both(run), f"slots {arch} {plan}")


@pytest.mark.gpu
@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("arch", ["nemotron-4-15b", "deepseek-7b"])
def test_paged_server_captured_equals_eager(cuda, arch, plan):
    cfg, params = _model(arch)
    prompts = _traffic(cfg.vocab_size, n=6)
    srvs = []

    def run():
        srv = PagedContinuousBatchingServer(
            cfg, params, device=cuda, num_slots=3, max_len=128,
            block_size=16, segment=4, plan=PLANS[plan])
        srvs.append(srv)
        for i, p in enumerate(prompts):
            srv.submit(p, 10, sample=SP if i % 2 else None)
        return [r.tokens for r in srv.run()]

    _assert_same(_both(run), f"paged {arch} {plan}")
    eager, captured = srvs[0], srvs[1]
    assert all(p.captures == 0 for p in eager.programs())
    assert sum(p.captures for p in captured.programs()) > 0
    assert sum(p.replays for p in captured.programs()) > 0


@pytest.mark.gpu
def test_capture_with_a_host_sync_raises(cuda):
    def step(fixed, x):
        return x * float(x.sum())                  # a host sync

    prog = graphs.Program(step, device=cuda)
    before = kops.launch_counts()
    with pytest.raises(RuntimeError):
        prog((), x=torch.ones(4, device=cuda))
    assert not prog._graphs and kops.launch_counts() == before
    torch.cuda.synchronize()                   # the card still works
    assert float(torch.ones(2, device=cuda).sum()) == 2.0
    # and so does its default generator (the broken capture held it)
    assert torch.randn(2, device=cuda).isfinite().all()
