"""The engine's device rules, on the CPU and on the card (no JAX here:
the card's machine has none).

On the CPU:
  * FLEXIBLE_DMA's one dispatch rule (``engine.dma_host_step``): an entry
    the standalone activation kernel takes goes through
    ``kernels.activations.activation``, LeNet's ``max_pool`` through its
    torch callable;
  * ``run`` refuses an input and parameters on different devices and
    moves nothing;
  * MONOLITHIC builds no program off the card.

On the card (``gpu``, skipped without one): FLEXIBLE_DMA launches the
``activation`` kernel once a table entry it takes (and the torch
callable for ``max_pool``); SIDEBAR and SIDEBAR_PIPELINED on a CUDA
input return a CUDA tensor equal to the CPU run's within 1e-4 with the
CPU run's protocol counts; MONOLITHIC captured == eager bit for bit,
unchanged by a table hot-swap after build.
"""

import dataclasses

import pytest
import torch

from repro_torch.core import engine, function_table
from repro_torch.core.modes import ExecutionMode
from repro_torch.kernels import activations
from repro_torch.kernels import ops as kops
from repro_torch.launch import graphs
from repro_torch.models import lenet

BATCH = 8


def _lenet(act="relu", device="cpu"):
    table = function_table.make_default_table()
    lenet.register_pooling(table)
    params = lenet.init(torch.Generator().manual_seed(0), device=device)
    x = torch.randn((BATCH, 3, 32, 32),
                    generator=torch.Generator().manual_seed(1)).to(device)
    graph = lenet.to_layer_graphs(BATCH, act)[0]
    return graph, lenet.engine_params(params), params, x, table


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the engine's card path")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("act", ["relu", "softplus"])
def test_dma_rule_sends_table_entries_to_the_activation_wrapper(
        monkeypatch, act):
    graph, ep, params, x, table = _lenet(act)
    seen = []
    wrapper = activations.activation

    def spy(t, name, *, table):
        seen.append((name, tuple(t.shape)))
        return wrapper(t, name, table=table)

    monkeypatch.setattr(activations, "activation", spy)
    res = engine.run(graph, ep, x, ExecutionMode.FLEXIBLE_DMA, table)
    want = [(act, tuple(op_shape)) for _, op, op_shape
            in graph.flexible_ops() if op.function == act]
    assert seen == want and len(seen) == 4
    assert res.launches == 5
    ref = lenet.forward(params, x, table.lookup(act))
    torch.testing.assert_close(res.output, ref, rtol=1e-5, atol=1e-5)


def test_dma_host_step_runs_other_entries_as_their_callable():
    table = function_table.make_default_table()
    lenet.register_pooling(table)
    table.register("twice", lambda t: 2 * t)
    x = torch.randn(2, 3, 4, 4)
    assert torch.equal(engine.dma_host_step(x, "max_pool", table),
                       torch.nn.functional.max_pool2d(x, 2, 2))
    assert torch.equal(engine.dma_host_step(x, "twice", table), 2 * x)
    assert torch.equal(engine.dma_host_step(x, "relu", table),
                       x.clamp_min(0))


def test_run_refuses_params_on_another_device():
    graph, ep, _, x, table = _lenet()
    ep = {**ep, "fc2": ep["fc2"].to("meta")}
    for mode in ExecutionMode:
        with pytest.raises(ValueError, match="one device"):
            engine.run(graph, ep, x, mode, table)
    assert x.device.type == "cpu" and ep["fc1"].device.type == "cpu"


def test_monolithic_builds_no_program_off_the_card():
    graph, ep, _, x, table = _lenet()
    mono = engine.build_monolithic(graph, table)
    out = mono(ep, x)
    assert mono.programs == {}
    assert torch.equal(out, engine.run(graph, ep, x,
                                       ExecutionMode.MONOLITHIC,
                                       table).output)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["relu", "softplus"])
def test_flexible_dma_launches_the_activation_kernel(cuda, act):
    graph, ep, params, x, table = _lenet(act, device=cuda)
    kops.reset_launch_counts()
    res = engine.run(graph, ep, x, ExecutionMode.FLEXIBLE_DMA, table)
    counts = kops.launch_counts()
    assert counts["activation"] == 4          # the relu/softplus ops
    assert sum(counts.values()) == 4          # max_pool: its callable
    assert res.output.is_cuda and res.launches == 5
    ref = lenet.forward(params, x, table.lookup(act))
    torch.testing.assert_close(res.output, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("mode,depth", [
    ("sidebar", 1), ("sidebar_pipelined", 1), ("sidebar_pipelined", 2),
    ("sidebar_pipelined", 3), ("sidebar_pipelined", 8)])
def test_sidebar_modes_on_a_cuda_input(cuda, mode, depth):
    graph, ep, _, x, table = _lenet(device=cuda)
    m = ExecutionMode(mode)
    got = engine.run(graph, ep, x, m, table, depth=depth)
    cpu_ep = {k: v.cpu() for k, v in ep.items()}
    want = engine.run(graph, cpu_ep, x.cpu(), m, table, depth=depth)
    assert got.output.is_cuda and got.output.device == x.device
    torch.testing.assert_close(got.output.cpu(), want.output, rtol=1e-4,
                               atol=1e-4)
    assert dataclasses.asdict(got.sidebar.stats) == dataclasses.asdict(
        want.sidebar.stats)
    assert got.launches == want.launches == 1


@pytest.mark.gpu
def test_monolithic_captured_equals_eager_and_stays_frozen(cuda):
    graph, ep, _, x, table = _lenet("softplus", device=cuda)
    mono = engine.build_monolithic(graph, table)
    with graphs.disable_capture():
        eager = mono(ep, x)
    outs = [mono(ep, x) for _ in range(3)]    # eager, captured, replayed
    prog = mono.programs[x.device]
    assert (prog.captures, prog.replays) == (1, 1)
    assert all(torch.equal(o, eager) for o in outs)
    table.register("softplus", lambda t: torch.clamp_min(t, 0.0),
                   overwrite=True)
    assert torch.equal(mono(ep, x), eager)
    swapped = engine.run(graph, ep, x, ExecutionMode.SIDEBAR, table).output
    assert not torch.allclose(swapped, eager)
