"""The Sidebar execution engine (port of ``repro.core.engine``).

Runs a ``LayerGraph`` (alternating static / flexible ops) under each of
the paper's three designs plus the ring-buffered SIDEBAR_PIPELINED
refinement. The modes give the same numbers (tests hold them to each
other and to the JAX engine) and differ in how many accelerator
launches happen, where intermediates live, who computes the flexible
functions and which protocol events fire.

Two layers of fidelity, as in the JAX package:

  1. ``run(...)`` executes the graph on the device of its input and
     parameters (the CPU, or the card), routing every flexible call
     through the mode's mechanism:

     * MONOLITHIC: one program with the flexible functions frozen at
       build (``build_monolithic``); a table hot-swap after build does
       not reach it. On the CPU it is a closure over the callables; on
       the card that closure is captured as a CUDA graph
       (``launch.graphs.Program``) and replayed.
     * FLEXIBLE_DMA: each static chain as its own program and each
       flexible op as its own dispatch, with a barrier after every one
       (``torch.cuda.synchronize`` on the card): the intermediate is
       materialized in device memory both ways. A flexible op that the
       standalone ``activation`` kernel takes launches it
       (``dma_host_step``).
     * SIDEBAR: every flexible op's operand crosses to the host, goes
       through a ``SidebarBuffer`` (ownership and traffic checked), is
       computed by the table's torch callable and comes back to the
       input's device.
     * SIDEBAR_PIPELINED: each flexible stage's operand is split into T
       tiles along its leading axis and traded through a T-deep
       ``SidebarRing``: every slot is filled, then retired first in,
       first out. On the card each tile is copied into pinned host
       memory asynchronously and the host waits on that tile's event
       before it reads it.

  2. ``account(...)``: exact counts with no execution, for
     ``core.energy.estimate``. ``pipeline_schedule`` is the one source of
     the pipelined stall / overlap counters, shared by ``run`` and
     ``account`` at every depth.

``run`` never moves a tensor the caller gave it: the input and every
parameter must sit on one device, or it raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.core.energy import VPU_RATE_DIV, TaskAccounting
from repro_torch.core.function_table import DEFAULT_TABLE, FunctionTable
from repro_torch.core.modes import (
    ExecutionMode,
    FlexibleOp,
    LayerGraph,
    LayerPlan,
    StaticOp,
    flexible_runs,
    segment_static_chains,
)
from repro_torch.core.sidebar import (
    Owner,
    SidebarBuffer,
    SidebarCall,
    SidebarRing,
    pipelined_capacity,
    required_capacity,
)

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Pipeline schedule: the shared overlap model of SIDEBAR_PIPELINED.
#
# Abstract cycle unit: one tensor-core flop-time at peak. A host vector op
# costs VPU_RATE_DIV cycles, so both sides' busy time is comparable.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StageTiming:
    """Timing of one flexible stage (a fused run of one or more
    consecutive flexible ops) under the T-deep ring protocol.

    With T tiles, all but the first tile's host time can hide behind the
    producer chain's epilogue and all but the last tile's behind the
    consumer chain's prologue; each adjacent static op donates at most
    half its flops, and total overlap is capped at the host's busy
    time."""

    index: int             # position of the stage's first op in graph.ops
    host_cycles: int       # total host time of this stage (all tiles)
    producer_cycles: int   # preceding static op's work
    consumer_cycles: int   # following static op's work
    tiles: int             # ring depth T; 1 (serial) when unsplittable
    indices: tuple[int, ...] = ()    # all fused op positions
    functions: tuple[str, ...] = ()  # function-table keys, in order
    operand_bytes: int = 0  # stage input crossing acc -> sidebar -> host
    result_bytes: int = 0   # stage output crossing host -> sidebar -> acc

    @property
    def overlap_cycles(self) -> int:
        """Cycles where host and accelerator are busy simultaneously."""
        if self.tiles < 2:
            return 0
        ahead = self.host_cycles * (self.tiles - 1) // self.tiles
        return min(
            self.host_cycles,
            min(ahead, self.producer_cycles // 2)
            + min(ahead, self.consumer_cycles // 2),
        )

    @property
    def stall_cycles(self) -> int:
        """Accelerator cycles spent polling the return flag."""
        return self.host_cycles - self.overlap_cycles


def host_cycles_of(op: FlexibleOp, operand_shape: tuple[int, ...],
                   table: FunctionTable) -> int:
    """Host time of one flexible op, in tensor-core flop-time cycles."""
    n = int(math.prod(operand_shape))
    return int(n * table.cost(op.function) * VPU_RATE_DIV)


def _splittable(operand_shape: tuple[int, ...],
                out_shape: tuple[int, ...]) -> bool:
    """A flexible op can be ring-buffered when its operand and result
    tile along a shared leading axis."""
    return (
        len(operand_shape) >= 1
        and len(out_shape) >= 1
        and operand_shape[0] >= 2
        and operand_shape[0] == out_shape[0]
    )


def pipeline_schedule(
    graph: LayerGraph,
    table: FunctionTable = DEFAULT_TABLE,
    *,
    depth: int = 2,
    fuse: bool = True,
) -> list[StageTiming]:
    """Per-flexible-stage overlap schedule for SIDEBAR_PIPELINED: each
    splittable stage tiles its operand into ``min(depth, leading axis)``
    chunks; ``fuse`` merges runs of consecutive flexible ops into one
    stage (one host invocation a tile)."""
    if depth < 1:
        raise ValueError(f"ring depth must be >= 1, got {depth}")
    shapes = graph.shapes()
    stages = []
    for indices in flexible_runs(graph, fuse=fuse):
        first, last = indices[0], indices[-1]
        prev = graph.ops[first - 1] if first > 0 else None
        nxt = graph.ops[last + 1] if last + 1 < len(graph.ops) else None
        producer = prev.flops if isinstance(prev, StaticOp) else 0
        consumer = nxt.flops if isinstance(nxt, StaticOp) else 0
        # the whole run must tile along one shared leading axis
        lead = shapes[first][0] if shapes[first] else 0
        splittable = all(
            _splittable(shapes[i], graph.ops[i].out_shape)
            and shapes[i][0] == lead
            for i in indices
        )
        tiles = min(depth, lead) if splittable and depth >= 2 else 1
        stages.append(
            StageTiming(
                index=first,
                host_cycles=sum(
                    host_cycles_of(graph.ops[i], shapes[i], table)
                    for i in indices
                ),
                producer_cycles=int(producer),
                consumer_cycles=int(consumer),
                tiles=tiles,
                indices=indices,
                functions=tuple(graph.ops[i].function for i in indices),
                operand_bytes=graph.bytes_of(shapes[first]),
                result_bytes=graph.bytes_of(graph.ops[last].out_shape),
            )
        )
    return stages


# ---------------------------------------------------------------------------
# Numeric execution.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RunResult:
    output: Tensor
    accounting: TaskAccounting
    launches: int
    sidebar: SidebarBuffer | None = None


def _device_of(params: dict[str, Any], x: Tensor) -> torch.device:
    """The device a task runs on: its input's, where every tensor
    parameter must also sit (nothing is moved quietly)."""
    for name, p in params.items():
        if isinstance(p, Tensor) and p.device != x.device:
            raise ValueError(
                f"parameter {name!r} is on {p.device} and the input on "
                f"{x.device}: the engine runs where both are; move them "
                "to one device first")
    return x.device


def _barrier(x: Tensor) -> Tensor:
    """FLEXIBLE_DMA's DMA barrier: the device finishes before the next
    dispatch (a no-op on the CPU, where every op has finished)."""
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    return x


def _tiles_to_host(x: Tensor, tiles: int
                   ) -> list[tuple[Tensor, torch.cuda.Event | None]]:
    """``x`` split into ``tiles`` along its leading axis, as
    ``np.array_split`` splits. On the card each tile is copied into
    pinned host memory asynchronously and paired with an event recorded
    after its copy: the host must wait on that event before it reads the
    tile."""
    parts = torch.tensor_split(x, tiles, dim=0)
    if not x.is_cuda:
        return [(p, None) for p in parts]
    stream = torch.cuda.current_stream(x.device)
    out = []
    for p in parts:
        host = torch.empty(p.shape, dtype=p.dtype, pin_memory=True)
        host.copy_(p, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
        out.append((host, done))
    return out


def dma_host_step(x: Tensor, function: str, table: FunctionTable) -> Tensor:
    """FLEXIBLE_DMA's dispatch of one flexible op. The one rule: an entry
    the standalone activation kernel takes (one with a ``device_id`` or a
    ``device_expr``) goes through ``kernels.activations.activation``,
    which launches ``csrc/activation.cu`` on a CUDA tensor and takes its
    plain version on a CPU tensor; any other entry (LeNet's 4-D
    ``max_pool``) runs its torch callable as its own dispatch."""
    # imported here: the kernels package imports core.function_table,
    # whose package imports this module
    from repro_torch.kernels.activations import activation

    entry = table[function]
    if entry.device_id is not None or entry.device_expr is not None:
        return activation(x, function, table=table)
    return entry.fn(x)


class MonolithicProgram:
    """The fixed-function accelerator: a task whose flexible functions
    were resolved when it was built. On the card the task is captured as
    a CUDA graph at its second call on a signature (``capture_after=2``:
    a one-shot ``run`` stays eager) and replayed after; ``programs``
    holds the ``Program`` of each device."""

    def __init__(self, graph: LayerGraph,
                 frozen: dict[str, Callable[..., Tensor]]) -> None:
        self.graph = graph
        self._frozen = frozen
        self.programs: dict = {}   # device -> launch.graphs.Program

    def _task(self, params: dict[str, Any], x: Tensor) -> Tensor:
        for op in self.graph.ops:
            if isinstance(op, StaticOp):
                x = op.fn(params[op.name], x)
            else:
                x = self._frozen[op.function](x)
        return x

    def __call__(self, params: dict[str, Any], x: Tensor) -> Tensor:
        device = _device_of(params, x)
        if device.type != "cuda":
            return self._task(params, x)
        prog = self.programs.get(device)
        if prog is None:
            # imported here, as dma_host_step's wrapper
            from repro_torch.launch.graphs import Program

            prog = self.programs[device] = Program(
                lambda fixed, x: self._task(fixed[0], x), device=device,
                capture_after=2)
        return prog((params,), x=x)


def build_monolithic(graph: LayerGraph,
                     table: FunctionTable = DEFAULT_TABLE
                     ) -> MonolithicProgram:
    """Freeze the whole task into one program. Flexible functions are
    resolved now; later table edits do not reach it (the inflexibility
    the paper ascribes to monolithic hardware)."""
    frozen = {op.function: table.lookup(op.function)
              for op in graph.ops if isinstance(op, FlexibleOp)}
    return MonolithicProgram(graph, frozen)


def run(
    graph: LayerGraph,
    params: dict[str, Any],
    x: Tensor,
    mode: ExecutionMode | LayerPlan,
    table: FunctionTable = DEFAULT_TABLE,
    *,
    sidebar_capacity: int | None = None,
    depth: int = 2,
    fuse: bool = True,
) -> RunResult:
    """Execute the task under ``mode`` on the device of ``x`` and
    ``params``; returns the output and the exact accounting. ``depth`` /
    ``fuse`` shape the SIDEBAR_PIPELINED ring (ignored by the other
    modes); a ``LayerPlan`` as ``mode`` supplies all three."""
    if isinstance(mode, LayerPlan):
        mode, depth, fuse = mode.mode, mode.depth, mode.fuse
    device = _device_of(params, x)
    acct = account(graph, mode, table, depth=depth, fuse=fuse)

    if mode is ExecutionMode.MONOLITHIC:
        out = build_monolithic(graph, table)(params, x)
        return RunResult(out, acct, launches=1)

    if mode is ExecutionMode.FLEXIBLE_DMA:
        # one launch a static chain; each flexible op its own dispatch,
        # the intermediate materialized both ways
        launches = 0
        for chain in segment_static_chains(graph):
            static_part = [op for op in chain if isinstance(op, StaticOp)]
            if static_part:
                for op in static_part:
                    x = op.fn(params[op.name], x)
                x = _barrier(x)  # the DMA-out barrier
                launches += 1
            for op in chain:
                if isinstance(op, FlexibleOp):
                    x = _barrier(dma_host_step(x, op.function, table))
        return RunResult(x, acct, launches=launches)

    if mode is ExecutionMode.SIDEBAR:
        # serial sidebar: one fused launch; every flexible op's operand
        # goes through the buffer, whose regions are recycled
        capacity = sidebar_capacity or required_capacity(
            graph.shapes()[0], graph.itemsize, copies=2)
        for _, op, shape in graph.flexible_ops():
            capacity = max(
                capacity,
                required_capacity(shape, graph.itemsize, copies=2),
                required_capacity(op.out_shape, graph.itemsize, copies=2),
            )
        sb = SidebarBuffer(capacity, name=f"{graph.name}.sidebar")

        for i, op in enumerate(graph.ops):
            if isinstance(op, StaticOp):
                x = op.fn(params[op.name], x)
                sb.stats.acc_busy_cycles += int(op.flops)
                continue
            operand = x.to("cpu")   # a synchronous copy off the card
            opn, res = f"op{i}.operand", f"op{i}.result"
            sb.allocate(opn, operand.numel() * operand.element_size())
            sb.allocate(res, int(math.prod(op.out_shape))
                        * operand.element_size())
            sb.write(Owner.ACCELERATOR, opn, operand)
            sb.invoke_host(
                SidebarCall(function=op.function, in_regions=(opn,),
                            out_regions=(res,),
                            n_elements=operand.numel()),
                table, dtype=operand.dtype)
            x = sb.read(Owner.ACCELERATOR, res).reshape(op.out_shape)
            x = x.to(device)
            # the accelerator polled the return flag for the whole host
            # computation: fully serialized
            h = host_cycles_of(op, tuple(operand.shape), table)
            sb.stats.host_busy_cycles += h
            sb.stats.stall_cycles += h
            sb.free(opn)
            sb.free(res)
        return RunResult(x, acct, launches=1, sidebar=sb)

    if mode is not ExecutionMode.SIDEBAR_PIPELINED:
        raise ValueError(f"unknown execution mode {mode!r}")
    # SIDEBAR_PIPELINED: one fused launch; each flexible stage's operand
    # is split into T tiles and traded through a T-deep ring; runs of
    # consecutive flexible ops share one host invocation a tile
    stages = pipeline_schedule(graph, table, depth=depth, fuse=fuse)
    schedule = {s.index: s for s in stages}
    shapes = graph.shapes()
    capacity = sidebar_capacity or 0
    for s in stages:
        capacity = max(capacity, pipelined_capacity(
            shapes[s.index], graph.ops[s.indices[-1]].out_shape,
            graph.itemsize, tiles=s.tiles))
    sb = SidebarBuffer(max(capacity, 512), name=f"{graph.name}.sidebar2")
    fused_tail = {i for s in stages for i in s.indices[1:]}

    for i, op in enumerate(graph.ops):
        if isinstance(op, StaticOp):
            x = op.fn(params[op.name], x)
            sb.stats.acc_busy_cycles += int(op.flops)
            continue
        if i in fused_tail:
            continue  # computed by its stage leader's invocation
        stage = schedule[i]
        chain = stage.functions[1:]
        out_shape = graph.ops[stage.indices[-1]].out_shape
        itemsize, dtype = x.element_size(), x.dtype
        if stage.tiles == 1:
            # unsplittable operand: the serial handshake on one recycled
            # pair; the fused chain still rides one invocation
            operand = x.to("cpu")
            opn, res = f"op{i}.operand", f"op{i}.result"
            sb.allocate(opn, operand.numel() * itemsize)
            sb.allocate(res, int(math.prod(out_shape)) * itemsize)
            sb.write(Owner.ACCELERATOR, opn, operand)
            sb.invoke_host(
                SidebarCall(op.function, (opn,), (res,), operand.numel(),
                            chain=chain),
                table, dtype=dtype)
            x = sb.read(Owner.ACCELERATOR, res).reshape(out_shape)
            x = x.to(device)
            sb.free(opn)
            sb.free(res)
        else:
            tiles = _tiles_to_host(x, stage.tiles)
            first = tiles[0][0]
            res_rest = int(math.prod(out_shape[1:]))
            ring = SidebarRing(
                sb, f"op{i}",
                operand_nbytes=first.numel() * itemsize,
                result_nbytes=first.shape[0] * res_rest * itemsize,
                depth=stage.tiles,
            )
            results: list[Tensor | None] = [None] * stage.tiles

            def _retire(t: int, slot) -> None:
                # host finishes tile t (after its copy has landed):
                # result written, return flag raised; the accelerator
                # reads it back and frees the slot
                tile, copied = tiles[t]
                if copied is not None:
                    copied.synchronize()
                sb.host_call(
                    SidebarCall(op.function, (slot.operand.name,),
                                (slot.result.name,), tile.numel(),
                                chain=chain),
                    table, dtype=dtype)
                ring.to_accelerator(slot)
                results[t] = sb.read(Owner.ACCELERATOR, slot.result.name)
                ring.release(slot)

            # ring depth == tile count: the accelerator fills and invokes
            # every slot ahead of the host (legal because ownership is
            # per region), then retirement drains first in, first out
            window = []
            for t in range(stage.tiles):
                slot = ring.acquire(t)
                sb.write(Owner.ACCELERATOR, slot.operand.name, tiles[t][0])
                ring.to_host(slot)
                window.append((t, slot))
            for entry in window:  # pipeline drain
                _retire(*entry)
            ring.free()
            x = torch.cat(results, dim=0).reshape(out_shape).to(device)
        sb.stats.host_busy_cycles += stage.host_cycles
        sb.stats.overlap_cycles += stage.overlap_cycles
        sb.stats.stall_cycles += stage.stall_cycles
    return RunResult(x, acct, launches=1, sidebar=sb)


# ---------------------------------------------------------------------------
# Analytic accounting (drives the energy model and the planner).
# ---------------------------------------------------------------------------


def account(
    graph: LayerGraph,
    mode: ExecutionMode | LayerPlan,
    table: FunctionTable = DEFAULT_TABLE,
    *,
    depth: int = 2,
    fuse: bool = True,
) -> TaskAccounting:
    """Exact byte / flop / protocol counts for one task under ``mode``.

    Shared by every mode (paper: "the initial and final DMA processes
    must still take place"): task input in, task output out, weight
    streaming and the static ops' flops."""
    if isinstance(mode, LayerPlan):
        mode, depth, fuse = mode.mode, mode.depth, mode.fuse
    io_bytes = graph.in_bytes + graph.out_bytes
    weight_bytes = graph.weight_bytes
    mxu = graph.static_flops

    flex = graph.flexible_ops()
    flex_elems = [(int(math.prod(shape)), table.cost(op.function))
                  for _, op, shape in flex]
    flex_ops_total = int(sum(n * c for n, c in flex_elems))
    flex_elems_total = int(sum(n for n, _ in flex_elems))
    flex_bytes_total = int(
        sum(graph.bytes_of(shape) for _, _, shape in flex)
        + sum(graph.bytes_of(op.out_shape) for _, op, _ in flex)
    )

    if mode is ExecutionMode.MONOLITHIC:
        return TaskAccounting(
            mode=mode.value,
            hbm_io_bytes=io_bytes,
            hbm_weight_bytes=weight_bytes,
            mxu_flops=mxu,
            flex_hw_ops=flex_ops_total,       # dedicated in-pipeline unit
            flex_elements=flex_elems_total,
            datapath_bytes=flex_bytes_total,  # internal registers/SRAM
            launches=1,
            flex_stages=len(flex),
            dma_flushes=2,                    # initial in + final out
        )

    if mode is ExecutionMode.FLEXIBLE_DMA:
        n_chains = len(segment_static_chains(graph))
        # each flexible operand crosses the bus 4x: acc store, host load,
        # host store, next-acc load (paper §5.3.2)
        dma_intermediate = 2 * flex_bytes_total
        return TaskAccounting(
            mode=mode.value,
            hbm_io_bytes=io_bytes,
            hbm_weight_bytes=weight_bytes,
            hbm_intermediate_bytes=dma_intermediate,
            mxu_flops=mxu,
            flex_vpu_ops=flex_ops_total,
            flex_elements=flex_elems_total,
            launches=n_chains,
            dma_flushes=2 + 2 * len(flex),    # a flush a handoff
            host_invocations=len(flex),
            flex_stages=len(flex),
        )

    # SIDEBAR / SIDEBAR_PIPELINED: the intermediate crosses the
    # scratchpad twice and never touches HBM; they differ in protocol
    # counts, in how much host time the accelerator waits out, and (when
    # pipelining fuses a run) in the inter-op intermediates kept on the
    # host
    sidebar_bytes = 2 * flex_bytes_total
    stages = pipeline_schedule(graph, table, depth=depth, fuse=fuse)
    host_busy = sum(s.host_cycles for s in stages)

    if mode is ExecutionMode.SIDEBAR:
        return TaskAccounting(
            mode=mode.value,
            hbm_io_bytes=io_bytes,
            hbm_weight_bytes=weight_bytes,
            sidebar_bytes=sidebar_bytes,
            mxu_flops=mxu,
            flex_vpu_ops=flex_ops_total,
            flex_elements=flex_elems_total,
            launches=1,
            dma_flushes=2,
            handshakes=2 * len(flex),
            host_invocations=len(flex),
            flex_stages=len(flex),
            host_busy_cycles=host_busy,
            acc_busy_cycles=mxu,
            stall_cycles=host_busy,   # fully serialized (paper §4)
            overlap_cycles=0,
        )

    if mode is not ExecutionMode.SIDEBAR_PIPELINED:
        raise ValueError(f"unknown execution mode {mode!r}")
    return TaskAccounting(
        mode=mode.value,
        hbm_io_bytes=io_bytes,
        hbm_weight_bytes=weight_bytes,
        # only each stage's input and final output cross the sidebar
        sidebar_bytes=2 * sum(s.operand_bytes + s.result_bytes
                              for s in stages),
        mxu_flops=mxu,
        flex_vpu_ops=flex_ops_total,
        flex_elements=flex_elems_total,
        launches=1,
        dma_flushes=2,
        # one flag per slot per direction: T tiles x (invoke + return)
        handshakes=sum(2 * s.tiles for s in stages),
        host_invocations=sum(s.tiles for s in stages),
        flex_stages=len(stages),
        host_busy_cycles=host_busy,
        acc_busy_cycles=mxu,
        stall_cycles=sum(s.stall_cycles for s in stages),
        overlap_cycles=sum(s.overlap_cycles for s in stages),
    )


def account_model(
    graphs: list[LayerGraph],
    mode: ExecutionMode | LayerPlan,
    table: FunctionTable = DEFAULT_TABLE,
    *,
    depth: int = 2,
    fuse: bool = True,
) -> TaskAccounting:
    """Accounting for a whole model: the merged per-layer tasks."""
    accts = [account(g, mode, table, depth=depth, fuse=fuse)
             for g in graphs]
    total = accts[0]
    for a in accts[1:]:
        total = total.merge(a)
    return total
