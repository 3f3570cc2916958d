"""Execution modes, the static/flexible layer-graph IR, and plans
(mirror of ``repro.core.modes``).

A ``LayerGraph`` is one accelerator task: an alternating list of
``StaticOp``s (fixed tensor primitives: products, convolutions) and
``FlexibleOp``s (function-table entries applied to the previous
intermediate). ``core.engine`` runs and accounts it under each mode;
``models.lenet`` emits the paper's workload in it. ``StaticOp.fn`` is a
torch callable ``(param, x) -> x``.

``LayerPlan``/``ExecutionPlan`` carry the deployment choice per layer;
``core.policy`` produces them and ``kernels.ops`` resolves them at call
time. Every mode is served:
``SIDEBAR`` and ``MONOLITHIC`` take the fused serial kernel,
``SIDEBAR_PIPELINED`` the T-deep ring kernel at the plan's depth, and
``FLEXIBLE_DMA`` the unfused three-launch route (producer product,
standalone activation, consumer product) with gathered-view decode
attention.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Callable, Mapping, Sequence

import torch


class ExecutionMode(enum.Enum):
    MONOLITHIC = "monolithic"
    FLEXIBLE_DMA = "flexible_dma"
    SIDEBAR = "sidebar"
    SIDEBAR_PIPELINED = "sidebar_pipelined"


class OpKind(enum.Enum):
    STATIC = "static"      # tensor cores: product/convolution
    FLEXIBLE = "flexible"  # host / function table: activation, pooling


@dataclasses.dataclass(frozen=True)
class StaticOp:
    """A fixed-function tensor primitive (one "small accelerator").

    ``fn(param, x) -> y`` must be pure. ``flops`` and weight bytes are
    declared, not inferred, so accounting is exact."""

    name: str
    fn: Callable[..., torch.Tensor]
    out_shape: tuple[int, ...]
    flops: int                    # tensor-core flops for one call
    weight_bytes: int             # parameter bytes streamed from HBM
    kind: OpKind = dataclasses.field(default=OpKind.STATIC, init=False)


@dataclasses.dataclass(frozen=True)
class FlexibleOp:
    """A host/function-table op applied to the previous intermediate."""

    function: str                 # function-table key
    out_shape: tuple[int, ...]
    kind: OpKind = dataclasses.field(default=OpKind.FLEXIBLE, init=False)


Op = StaticOp | FlexibleOp


@dataclasses.dataclass(frozen=True)
class LayerGraph:
    """One accelerator task: an alternating sequence of ops.

    ``in_shape`` describes the activation entering the task (DMA'd in at
    task start in every mode); ``itemsize`` is the bytes per element of
    activations and intermediates."""

    name: str
    ops: tuple[Op, ...]
    in_shape: tuple[int, ...]
    itemsize: int = 4

    def __post_init__(self) -> None:
        if not self.ops:
            raise ValueError(f"layer graph {self.name!r} has no ops")

    def shapes(self) -> list[tuple[int, ...]]:
        """[in_shape, op0.out, op1.out, ...]."""
        return [self.in_shape] + [op.out_shape for op in self.ops]

    def bytes_of(self, shape: Sequence[int]) -> int:
        return int(math.prod(shape)) * self.itemsize

    @property
    def in_bytes(self) -> int:
        return self.bytes_of(self.in_shape)

    @property
    def out_bytes(self) -> int:
        return self.bytes_of(self.ops[-1].out_shape)

    @property
    def static_flops(self) -> int:
        return sum(op.flops for op in self.ops if isinstance(op, StaticOp))

    @property
    def weight_bytes(self) -> int:
        return sum(op.weight_bytes for op in self.ops
                   if isinstance(op, StaticOp))

    def flexible_ops(self) -> list[tuple[int, FlexibleOp, tuple[int, ...]]]:
        """(index, op, operand_shape) for each flexible op; the operand is
        the previous op's output (or the input for index 0)."""
        shapes = self.shapes()
        return [(i, op, shapes[i]) for i, op in enumerate(self.ops)
                if isinstance(op, FlexibleOp)]

    def max_intermediate_bytes(self) -> int:
        """Sidebar capacity the task needs (largest staged intermediate)."""
        flex = self.flexible_ops()
        if not flex:
            return 0
        return max(max(self.bytes_of(shape), self.bytes_of(op.out_shape))
                   for _, op, shape in flex)


def flexible_runs(graph: LayerGraph, fuse: bool = True
                  ) -> list[tuple[int, ...]]:
    """Indices of flexible ops grouped into maximal consecutive runs (one
    host invocation per tile under SIDEBAR_PIPELINED); with
    ``fuse=False`` every flexible op is its own run."""
    runs: list[tuple[int, ...]] = []
    current: list[int] = []
    for i, op in enumerate(graph.ops):
        if isinstance(op, FlexibleOp):
            if current and (not fuse or current[-1] != i - 1):
                runs.append(tuple(current))
                current = []
            current.append(i)
        elif current:
            runs.append(tuple(current))
            current = []
    if current:
        runs.append(tuple(current))
    return runs


def segment_static_chains(graph: LayerGraph) -> list[list[Op]]:
    """Split the op list into maximal chains, breaking after flexible
    ops: FLEXIBLE_DMA launches one accelerator per chain (the paper's
    S1..S5 for LeNet, Figure 4)."""
    chains: list[list[Op]] = [[]]
    for op in graph.ops:
        chains[-1].append(op)
        if isinstance(op, FlexibleOp):
            chains.append([])
    if not chains[-1]:
        chains.pop()
    return chains


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """How one layer executes: mode + ring depth + fusion."""

    mode: ExecutionMode
    depth: int = 2
    fuse: bool = True

    def __post_init__(self) -> None:
        if self.depth < 1:
            raise ValueError(f"ring depth must be >= 1, got {self.depth}")


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """A per-layer mapping of ``LayerPlan``s plus a default. Layers are
    keyed by graph name or integer layer index; ``for_layer`` falls back
    exact key -> str(key) -> default."""

    default: LayerPlan
    layers: Mapping[str | int, LayerPlan] = dataclasses.field(
        default_factory=dict)

    @classmethod
    def uniform(cls, mode: ExecutionMode | str, depth: int = 2,
                fuse: bool = True) -> "ExecutionPlan":
        if isinstance(mode, str):
            mode = ExecutionMode(mode)
        return cls(default=LayerPlan(mode, depth, fuse))

    @classmethod
    def by_index(cls, plans: Sequence[LayerPlan],
                 default: LayerPlan | None = None) -> "ExecutionPlan":
        """Plan for a model's layer stack: plans[i] applies to layer i;
        the default is the most common plan unless given."""
        if default is None:
            if not plans:
                raise ValueError("by_index needs at least one LayerPlan")
            counts: dict[LayerPlan, int] = {}
            for p in plans:
                counts[p] = counts.get(p, 0) + 1
            default = max(counts, key=counts.get)
        return cls(default=default, layers=dict(enumerate(plans)))

    def for_layer(self, key: str | int | None) -> LayerPlan:
        if key is None:
            return self.default
        hit = self.layers.get(key)
        if hit is None:
            if isinstance(key, int):
                hit = self.layers.get(str(key))
            elif isinstance(key, str) and key.lstrip("-").isdigit():
                hit = self.layers.get(int(key))
        return hit if hit is not None else self.default

    @property
    def is_uniform(self) -> bool:
        """True when every per-layer entry equals the default."""
        return all(lp == self.default for lp in self.layers.values())

    def cache_key(self) -> tuple:
        """Hashable fingerprint (``layers`` is a plain dict, so the
        dataclass itself is not hashable)."""
        return (
            self.default,
            tuple(sorted(((str(k), v) for k, v in self.layers.items()),
                         key=lambda kv: kv[0])),
        )


def coerce_layer_plan(
    plan: "LayerPlan | ExecutionPlan | ExecutionMode | str",
    depth: int | None = None,
) -> LayerPlan:
    """Normalize any plan spelling to a single ``LayerPlan`` (a whole
    ``ExecutionPlan`` collapses to its default; a bare mode gets depth 2
    when pipelined, else 1; ``depth`` overrides either)."""
    if isinstance(plan, ExecutionPlan):
        plan = plan.default
    if isinstance(plan, str):
        plan = ExecutionMode(plan)
    if isinstance(plan, ExecutionMode):
        base = 2 if plan is ExecutionMode.SIDEBAR_PIPELINED else 1
        plan = LayerPlan(plan, depth=depth if depth is not None else base)
    elif depth is not None and depth != plan.depth:
        plan = dataclasses.replace(plan, depth=depth)
    return plan
