"""Per-layer execution planning, the paper's "compilation tool" (§3.1)
(port of ``repro.core.policy``).

``AutoPolicy`` plans each layer graph:

  * mode: a sidebar mode when the intermediate fits the sidebar (SIDEBAR
    or SIDEBAR_PIPELINED, whichever the EDP model prefers), else
    FLEXIBLE_DMA; MONOLITHIC only for a layer with no flexible op;
  * ring depth: swept over ``depth_candidates`` under the sidebar
    capacity (a T-deep ring needs T slot pairs), scored by
    ``core.energy.estimate``;
  * fusion: runs of consecutive flexible ops share one host invocation a
    tile.

The defaults are the H100 spec of ``core.constants`` and a sidebar of
half its ``vmem_bytes`` (the SMs' shared memory), as the JAX planner
halves its chip's vector memory. ``plan`` returns a ``PlanResult``: the
``ExecutionPlan`` that ``PagedContinuousBatchingServer(plan=...)``
serves (layers keyed by graph name; ``ExecutionPlan.for_layer`` resolves
"i" for layer i) and the diagnostics of choosing it.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Callable, Sequence

from repro_torch.core import constants
from repro_torch.core.energy import estimate
from repro_torch.core.engine import account
from repro_torch.core.function_table import DEFAULT_TABLE, FunctionTable
from repro_torch.core.modes import (
    ExecutionMode,
    ExecutionPlan,
    LayerGraph,
    LayerPlan,
)
from repro_torch.core.sidebar import pipelined_capacity

Policy = Callable[[LayerGraph], ExecutionMode]

DEFAULT_DEPTH_CANDIDATES = (1, 2, 3, 4, 8)


def fixed(mode: ExecutionMode) -> Policy:
    def policy(graph: LayerGraph) -> ExecutionMode:
        return mode

    return policy


@dataclasses.dataclass(frozen=True)
class PlanDiagnostics:
    """What the planner saw while choosing. ``fallbacks`` lists layers
    forced off the sidebar modes by capacity; ``edp`` maps layer name ->
    the chosen plan's modeled EDP (J*s); ``depth_sweep`` maps layer name
    -> {depth: EDP} for every capacity-feasible SIDEBAR_PIPELINED depth
    scored."""

    fallbacks: tuple[str, ...] = ()
    edp: dict[str, float] = dataclasses.field(default_factory=dict)
    depth_sweep: dict[str, dict[int, float]] = dataclasses.field(
        default_factory=dict)


@dataclasses.dataclass(frozen=True)
class PlanResult:
    """An ``ExecutionPlan`` plus the diagnostics of producing it."""

    plan: ExecutionPlan
    diagnostics: PlanDiagnostics

    def for_layer(self, name: str) -> LayerPlan:
        return self.plan.for_layer(name)


@dataclasses.dataclass(frozen=True)
class AutoPolicy:
    """EDP-minimizing per-layer (mode, ring depth, fusion) choice under a
    sidebar-capacity constraint. Stateless: diagnostics come back in the
    ``PlanResult``."""

    table: FunctionTable = dataclasses.field(
        default_factory=lambda: DEFAULT_TABLE)
    sidebar_capacity: int = constants.H100.vmem_bytes // 2
    chip: constants.ChipSpec = constants.H100
    depth_candidates: Sequence[int] = DEFAULT_DEPTH_CANDIDATES

    def _ring_fits(self, graph: LayerGraph, depth: int) -> bool:
        """The largest stage's T-deep ring must fit the sidebar."""
        need = max(
            (pipelined_capacity(shape, op.out_shape, graph.itemsize,
                                tiles=depth)
             for _, op, shape in graph.flexible_ops()),
            default=0,
        )
        return need <= self.sidebar_capacity

    def plan_layer(self, graph: LayerGraph) -> tuple[LayerPlan, dict]:
        """Choose (mode, depth, fuse) for one layer; returns the plan and
        {"fallback": bool, "edp": float, "depth_sweep": {depth: edp}}."""
        if not graph.flexible_ops():
            plan = LayerPlan(ExecutionMode.MONOLITHIC, depth=1)
            edp = estimate(account(graph, plan.mode, self.table),
                           self.chip).edp
            return plan, {"fallback": False, "edp": edp, "depth_sweep": {}}

        candidates: list[LayerPlan] = [
            LayerPlan(ExecutionMode.FLEXIBLE_DMA, depth=1)]
        sweep: dict[int, float] = {}
        fallback = graph.max_intermediate_bytes() > self.sidebar_capacity
        if not fallback:
            candidates.append(LayerPlan(ExecutionMode.SIDEBAR, depth=1))
            for d in self.depth_candidates:
                if d >= 1 and self._ring_fits(graph, d):
                    candidates.append(
                        LayerPlan(ExecutionMode.SIDEBAR_PIPELINED, depth=d))

        scored: list[tuple[float, LayerPlan]] = []
        for plan in candidates:
            edp = estimate(account(graph, plan, self.table), self.chip).edp
            if plan.mode is ExecutionMode.SIDEBAR_PIPELINED:
                sweep[plan.depth] = edp
            scored.append((edp, plan))
        # stable min: ties keep candidate order (DMA < SIDEBAR < deeper)
        best_edp, best = min(scored, key=lambda t: t[0])
        return best, {"fallback": fallback, "edp": best_edp,
                      "depth_sweep": sweep}

    def plan(self, graphs: Sequence[LayerGraph]) -> PlanResult:
        """Resolve an ``ExecutionPlan`` over ``graphs``, plus the
        diagnostics. The plan's ``default`` is the modal per-layer
        choice."""
        layers: dict[str, LayerPlan] = {}
        fallbacks: list[str] = []
        edp: dict[str, float] = {}
        depth_sweep: dict[str, dict[int, float]] = {}
        for g in graphs:
            lp, diag = self.plan_layer(g)
            layers[g.name] = lp
            edp[g.name] = diag["edp"]
            if diag["depth_sweep"]:
                depth_sweep[g.name] = diag["depth_sweep"]
            if diag["fallback"]:
                fallbacks.append(g.name)
        if layers:
            default = Counter(layers.values()).most_common(1)[0][0]
        else:
            default = LayerPlan(ExecutionMode.SIDEBAR_PIPELINED)
        return PlanResult(
            plan=ExecutionPlan(default=default, layers=layers),
            diagnostics=PlanDiagnostics(fallbacks=tuple(fallbacks), edp=edp,
                                        depth_sweep=depth_sweep),
        )

    def __call__(self, graph: LayerGraph) -> ExecutionMode:
        return self.plan_layer(graph)[0].mode


def plan(graphs: Sequence[LayerGraph],
         policy: Policy | AutoPolicy | None = None) -> PlanResult:
    """Resolve a plan per layer. With an ``AutoPolicy`` (the default) the
    full (mode, depth, fuse) sweep runs; a plain ``Policy`` callable only
    chooses modes and gets default ring parameters."""
    if policy is None:
        policy = AutoPolicy()
    if isinstance(policy, AutoPolicy):
        return policy.plan(graphs)
    layers = {g.name: LayerPlan(policy(g)) for g in graphs}
    return PlanResult(
        plan=ExecutionPlan(default=LayerPlan(ExecutionMode.SIDEBAR_PIPELINED),
                           layers=layers),
        diagnostics=PlanDiagnostics(),
    )
