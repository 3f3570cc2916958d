"""Execution modes and plans (mirror of ``repro.core.modes``).

``LayerPlan``/``ExecutionPlan`` carry the deployment choice per layer;
``kernels.ops`` resolves them at call time. The port serves ``SIDEBAR``
(the fused kernel with the intermediate on chip) and ``MONOLITHIC``
(which routes the same way). ``SIDEBAR_PIPELINED`` and ``FLEXIBLE_DMA``
need kernels that are still to be ported; ``require_served`` rejects
them.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Mapping


class ExecutionMode(enum.Enum):
    MONOLITHIC = "monolithic"
    FLEXIBLE_DMA = "flexible_dma"
    SIDEBAR = "sidebar"
    SIDEBAR_PIPELINED = "sidebar_pipelined"


# mode -> the ROADMAP.md item (Queue 2) that ports its kernels
_UNPORTED = {
    ExecutionMode.SIDEBAR_PIPELINED:
        "ROADMAP Queue 2 item 5 (sidebar_mlp_pipelined)",
    ExecutionMode.FLEXIBLE_DMA:
        "ROADMAP Queue 2 items 7-8 (sidebar_matmul, activation)",
}


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

    def all_plans(self) -> list[LayerPlan]:
        return [self.default, *self.layers.values()]


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


def require_served(plan: "LayerPlan | ExecutionPlan") -> None:
    """Raise ``NotImplementedError`` for a plan whose mode needs a kernel
    the port does not have yet."""
    plans = plan.all_plans() if isinstance(plan, ExecutionPlan) else [plan]
    for lp in plans:
        item = _UNPORTED.get(lp.mode)
        if item is not None:
            raise NotImplementedError(
                f"execution mode {lp.mode.value!r} is not ported yet: "
                f"see {item}")
