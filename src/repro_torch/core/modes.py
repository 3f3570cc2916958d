"""Execution modes and plans (mirror of ``repro.core.modes``).

``LayerPlan``/``ExecutionPlan`` carry the deployment choice per layer;
``kernels.ops`` resolves them at call time. Every mode is served:
``SIDEBAR`` and ``MONOLITHIC`` take the fused serial kernel,
``SIDEBAR_PIPELINED`` the T-deep ring kernel at the plan's depth, and
``FLEXIBLE_DMA`` the unfused three-launch route (producer product,
standalone activation, consumer product) with gathered-view decode
attention.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Mapping, Sequence


class ExecutionMode(enum.Enum):
    MONOLITHIC = "monolithic"
    FLEXIBLE_DMA = "flexible_dma"
    SIDEBAR = "sidebar"
    SIDEBAR_PIPELINED = "sidebar_pipelined"


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
