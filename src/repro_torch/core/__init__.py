"""Core: the paper's contribution, Sidebar-based CPU/accelerator
cooperation (mirror of ``repro.core``'s public surface, with the H100
spec in the place of the JAX package's chip).

  * ``FunctionTable`` / ``DEFAULT_TABLE``: the host function table.
  * ``SidebarBuffer``, ``SidebarRing``: the ownership-checked scratchpad
    protocol model.
  * ``LayerGraph`` / ``StaticOp`` / ``FlexibleOp``: the static/flexible
    IR.
  * ``ExecutionMode``: MONOLITHIC | FLEXIBLE_DMA | SIDEBAR |
    SIDEBAR_PIPELINED.
  * ``engine.run`` / ``engine.account``: execute / meter a task.
  * ``energy.estimate``: the latency / energy / EDP model.
  * ``policy.AutoPolicy``: per-layer mode selection.
"""

from repro_torch.core.constants import H100, ChipSpec
from repro_torch.core.energy import (
    Estimate,
    TaskAccounting,
    estimate,
    normalized_edp,
)
from repro_torch.core.engine import (
    StageTiming,
    account,
    account_model,
    build_monolithic,
    pipeline_schedule,
    run,
)
from repro_torch.core.function_table import (
    DEFAULT_TABLE,
    FunctionTable,
    make_default_table,
)
from repro_torch.core.modes import (
    ExecutionMode,
    ExecutionPlan,
    FlexibleOp,
    LayerGraph,
    LayerPlan,
    OpKind,
    StaticOp,
    flexible_runs,
    segment_static_chains,
)
from repro_torch.core.policy import (
    AutoPolicy,
    PlanDiagnostics,
    PlanResult,
    fixed,
    plan,
)
from repro_torch.core.sidebar import (
    Owner,
    PingPongPair,
    Region,
    RingSlot,
    SidebarBuffer,
    SidebarCall,
    SidebarProtocolError,
    SidebarRing,
    SidebarStats,
    pipelined_capacity,
)

__all__ = [
    "H100",
    "ChipSpec",
    "Estimate",
    "TaskAccounting",
    "estimate",
    "normalized_edp",
    "account",
    "account_model",
    "build_monolithic",
    "run",
    "DEFAULT_TABLE",
    "FunctionTable",
    "make_default_table",
    "ExecutionMode",
    "ExecutionPlan",
    "FlexibleOp",
    "LayerGraph",
    "LayerPlan",
    "OpKind",
    "StaticOp",
    "flexible_runs",
    "segment_static_chains",
    "AutoPolicy",
    "PlanDiagnostics",
    "PlanResult",
    "fixed",
    "plan",
    "Owner",
    "PingPongPair",
    "Region",
    "RingSlot",
    "SidebarBuffer",
    "SidebarCall",
    "SidebarProtocolError",
    "SidebarRing",
    "SidebarStats",
    "StageTiming",
    "pipeline_schedule",
    "pipelined_capacity",
]
