"""Public entry points of the port's kernels (mirror of
``repro.kernels.ops``: the ambient execution plan, ``layer_scope``,
``record_dispatches`` and the ``sidebar_mlp`` / ``sidebar_gated_mlp`` /
``sidebar_matmul`` / ``host_activation`` / ``paged_attention_gqa`` /
``paged_attention_mla`` / ``flash_attention`` ops).

Each op resolves the ambient plan for the current layer, records its
dispatch, and calls the kernel wrapper for that plan's route — which
launches the Hopper kernel for a CUDA tensor and takes the plain version
for a CPU tensor. Every ``ExecutionMode`` is served:

  * ``SIDEBAR`` / ``MONOLITHIC``: the fused serial MLP kernel and the
    paged decode kernel (GQA or MLA);
  * ``SIDEBAR_PIPELINED``: the T-deep ring MLP kernel at the plan's
    depth, and the paged decode kernel;
  * ``FLEXIBLE_DMA``: the unfused MLP (producer ``sidebar_matmul``,
    standalone ``host_activation`` with its input and output in HBM,
    consumer ``sidebar_matmul``) and the gather route for decode
    attention — that mode's semantics on every device, as in the JAX
    package.

The gated MLP (``sidebar_gated_mlp``) is the fused serial kernel under
every plan: the JAX package has no ring or DMA route for it, and the
port invents none. Its layers still take the plan's attention route.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable

import torch

from repro_torch.core.function_table import DEFAULT_TABLE, FunctionTable
from repro_torch.core.modes import (
    ExecutionMode,
    ExecutionPlan,
    LayerPlan,
    coerce_layer_plan,
)
from repro_torch.kernels import build

# The ops ``sidebar_matmul`` (the single static primitive c = f(a @ b))
# and ``host_activation`` (the FLEXIBLE_DMA host step: its own launch,
# input and output in HBM) need no plan of their own: they are the
# kernel wrappers themselves, which take the plain version for a CPU
# tensor.
from repro_torch.kernels.activations import activation as host_activation
from repro_torch.kernels.flash_attention import (
    flash_attention as _flash_kernel,
)
from repro_torch.kernels.paged_attention import (
    paged_gqa,
    paged_gqa_reference,
    paged_mla,
    paged_mla_reference,
)
from repro_torch.kernels.sidebar_gated_mlp import (
    sidebar_gated_mlp as _gated_kernel,
)
from repro_torch.kernels.sidebar_matmul import sidebar_matmul
from repro_torch.kernels.sidebar_mlp import sidebar_mlp as _mlp_kernel
from repro_torch.kernels.sidebar_mlp import (
    sidebar_mlp_pipelined as _mlp_kernel_pipelined,
)

Tensor = torch.Tensor

# -- execution-plan selection ------------------------------------------------
# Models call the ops unconditionally; which kernel variant backs them
# is a deployment choice carried as thread-local ambient state. Models
# announce the layer index they run via ``layer_scope`` and
# ``current_plan()`` resolves ``plan.for_layer(index)``.

_PLAN_STATE = threading.local()

_DEFAULT_PLAN = LayerPlan(ExecutionMode.SIDEBAR, depth=1)


def current_layer() -> str | int | None:
    return getattr(_PLAN_STATE, "layer", None)


@contextlib.contextmanager
def layer_scope(key: str | int | None):
    """Announce the layer being run so a layer-indexed plan resolves."""
    prev = current_layer()
    _PLAN_STATE.layer = key
    try:
        yield
    finally:
        _PLAN_STATE.layer = prev


def current_full_plan() -> LayerPlan | ExecutionPlan:
    return getattr(_PLAN_STATE, "plan", _DEFAULT_PLAN)


def current_plan() -> LayerPlan:
    plan = current_full_plan()
    if isinstance(plan, ExecutionPlan):
        return plan.for_layer(current_layer())
    return plan


def set_plan(plan: LayerPlan | ExecutionPlan | ExecutionMode | str,
             depth: int | None = None) -> LayerPlan | ExecutionPlan:
    """Set the ambient plan; returns the previous one."""
    prev = current_full_plan()
    if isinstance(plan, ExecutionPlan):
        _PLAN_STATE.plan = plan
    else:
        _PLAN_STATE.plan = coerce_layer_plan(plan, depth)
    return prev


@contextlib.contextmanager
def execution_plan(plan: LayerPlan | ExecutionPlan | ExecutionMode | str,
                   depth: int | None = None):
    prev = set_plan(plan, depth)
    try:
        yield
    finally:
        set_plan(prev)


# -- dispatch recording --------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlanDispatch:
    """One op's dispatch decision."""

    op: str                       # "sidebar_mlp" | "paged_attention" | ...
    layer: str | int | None       # ambient layer_scope key
    mode: ExecutionMode
    depth: int
    variant: str                  # "serial" | "pipelined" | "paged" |
                                  # "dma" | "flash" | "ref"
    used_kernel: bool             # the CUDA kernel was launched


@contextlib.contextmanager
def record_dispatches(into: list):
    """Append a ``PlanDispatch`` per op call into ``into``."""
    prev = getattr(_PLAN_STATE, "recorder", None)
    _PLAN_STATE.recorder = into
    try:
        yield into
    finally:
        _PLAN_STATE.recorder = prev


def _record(op: str, mode: ExecutionMode, depth: int, variant: str,
            used_kernel: bool) -> None:
    rec = getattr(_PLAN_STATE, "recorder", None)
    if rec is not None:
        rec.append(PlanDispatch(op, current_layer(), mode, depth, variant,
                                used_kernel))


def extend_dispatches(records: list) -> None:
    """Append records made earlier (a captured graph's, at its replay) to
    the ambient recorder, if any."""
    rec = getattr(_PLAN_STATE, "recorder", None)
    if rec is not None:
        rec.extend(records)


def record_dispatch(op: str, variant: str, used_kernel: bool = False) -> None:
    """Dispatch record for non-kernel hot-path ops (``kvpool``'s
    ``gather_blocks``/``scatter_blocks``)."""
    plan = current_plan()
    _record(op, plan.mode, plan.depth, variant, used_kernel)


# -- launch counts -------------------------------------------------------------


def launch_counts() -> dict[str, int]:
    """CUDA launches per kernel since the last reset."""
    return {name: build.launches[name] for name in build.SOURCES}


def reset_launch_counts() -> None:
    build.launches.clear()


# -- ops -----------------------------------------------------------------------


def sidebar_mlp(
    x: Tensor,
    w1: Tensor,
    w2: Tensor,
    activation: str | Callable = "relu",
    *,
    table: FunctionTable = DEFAULT_TABLE,
) -> Tensor:
    """y = f(x @ w1) @ w2 by the ambient plan's route for this layer:
    SIDEBAR_PIPELINED => the ring kernel at the plan's depth,
    FLEXIBLE_DMA => the unfused three-launch route, SIDEBAR / MONOLITHIC
    => the serial fused kernel. All routes compute the same function.
    On a CPU tensor the kernel routes record variant "ref" (the plain
    version ran); the DMA route records "dma" on every device."""
    plan = current_plan()
    if plan.mode is ExecutionMode.FLEXIBLE_DMA:
        _record("sidebar_mlp", plan.mode, 1, "dma", x.is_cuda)
        # rounding points of the JAX route: h and f(h) in x's type
        h = sidebar_matmul(x, w1, "identity", table=table)
        h = host_activation(h.to(x.dtype), activation, table=table)
        return sidebar_matmul(h.to(x.dtype), w2, "identity", table=table)
    if plan.mode is ExecutionMode.SIDEBAR_PIPELINED:
        _record("sidebar_mlp", plan.mode, plan.depth,
                "pipelined" if x.is_cuda else "ref", x.is_cuda)
        return _mlp_kernel_pipelined(x, w1, w2, activation, table=table,
                                     depth=plan.depth)
    # the serial kernel has no ring: depth 1, as the JAX op records it
    _record("sidebar_mlp", plan.mode, 1, "serial" if x.is_cuda else "ref",
            x.is_cuda)
    return _mlp_kernel(x, w1, w2, activation, table=table)


def sidebar_gated_mlp(
    x: Tensor,
    w_gate: Tensor,
    w_up: Tensor,
    w_down: Tensor,
    activation: str | Callable = "silu",
    *,
    table: FunctionTable = DEFAULT_TABLE,
) -> Tensor:
    """y = (f(x @ w_gate) * (x @ w_up)) @ w_down through the fused serial
    kernel under every plan (the JAX op's one route), recorded at depth
    1 with the plan's mode; variant "ref" on a CPU tensor."""
    plan = current_plan()
    _record("sidebar_gated_mlp", plan.mode, 1,
            "serial" if x.is_cuda else "ref", x.is_cuda)
    return _gated_kernel(x, w_gate, w_up, w_down, activation, table=table)


def paged_attention_gqa(
    q: Tensor,                    # (B, H, Dh) — one decode token per row
    k_pool: Tensor,               # (P, Hkv, bs, Dh) pooled blocks
    v_pool: Tensor,
    block_tables: Tensor,         # (B, nb) int32, host-validated in-bounds
    lengths: Tensor,              # (B,) int32 — row attends kpos < length
    *,
    scale: float,
    k_scale: Tensor | None = None,
    v_scale: Tensor | None = None,
    compute_dtype: torch.dtype | None = None,
) -> Tensor:
    """Paged GQA decode attention: in place on the block pool, or — for
    a layer planned FLEXIBLE_DMA — through the gathered dense view
    (recorded as variant "dma")."""
    plan = current_plan()
    kw = dict(scale=scale, k_scale=k_scale, v_scale=v_scale,
              compute_dtype=compute_dtype)
    if plan.mode is ExecutionMode.FLEXIBLE_DMA:
        _record("paged_attention", plan.mode, plan.depth, "dma", False)
        return paged_gqa_reference(q, k_pool, v_pool, block_tables,
                                   lengths, **kw)
    _record("paged_attention", plan.mode, plan.depth,
            "paged" if q.is_cuda else "ref", q.is_cuda)
    return paged_gqa(q, k_pool, v_pool, block_tables, lengths, **kw)


def paged_attention_mla(
    q_lat: Tensor,                # (B, H, kvr) fp32 — q @ absorbed w_uk
    q_rope: Tensor,               # (B, H, rope)
    ckv_pool: Tensor,             # (P, bs, kvr) pooled latent blocks
    krope_pool: Tensor,           # (P, bs, rope)
    block_tables: Tensor,         # (B, nb) int32, host-validated in-bounds
    lengths: Tensor,              # (B,) int32 — row attends kpos < length
    *,
    scale: float,
    compute_dtype: torch.dtype | None = None,
) -> Tensor:
    """Paged MLA absorbed decode; returns ctx_lat (B, H, kvr) fp32. Same
    dispatch contract as ``paged_attention_gqa``: in place on the pool
    (variant "paged" on the card, "ref" on the CPU), or the gathered
    dense view for a layer planned FLEXIBLE_DMA (variant "dma"). The
    w_uk projection (before) and the w_uv absorption (after) stay with
    the model."""
    plan = current_plan()
    kw = dict(scale=scale, compute_dtype=compute_dtype)
    if plan.mode is ExecutionMode.FLEXIBLE_DMA:
        _record("paged_attention", plan.mode, plan.depth, "dma", False)
        return paged_mla_reference(q_lat, q_rope, ckv_pool, krope_pool,
                                   block_tables, lengths, **kw)
    _record("paged_attention", plan.mode, plan.depth,
            "paged" if q_lat.is_cuda else "ref", q_lat.is_cuda)
    return paged_mla(q_lat, q_rope, ckv_pool, krope_pool, block_tables,
                     lengths, **kw)


def flash_attention(
    q: Tensor,                    # (B, Hq, S, D)
    k: Tensor,                    # (B, Hkv, T, D)
    v: Tensor,
    *,
    causal: bool = True,
    scale: float | None = None,
) -> Tensor:
    """Blocked attention through its wrapper: a CUDA tensor launches the
    kernel (variant "flash"), a CPU tensor takes the plain version
    (variant "ref"). The kernel masks ragged tiles, so it takes any S
    and T; the JAX op's block rule (S, T whole 128-blocks) is kept in
    the layer that routes to this op (``attention._attend``)."""
    _record("flash_attention", current_plan().mode, 1,
            "flash" if q.is_cuda else "ref", q.is_cuda)
    return _flash_kernel(q, k, v, causal=causal, scale=scale)
