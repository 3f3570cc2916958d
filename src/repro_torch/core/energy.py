"""Analytical latency / energy / EDP model (the paper's Figures 6-8;
port of ``repro.core.energy``, the same formulas line for line).

The model turns a ``TaskAccounting`` (exact byte / flop / protocol
counts from ``core.engine.account``) into seconds and joules with the
constants of a ``ChipSpec`` (default: the H100 of ``core.constants``):

  * static primitives run on the tensor cores, overlapped with HBM
    weight / IO streaming (``max(compute, memory)``);
  * flexible functions are serial with the accelerator, which polls
    until the host signals completion (paper §4);
  * FLEXIBLE_DMA pays four HBM crossings of each intermediate, a DMA
    flush a handoff and a DRAM-fed host stall factor;
  * SIDEBAR: the accelerator's own sidebar traffic replaces its private
    buffers (free in time, counted in energy); the host streams its half
    of the bytes at ``vpu_bytes_per_s`` overlapped with its compute
    (max, not sum), plus two flag handshakes;
  * MONOLITHIC computes flexible functions in a dedicated pipelined
    stage: the first op an element at peak/4, the remaining (cost - 1)
    at the vector rate peak/16 (the paper's Table 3: a hardware softplus
    is slower than a hardware relu);
  * SIDEBAR_PIPELINED keeps SIDEBAR's energy, but the ring hides the
    overlapped fraction of the host's busy time; only the stalled
    fraction stays on the critical path, with one invoke and one return
    flag a stage.

Rates derived from the chip spec: vector (host) rate = peak / 16
(``VPU_RATE_DIV``; the H100's fp32 pipes run at 67 / 989 = 1 / 14.8 of
its bf16 tensor-core rate, and the model keeps the JAX package's 16 so
its cycle counts equal that package's), in-pipeline rate = peak / 4,
DRAM-fed host stall factor 2.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.constants import H100, ChipSpec

VPU_RATE_DIV = 16.0
MONO_HW_RATE_DIV = 4.0
DMA_HOST_STALL = 2.0


@dataclasses.dataclass(frozen=True)
class TaskAccounting:
    """Exact counts for one accelerator task under one execution mode."""

    mode: str
    # data movement (bytes)
    hbm_io_bytes: int = 0          # task input + output activations
    hbm_weight_bytes: int = 0      # parameters streamed from HBM
    hbm_intermediate_bytes: int = 0  # FLEXIBLE_DMA: 4x crossings of operands
    sidebar_bytes: int = 0         # SIDEBAR: scratchpad crossings
    datapath_bytes: int = 0        # MONOLITHIC: internal pipeline traffic
    # compute (flops / vector ops)
    mxu_flops: int = 0
    flex_vpu_ops: int = 0          # flexible work done by the host
    flex_hw_ops: int = 0           # flexible work in dedicated hardware
    flex_elements: int = 0         # total elements through flexible ops
    # protocol events
    launches: int = 0              # accelerator invocations
    dma_flushes: int = 0           # flush + invalidate events
    handshakes: int = 0            # sidebar flag transfers
    host_invocations: int = 0
    flex_stages: int = 0           # number of flexible stages
    # pipelined-overlap counters (abstract cycles, 1 cycle = one
    # tensor-core flop-time; see engine.pipeline_schedule)
    host_busy_cycles: int = 0
    acc_busy_cycles: int = 0
    stall_cycles: int = 0
    overlap_cycles: int = 0

    def merge(self, other: "TaskAccounting") -> "TaskAccounting":
        if self.mode != other.mode:
            raise ValueError(f"merging accountings of modes {self.mode!r} "
                             f"and {other.mode!r}")
        return TaskAccounting(
            self.mode,
            self.hbm_io_bytes + other.hbm_io_bytes,
            self.hbm_weight_bytes + other.hbm_weight_bytes,
            self.hbm_intermediate_bytes + other.hbm_intermediate_bytes,
            self.sidebar_bytes + other.sidebar_bytes,
            self.datapath_bytes + other.datapath_bytes,
            self.mxu_flops + other.mxu_flops,
            self.flex_vpu_ops + other.flex_vpu_ops,
            self.flex_hw_ops + other.flex_hw_ops,
            self.flex_elements + other.flex_elements,
            self.launches + other.launches,
            self.dma_flushes + other.dma_flushes,
            self.handshakes + other.handshakes,
            self.host_invocations + other.host_invocations,
            self.flex_stages + other.flex_stages,
            self.host_busy_cycles + other.host_busy_cycles,
            self.acc_busy_cycles + other.acc_busy_cycles,
            self.stall_cycles + other.stall_cycles,
            self.overlap_cycles + other.overlap_cycles,
        )

    @property
    def total_hbm_bytes(self) -> int:
        return (self.hbm_io_bytes + self.hbm_weight_bytes
                + self.hbm_intermediate_bytes)


@dataclasses.dataclass(frozen=True)
class Estimate:
    latency_s: float
    energy_j: float
    # breakdowns (Figure 7)
    e_hbm_j: float
    e_sidebar_j: float
    e_compute_j: float
    e_static_j: float
    t_static_s: float
    t_flexible_s: float
    t_protocol_s: float

    @property
    def edp(self) -> float:
        return self.latency_s * self.energy_j


def estimate(acct: TaskAccounting, chip: ChipSpec = H100) -> Estimate:
    """Latency/energy/EDP for one task accounting."""
    vpu_rate = chip.peak_flops / VPU_RATE_DIV
    mono_hw_rate = chip.peak_flops / MONO_HW_RATE_DIV

    # --- latency ---------------------------------------------------------
    t_mxu = acct.mxu_flops / chip.peak_flops
    t_stream = (acct.hbm_io_bytes + acct.hbm_weight_bytes) / chip.hbm_bytes_per_s
    t_static = max(t_mxu, t_stream)  # weights/IO stream overlaps compute

    # flexible (serial with the accelerator in every mode)
    if acct.mode == "monolithic":
        # in-pipeline stage: the first op an element at peak/4, the
        # remaining (cost - 1) at the vector rate
        extra_ops = max(0, acct.flex_hw_ops - acct.flex_elements)
        t_flex = acct.flex_elements / mono_hw_rate + extra_ops / vpu_rate
    elif acct.mode == "flexible_dma":
        # DRAM-fed host: stalled pipeline + 4 serial HBM crossings
        t_flex = acct.flex_vpu_ops * DMA_HOST_STALL / vpu_rate
        t_flex += acct.hbm_intermediate_bytes / chip.hbm_bytes_per_s
    else:
        # SIDEBAR: the host's half of the sidebar bytes streams at
        # vpu_bytes_per_s, overlapped with its compute
        host_bytes = acct.sidebar_bytes / 2
        t_flex = max(acct.flex_vpu_ops / vpu_rate,
                     host_bytes / chip.vpu_bytes_per_s)
        if acct.mode == "sidebar_pipelined" and acct.host_busy_cycles > 0:
            # the ring hides the overlapped fraction of the host's busy
            # time behind accelerator work already paid in t_static
            t_flex *= acct.stall_cycles / acct.host_busy_cycles

    exposed_handshakes = acct.handshakes
    if acct.mode == "sidebar_pipelined":
        # interior ring flags are raised while other slots are busy: one
        # invoke and one return a stage sit on the critical path
        exposed_handshakes = 2 * acct.flex_stages
    t_protocol = (
        acct.launches * chip.kernel_launch_s
        + acct.dma_flushes * chip.dma_flush_s
        + exposed_handshakes * chip.sidebar_handshake_s
    )
    latency = t_static + t_flex + t_protocol

    # --- energy ------------------------------------------------------------
    e_hbm = acct.total_hbm_bytes * chip.e_hbm_per_byte
    e_sidebar = (acct.sidebar_bytes + acct.datapath_bytes) * chip.e_sidebar_per_byte
    e_compute = (
        acct.mxu_flops * chip.e_mxu_per_flop
        + acct.flex_hw_ops * chip.e_mxu_per_flop   # dedicated unit
        + acct.flex_vpu_ops * chip.e_vpu_per_flop  # general-purpose host
    )
    e_static = chip.static_w * latency
    energy = e_hbm + e_sidebar + e_compute + e_static

    return Estimate(
        latency_s=latency,
        energy_j=energy,
        e_hbm_j=e_hbm,
        e_sidebar_j=e_sidebar,
        e_compute_j=e_compute,
        e_static_j=e_static,
        t_static_s=t_static,
        t_flexible_s=t_flex,
        t_protocol_s=t_protocol,
    )


def normalized_edp(estimates: dict[str, Estimate],
                   baseline: str = "monolithic") -> dict[str, float]:
    """Figure 8: EDP of each design normalized to the baseline's."""
    base = estimates[baseline].edp
    return {k: v.edp / base for k, v in estimates.items()}
