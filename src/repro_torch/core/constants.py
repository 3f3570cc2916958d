"""Hardware constants of the analytical latency / energy model: one
NVIDIA H100 SXM5 80GB (port of ``repro.core.constants``; the field names
of ``ChipSpec`` are the JAX package's).

How the model reads the card. The JAX spec reads a TPU whose vector
memory holds the Sidebar; this one reads the card as the port's fused
kernels use it (``csrc/sidebar_tc.cuh``: the intermediate ``f(x @ W1)``
tile stays in shared memory and registers):

  * the SMs' tensor cores are the "MXU" (the static primitives);
  * their FP32 pipes are the "VPU" / host (the flexible functions);
  * shared memory is the Sidebar: ``vmem_bytes`` = 132 SMs x 228 KB =
    30,818,304 bytes, and the host side streams it at
    ``vpu_bytes_per_s``.

Where each value comes from (the card: "NVIDIA H100 80GB HBM3, 700.00
W" as ``nvidia-smi --query-gpu=name,power.limit`` prints it):

  * NVIDIA H100 Tensor Core GPU datasheet, SXM5 column (dense rates,
    without sparsity): 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s
    fp32 outside them, 80 GB of HBM3 at 3.35 TB/s, NVLink 900 GB/s, a
    board power of up to 700 W;
  * NVIDIA H100 Tensor Core GPU Architecture whitepaper: 132 SMs in the
    SXM5 part, up to 228 KB of shared memory an SM;
  * CUDA C++ Programming Guide, compute capability 9.0: shared memory
    is 32 banks of 4 bytes, each serving one access a clock, so an SM
    reads 128 bytes of it a clock;
  * ``chip_smoke.py`` phase 15, ``chip_probe()`` on that card: the SM
    clock's maximum (``nvidia-smi --query-gpu=clocks.max.sm``, 1980
    MHz), the launch, round-trip and handshake times below and the idle
    board draw.

No datasheet gives an energy per operation, so each energy is derived
as an upper bound: the whole 700 W board limit spent at that unit's
peak rate. The model's energies are upper bounds in the same sense.

``FLEXIBLE_OP_COST`` is the model's count of vector operations per
element of each flexible function (relu 1, softplus 15: the paper's
asymmetry), not a property of any chip; it is the JAX package's table.
"""

from __future__ import annotations

import dataclasses

# ----------------------------------------------------------------------------
# Rates and sizes (datasheet, whitepaper, programming guide).
# ----------------------------------------------------------------------------
BOARD_POWER_W: float = 700.0                 # datasheet: max board power
PEAK_FLOPS_BF16: float = 989e12              # FLOP/s, tensor cores, dense
PEAK_FLOPS_FP32: float = 67e12               # FLOP/s, FP32 pipes
HBM_BYTES_PER_S: float = 3.35e12             # B/s, HBM3
NVLINK_BYTES_PER_S: float = 900e9            # B/s, NVLink 4 (all links)
HBM_BYTES: int = 80 * 10**9                  # datasheet "80GB"
NUM_SMS: int = 132                           # SXM5
SMEM_BYTES_PER_SM: int = 228 * 1024          # whitepaper "228 KB"
SIDEBAR_BYTES: int = NUM_SMS * SMEM_BYTES_PER_SM   # 30,818,304 bytes
SMEM_BYTES_PER_CLOCK_PER_SM: int = 32 * 4    # 32 banks x 4 bytes
SM_CLOCK_MAX_HZ: float = 1.98e9              # clocks.max.sm (chip_probe)
SIDEBAR_BYTES_PER_S: float = (NUM_SMS * SMEM_BYTES_PER_CLOCK_PER_SM
                              * SM_CLOCK_MAX_HZ)    # 3.345e13 B/s

# ----------------------------------------------------------------------------
# Energies: upper bounds, the board limit over each unit's peak rate.
# ----------------------------------------------------------------------------
E_HBM_PER_BYTE: float = BOARD_POWER_W / HBM_BYTES_PER_S        # 2.09e-10 J/B
E_SIDEBAR_PER_BYTE: float = BOARD_POWER_W / SIDEBAR_BYTES_PER_S  # 2.09e-11
E_MXU_PER_FLOP: float = BOARD_POWER_W / PEAK_FLOPS_BF16        # 7.08e-13 J
E_VPU_PER_FLOP: float = BOARD_POWER_W / PEAK_FLOPS_FP32        # 1.04e-11 J

# ----------------------------------------------------------------------------
# Measured on the card by chip_smoke.py phase 15 (``chip_probe``; NVIDIA
# H100 80GB HBM3 at 700.00 W, after the serving phases):
# ----------------------------------------------------------------------------
# idle board draw: the least nvidia-smi power.draw of ten reads over ~3 s
# with the card idle (clocks up, weights resident)
E_STATIC_W: float = 119.65
# host seconds a launch of the ``activation`` kernel on one element
# (1000 launches back to back through its ctypes wrapper, then one
# synchronize)
KERNEL_LAUNCH_S: float = 1.6655e-5
# a small pinned round trip: 4 KiB device -> pinned host -> device, each
# copy synchronized (what FLEXIBLE_DMA pays at a handoff)
DMA_FLUSH_S: float = 4.3240e-5
# one way of a 4-byte flag: half of a pinned device -> host -> device
# round trip, synchronized (the engine's Sidebar crosses PCIe to the
# CPU; an on-SM flag would be far shorter and is not measured)
SIDEBAR_HANDSHAKE_S: float = 2.1044e-5

# VPU cost (vector-ops per element) of each flexible function: the
# model's table (softplus is far more expensive than relu, paper §5).
FLEXIBLE_OP_COST: dict[str, float] = {
    "identity": 0.0,
    "heaviside": 1.0,
    "relu": 1.0,
    "leaky_relu": 2.0,
    "squared_relu": 2.0,
    "abs": 1.0,
    "elu": 8.0,
    "silu": 11.0,
    "sigmoid": 10.0,
    "tanh": 12.0,
    "gelu": 14.0,
    "softplus": 15.0,
    "softmax": 12.0,
    "rmsnorm": 6.0,
    "layernorm": 8.0,
    "exp_decay": 10.0,
    "router_topk": 16.0,
    "max_pool": 1.0,
    "avg_pool": 1.0,
    "qk_rmsnorm": 6.0,
}
DEFAULT_FLEXIBLE_OP_COST: float = 8.0


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """A parameterizable chip model (defaults: the H100 above)."""

    peak_flops: float = PEAK_FLOPS_BF16
    hbm_bytes_per_s: float = HBM_BYTES_PER_S
    ici_bytes_per_s: float = NVLINK_BYTES_PER_S
    hbm_bytes: int = HBM_BYTES
    vmem_bytes: int = SIDEBAR_BYTES
    e_hbm_per_byte: float = E_HBM_PER_BYTE
    e_sidebar_per_byte: float = E_SIDEBAR_PER_BYTE
    e_mxu_per_flop: float = E_MXU_PER_FLOP
    e_vpu_per_flop: float = E_VPU_PER_FLOP
    static_w: float = E_STATIC_W
    kernel_launch_s: float = KERNEL_LAUNCH_S
    dma_flush_s: float = DMA_FLUSH_S
    sidebar_handshake_s: float = SIDEBAR_HANDSHAKE_S
    vpu_bytes_per_s: float = SIDEBAR_BYTES_PER_S


H100 = ChipSpec()
