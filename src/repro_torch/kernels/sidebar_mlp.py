"""Fused Sidebar MLP: y = f(x @ W1) @ W2 (port of
``repro.kernels.sidebar_mlp``: ``sidebar_mlp`` and
``sidebar_mlp_pipelined``).

``sidebar_mlp`` launches the serial kernel (``csrc/sidebar_mlp.cu``) and
``sidebar_mlp_pipelined`` the T-deep ring kernel
(``csrc/sidebar_mlp_pipelined.cu``); each source's header says what
bounds it and how it is built. Both compute the same function, and for
CPU tensors both take the plain PyTorch version, ``sidebar_mlp_plain``
(= ``ref.sidebar_mlp_ref``). There is no fallback between kernel and
plain version: a CUDA tensor a kernel does not take raises.
"""

from __future__ import annotations

import ctypes
from typing import Callable

import torch

from repro_torch.core.function_table import DEFAULT_TABLE, FunctionTable
from repro_torch.kernels import build
from repro_torch.kernels.ref import sidebar_mlp_ref as sidebar_mlp_plain

# csrc/sidebar_mlp.cu: rows per row panel and the column tile (the F
# range of one block is a multiple of it)
BLOCK_M = 16
BLOCK_N = 128
# aim for two blocks per SM of an H100 (132 SMs); cap the per-block F
# range so its f(h) panel stays well inside shared memory
TARGET_BLOCKS = 264
MAX_F_RANGE = 2048

# csrc/sidebar_mlp_pipelined.cu, bf16 route: a thread-block cluster of
# ``cluster_size(m)`` blocks shares one F range, walked in sub-tiles
# (ring slots) of cluster_size x SHARE_F columns; a panel holds 8 token
# rows (M <= 8), 16 (M <= 16) or 32 (on clusters of 8). Clusters aim to
# cover the H100's SMs
SHARE_F = 64
SMS = 132
# the fp32 route (plain FMA): F columns of one ring slot; a block owns at
# least FMA_MIN_SUBTILES of them, so a ring of depth up to 4 has
# sub-tiles to pipeline even at decode
FMA_SUBTILE_F = 64
FMA_MIN_SUBTILES = 4

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
_PIPE_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                  + [ctypes.c_void_p])
_SMEM_ARGTYPES = [ctypes.c_int] * 3


def f_range(m: int, f: int) -> int:
    """Width of the F range one block owns: enough splits that the
    grid (row panels x splits) fills the card, in whole column tiles."""
    panels = -(-m // BLOCK_M)
    splits = max(1, -(-TARGET_BLOCKS // panels))
    fr = -(-f // splits)
    fr = -(-fr // BLOCK_N) * BLOCK_N
    return max(BLOCK_N, min(fr, MAX_F_RANGE))


def tokens_per_panel(m: int) -> int:
    """Token rows of one panel of the bf16 ring kernel: the N of its
    m64nNk16 tensor-core products (8 at decode, 16, or 32 above 16)."""
    return 8 if m <= 8 else 16 if m <= 16 else 32


def cluster_size(m: int) -> int:
    """Blocks of a cluster of the bf16 ring kernel: 8 beside 32-row
    panels (a consumer then holds D2 / 16 columns of 64 x 32
    accumulators), else 4."""
    return 8 if tokens_per_panel(m) == 32 else 4


def subtile_f(m: int) -> int:
    """F columns of one ring slot of the bf16 ring kernel."""
    return cluster_size(m) * SHARE_F


def f_range_pipelined(m: int, f: int) -> int:
    """Width of the F range one cluster of the bf16 ring kernel owns:
    the panels' clusters together aim at one block per SM (each panel
    gets an equal share of them), in whole sub-tiles. It depends on M
    and F only — never on the ring depth — which keeps the output
    bitwise equal across depths."""
    panels = max(1, -(-m // tokens_per_panel(m)))
    clusters = max(1, SMS // cluster_size(m) // panels)
    fr = -(-f // clusters)
    return -(-fr // subtile_f(m)) * subtile_f(m)


def f_range_fma(m: int, f: int) -> int:
    """Width of the F range one block of the fp32 ring kernel owns:
    enough splits to fill the card, in whole 64-column sub-tiles, but at
    least ``FMA_MIN_SUBTILES`` of them; M and F only, as above."""
    panels = max(1, -(-m // BLOCK_M))
    splits = max(1, -(-TARGET_BLOCKS // panels))
    fr = -(-f // splits)
    fr = -(-fr // FMA_SUBTILE_F) * FMA_SUBTILE_F
    return max(FMA_MIN_SUBTILES * FMA_SUBTILE_F, fr)


def ring_slots(m: int, f: int, depth: int,
               dtype: torch.dtype = torch.bfloat16) -> int:
    """The depth the wrapper asks of the kernel: a ring deeper than the
    sub-tiles one cluster (bf16) or block (fp32) owns never holds more
    than those. The bf16 launch caps it again at the slots its shared
    memory holds (``csrc`` ``Layout::MAX_SLOTS``); the output does not
    depend on either cap."""
    if depth < 1:
        raise ValueError(f"ring depth must be >= 1, got {depth}")
    if dtype == torch.float32:
        return min(depth, f_range_fma(m, f) // FMA_SUBTILE_F)
    return min(depth, f_range_pipelined(m, f) // subtile_f(m))


def pipelined_smem_bytes(m: int, f: int, depth: int,
                         dtype: torch.dtype) -> int:
    """Dynamic shared memory one block of the ring kernel requests (its
    stages, ring and mbarriers), from the built library: the one place
    that knows the layout."""
    fn = build.entry("sidebar_mlp_pipelined", "sidebar_mlp_pipelined_smem",
                     _SMEM_ARGTYPES)
    return fn(m, ring_slots(m, f, depth, dtype), build.DTYPES[dtype])


def check_pipelined_operands(x: torch.Tensor, w1: torch.Tensor,
                             w2: torch.Tensor) -> None:
    """The ring kernel's eligibility rule beyond the common checks: fp32
    operands of any shape; bf16 operands with D, F and D2 multiples of 8
    (TMA row strides in whole 16 bytes) and 16-byte aligned. Raises for
    anything else: there is no fallback."""
    if x.dtype == torch.float32:
        return
    (_, d), (_, f), (_, d2) = x.shape, w1.shape, w2.shape
    if d % 8 or f % 8 or d2 % 8 \
            or any(t.data_ptr() % 16 for t in (x, w1, w2)):
        raise ValueError(
            f"sidebar_mlp_pipelined bf16 kernel takes D, F and D2 "
            f"multiples of 8 and 16-byte aligned operands; got D {d}, "
            f"F {f}, D2 {d2}")


def _kernel_operands(name: str, x, w1, w2, activation, table):
    """Shapes, and for CUDA operands the kernel-side activation (id,
    device_expr) after the checks every MLP kernel wrapper makes; None
    for CPU operands (the plain version serves them)."""
    if x.ndim != 2 or w1.ndim != 2 or w2.ndim != 2:
        raise ValueError(f"{name} takes 2-D operands")
    m, d = x.shape
    d1, f = w1.shape
    f2, d2 = w2.shape
    if d != d1 or f != f2:
        raise ValueError(
            f"shape mismatch: x{tuple(x.shape)} w1{tuple(w1.shape)} "
            f"w2{tuple(w2.shape)}")
    if not x.is_cuda:
        return (m, d, f, d2), None
    build.check_operands(name, x, w1, w2)
    return (m, d, f, d2), build.kernel_activation(name, activation, table,
                                                  x.device)


def sidebar_mlp(
    x: torch.Tensor,
    w1: torch.Tensor,
    w2: torch.Tensor,
    activation: str | Callable = "relu",
    *,
    table: FunctionTable = DEFAULT_TABLE,
) -> torch.Tensor:
    """f(x @ w1) @ w2 with x (M, D), w1 (D, F), w2 (F, D2)."""
    (m, d, f, d2), act = _kernel_operands("sidebar_mlp", x, w1, w2,
                                          activation, table)
    if act is None:
        return sidebar_mlp_plain(x, w1, w2, activation, table)
    y = torch.empty((m, d2), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    fr = f_range(m, f)
    splits = -(-f // fr)
    ws = torch.empty((splits * m * d2,), dtype=torch.float32,
                     device=x.device)
    fn = build.entry("sidebar_mlp", "sidebar_mlp_launch", _ARGTYPES, act[1])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), w1.data_ptr(), w2.data_ptr(), y.data_ptr(),
             ws.data_ptr(), m, d, f, d2, fr, act[0],
             build.DTYPES[x.dtype], stream)
    build.check(err, "sidebar_mlp")
    build.launches["sidebar_mlp"] += 1
    return y


def sidebar_mlp_pipelined(
    x: torch.Tensor,
    w1: torch.Tensor,
    w2: torch.Tensor,
    activation: str | Callable = "relu",
    *,
    table: FunctionTable = DEFAULT_TABLE,
    depth: int = 2,
) -> torch.Tensor:
    """f(x @ w1) @ w2 through a ``depth``-deep ring of f(h) sub-tiles;
    the same function as ``sidebar_mlp``, bitwise equal across depths."""
    (m, d, f, d2), act = _kernel_operands("sidebar_mlp_pipelined", x, w1,
                                          w2, activation, table)
    slots = ring_slots(m, f, depth, x.dtype)
    if act is None:
        return sidebar_mlp_plain(x, w1, w2, activation, table)
    check_pipelined_operands(x, w1, w2)
    y = torch.empty((m, d2), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    fr = (f_range_fma(m, f) if x.dtype == torch.float32
          else f_range_pipelined(m, f))
    splits = -(-f // fr)
    ws = torch.empty((splits * m * d2,), dtype=torch.float32,
                     device=x.device)
    fn = build.entry("sidebar_mlp_pipelined", "sidebar_mlp_pipelined_launch",
                     _PIPE_ARGTYPES, act[1])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), w1.data_ptr(), w2.data_ptr(), y.data_ptr(),
             ws.data_ptr(), m, d, f, d2, fr, slots, act[0],
             build.DTYPES[x.dtype], stream)
    build.check(err, "sidebar_mlp_pipelined")
    build.launches["sidebar_mlp_pipelined"] += 1
    return y
