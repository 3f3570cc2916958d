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

# csrc/sidebar_mlp_pipelined.cu: F columns of one ring slot; a block
# owns at least MIN_SUBTILES of them, so a ring of depth up to 4 has
# sub-tiles to pipeline even at decode
SUBTILE_F = 64
MIN_SUBTILES = 4

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
_PIPE_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                  + [ctypes.c_void_p])


def f_range(m: int, f: int) -> int:
    """Width of the F range one block owns: enough splits that the
    grid (row panels x splits) fills the card, in whole column tiles."""
    panels = -(-m // BLOCK_M)
    splits = max(1, -(-TARGET_BLOCKS // panels))
    fr = -(-f // splits)
    fr = -(-fr // BLOCK_N) * BLOCK_N
    return max(BLOCK_N, min(fr, MAX_F_RANGE))


def f_range_pipelined(m: int, f: int) -> int:
    """Width of the F range one block of the ring kernel owns: enough
    splits to fill the card, in whole sub-tiles, but at least
    ``MIN_SUBTILES`` of them. It depends on M and F only — never on the
    ring depth — which keeps the output bitwise equal across depths."""
    panels = -(-m // BLOCK_M)
    splits = max(1, -(-TARGET_BLOCKS // panels))
    fr = -(-f // splits)
    fr = -(-fr // SUBTILE_F) * SUBTILE_F
    return max(MIN_SUBTILES * SUBTILE_F, fr)


def ring_slots(m: int, f: int, depth: int) -> int:
    """Ring slots the kernel allocates at ``depth``: a ring deeper than
    the sub-tiles one block owns never holds more than those, so the
    depth is capped there (the output does not depend on it)."""
    if depth < 1:
        raise ValueError(f"ring depth must be >= 1, got {depth}")
    return min(depth, f_range_pipelined(m, f) // SUBTILE_F)


def pipelined_smem_bytes(m: int, f: int, depth: int,
                         dtype: torch.dtype) -> int:
    """Dynamic shared memory one block of the ring kernel requests (the
    ring and its mbarriers), as the built library computes it."""
    fn = build.entry("sidebar_mlp_pipelined", "sidebar_mlp_pipelined_smem",
                     [ctypes.c_int, ctypes.c_int])
    return fn(ring_slots(m, f, depth), build.DTYPES[dtype])


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
    return (m, d, f, d2), build.kernel_activation(name, activation, table)


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
    slots = ring_slots(m, f, depth)
    if act is None:
        return sidebar_mlp_plain(x, w1, w2, activation, table)
    y = torch.empty((m, d2), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    fr = f_range_pipelined(m, f)
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
