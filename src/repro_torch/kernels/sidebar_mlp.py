"""Fused Sidebar MLP: y = f(x @ W1) @ W2 (port of
``repro.kernels.sidebar_mlp.sidebar_mlp``).

``sidebar_mlp`` launches the hand-written Hopper kernel
(``csrc/sidebar_mlp.cu``; its header says what bounds it and how it is
built) for CUDA tensors and takes the plain PyTorch version,
``sidebar_mlp_plain`` (= ``ref.sidebar_mlp_ref``), for CPU tensors.
There is no fallback between the two: a CUDA tensor the kernel does not
take raises.
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

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p])


def f_range(m: int, f: int) -> int:
    """Width of the F range one block owns: enough splits that the
    grid (row panels x splits) fills the card, in whole column tiles."""
    panels = -(-m // BLOCK_M)
    splits = max(1, -(-TARGET_BLOCKS // panels))
    fr = -(-f // splits)
    fr = -(-fr // BLOCK_N) * BLOCK_N
    return max(BLOCK_N, min(fr, MAX_F_RANGE))


def sidebar_mlp(
    x: torch.Tensor,
    w1: torch.Tensor,
    w2: torch.Tensor,
    activation: str | Callable = "relu",
    *,
    table: FunctionTable = DEFAULT_TABLE,
) -> torch.Tensor:
    """f(x @ w1) @ w2 with x (M, D), w1 (D, F), w2 (F, D2)."""
    if x.ndim != 2 or w1.ndim != 2 or w2.ndim != 2:
        raise ValueError("sidebar_mlp takes 2-D operands")
    m, d = x.shape
    d1, f = w1.shape
    f2, d2 = w2.shape
    if d != d1 or f != f2:
        raise ValueError(
            f"shape mismatch: x{tuple(x.shape)} w1{tuple(w1.shape)} "
            f"w2{tuple(w2.shape)}")
    if not x.is_cuda:
        return sidebar_mlp_plain(x, w1, w2, activation, table)
    if not (w1.device == x.device and w2.device == x.device):
        raise ValueError("sidebar_mlp: operands on different devices")
    if x.dtype not in _DTYPES or not x.dtype == w1.dtype == w2.dtype:
        raise TypeError(
            f"sidebar_mlp kernel takes fp32 or bf16 operands of one type, "
            f"got {x.dtype}, {w1.dtype}, {w2.dtype}")
    if not (x.is_contiguous() and w1.is_contiguous()
            and w2.is_contiguous()):
        raise ValueError("sidebar_mlp kernel takes contiguous operands")
    if callable(activation):
        raise TypeError("sidebar_mlp kernel takes a function-table key")
    entry = table[activation]
    if entry.device_id is None:
        raise NotImplementedError(
            f"activation {activation!r} has no kernel-side "
            "implementation (rowwise entries and run-time registrations "
            "serve the plain version only; see ROADMAP Queue 2)")
    y = torch.empty((m, d2), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    fr = f_range(m, f)
    splits = -(-f // fr)
    ws = torch.empty((splits * m * d2,), dtype=torch.float32,
                     device=x.device)
    fn = build.entry("sidebar_mlp", "sidebar_mlp_launch", _ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), w1.data_ptr(), w2.data_ptr(), y.data_ptr(),
             ws.data_ptr(), m, d, f, d2, fr, entry.device_id,
             _DTYPES[x.dtype], stream)
    build.check(err, "sidebar_mlp")
    build.launches["sidebar_mlp"] += 1
    return y
