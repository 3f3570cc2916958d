"""Fused gated Sidebar MLP: y = (f(x @ Wg) * (x @ Wu)) @ Wd (port of
``repro.kernels.sidebar_gated_mlp``), the MLP of the llama family.

``sidebar_gated_mlp`` launches the hand-written Hopper kernel
(``csrc/sidebar_gated_mlp.cu``; its header says what bounds it and how
it is built) for CUDA tensors and takes the plain PyTorch version,
``sidebar_gated_mlp_plain`` (= ``ref.sidebar_gated_mlp_ref``), for CPU
tensors. Any M, D, F and D2: there is no TPU tile rule. The activation
is any elementwise table entry, one registered at run time with a
``device_expr`` included. There is no fallback between kernel and
plain version: a CUDA tensor the kernel does not take raises.
"""

from __future__ import annotations

import ctypes
from typing import Callable

import torch

from repro_torch.core.function_table import DEFAULT_TABLE, FunctionTable
from repro_torch.kernels import build
from repro_torch.kernels.ref import (
    sidebar_gated_mlp_ref as sidebar_gated_mlp_plain,
)

# csrc/sidebar_gated_mlp.cu: rows per row panel and the column tile (the
# F range of one block is a multiple of it). The 64-column tile gives
# deepseek-7b's F = 11008 = 172 x 64 its 172 blocks at decode, where a
# 128-column tile would leave 86 blocks for 132 SMs.
BLOCK_M = 16
BLOCK_N = 64
# aim for two blocks per SM of an H100 (132 SMs); cap the per-block F
# range so its h panel stays well inside shared memory
TARGET_BLOCKS = 264
MAX_F_RANGE = 2048

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p])


def f_range(m: int, f: int) -> int:
    """Width of the F range one block owns: enough splits that the
    grid (row panels x splits) fills the card, in whole column tiles."""
    panels = -(-m // BLOCK_M)
    splits = max(1, -(-TARGET_BLOCKS // panels))
    fr = -(-f // splits)
    fr = -(-fr // BLOCK_N) * BLOCK_N
    return max(BLOCK_N, min(fr, MAX_F_RANGE))


def sidebar_gated_mlp(
    x: torch.Tensor,
    w_gate: torch.Tensor,
    w_up: torch.Tensor,
    w_down: torch.Tensor,
    activation: str | Callable = "silu",
    *,
    table: FunctionTable = DEFAULT_TABLE,
) -> torch.Tensor:
    """(f(x @ w_gate) * (x @ w_up)) @ w_down with x (M, D), w_gate and
    w_up (D, F), w_down (F, D2)."""
    ops = (x, w_gate, w_up, w_down)
    if any(t.ndim != 2 for t in ops):
        raise ValueError("sidebar_gated_mlp takes 2-D operands")
    m, d = x.shape
    f = w_gate.shape[1]
    d2 = w_down.shape[1]
    if w_gate.shape != (d, f) or w_up.shape != (d, f) \
            or w_down.shape[0] != f:
        raise ValueError(
            f"shape mismatch: x{tuple(x.shape)} wg{tuple(w_gate.shape)} "
            f"wu{tuple(w_up.shape)} wd{tuple(w_down.shape)}")
    if not x.is_cuda:
        return sidebar_gated_mlp_plain(x, w_gate, w_up, w_down, activation,
                                       table)
    dtype = build.check_operands("sidebar_gated_mlp", *ops)
    act, expr = build.kernel_activation("sidebar_gated_mlp", activation,
                                        table, x.device)
    y = torch.empty((m, d2), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    fr = f_range(m, f)
    splits = -(-f // fr)
    ws = torch.empty((splits * m * d2,), dtype=torch.float32,
                     device=x.device)
    fn = build.entry("sidebar_gated_mlp", "sidebar_gated_mlp_launch",
                     _ARGTYPES, expr)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
             w_down.data_ptr(), y.data_ptr(), ws.data_ptr(), m, d, f, d2, fr,
             act, dtype, stream)
    build.check(err, "sidebar_gated_mlp")
    build.launches["sidebar_gated_mlp"] += 1
    return y
