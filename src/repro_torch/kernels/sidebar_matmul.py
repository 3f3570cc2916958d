"""Tiled product with a function-table epilogue: c = f(a @ b) (port of
``repro.kernels.sidebar_matmul``).

``sidebar_matmul`` launches the hand-written Hopper kernel
(``csrc/sidebar_matmul.cu``; its header says what bounds it and how it
is built) for CUDA tensors and takes the plain PyTorch version,
``sidebar_matmul_plain`` (= ``ref.sidebar_matmul_ref``), for CPU
tensors. Any M, K and N: there is no TPU tile rule. The epilogue is any
elementwise table entry, one registered at run time with a
``device_expr`` included. A CUDA tensor the kernel does not take
raises.
"""

from __future__ import annotations

import ctypes
from typing import Callable

import torch

from repro_torch.core.function_table import DEFAULT_TABLE, FunctionTable
from repro_torch.kernels import build
from repro_torch.kernels.ref import sidebar_matmul_ref as sidebar_matmul_plain

# csrc/sidebar_matmul.cu: rows per row panel, the column tile and the
# contraction chunk (a K range is a whole number of chunks)
BLOCK_M = 16
BLOCK_N = 128
BLOCK_K = 64
# aim for two blocks per SM of an H100 (132 SMs)
TARGET_BLOCKS = 264

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def k_range(m: int, k: int, n: int, identity: bool) -> int:
    """The K range one block owns. Under the identity epilogue K is split
    so that (row panels x column tiles x K splits) fills the card; under
    any other epilogue one block owns all of K, so the pre-activation
    sum never leaves the block."""
    whole = max(BLOCK_K, -(-k // BLOCK_K) * BLOCK_K)
    if not identity:
        return whole
    tiles = -(-m // BLOCK_M) * -(-n // BLOCK_N)
    splits = max(1, -(-TARGET_BLOCKS // tiles))
    kr = -(-k // splits)
    return min(whole, max(BLOCK_K, -(-kr // BLOCK_K) * BLOCK_K))


def sidebar_matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    activation: str | Callable = "identity",
    *,
    table: FunctionTable = DEFAULT_TABLE,
) -> torch.Tensor:
    """f(a @ b) with a (M, K), b (K, N); the result in a's type."""
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError("sidebar_matmul takes 2-D operands")
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(
            f"contraction mismatch: a{tuple(a.shape)} b{tuple(b.shape)}")
    if not a.is_cuda:
        return sidebar_matmul_plain(a, b, activation, table)
    dtype = build.check_operands("sidebar_matmul", a, b)
    act, expr = build.kernel_activation("sidebar_matmul", activation,
                                        table)
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if m == 0 or n == 0:
        return c
    kr = k_range(m, k, n, act == 0)
    splits = max(1, -(-k // kr))
    ws = torch.empty((splits * m * n if splits > 1 else 0,),
                     dtype=torch.float32, device=a.device)
    fn = build.entry("sidebar_matmul", "sidebar_matmul_launch", _ARGTYPES,
                     expr)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), ws.data_ptr(), m, k,
             n, kr, act, dtype, stream)
    build.check(err, "sidebar_matmul")
    build.launches["sidebar_matmul"] += 1
    return c
