"""Standalone activation, the FLEXIBLE_DMA "host step": y = f(x) as its
own launch, HBM -> HBM (port of ``repro.kernels.activations``).

``activation_2d`` launches the hand-written Hopper kernel
(``csrc/activation.cu``; its header says what bounds it) for CUDA
tensors and takes the plain PyTorch version, ``activation_plain``
(= ``ref.activation_ref``), for CPU tensors. ``activation`` flattens the
leading dims into rows, as the JAX entry point does.

The port's eligibility rule: on the card the kernel takes every shape
(there is no TPU tile rule) of a fp32 or bf16 contiguous tensor, for any
default table entry — elementwise, or rowwise (``softmax``,
``rmsnorm``) over the last dim — and for a function registered at run
time with a ``device_expr``. An entry with neither raises for a CUDA
tensor, as does any other operand the kernel does not take. The round
trip through HBM is the baseline the paper measures the Sidebar
against: nothing fuses it away.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable

import torch

from repro_torch.core.function_table import DEFAULT_TABLE, FunctionTable
from repro_torch.kernels import build
from repro_torch.kernels.ref import activation_ref as activation_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def activation(
    x: torch.Tensor,
    activation: str | Callable = "relu",
    *,
    table: FunctionTable = DEFAULT_TABLE,
) -> torch.Tensor:
    """y = f(x) for x of any rank >= 1 (rowwise entries over the last
    dim), as its own launch."""
    if x.ndim == 0:
        raise ValueError("activation takes a tensor of rank >= 1")
    rows = math.prod(x.shape[:-1])
    y = activation_2d(x.reshape(rows, x.shape[-1]), activation, table=table)
    return y.reshape(x.shape)


def activation_2d(
    x: torch.Tensor,
    activation: str | Callable = "relu",
    *,
    table: FunctionTable = DEFAULT_TABLE,
) -> torch.Tensor:
    """y = f(x) for x (M, N), computed in fp32 and cast back to x's
    type."""
    if x.ndim != 2:
        raise ValueError("activation_2d takes a 2-D operand")
    if not x.is_cuda:
        return activation_plain(x, activation, table)
    build.refuse_autograd("activation", x)
    if x.dtype not in _DTYPES:
        raise TypeError(f"activation kernel takes fp32 or bf16, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("activation kernel takes a contiguous operand")
    act, expr = build.kernel_activation("activation", activation, table,
                                        x.device, rowwise_ok=True)
    m, n = x.shape
    y = torch.empty_like(x)
    if m == 0 or n == 0:
        return y
    fn = build.entry("activation", "activation_launch", _ARGTYPES, expr)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), y.data_ptr(), m, n, act, _DTYPES[x.dtype],
             stream)
    build.check(err, "activation")
    build.launches["activation"] += 1
    return y
