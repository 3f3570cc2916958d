"""Grouped expert product of the MoE layer: ``out[r] = a[r] @ w[e(r)]``
in fp32 for rows sorted by expert (the products of ``_expert_mlp`` in
``repro.models.moe``, which the JAX package leaves to XLA: one
``jnp.dot(..., preferred_element_type=float32)`` per expert).

``grouped_mm(a, w, offsets)`` takes a (n, K), the expert stack w
(E, K, N) and ``offsets`` (E + 1,) int32: expert e owns rows
``[offsets[e], offsets[e + 1])``; rows from ``offsets[E]`` on belong to
none and come out zero. The groups stay on the device: nothing is read
on the host, so a CUDA graph can hold the call, and an expert no row
chose is never read.

For CUDA tensors it launches the hand-written Hopper kernel
(``csrc/moe_experts.cu``; its header says what bounds it) on one of two
routes (``route``): "tc", bf16 on the tensor cores, and "fma", fp32 and
bf16 of any other width. For CPU tensors it takes the plain version,
``grouped_mm_plain``: every expert's product over all rows, each row
keeping its own expert's (fixed-order ``ref.dot``, so a row's result
depends on its row alone). There is no fallback between the two: a CUDA
tensor the kernel does not take raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import dot

Tensor = torch.Tensor

ROUTES = {"fma": 0, "tc": 1}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def route(a: Tensor, w: Tensor) -> str:
    """"tc" for bf16 operands whose contraction and output widths (K, N)
    are multiples of 8 at 16-byte aligned addresses; else "fma"."""
    k, n = w.shape[-2], w.shape[-1]
    if (a.dtype == w.dtype == torch.bfloat16 and k % 8 == 0 and n % 8 == 0
            and a.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0):
        return "tc"
    return "fma"


def group_of_rows(offsets: Tensor, n: int) -> Tensor:
    """(n,) expert of each row; E for rows past ``offsets[E]``."""
    rows = torch.arange(n, device=offsets.device, dtype=offsets.dtype)
    return torch.searchsorted(offsets[1:], rows, right=True)


def grouped_mm_plain(a: Tensor, w: Tensor, offsets: Tensor) -> Tensor:
    """The plain version: (n, N) fp32, each row ``a[r] @ w[e(r)]`` (zero
    past the groups), every expert's product taken over all rows."""
    group = group_of_rows(offsets, a.shape[0])[:, None]
    out = torch.zeros((a.shape[0], w.shape[-1]), dtype=torch.float32,
                      device=a.device)
    for e in range(w.shape[0]):
        out = torch.where(group == e, dot(a, w[e]), out)
    return out


def _check(a: Tensor, w: Tensor, offsets: Tensor) -> None:
    if a.ndim != 2 or w.ndim != 3 or a.shape[1] != w.shape[1]:
        raise ValueError(f"grouped_mm takes a (n, K) and w (E, K, N), got "
                         f"a{tuple(a.shape)} w{tuple(w.shape)}")
    if offsets.shape != (w.shape[0] + 1,) or offsets.dtype != torch.int32:
        raise ValueError(f"offsets must be ({w.shape[0] + 1},) int32, got "
                         f"{tuple(offsets.shape)} {offsets.dtype}")


def grouped_mm(a: Tensor, w: Tensor, offsets: Tensor) -> Tensor:
    """(n, N) fp32: row r of ``a`` times its expert's matrix of ``w``."""
    _check(a, w, offsets)
    if not a.is_cuda:
        return grouped_mm_plain(a, w, offsets)
    dtype = build.check_operands("moe_grouped_mm", a, w)
    if offsets.device != a.device or not offsets.is_contiguous():
        raise ValueError("moe_grouped_mm: offsets must be contiguous on the "
                         "operands' device")
    n, k = a.shape
    e, _, nout = w.shape
    out = torch.zeros((n, nout), dtype=torch.float32, device=a.device)
    if n == 0:
        return out
    r = route(a, w)
    fn = build.entry("moe_grouped_mm", "moe_grouped_mm_launch", _ARGTYPES)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = fn(a.data_ptr(), w.data_ptr(), offsets.data_ptr(), out.data_ptr(),
             n, k, nout, e, dtype, ROUTES[r], stream)
    build.check(err, "moe_grouped_mm")
    build.launches["moe_grouped_mm"] += 1
    return out
