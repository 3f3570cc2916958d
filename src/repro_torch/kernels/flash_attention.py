"""Blocked (flash) attention with an online softmax (port of
``repro.kernels.flash_attention``).

``flash_attention`` launches the hand-written kernel
(``csrc/flash_attention.cu``; its header says what bounds it and how it
is built) for CUDA tensors and takes the plain version,
``flash_attention_plain`` (= ``ref.flash_attention_ref``), for CPU
tensors. There is no fallback between the two: a CUDA tensor the kernel
does not take raises. The kernel has no backward, as the Pallas kernel
has none: under autograd a CUDA operand that requires grad raises.

On the card the kernel picks its route by type and head dim: bf16 at
head dims 16, 32, ..., 128 takes the tensor cores (wgmma, a TMA ring of
K / V tiles, 128-row q tiles); fp32, and bf16 at head dim 8 or 136-256,
take the fp32 FMA route.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_ref as flash_attention_plain

# csrc/flash_attention.cu: head_dim in whole 16-byte vectors of bf16,
# and a thread's accumulator holds at most four float4 groups a row
MAX_HEAD_DIM = 256
HEAD_DIM_MULTIPLE = 8

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float]
             + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    """softmax(q k^T * scale) v, fused; q (B, Hq, S, D), k/v
    (B, Hkv, T, D); queries at the sequence end (offset T - S)."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention takes 4-D q, k and v")
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got {hq} % {hkv}")
    if k.shape != (b, hkv, t, d) or v.shape != k.shape:
        raise ValueError(f"shapes: q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    if causal and t < s:
        raise ValueError("causal attention needs T >= S")
    scale = scale if scale is not None else 1.0 / d ** 0.5
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    dtype = build.check_operands("flash_attention", q, k, v)
    if d % HEAD_DIM_MULTIPLE or d > MAX_HEAD_DIM \
            or any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError(
            f"flash_attention kernel takes head_dim a multiple of "
            f"{HEAD_DIM_MULTIPLE} up to {MAX_HEAD_DIM} and 16-byte aligned "
            f"operands; got head_dim {d}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = build.entry("flash_attention", "flash_attention_launch", _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
             hq, hkv, s, t, d, float(scale), int(causal), dtype, stream)
    build.check(err, "flash_attention")
    build.launches["flash_attention"] += 1
    return out
