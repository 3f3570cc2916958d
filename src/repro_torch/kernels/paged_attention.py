"""Paged GQA decode attention, in place on the KV block pool (port of
the GQA half of ``repro.kernels.paged_attention``).

``paged_gqa`` launches the hand-written Hopper kernel
(``csrc/paged_gqa.cu``) for CUDA tensors and takes the plain PyTorch
version, ``paged_gqa_reference``, for CPU tensors. The plain version is
the slab path's dense math fed by a table gather, op for op: masked
logits are -1e30, which underflow to exactly 0.0 in fp32, so junk behind
the mask and the width of the table change no sum. The kernel
accumulates online instead and matches it to fp32 tolerance.

``paged_gqa_reference`` is also the FLEXIBLE_DMA route, on every device:
the dense view's round trip through HBM is that mode's memory
discipline (the JAX package serves both routes with one function too).

Tables must be validated in-bounds host-side before every call
(``launch.kvpool.validate_tables``): the gathers index without a check
and the kernel's table-indexed loads have none either.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import attend_direct_offset

Tensor = torch.Tensor

_QTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KVTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float]
             + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def gather_kv(leaf: Tensor, tables: Tensor) -> Tensor:
    """(P, Hkv, bs, Dh) pool -> (B, Hkv, nb*bs, Dh) dense view."""
    g = leaf[tables].movedim(1, 2)                # (B, Hkv, nb, bs, Dh)
    return g.reshape(g.shape[0], g.shape[1], -1, leaf.shape[-1])


def gather_scale(leaf: Tensor, tables: Tensor) -> Tensor:
    """(P, Hkv, bs) pooled scales -> (B, Hkv, nb*bs)."""
    g = leaf[tables].movedim(1, 2)                # (B, Hkv, nb, bs)
    return g.reshape(g.shape[0], g.shape[1], -1)


def paged_gqa_reference(
    q: Tensor,                    # (B, H, Dh) — one decode token per row
    k_pool: Tensor,               # (P, Hkv, bs, Dh)
    v_pool: Tensor,
    tables: Tensor,               # (B, nb) int physical block ids
    lengths: Tensor,              # (B,) int — row attends kpos < length
    *,
    scale: float,
    k_scale: Tensor | None = None,  # (P, Hkv, bs) fp32 int8-KV scales
    v_scale: Tensor | None = None,
    compute_dtype: torch.dtype | None = None,
) -> Tensor:
    """The table's blocks gathered into a dense (B, Hkv, nb*bs, Dh) view,
    then ``attend_direct_offset`` with the row's query at position
    length - 1 (mirror of the jnp ``paged_gqa_reference``)."""
    h = q.shape[1]
    dt = compute_dtype if compute_dtype is not None else q.dtype
    k = gather_kv(k_pool, tables)
    v = gather_kv(v_pool, tables)
    if k_scale is not None:
        k = (k.float() * gather_scale(k_scale, tables)[..., None]).to(dt)
        v = (v.float() * gather_scale(v_scale, tables)[..., None]).to(dt)
    else:
        k, v = k.to(dt), v.to(dt)
    pos = lengths.to(device=q.device, dtype=torch.int64) - 1
    out = attend_direct_offset(q[:, :, None, :], k, v, h // k.shape[1],
                               scale, True, pos)
    return out[:, :, 0, :]


def paged_gqa(
    q: Tensor,
    k_pool: Tensor,
    v_pool: Tensor,
    tables: Tensor,
    lengths: Tensor,
    *,
    scale: float,
    k_scale: Tensor | None = None,
    v_scale: Tensor | None = None,
    compute_dtype: torch.dtype | None = None,
) -> Tensor:
    """Paged GQA decode: q (B, H, Dh) against the pool in place."""
    b, h, dh = q.shape
    _, hkv, bs, dh2 = k_pool.shape
    if h % hkv or dh != dh2:
        raise ValueError(f"GQA shapes: q{tuple(q.shape)} vs pool "
                         f"{tuple(k_pool.shape)}")
    if not q.is_cuda:
        return paged_gqa_reference(
            q, k_pool, v_pool, tables, lengths, scale=scale,
            k_scale=k_scale, v_scale=v_scale, compute_dtype=compute_dtype)
    quantized = k_pool.dtype == torch.int8
    if q.dtype not in _QTYPES or k_pool.dtype not in _KVTYPES \
            or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"paged_gqa kernel: q {q.dtype}, pool "
                        f"{k_pool.dtype}/{v_pool.dtype}")
    if quantized != (k_scale is not None and v_scale is not None):
        raise ValueError("paged_gqa: an int8 pool needs k_scale and "
                         "v_scale, and only an int8 pool takes them")
    if quantized and not (k_scale.dtype == v_scale.dtype == torch.float32
                          and k_scale.shape == k_pool.shape[:3]
                          and v_scale.shape == k_pool.shape[:3]):
        raise ValueError("paged_gqa: scales must be fp32 (P, Hkv, bs)")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32 \
            or tables.ndim != 2 or tables.shape[0] != b \
            or lengths.shape != (b,):
        raise ValueError("paged_gqa: tables (B, nb) and lengths (B,) "
                         "must be int32")
    tensors = [q, k_pool, v_pool, tables, lengths]
    if quantized:
        tensors += [k_scale, v_scale]
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_gqa: operands on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_gqa kernel takes contiguous operands")
    out = torch.empty_like(q)
    if b == 0:
        return out
    fn = build.entry("paged_gqa", "paged_gqa_launch", _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             k_scale.data_ptr() if quantized else None,
             v_scale.data_ptr() if quantized else None,
             tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             b, h, hkv, bs, dh, tables.shape[1], float(scale),
             _QTYPES[q.dtype], _KVTYPES[k_pool.dtype], stream)
    build.check(err, "paged_gqa")
    build.launches["paged_gqa"] += 1
    return out
