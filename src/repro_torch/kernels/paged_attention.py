"""Paged decode attention, in place on the KV block pool (port of
``repro.kernels.paged_attention``): GQA and MLA absorbed decode.

``paged_gqa`` and ``paged_mla`` launch the hand-written Hopper kernels
(``csrc/paged_gqa.cu``, ``csrc/paged_mla.cu``) for CUDA tensors and take
the plain PyTorch versions, ``paged_gqa_reference`` and
``paged_mla_reference``, for CPU tensors. A plain version is the slab
path's dense math fed by a table gather, op for op: masked logits are
-1e30, which underflow to exactly 0.0 in fp32, so junk behind the mask
and the width of the table change no sum. The kernels accumulate online
instead and match them to fp32 tolerance. Both kernels split each
row's positions at multiples of ``split_chunk(bs)`` (split-KV) and
merge the splits in a fixed order: ``split_bounds`` is their
partition, a function of the row's own length. ``paged_mla`` has two
routes, chosen by ``mla_route``, a rule of shape and type: "tc" (the
heads of a group on the tensor cores, TF32 split into high and low
parts) and "fma" (the CUDA cores: fp32 pools and widths too small or
ragged for the tiles).

The plain versions are also the FLEXIBLE_DMA route, on every device:
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
from repro_torch.kernels.ref import attend_direct_offset, attend_mla_absorbed
from repro_torch.kernels.sidebar_mlp import ROUTES

Tensor = torch.Tensor

_QTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KVTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
             + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
# csrc/paged_gqa.cu: a split covers SPLIT_POSITIONS positions (or one
# pool block where a block is longer), always whole blocks; head dims up
# to GQA_MAX_HEAD_DIM
SPLIT_POSITIONS = 64
GQA_MAX_HEAD_DIM = 256
# widths the MLA kernel takes on its fma route (csrc/paged_mla.cu)
MLA_MAX_KVR = 512
MLA_MAX_WIDTH = 640
# its tc route: 16 heads a block (the M of mma.sync m16n8k8), 8 warps
# sharing the contraction (kvr + rope, a multiple of 64 up to 576) and
# the latent columns (kvr, a multiple of 64 up to 512), one split of
# MLA_TC_SPLIT positions staged at once
MLA_TC_HEADS = 16
MLA_TC_MAX_KVR = 512
MLA_TC_MAX_WIDTH = 576
MLA_TC_SPLIT = 64
_MLA_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                 + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def split_chunk(bs: int) -> int:
    """Positions of one split of the paged decode kernels at pool block
    size ``bs``: the fewest whole blocks that cover SPLIT_POSITIONS."""
    return bs * max(1, -(-SPLIT_POSITIONS // bs))


def split_bounds(length: int, bs: int) -> list[tuple[int, int]]:
    """The [start, end) positions of a row's live splits: boundaries at
    multiples of ``split_chunk(bs)``, a function of the row's own length
    (never of the batch or the table width); a length-0 row has none."""
    c = split_chunk(bs)
    return [(s, min(s + c, length)) for s in range(0, max(length, 0), c)]


def mla_route(kvr: int, rope: int, bs: int, pool_dtype: torch.dtype
              ) -> str:
    """The route of ``paged_mla``'s kernel, a pure function of widths and
    the pool's type: "tc" for a bf16 pool whose kvr is a multiple of 64
    up to MLA_TC_MAX_KVR, whose kvr + rope is a multiple of 64 up to
    MLA_TC_MAX_WIDTH and whose splits are MLA_TC_SPLIT positions; "fma"
    for everything else (fp32 pools, and widths such as the smoke
    configs' kvr 32, rope 8)."""
    w = kvr + rope
    if (pool_dtype == torch.bfloat16 and kvr % 64 == 0
            and 0 < kvr <= MLA_TC_MAX_KVR and w % 64 == 0
            and w <= MLA_TC_MAX_WIDTH and split_chunk(bs) == MLA_TC_SPLIT):
        return "tc"
    return "fma"


def gather_kv(leaf: Tensor, tables: Tensor) -> Tensor:
    """(P, Hkv, bs, Dh) pool -> (B, Hkv, nb*bs, Dh) dense view."""
    g = leaf[tables].movedim(1, 2)                # (B, Hkv, nb, bs, Dh)
    return g.reshape(g.shape[0], g.shape[1], -1, leaf.shape[-1])


def gather_scale(leaf: Tensor, tables: Tensor) -> Tensor:
    """(P, Hkv, bs) pooled scales -> (B, Hkv, nb*bs)."""
    g = leaf[tables].movedim(1, 2)                # (B, Hkv, nb, bs)
    return g.reshape(g.shape[0], g.shape[1], -1)


def gather_lat(leaf: Tensor, tables: Tensor) -> Tensor:
    """(P, bs, r) pooled MLA latent/rope -> (B, nb*bs, r) dense view."""
    g = leaf[tables]                              # (B, nb, bs, r)
    return g.reshape(g.shape[0], -1, leaf.shape[-1])


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
    build.refuse_autograd("paged_gqa", q, k_pool, v_pool, k_scale, v_scale)
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
    if dh > GQA_MAX_HEAD_DIM:
        raise ValueError(f"paged_gqa kernel takes head_dim <= "
                         f"{GQA_MAX_HEAD_DIM}, got {dh}")
    out = torch.empty_like(q)
    nb = tables.shape[1]
    if b == 0 or nb == 0:
        return out.zero_() if b else out
    # the splits' partials (m, l and acc, fp32): S splits a row at most
    chunk = split_chunk(bs)
    splits = -(-nb * bs // chunk)
    ws_acc = torch.empty((b * h * splits * dh,), dtype=torch.float32,
                         device=q.device)
    ws_ml = torch.empty((b * h * splits * 2,), dtype=torch.float32,
                        device=q.device)
    fn = build.entry("paged_gqa", "paged_gqa_launch", _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             k_scale.data_ptr() if quantized else None,
             v_scale.data_ptr() if quantized else None,
             tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             ws_acc.data_ptr(), ws_ml.data_ptr(), b, h, hkv, bs, dh, nb,
             chunk, float(scale), _QTYPES[q.dtype], _KVTYPES[k_pool.dtype],
             stream)
    build.check(err, "paged_gqa")
    build.launches["paged_gqa"] += 1
    return out


def paged_mla_reference(
    q_lat: Tensor,                # (B, H, kvr) fp32 — q @ absorbed w_uk
    q_rope: Tensor,               # (B, H, rope)
    ckv_pool: Tensor,             # (P, bs, kvr)
    krope_pool: Tensor,           # (P, bs, rope)
    tables: Tensor,               # (B, nb) int physical block ids
    lengths: Tensor,              # (B,) int — row attends kpos < length
    *,
    scale: float,
    compute_dtype: torch.dtype | None = None,
) -> Tensor:
    """The table's blocks gathered into a dense (B, nb*bs, r) view, then
    the slab path's absorbed-decode math (``ref.attend_mla_absorbed``);
    returns ctx_lat (B, H, kvr) fp32 (mirror of the jnp
    ``paged_mla_reference``; the w_uv absorption stays outside)."""
    dt = compute_dtype if compute_dtype is not None else q_rope.dtype
    ckv = gather_lat(ckv_pool, tables).to(dt)
    krope = gather_lat(krope_pool, tables).to(dt)
    end = lengths.to(device=q_lat.device, dtype=torch.int64) - 1
    return attend_mla_absorbed(q_lat, q_rope, ckv, krope, end, scale)


def paged_mla(
    q_lat: Tensor,
    q_rope: Tensor,
    ckv_pool: Tensor,
    krope_pool: Tensor,
    tables: Tensor,
    lengths: Tensor,
    *,
    scale: float,
    compute_dtype: torch.dtype | None = None,
) -> Tensor:
    """Paged MLA absorbed decode: q_lat (B, H, kvr) fp32 and q_rope
    (B, H, rope) against the compressed pool in place; returns ctx_lat
    (B, H, kvr) fp32. The kernel reads the pool in its own type
    (``compute_dtype`` only shapes the plain version, as in the JAX
    kernel)."""
    if q_lat.ndim != 3 or q_rope.ndim != 3 or ckv_pool.ndim != 3 \
            or krope_pool.ndim != 3:
        raise ValueError("paged_mla takes 3-D q_lat, q_rope and pools")
    b, h, kvr = q_lat.shape
    rope = q_rope.shape[-1]
    if q_rope.shape[:2] != (b, h) or ckv_pool.shape[2] != kvr \
            or krope_pool.shape[:2] != ckv_pool.shape[:2] \
            or krope_pool.shape[2] != rope:
        raise ValueError(
            f"MLA shapes: q_lat{tuple(q_lat.shape)} q_rope"
            f"{tuple(q_rope.shape)} pools {tuple(ckv_pool.shape)}/"
            f"{tuple(krope_pool.shape)}")
    if not q_lat.is_cuda:
        return paged_mla_reference(q_lat, q_rope, ckv_pool, krope_pool,
                                   tables, lengths, scale=scale,
                                   compute_dtype=compute_dtype)
    build.refuse_autograd("paged_mla", q_lat, q_rope, ckv_pool, krope_pool)
    if q_lat.dtype != torch.float32 or q_rope.dtype not in _QTYPES \
            or ckv_pool.dtype not in _QTYPES \
            or krope_pool.dtype != ckv_pool.dtype:
        raise TypeError(f"paged_mla kernel: q_lat {q_lat.dtype} (fp32), "
                        f"q_rope {q_rope.dtype}, pools {ckv_pool.dtype}/"
                        f"{krope_pool.dtype} (fp32 or bf16, one type)")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32 \
            or tables.ndim != 2 or tables.shape[0] != b \
            or lengths.shape != (b,):
        raise ValueError("paged_mla: tables (B, nb) and lengths (B,) "
                         "must be int32")
    tensors = [q_lat, q_rope, ckv_pool, krope_pool, tables, lengths]
    if any(t.device != q_lat.device for t in tensors):
        raise ValueError("paged_mla: operands on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_mla kernel takes contiguous operands")
    # csrc/paged_mla.cu: pool rows and q_lat rows stream as whole 16-byte
    # vectors; on the fma route a lane holds five float4 of the query and
    # four of the accumulator
    vec = 16 // ckv_pool.element_size()
    if kvr > MLA_MAX_KVR or kvr + rope > MLA_MAX_WIDTH or kvr % vec \
            or rope % vec or ckv_pool.data_ptr() % 16 \
            or krope_pool.data_ptr() % 16 or q_lat.data_ptr() % 16:
        raise ValueError(
            f"paged_mla kernel takes kvr <= {MLA_MAX_KVR}, kvr + rope <= "
            f"{MLA_MAX_WIDTH}, both multiples of {vec} and 16-byte aligned "
            f"pools and q_lat; got kvr {kvr}, rope {rope}")
    # the tc route copies q_rope rows in bulk: a view that starts off a
    # 16-byte boundary takes the fma route, which reads it by element
    route = (mla_route(kvr, rope, ckv_pool.shape[1], ckv_pool.dtype)
             if q_rope.data_ptr() % 16 == 0 else "fma")
    out = torch.empty((b, h, kvr), dtype=torch.float32, device=q_lat.device)
    nb = tables.shape[1]
    if b == 0 or h == 0 or nb == 0:
        return out.zero_()
    # the splits' partials (m, l and acc, fp32): S splits a row at most
    bs = ckv_pool.shape[1]
    chunk = split_chunk(bs)
    splits = -(-nb * bs // chunk)
    ws_acc = torch.empty((b * h * splits * kvr,), dtype=torch.float32,
                         device=q_lat.device)
    ws_ml = torch.empty((b * h * splits * 2,), dtype=torch.float32,
                        device=q_lat.device)
    fn = build.entry("paged_mla", "paged_mla_launch", _MLA_ARGTYPES)
    stream = torch.cuda.current_stream(q_lat.device).cuda_stream
    err = fn(q_lat.data_ptr(), q_rope.data_ptr(), ckv_pool.data_ptr(),
             krope_pool.data_ptr(), tables.data_ptr(), lengths.data_ptr(),
             out.data_ptr(), ws_acc.data_ptr(), ws_ml.data_ptr(), b, h, kvr,
             rope, bs, nb, chunk, float(scale), _QTYPES[q_rope.dtype],
             _QTYPES[ckv_pool.dtype], ROUTES[route], stream)
    build.check(err, "paged_mla")
    build.launches["paged_mla"] += 1
    return out
