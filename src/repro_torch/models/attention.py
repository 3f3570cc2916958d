"""GQA attention with dense-slab and paged KV caches (mirror of the GQA
half of ``repro.models.attention``).

KV caches, per layer (the port keeps one dict per layer, not a stacked
leading L axis):
  * slab: k/v (B, Hkv, T, Dh), int8 scales (B, Hkv, T);
  * paged pool: k/v (P + 1, Hkv, bs, Dh), scales (P + 1, Hkv, bs). Row
    P is the DROP SINK: positions past a row's table get block id P
    (``paged_write_index``), where the JAX package scatters with
    ``mode="drop"``. Torch's ``index_put_`` has no drop mode and an
    index P of a P-row tensor is a device-side assert, so the pool
    carries the one extra row those writes land in. No table entry ever
    names it (``launch.kvpool.validate_tables`` bounds tables by P).

Cache updates are IN PLACE on the given tensors (they replace JAX's
donated buffers): ``gqa_attention`` returns the same dict it was given.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.paged_attention import gather_kv, gather_scale
from repro_torch.kernels.ref import attend_direct_offset, rowwise_pos
from repro_torch.models.layers import apply_rope, linear

Tensor = torch.Tensor


def gqa_param_shapes(cfg: ModelConfig) -> dict:
    d, h, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": ((d, h * dh), "normal"),
        "wk": ((d, hkv * dh), "normal"),
        "wv": ((d, hkv * dh), "normal"),
        "wo": ((h * dh, d), "normal"),
    }


def kv_cache_shapes(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """One layer's cache: name -> (shape, dtype)."""
    hkv, dh = cfg.num_kv_heads, cfg.head_dim
    shapes = {
        "k": ((batch, hkv, max_len, dh), cfg.kv_cache_dtype),
        "v": ((batch, hkv, max_len, dh), cfg.kv_cache_dtype),
    }
    if cfg.kv_cache_dtype == torch.int8:
        shapes["k_scale"] = ((batch, hkv, max_len), torch.float32)
        shapes["v_scale"] = ((batch, hkv, max_len), torch.float32)
    return shapes


def paged_write_index(block_tables: Tensor, cache_pos, s: int, bs: int,
                      num_blocks: int) -> tuple[Tensor, Tensor]:
    """Physical (block, offset) of each written position: ``(B,)`` for
    single-token decode, ``(B, s)`` for a prefill chunk. A position past
    the table gets the sentinel block id ``num_blocks`` (the pool's drop
    sink) instead of clamping onto the row's last real block, which
    could be a prefix-shared neighbour's."""
    b, nb = block_tables.shape
    pos = torch.as_tensor(cache_pos, dtype=torch.int64,
                          device=block_tables.device)
    if s == 1:
        p = pos.expand(b) if pos.ndim == 0 else pos
    else:
        start = pos[:, None] if pos.ndim == 1 else pos
        p = (start + torch.arange(s, device=pos.device)).expand(b, s)
    blk = p // bs
    pb = torch.gather(block_tables.long(), 1,
                      blk.clamp_max(nb - 1).reshape(b, -1)).reshape(p.shape)
    pb = torch.where(blk < nb, pb, torch.full_like(pb, num_blocks))
    return pb, p % bs


def quantize_kv(x: Tensor) -> tuple[Tensor, Tensor]:
    """Per-(token, head) int8 quantization of x (B, Hkv, S, Dh); rounds
    half to even like ``jnp.round``."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(-1) / 127.0, 1e-8)
    return torch.round(xf / scale[..., None]).to(torch.int8), scale


def dequantize_kv(q: Tensor, scale: Tensor, dtype) -> Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def _write_slab(cache: dict, name: str, vals: Tensor, cache_pos,
                s: int) -> None:
    leaf = cache[name]
    if rowwise_pos(cache_pos):
        if s != 1:
            raise NotImplementedError(
                "multi-token rowwise slab writes (the speculative draft's "
                "ingest) come with speculative decoding")
        bidx = torch.arange(leaf.shape[0], device=leaf.device)
        leaf[bidx, :, cache_pos.to(leaf.device)] = vals[:, :, 0]
    else:
        # dynamic_update_slice semantics: the start clamps so the update
        # fits inside the cache
        start = max(0, min(int(cache_pos), leaf.shape[2] - s))
        leaf[:, :, start:start + s] = vals


def gqa_attention(
    params: dict,
    cfg: ModelConfig,
    x: Tensor,                       # (B, S, D)
    positions: Tensor,               # (B, S)
    *,
    cache: dict | None = None,       # one layer's cache (slab or pool)
    cache_pos=None,                  # int / 0-d tensor, or (B,) per row
    block_tables: Tensor | None = None,  # (B, nb) paged-KV mapping
) -> tuple[Tensor, dict | None]:
    b, s, _ = x.shape
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    q = linear(x, params["wq"]).reshape(b, s, h, dh)
    k = linear(x, params["wk"]).reshape(b, s, hkv, dh)
    v = linear(x, params["wv"]).reshape(b, s, hkv, dh)

    q = apply_rope(q, positions, cfg.rope_theta)
    ar = torch.arange(s, device=x.device)
    if cache is None:
        kpos = positions
    elif rowwise_pos(cache_pos):
        kpos = cache_pos.to(x.device)[:, None] + ar[None, :]
    else:
        kpos = int(cache_pos) + ar[None, :]
    k = apply_rope(k, kpos, cfg.rope_theta)

    q, k, v = (t.transpose(1, 2) for t in (q, k, v))   # (B, heads, S, Dh)

    if cache is not None:
        int8 = cfg.kv_cache_dtype == torch.int8
        if int8:
            kq, ks = quantize_kv(k)
            vq, vs = quantize_kv(v)
        else:
            kq, vq = k.to(cfg.kv_cache_dtype), v.to(cfg.kv_cache_dtype)
        if block_tables is not None:
            # paged KV: each written position scatters to its row's table
            # entry; out-of-table positions go to the drop sink row
            sink = cache["k"].shape[0] - 1
            pb, po = paged_write_index(block_tables, cache_pos, s,
                                       cache["k"].shape[2], sink)
            if s == 1:
                writes = {"k": kq[:, :, 0], "v": vq[:, :, 0]}
                if int8:
                    writes.update(k_scale=ks[:, :, 0], v_scale=vs[:, :, 0])
            else:
                writes = {"k": kq.transpose(1, 2), "v": vq.transpose(1, 2)}
                if int8:
                    writes.update(k_scale=ks.transpose(1, 2),
                                  v_scale=vs.transpose(1, 2))
            for name, vals in writes.items():
                cache[name][pb, :, po] = vals
        else:
            _write_slab(cache, "k", kq, cache_pos, s)
            _write_slab(cache, "v", vq, cache_pos, s)
            if int8:
                _write_slab(cache, "k_scale", ks, cache_pos, s)
                _write_slab(cache, "v_scale", vs, cache_pos, s)
        if block_tables is not None and s == 1:
            # paged decode IN PLACE on the pool: the op walks the block
            # table (the Hopper kernel on the card, the table gather
            # feeding the dense math on the CPU)
            pos = torch.as_tensor(cache_pos, dtype=torch.int32,
                                  device=x.device)
            lengths = (pos.expand(b) + 1).to(torch.int32).contiguous()
            ctx = kops.paged_attention_gqa(
                q[:, :, 0, :].contiguous(), cache["k"], cache["v"],
                block_tables, lengths, scale=1.0 / math.sqrt(dh),
                k_scale=cache["k_scale"] if int8 else None,
                v_scale=cache["v_scale"] if int8 else None,
                compute_dtype=cfg.dtype,
            )
            return linear(ctx.reshape(b, 1, h * dh), params["wo"]), cache
        if block_tables is not None:
            # prefill chunks: dense view gathered through the table; junk
            # in padded/unwritten blocks sits behind the causal mask
            k = gather_kv(cache["k"], block_tables)
            v = gather_kv(cache["v"], block_tables)
            if int8:
                k = dequantize_kv(k, gather_scale(cache["k_scale"],
                                                  block_tables), cfg.dtype)
                v = dequantize_kv(v, gather_scale(cache["v_scale"],
                                                  block_tables), cfg.dtype)
            else:
                k, v = k.to(cfg.dtype), v.to(cfg.dtype)
        elif int8:
            k = dequantize_kv(cache["k"], cache["k_scale"], cfg.dtype)
            v = dequantize_kv(cache["v"], cache["v_scale"], cfg.dtype)
        else:
            k, v = cache["k"].to(cfg.dtype), cache["v"].to(cfg.dtype)

    t = k.shape[2]
    offset = (cache_pos if rowwise_pos(cache_pos) else int(cache_pos)) \
        if cache is not None else t - s
    out = attend_direct_offset(q, k, v, h // hkv, 1.0 / math.sqrt(dh),
                               True, offset)
    out = out.transpose(1, 2).reshape(b, s, h * dh)
    return linear(out, params["wo"]), cache
