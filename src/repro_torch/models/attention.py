"""GQA and MLA attention with dense-slab and paged KV caches (mirror of
``repro.models.attention``).

KV caches, per layer (the port keeps one dict per layer, not a stacked
leading L axis):
  * GQA slab: k/v (B, Hkv, T, Dh), int8 scales (B, Hkv, T);
  * GQA paged pool: k/v (P + 1, Hkv, bs, Dh), scales (P + 1, Hkv, bs);
  * MLA (deepseek-v3), compressed, in ``cfg.dtype``: slab c_kv
    (B, T, kvr) and k_rope (B, T, rope); pool (P + 1, bs, kvr) and
    (P + 1, bs, rope).
Row P of a pool is the DROP SINK: positions past a row's table get block
id P (``paged_write_index``), where the JAX package scatters with
``mode="drop"``. Torch's ``index_put_`` has no drop mode and an index P
of a P-row tensor is a device-side assert, so the pool carries the one
extra row those writes land in. No table entry ever names it
(``launch.kvpool.validate_tables`` bounds tables by P).

Cache updates are IN PLACE on the given tensors (they replace JAX's
donated buffers): ``attention`` returns the same dict it was given.

MLA decode uses the absorbed formulation: q is projected into latent
space through w_uk, attends over the latent cache without expanding
per-head keys or values (in place on the pool through
``kops.paged_attention_mla``, or the same fp32 math on a slab), and the
latent context goes back through w_uv. Prefill expands per-head keys and
values from the latent (naive MLA).

Multi-token attention (``_attend``, mirror of the JAX module's): the
flash kernel for the cache-free training forward with ``use_pallas``
and S, T multiples of 128; else the direct form, or — for S > CHUNK_Q,
a multiple of it — the chunked form whose peak logits are O(CHUNK_Q x T)
(causal prefixes per chunk with a static offset, every chunk against
all of k otherwise: the JAX module's unrolled and scanned forms). The
JAX module reads ``REPRO_ATTN_CHUNK_Q``/``REPRO_ATTN_UNROLL``; the port
keeps their defaults as module constants.

Cross-attention (``gqa_attention(memory=)``, whisper's decoder and the
VLM's gated blocks): K and V are projected from the encoder or image
``memory`` (B, T, D) at every call, as in the JAX module; no rope, no
cache write, and the attend is non-causal (whisper's encoder passes
``causal=False`` itself).

Under the ambient TP context (``parallel.tp``) the config holds the
rank's heads (``TpSpec.cfg_local``), wq / wk / wv (MLA: w_uq, w_uk,
w_uv) are column-parallel over whole heads and wo row-parallel: every
exit reduces wo's partial over the model axis. The GQA pool and slab
shard their KV heads, so the paged kernels walk the rank's heads and no
KV moves; MLA's latent cache is replicated.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.paged_attention import (
    gather_kv,
    gather_lat,
    gather_scale,
)
from repro_torch.kernels.ref import (
    attend_direct_offset,
    attend_mla_absorbed,
    dot,
    rowwise_pos,
)
from repro_torch.models.layers import apply_rope, linear, rms_norm
from repro_torch.parallel import tp

Tensor = torch.Tensor

CHUNK_Q = 1024        # q-block size of the chunked form
UNROLL_CHUNKS = 64    # chunk counts up to this take causal prefixes


def gqa_param_shapes(cfg: ModelConfig) -> dict:
    d, h, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    shapes = {
        "wq": ((d, h * dh), "normal"),
        "wk": ((d, hkv * dh), "normal"),
        "wv": ((d, hkv * dh), "normal"),
        "wo": ((h * dh, d), "normal"),
    }
    if cfg.qk_norm:
        shapes["q_norm"] = ((dh,), "ones")
        shapes["k_norm"] = ((dh,), "ones")
    return shapes


def mla_param_shapes(cfg: ModelConfig) -> dict:
    d, h = cfg.d_model, cfg.num_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rope, vdh = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    return {
        "w_dq": ((d, qr), "normal"),
        "q_norm": ((qr,), "ones"),
        "w_uq": ((qr, h * (nope + rope)), "normal"),
        "w_dkv": ((d, kvr), "normal"),
        "kv_norm": ((kvr,), "ones"),
        "w_kr": ((d, rope), "normal"),
        "w_uk": ((kvr, h * nope), "normal"),
        "w_uv": ((kvr, h * vdh), "normal"),
        "wo": ((h * vdh, d), "normal"),
    }


def attn_param_shapes(cfg: ModelConfig) -> dict:
    return mla_param_shapes(cfg) if cfg.use_mla else gqa_param_shapes(cfg)


# The sharding description beside each shape tree: a leaf is the
# model-only partition of its tensor (``parallel.tp.model_only_pspec`` of
# the JAX package's spec), a tuple naming "model" at the sharded dim, or
# () for a replicated leaf.

def gqa_param_pspecs(cfg: ModelConfig) -> dict:
    """Column-parallel q / k / v over whole heads, row-parallel wo."""
    specs = {"wq": (None, "model"), "wk": (None, "model"),
             "wv": (None, "model"), "wo": ("model",)}
    if cfg.qk_norm:
        specs["q_norm"] = ()
        specs["k_norm"] = ()
    return specs


def mla_param_pspecs(cfg: ModelConfig) -> dict:
    """The latent projections replicated, the per-head ups column-
    parallel, wo row-parallel."""
    return {"w_dq": (), "q_norm": (), "w_uq": (None, "model"),
            "w_dkv": (), "kv_norm": (), "w_kr": (),
            "w_uk": (None, "model"), "w_uv": (None, "model"),
            "wo": ("model",)}


def attn_param_pspecs(cfg: ModelConfig) -> dict:
    return mla_param_pspecs(cfg) if cfg.use_mla else gqa_param_pspecs(cfg)


def kv_cache_pspecs(cfg: ModelConfig) -> dict:
    """One layer's cache (slab or pool: the same leaves): GQA shards its
    KV heads (axis 1 of both layouts), MLA's latent is replicated."""
    if cfg.use_mla:
        return {"c_kv": (), "k_rope": ()}
    specs = {"k": (None, "model"), "v": (None, "model")}
    if cfg.kv_cache_dtype == torch.int8:
        specs["k_scale"] = (None, "model")
        specs["v_scale"] = (None, "model")
    return specs


def kv_cache_shapes(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """One layer's cache: name -> (shape, dtype)."""
    if cfg.use_mla:
        return {
            "c_kv": ((batch, max_len, cfg.kv_lora_rank), cfg.dtype),
            "k_rope": ((batch, max_len, cfg.rope_head_dim), cfg.dtype),
        }
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
                s: int, axis: int = 2) -> None:
    """Write ``vals`` into slab leaf ``name`` at positions ``cache_pos``
    onward along the leaf's position ``axis`` (2 for GQA leaves, 1 for
    MLA's)."""
    leaf = cache[name].movedim(axis, 1)           # a view: writes land
    vals = vals.movedim(axis, 1)
    if rowwise_pos(cache_pos):
        bidx = torch.arange(leaf.shape[0], device=leaf.device)
        start = cache_pos.to(leaf.device)
        if s == 1:
            leaf[bidx, start] = vals[:, 0]
        else:
            _write_rows_dropping(leaf, vals, bidx, start, s)
    else:
        # dynamic_update_slice semantics: the start clamps so the update
        # fits inside the cache
        start = max(0, min(int(cache_pos), leaf.shape[1] - s))
        leaf[:, start:start + s] = vals


def _write_rows_dropping(leaf: Tensor, vals: Tensor, bidx: Tensor,
                         start: Tensor, s: int) -> None:
    """Row b writes ``vals[b, i]`` at position ``start[b] + i`` of
    ``leaf`` (B, T, ...); positions past the slab vanish, as the JAX
    package's ``mode="drop"`` scatter (the speculative draft's ingest of
    padded short rows). Dropped writes are aimed at position T - 1 and
    carry what that position holds after the valid writes, so the
    duplicate indices of the scatter all agree."""
    t = leaf.shape[1]
    ppos = start[:, None] + torch.arange(s, device=leaf.device)[None, :]
    trail = (1,) * (vals.ndim - 2)
    # the chunk offset that writes T - 1, where the row reaches it
    at_last = t - 1 - start
    hit = ((at_last >= 0) & (at_last < s)).reshape((-1,) + trail)
    fill = torch.where(hit, vals[bidx, at_last.clamp(0, s - 1)],
                       leaf[bidx, t - 1])
    vals = torch.where((ppos < t).reshape(ppos.shape + trail), vals,
                       fill[:, None])
    leaf[bidx[:, None], ppos.clamp_max(t - 1)] = vals


def _key_positions(positions: Tensor, cache, cache_pos, s: int,
                   device) -> Tensor:
    """Positions of the chunk's keys: the queries' own without a cache,
    else ``cache_pos`` onward (per row for a (B,) ``cache_pos``)."""
    if cache is None:
        return positions
    ar = torch.arange(s, device=device)
    if rowwise_pos(cache_pos):
        return cache_pos.to(device)[:, None] + ar[None, :]
    return int(cache_pos) + ar[None, :]


def _decode_lengths(cache_pos, b: int, device) -> Tensor:
    """(B,) int32 lengths of a decode step: each row attends kpos <=
    its position."""
    pos = torch.as_tensor(cache_pos, dtype=torch.int32, device=device)
    return (pos.expand(b) + 1).to(torch.int32).contiguous()


def _attend(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
            cfg: ModelConfig, offset=None) -> Tensor:
    """q (B, H, S, Dh) against k/v (B, Hkv, T, Dh): flash, chunked or
    direct. ``offset`` is the global position of query row 0, scalar or
    per row (B,); None — the cache-free forward — puts the queries at the
    sequence end (T - S), the only static offset. A prefill with a cache
    always passes its ``cache_pos`` (the JAX package's is a traced
    int32), so it never reaches the kernel."""
    s, dh = q.shape[2], q.shape[3]
    t = k.shape[2]
    static = offset is None
    if static:
        offset = t - s
    if cfg.use_pallas and s % 128 == 0 and t % 128 == 0 and static:
        return kops.flash_attention(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal=causal)
    group = q.shape[1] // k.shape[1]
    scale = 1.0 / math.sqrt(dh)
    if s <= CHUNK_Q or s % CHUNK_Q:
        return attend_direct_offset(q, k, v, group, scale, causal, offset)
    return _attend_chunked(q, k, v, group, scale, causal, offset, static)


def _attend_chunked(q, k, v, group: int, scale: float, causal: bool,
                    offset, static: bool) -> Tensor:
    """Over q chunks of CHUNK_Q: peak logits O(CHUNK_Q x T), not
    O(S x T). With a static offset and at most UNROLL_CHUNKS chunks a
    causal chunk i attends only k[:offset + (i+1) * CHUNK_Q] (the
    causal skipping of the JAX module's unrolled loop); otherwise every
    chunk attends all of k (its scan)."""
    s = q.shape[2]
    n_chunks = s // CHUNK_Q
    prefix = causal and static and n_chunks <= UNROLL_CHUNKS
    outs = []
    for i in range(n_chunks):
        qi = q[:, :, i * CHUNK_Q:(i + 1) * CHUNK_Q]
        ki, vi = k, v
        if prefix:
            end = offset + (i + 1) * CHUNK_Q
            ki, vi = k[:, :, :end], v[:, :, :end]
        outs.append(attend_direct_offset(qi, ki, vi, group, scale, causal,
                                         offset + i * CHUNK_Q))
    return torch.cat(outs, dim=2)


def gqa_attention(
    params: dict,
    cfg: ModelConfig,
    x: Tensor,                       # (B, S, D)
    positions: Tensor,               # (B, S)
    *,
    causal: bool = True,
    cache: dict | None = None,       # one layer's cache (slab or pool)
    cache_pos=None,                  # int / 0-d tensor, or (B,) per row
    memory: Tensor | None = None,    # cross-attention memory (B, T, D)
    block_tables: Tensor | None = None,  # (B, nb) paged-KV mapping
) -> tuple[Tensor, dict | None]:
    b, s, _ = x.shape
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    q = linear(x, params["wq"]).reshape(b, s, h, dh)
    kv_src = x if memory is None else memory
    k = linear(kv_src, params["wk"]).reshape(b, kv_src.shape[1], hkv, dh)
    v = linear(kv_src, params["wv"]).reshape(b, kv_src.shape[1], hkv, dh)

    if cfg.qk_norm:  # qk-RMSNorm over the head dim (qwen3), before rope
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)

    if memory is None:  # rope only for self-attention
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, _key_positions(positions, cache, cache_pos, s,
                                         x.device), cfg.rope_theta)

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
            ctx = kops.paged_attention_gqa(
                q[:, :, 0, :].contiguous(), cache["k"], cache["v"],
                block_tables, _decode_lengths(cache_pos, b, x.device),
                scale=1.0 / math.sqrt(dh),
                k_scale=cache["k_scale"] if int8 else None,
                v_scale=cache["v_scale"] if int8 else None,
                compute_dtype=cfg.dtype,
            )
            return tp.psum_partial(linear(ctx.reshape(b, 1, h * dh),
                                          params["wo"])), cache
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

    offset = None if cache is None else (
        cache_pos if rowwise_pos(cache_pos) else int(cache_pos))
    out = _attend(q, k, v, causal=causal and memory is None, cfg=cfg,
                  offset=offset)
    out = out.transpose(1, 2).reshape(b, s, h * dh)
    return tp.psum_partial(linear(out, params["wo"])), cache


def _per_head_dot(x: Tensor, wh: Tensor) -> Tensor:
    """fp32 ``einsum("bshi,hij->bshj")`` of x (B, S, H, I) with per-head
    matrices wh (H, I, J): one fixed-order contraction per head."""
    b, s, h, i = x.shape
    xh = x.float().permute(2, 0, 1, 3).reshape(h, b * s, i)
    out = dot(xh, wh.float())                                 # (H, B*S, J)
    return out.reshape(h, b, s, -1).permute(1, 2, 0, 3)


def mla_attention(
    params: dict,
    cfg: ModelConfig,
    x: Tensor,                       # (B, S, D)
    positions: Tensor,               # (B, S)
    *,
    cache: dict | None = None,       # one layer's cache (slab or pool)
    cache_pos=None,                  # int / 0-d tensor, or (B,) per row
    block_tables: Tensor | None = None,  # (B, nb) paged-KV mapping
) -> tuple[Tensor, dict | None]:
    """MLA (DeepSeek-V3) with a compressed cache (mirror of
    ``repro.models.attention.mla_attention``)."""
    b, s, _ = x.shape
    h, kvr = cfg.num_heads, cfg.kv_lora_rank
    nope, rope, vdh = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim

    # queries: low-rank down + norm + up
    c_q = rms_norm(linear(x, params["w_dq"]), params["q_norm"], cfg.norm_eps)
    q = linear(c_q, params["w_uq"]).reshape(b, s, h, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    # compressed kv latent + shared rope key
    c_kv = rms_norm(linear(x, params["w_dkv"]), params["kv_norm"],
                    cfg.norm_eps)                             # (B, S, kvr)
    k_rope = apply_rope(linear(x, params["w_kr"]),
                        _key_positions(positions, cache, cache_pos, s,
                                       x.device), cfg.rope_theta)

    if cache is not None:
        ckv_w = c_kv.to(cache["c_kv"].dtype)
        kr_w = k_rope.to(cache["k_rope"].dtype)
        if block_tables is not None:
            # paged: the (block, offset) scatter of the GQA path, out-of-
            # table positions into the drop sink row
            sink = cache["c_kv"].shape[0] - 1
            pb, po = paged_write_index(block_tables, cache_pos, s,
                                       cache["c_kv"].shape[1], sink)
            if s == 1:
                ckv_w, kr_w = ckv_w[:, 0], kr_w[:, 0]
            cache["c_kv"][pb, po] = ckv_w
            cache["k_rope"][pb, po] = kr_w
            if s != 1:
                # prefill chunks attend through the gathered dense view;
                # single-token decode goes in place on the pool below
                c_kv = gather_lat(cache["c_kv"], block_tables).to(cfg.dtype)
                k_rope = gather_lat(cache["k_rope"], block_tables
                                    ).to(cfg.dtype)
        else:
            _write_slab(cache, "c_kv", ckv_w, cache_pos, s, axis=1)
            _write_slab(cache, "k_rope", kr_w, cache_pos, s, axis=1)
            c_kv = cache["c_kv"].to(cfg.dtype)
            k_rope = cache["k_rope"].to(cfg.dtype)

    scale = 1.0 / math.sqrt(nope + rope)

    if cache is not None and s == 1:
        # absorbed decode: q into latent space, K/V never expanded
        # einsum("bshn,rhn->bshr") with w_uk as (kvr, H, nope)
        w_uk = params["w_uk"].reshape(kvr, h, nope).permute(1, 2, 0)
        q_lat = _per_head_dot(q_nope, w_uk)                   # (B,1,H,kvr)
        if block_tables is not None:
            ctx = kops.paged_attention_mla(
                q_lat[:, 0].contiguous(), q_rope[:, 0].contiguous(),
                cache["c_kv"], cache["k_rope"], block_tables,
                _decode_lengths(cache_pos, b, x.device), scale=scale,
                compute_dtype=cfg.dtype)
        else:
            ctx = attend_mla_absorbed(q_lat[:, 0], q_rope[:, 0], c_kv,
                                      k_rope, cache_pos, scale)
        # einsum("bshr,rhv->bshv") with w_uv as (kvr, H, vdh)
        w_uv = params["w_uv"].reshape(kvr, h, vdh).permute(1, 0, 2)
        out = _per_head_dot(ctx[:, None], w_uv)               # (B,1,H,vdh)
        out = out.reshape(b, 1, h * vdh).to(cfg.dtype)
        return tp.psum_partial(linear(out, params["wo"])), cache

    # prefill: expand per-head keys and values from the latent (naive MLA)
    t = c_kv.shape[1]
    k_nope = linear(c_kv, params["w_uk"]).reshape(b, t, h, nope)
    v = linear(c_kv, params["w_uv"]).reshape(b, t, h, vdh)
    k_rope_h = k_rope[:, :, None, :].expand(b, t, h, rope)
    q_full = torch.cat([q_nope, q_rope], dim=-1).transpose(1, 2)
    k_full = torch.cat([k_nope, k_rope_h], dim=-1).transpose(1, 2)
    static = cache is None
    offset = t - s if static else (
        cache_pos if rowwise_pos(cache_pos) else int(cache_pos))
    # MLA head dims are non-uniform: never the kernel, as in the JAX module
    if s > CHUNK_Q and s % CHUNK_Q == 0:
        out = _attend_chunked(q_full, k_full, v.transpose(1, 2), 1, scale,
                              True, offset, static)
    else:
        out = attend_direct_offset(q_full, k_full, v.transpose(1, 2), 1,
                                   scale, True, offset)
    out = out.transpose(1, 2).reshape(b, s, h * vdh)
    return tp.psum_partial(linear(out, params["wo"])), cache


def attention(params: dict, cfg: ModelConfig, x: Tensor, positions: Tensor,
              **kw) -> tuple[Tensor, dict | None]:
    """The layer's self-attention: MLA or GQA by the config."""
    if cfg.use_mla:
        return mla_attention(params, cfg, x, positions, **kw)
    return gqa_attention(params, cfg, x, positions, **kw)
