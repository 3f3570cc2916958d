"""Whisper-medium backbone: an encoder-decoder transformer (mirror of
``repro.models.whisper``).

The conv audio frontend is a stub, as in the JAX package: the caller
gives precomputed frame embeddings (B, encoder_seq, D). The encoder is
a bidirectional transformer (non-causal self-attention with rope on the
frame positions, a GELU MLP); the decoder adds causal self-attention
with a KV cache and cross-attention to the encoder memory, whose K and V
are projected from the memory at every call. Pre-LN blocks; the
embedding is tied to the unembedding.

Layout (``repro_torch.bridge`` converts from the JAX package's stacks):
``params["encoder"]`` and ``params["decoder"]`` are lists of per-layer
dicts in layer order, beside ``embed``, ``enc_norm`` and ``dec_norm``;
the cache is a list of GQA slabs, one a decoder layer, updated in
place. With ``cfg.use_pallas`` every MLP of either stack is one
``sidebar_mlp`` launch.

``prefill`` encodes ``batch["frames"]`` itself and writes the prompt's
KV from position 0 on a dense slab; ``decode_step`` takes the encoder
output as ``memory`` and an int position or the per-row (B,) tensor of
a captured scan, both through the attention's rowwise form, so a
captured step never reads a position on the host.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.function_table import DEFAULT_TABLE
from repro_torch.device import resolve_device
from repro_torch.kernels.ref import rowwise_pos
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models.mlp import mlp, mlp_param_shapes

Tensor = torch.Tensor


def _enc_block_shapes(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {
        "attn_norm": ((d,), "ones"),
        "mlp_norm": ((d,), "ones"),
        "attn": attn_lib.gqa_param_shapes(cfg),
        "mlp": mlp_param_shapes(cfg),
    }


def _dec_block_shapes(cfg: ModelConfig) -> dict:
    shapes = _enc_block_shapes(cfg)
    shapes["xattn"] = attn_lib.gqa_param_shapes(cfg)
    shapes["xattn_norm"] = ((cfg.d_model,), "ones")
    return shapes


def param_shapes(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {
        "embed": ((L.padded_vocab(cfg.vocab_size), d), "embed"),
        "enc_norm": ((d,), "ones"),
        "dec_norm": ((d,), "ones"),
        "encoder": [_enc_block_shapes(cfg)
                    for _ in range(cfg.encoder_layers)],
        "decoder": [_dec_block_shapes(cfg) for _ in range(cfg.num_layers)],
    }


def init(cfg: ModelConfig, *, seed: int = 0, device=None) -> dict:
    return L.materialize(param_shapes(cfg), cfg.dtype, seed=seed,
                         device=resolve_device(device))


def _enc_layer(p, cfg, x, positions, *, table):
    h = L.rms_norm(x, p["attn_norm"], cfg.norm_eps)
    a, _ = attn_lib.gqa_attention(p["attn"], cfg, h, positions,
                                  causal=False)
    x = x + a
    h = L.rms_norm(x, p["mlp_norm"], cfg.norm_eps)
    return x + mlp(p["mlp"], cfg, h, table=table)


def encode(params, cfg: ModelConfig, frames: Tensor, *,
           table=DEFAULT_TABLE) -> Tensor:
    """frames (B, T_enc, D), the stub frontend's output -> the encoder
    memory (B, T_enc, D) in ``cfg.dtype``."""
    b, t, _ = frames.shape
    positions = torch.arange(t, device=frames.device)[None, :].expand(b, t)
    x = frames.to(cfg.dtype)
    remat = L.remat_kwargs(cfg)
    for p in params["encoder"]:
        if remat is None:
            x = _enc_layer(p, cfg, x, positions, table=table)
        else:
            x = checkpoint(functools.partial(_enc_layer, table=table), p,
                           cfg, x, positions, **remat)
    return L.rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _dec_layer(p, cfg, x, positions, memory, *, table, cache=None,
               cache_pos=None):
    h = L.rms_norm(x, p["attn_norm"], cfg.norm_eps)
    a, _ = attn_lib.gqa_attention(p["attn"], cfg, h, positions, cache=cache,
                                  cache_pos=cache_pos)
    x = x + a
    h = L.rms_norm(x, p["xattn_norm"], cfg.norm_eps)
    xa, _ = attn_lib.gqa_attention(p["xattn"], cfg, h, positions,
                                   causal=False, memory=memory)
    x = x + xa
    h = L.rms_norm(x, p["mlp_norm"], cfg.norm_eps)
    return x + mlp(p["mlp"], cfg, h, table=table)


def _decode_stack(params, cfg: ModelConfig, x, positions, memory, *, table,
                  caches=None, cache_pos=None) -> Tensor:
    """The decoder layers, then ``dec_norm``; ``caches`` (a slab a layer)
    are written in place at ``cache_pos``."""
    remat = L.remat_kwargs(cfg) if caches is None else None
    for i, p in enumerate(params["decoder"]):
        if remat is None:
            x = _dec_layer(p, cfg, x, positions, memory, table=table,
                           cache=caches[i] if caches is not None else None,
                           cache_pos=cache_pos)
        else:
            x = checkpoint(functools.partial(_dec_layer, table=table), p,
                           cfg, x, positions, memory, **remat)
    return L.rms_norm(x, params["dec_norm"], cfg.norm_eps)


def _positions(b: int, s: int, device) -> Tensor:
    return torch.arange(s, device=device)[None, :].expand(b, s)


def forward(params, cfg: ModelConfig, batch: dict, *,
            table=DEFAULT_TABLE) -> Tensor:
    """batch {"tokens": (B, S) decoder tokens, "frames": (B, T_enc, D)}
    -> fp32 logits (B, S, V_pad)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    memory = encode(params, cfg, batch["frames"], table=table)
    x = L.embed_lookup(params["embed"], tokens)
    x = _decode_stack(params, cfg, x, _positions(b, s, tokens.device),
                      memory, table=table)
    return L.unembed(x, params["embed"])


def loss(params, cfg: ModelConfig, batch: dict, *,
         table=DEFAULT_TABLE) -> Tensor:
    logits = forward(params, cfg, batch, table=table)
    return L.softmax_cross_entropy(
        logits[:, :-1, :].reshape(-1, logits.shape[-1]),
        batch["labels"][:, 1:].reshape(-1), vocab=cfg.vocab_size)


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int) -> list:
    return [attn_lib.kv_cache_shapes(cfg, batch, max_len)
            for _ in range(cfg.num_layers)]


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device=None) -> list:
    return L.zeros(cache_shapes(cfg, batch, max_len), resolve_device(device))


def prefill(params, cfg: ModelConfig, batch: dict, cache: list, *,
            table=DEFAULT_TABLE, cache_pos=None, block_tables=None):
    """Encode ``batch["frames"]``, write the prompt's KV from position 0
    into the slabs ``cache`` (in place) and return the logits at the
    last position (B, 1, V_pad). The JAX module takes no chunk offset
    and no paged pool: neither is taken here."""
    if cache_pos is not None or block_tables is not None:
        raise ValueError("whisper prefill writes the whole prompt from "
                         "position 0 into dense slabs: cache_pos and "
                         "block_tables are not taken")
    tokens = batch["tokens"]
    b, s = tokens.shape
    memory = encode(params, cfg, batch["frames"], table=table)
    x = L.embed_lookup(params["embed"], tokens)
    x = _decode_stack(params, cfg, x, _positions(b, s, tokens.device),
                      memory, table=table, caches=cache, cache_pos=0)
    return L.unembed(x[:, -1:, :], params["embed"]), cache


def decode_step(params, cfg: ModelConfig, tokens: Tensor, cache: list,
                pos, *, table=DEFAULT_TABLE, block_tables=None,
                memory: Tensor | None = None):
    """One token a row (B, 1) at ``pos`` (an int, or a per-row (B,)
    tensor), attending the encoder output ``memory`` (B, T_enc, D)."""
    if memory is None:
        raise ValueError("whisper decode needs the encoder memory")
    if block_tables is not None:
        raise ValueError("whisper decodes on dense slabs: block_tables "
                         "are not taken")
    b = tokens.shape[0]
    if not rowwise_pos(pos):
        pos = torch.full((b,), int(pos), dtype=torch.int64,
                         device=tokens.device)
    x = L.embed_lookup(params["embed"], tokens)
    x = _decode_stack(params, cfg, x, pos[:, None], memory, table=table,
                      caches=cache, cache_pos=pos)
    return L.unembed(x, params["embed"]), cache
