"""Serving steps (mirror of ``repro.launch.serve`` without tensor
parallelism).

``make_serve_step`` builds the single-token decode and
``make_prefill_step`` the (chunked) prompt-KV writer, both greedy. The
JAX package compiles N decode steps into one scanned program; here a
segment is a Python loop of eager steps (a CUDA graph of the loop is
later work). ``generate`` is the solo reference decoder the schedulers
are held to: whole-prompt prefill, then one step per token.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.launch import sampling
from repro_torch.models import layers as L
from repro_torch.models.registry import ModelApi, get_model


def make_serve_step(cfg: ModelConfig, api: ModelApi):
    """decode one token: (params, tokens (B, 1), cache, pos[,
    block_tables]) -> (next tokens (B, 1) int32, cache). ``pos`` is an
    int or a per-row (B,) tensor; the token emitted sits at ``pos + 1``.
    ``block_tables`` makes ``cache`` the paged pool, decoded in place."""

    def serve_step(params, tokens, cache, pos, block_tables=None):
        logits, cache = api.decode_step(params, cfg, tokens, cache, pos,
                                        block_tables=block_tables)
        logits = L.mask_pad_logits(logits, cfg.vocab_size)
        return sampling.sample_tokens(logits[:, -1, :])[:, None], cache

    return serve_step


def make_prefill_step(cfg: ModelConfig, api: ModelApi):
    """prompt-KV writer: (params, batch, cache[, cache_pos,
    block_tables]) -> (next tokens (B, 1), cache). ``cache_pos`` (int or
    per-row (B,)) makes the step chunked; ``block_tables`` routes the
    writes through the paged pool."""

    def prefill_step(params, batch, cache, cache_pos=None,
                     block_tables=None):
        logits, cache = api.prefill(params, cfg, batch, cache,
                                    cache_pos=cache_pos,
                                    block_tables=block_tables)
        logits = L.mask_pad_logits(logits, cfg.vocab_size)
        return sampling.sample_tokens(logits[:, -1, :])[:, None], cache

    return prefill_step


@torch.inference_mode()
def generate(cfg: ModelConfig, params, prompts: torch.Tensor,
             num_tokens: int, *, max_len: int,
             device=None) -> torch.Tensor:
    """Solo greedy decode: prompts (B, S) -> tokens (B, S + num_tokens).
    Whole-prompt prefill, then ``num_tokens - 1`` single-token steps at
    scalar positions on a fresh dense slab cache."""
    dev = resolve_device(device)
    api = get_model(cfg)
    b, s = prompts.shape
    if s + num_tokens > max_len:
        raise ValueError(f"prompt {s} + generate {num_tokens} exceeds "
                         f"max_len {max_len}")
    prompts = prompts.to(dev).long()
    cache = api.init_cache(cfg, b, max_len, device=dev)
    prefill = make_prefill_step(cfg, api)
    step = make_serve_step(cfg, api)
    nxt, cache = prefill(params, {"tokens": prompts}, cache)
    pieces = [prompts.to(torch.int32), nxt]
    for i in range(num_tokens - 1):
        nxt, cache = step(params, nxt.long(), cache, s + i)
        pieces.append(nxt)
    return torch.cat(pieces, dim=1)
