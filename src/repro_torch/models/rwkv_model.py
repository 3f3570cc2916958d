"""RWKV6 full model (mirror of ``repro.models.rwkv_model``): embeddings,
then per layer [RMSNorm, time-mix, RMSNorm, channel-mix], each half
residual; tied unembedding.

Layout: ``params["layers"]`` is a list of per-layer dicts (the JAX
package stacks them on a leading L axis for its ``lax.scan``;
``repro_torch.bridge`` converts), and so is the decode state:
``{"wkv": (B, H, K, K) fp32, "shift_tm": (B, D), "shift_cm": (B, D)}``
a layer. ``prefill`` and ``decode_step`` write the new state into the
given tensors in place and return the same list, so a server that
zeroes one state buffer before each request keeps the addresses its
captured decode graph reads.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.function_table import DEFAULT_TABLE
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import rwkv as rwkv_lib

Tensor = torch.Tensor


def param_shapes(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    block = dict(rwkv_lib.rwkv_param_shapes(cfg))
    block["tm_norm"] = ((d,), "ones")
    block["cm_norm"] = ((d,), "ones")
    return {
        "embed": ((L.padded_vocab(cfg.vocab_size), d), "embed"),
        "final_norm": ((d,), "ones"),
        "layers": [block for _ in range(cfg.num_layers)],
    }


def init(cfg: ModelConfig, *, seed: int = 0, device=None) -> dict:
    return L.materialize(param_shapes(cfg), cfg.dtype, seed=seed,
                         device=resolve_device(device))


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int) -> list:
    """The recurrent state a layer; ``max_len`` is not used (the state is
    O(1) in sequence length)."""
    return [rwkv_lib.rwkv_state_shapes(cfg, batch)
            for _ in range(cfg.num_layers)]


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device=None) -> list:
    return L.zeros(cache_shapes(cfg, batch, max_len), resolve_device(device))


def _layer(p, cfg, x, state, *, table):
    h = L.rms_norm(x, p["tm_norm"], cfg.norm_eps)
    y, ns = rwkv_lib.rwkv_block(p, cfg, h, table=table, state=state)
    x = x + y
    h = L.rms_norm(x, p["cm_norm"], cfg.norm_eps)
    y, ns = rwkv_lib.rwkv_channel_mix(p, cfg, h, table=table, state=ns)
    return x + y, ns


def _layer_out(p, cfg, x, *, table):
    return _layer(p, cfg, x, None, table=table)[0]


def store_state(dst: dict, new: dict) -> None:
    """Write a layer's new state into its carried tensors."""
    for name, t in new.items():
        dst[name].copy_(t)


def _run(params, cfg: ModelConfig, x, *, table, state=None):
    remat = L.remat_kwargs(cfg) if state is None else None
    for i, p in enumerate(params["layers"]):
        if state is not None:
            x, ns = _layer(p, cfg, x, state[i], table=table)
            store_state(state[i], ns)
        elif remat is None:
            x, _ = _layer(p, cfg, x, None, table=table)
        else:
            x = checkpoint(functools.partial(_layer_out, table=table), p,
                           cfg, x, **remat)
    return x


def forward(params, cfg: ModelConfig, batch: dict, *,
            table=DEFAULT_TABLE) -> Tensor:
    """batch {"tokens": (B, S)} -> fp32 logits (B, S, V_pad)."""
    x = L.embed_lookup(params["embed"], batch["tokens"])
    x = _run(params, cfg, x, table=table)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(x, params["embed"])


def loss(params, cfg: ModelConfig, batch: dict, *,
         table=DEFAULT_TABLE) -> Tensor:
    logits = forward(params, cfg, batch, table=table)
    return L.softmax_cross_entropy(
        logits[:, :-1, :].reshape(-1, logits.shape[-1]),
        batch["labels"][:, 1:].reshape(-1), vocab=cfg.vocab_size)


def check_whole_prompt(cache_pos, block_tables) -> None:
    """The recurrent families prefill a whole prompt into a zero state:
    no chunk offset, no paged pool (the JAX modules take neither)."""
    if cache_pos is not None or block_tables is not None:
        raise ValueError(
            "a recurrent-state prefill runs the whole prompt from a zero "
            "state: cache_pos and block_tables are not taken")


def prefill(params, cfg: ModelConfig, batch: dict, cache: list, *,
            table=DEFAULT_TABLE, cache_pos=None, block_tables=None):
    """Run the prompt through the state ``cache`` (updated in place) and
    return the logits at its last position (B, 1, V_pad)."""
    check_whole_prompt(cache_pos, block_tables)
    x = L.embed_lookup(params["embed"], batch["tokens"])
    x = _run(params, cfg, x, table=table, state=cache)
    x = L.rms_norm(x[:, -1:, :], params["final_norm"], cfg.norm_eps)
    return L.unembed(x, params["embed"]), cache


def decode_step(params, cfg: ModelConfig, tokens: Tensor, cache: list,
                pos, *, table=DEFAULT_TABLE, block_tables=None):
    """One token a row (B, 1); ``pos`` (an int or (B,)) is not read: the
    state carries the position."""
    check_whole_prompt(None, block_tables)
    x = L.embed_lookup(params["embed"], tokens)
    x = _run(params, cfg, x, table=table, state=cache)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(x, params["embed"]), cache
