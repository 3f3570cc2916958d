"""Zamba2-style hybrid: a Mamba2 backbone and one SHARED attention block
(mirror of ``repro.models.zamba``).

Layer plan for num_layers=81, attn_every=6: 13 groups of [6 Mamba2
layers, then the shared attention + MLP block], then 3 tail Mamba2
layers. The shared block's weights are reused at every invocation; each
invocation keeps its own KV cache (13 slabs).

Layout (``repro_torch.bridge`` converts from the JAX package's nested
stacks): ``params["layers"]`` is a list of the Mamba2 layers in layer
order (group-major, then the tail), each dict holding its block's
weights and its pre-norm ``mamba_norm``; ``params["shared"]`` the one
attention + MLP block. The state is ``{"ssm": [{"h", "conv"}] a layer,
"kv": [GQA slab] a group}``; ``prefill`` and ``decode_step`` update it
in place and return it.

The shared block runs the port's ``gqa_attention`` (dense slab routes)
and ``mlp()``: with ``cfg.use_pallas`` its gated MLP is one
``sidebar_gated_mlp`` launch an invocation. Decode takes an int or a
per-row (B,) position and runs the attention's rowwise form either way,
so a captured step never reads a position on the host.
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
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.mlp import mlp, mlp_param_shapes
from repro_torch.models.rwkv_model import check_whole_prompt, store_state

Tensor = torch.Tensor


def _plan(cfg: ModelConfig) -> tuple[int, int]:
    """(n_groups, n_tail)."""
    n_groups = cfg.num_layers // cfg.attn_every
    return n_groups, cfg.num_layers - n_groups * cfg.attn_every


def param_shapes(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    layer = dict(ssm_lib.mamba2_param_shapes(cfg), mamba_norm=((d,), "ones"))
    return {
        "embed": ((L.padded_vocab(cfg.vocab_size), d), "embed"),
        "final_norm": ((d,), "ones"),
        "layers": [layer for _ in range(cfg.num_layers)],
        "shared": {
            "attn_norm": ((d,), "ones"),
            "mlp_norm": ((d,), "ones"),
            "attn": attn_lib.gqa_param_shapes(cfg),
            "mlp": mlp_param_shapes(cfg),
        },
    }


def init(cfg: ModelConfig, *, seed: int = 0, device=None) -> dict:
    return L.materialize(param_shapes(cfg), cfg.dtype, seed=seed,
                         device=resolve_device(device))


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    n_groups, _ = _plan(cfg)
    return {
        "ssm": [ssm_lib.ssm_state_shapes(cfg, batch)
                for _ in range(cfg.num_layers)],
        "kv": [attn_lib.kv_cache_shapes(cfg, batch, max_len)
               for _ in range(n_groups)],
    }


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device=None) -> dict:
    return L.zeros(cache_shapes(cfg, batch, max_len), resolve_device(device))


def _mamba(p, cfg, x, state, *, table):
    h = L.rms_norm(x, p["mamba_norm"], cfg.norm_eps)
    y, ns = ssm_lib.mamba2_block(p, cfg, h, table=table, state=state)
    return x + y, ns


def _mamba_out(p, cfg, x, *, table):
    return _mamba(p, cfg, x, None, table=table)[0]


def _shared_block(p, cfg, x, positions, *, table, cache=None,
                  cache_pos=None):
    h = L.rms_norm(x, p["attn_norm"], cfg.norm_eps)
    a, _ = attn_lib.gqa_attention(p["attn"], cfg, h, positions, cache=cache,
                                  cache_pos=cache_pos)
    x = x + a
    h = L.rms_norm(x, p["mlp_norm"], cfg.norm_eps)
    return x + mlp(p["mlp"], cfg, h, table=table)


def _run(params, cfg: ModelConfig, x, positions, *, table, state=None,
         cache_pos=None):
    remat = L.remat_kwargs(cfg) if state is None else None
    shared = params["shared"]
    for i, p in enumerate(params["layers"]):
        if state is not None:
            x, ns = _mamba(p, cfg, x, state["ssm"][i], table=table)
            store_state(state["ssm"][i], ns)
        elif remat is None:
            x, _ = _mamba(p, cfg, x, None, table=table)
        else:
            x = checkpoint(functools.partial(_mamba_out, table=table), p,
                           cfg, x, **remat)
        if (i + 1) % cfg.attn_every:
            continue
        # the end of group g: the shared block with its own KV slab
        g = (i + 1) // cfg.attn_every - 1
        if state is not None:
            x = _shared_block(shared, cfg, x, positions, table=table,
                              cache=state["kv"][g], cache_pos=cache_pos)
        elif remat is None:
            x = _shared_block(shared, cfg, x, positions, table=table)
        else:
            x = checkpoint(functools.partial(_shared_block, table=table),
                           shared, cfg, x, positions, **remat)
    return x


def forward(params, cfg: ModelConfig, batch: dict, *,
            table=DEFAULT_TABLE) -> Tensor:
    """batch {"tokens": (B, S)} -> fp32 logits (B, S, V_pad)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = L.embed_lookup(params["embed"], tokens)
    positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
    x = _run(params, cfg, x, positions, table=table)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(x, params["embed"])


def loss(params, cfg: ModelConfig, batch: dict, *,
         table=DEFAULT_TABLE) -> Tensor:
    logits = forward(params, cfg, batch, table=table)
    return L.softmax_cross_entropy(
        logits[:, :-1, :].reshape(-1, logits.shape[-1]),
        batch["labels"][:, 1:].reshape(-1), vocab=cfg.vocab_size)


def prefill(params, cfg: ModelConfig, batch: dict, cache: dict, *,
            table=DEFAULT_TABLE, cache_pos=None, block_tables=None):
    """The whole prompt from position 0 (the JAX module's ``cache_pos``
    0): the Mamba2 states and the shared block's KV slabs are written in
    place. Returns the logits at the last position (B, 1, V_pad)."""
    check_whole_prompt(cache_pos, block_tables)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = L.embed_lookup(params["embed"], tokens)
    positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
    x = _run(params, cfg, x, positions, table=table, state=cache,
             cache_pos=0)
    x = L.rms_norm(x[:, -1:, :], params["final_norm"], cfg.norm_eps)
    return L.unembed(x, params["embed"]), cache


def decode_step(params, cfg: ModelConfig, tokens: Tensor, cache: dict,
                pos, *, table=DEFAULT_TABLE, block_tables=None):
    """One token a row (B, 1) at ``pos``: an int (the whole batch) or a
    per-row (B,) tensor, both through the rowwise attention form."""
    check_whole_prompt(None, block_tables)
    b = tokens.shape[0]
    if not rowwise_pos(pos):
        pos = torch.full((b,), int(pos), dtype=torch.int64,
                         device=tokens.device)
    x = L.embed_lookup(params["embed"], tokens)
    x = _run(params, cfg, x, pos[:, None], table=table, state=cache,
             cache_pos=pos)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(x, params["embed"]), cache
