"""Decoder-only transformer LM (mirror of the dense and MoE branches of
``repro.models.transformer``): GQA or MLA attention, then a dense MLP or
a MoE block, by the layer plan (``first_dense_layers`` dense blocks, then
MoE blocks, for a config with experts).

Model API (see ``registry.py``):

  param_shapes(cfg)                           -> shape/initializer tree
  init(cfg, *, seed, device)                  -> params
  cache_shapes(cfg, batch, max_len)           -> per-layer cache shapes
  init_cache(cfg, batch, max_len, *, device)  -> per-layer cache dicts
  prefill(params, cfg, batch, cache, ...)     -> (logits, cache)
  decode_step(params, cfg, tokens, cache, pos, ...) -> (logits, cache)

Layout: ``params["layers"]`` and the cache are LISTS of per-layer dicts
in layer order (the JAX package stacks each kind of layer on a leading
L axis for its scan, ``blocks["dense"]`` then ``blocks["moe"]``;
``repro_torch.bridge`` converts). A dense layer's dict holds ``mlp``, a
MoE layer's ``moe``. Every layer runs under
``kops.layer_scope(i)``, so a layer-indexed ``ExecutionPlan`` resolves
per layer. Cache updates are in place.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.function_table import DEFAULT_TABLE
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models.mlp import mlp, mlp_param_shapes
from repro_torch.models.moe import moe, moe_param_shapes

Tensor = torch.Tensor


FAMILIES = ("dense", "moe")


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (the port serves "
            f"{', '.join(FAMILIES)})")


def layer_plan(cfg: ModelConfig) -> list[tuple[str, int]]:
    """[(kind, count)] in layer order (``_layer_plan`` of the JAX
    package): with experts, ``first_dense_layers`` dense blocks, then
    MoE blocks."""
    if cfg.num_experts:
        plan = []
        if cfg.first_dense_layers:
            plan.append(("dense", cfg.first_dense_layers))
        plan.append(("moe", cfg.num_layers - cfg.first_dense_layers))
        return plan
    return [("dense", cfg.num_layers)]


def layer_kinds(cfg: ModelConfig) -> list[str]:
    """The kind of each layer, by global layer index."""
    return [kind for kind, n in layer_plan(cfg) for _ in range(n)]


def param_shapes(cfg: ModelConfig) -> dict:
    """name -> ((shape), initializer), with ``layers`` a list."""
    check_family(cfg)
    d = cfg.d_model

    def block(kind):
        out = {
            "attn_norm": ((d,), "ones"),
            "mlp_norm": ((d,), "ones"),
            "attn": attn_lib.attn_param_shapes(cfg),
        }
        if kind == "moe":
            out["moe"] = moe_param_shapes(cfg)
        else:
            out["mlp"] = mlp_param_shapes(cfg)
        return out

    return {
        "embed": ((L.padded_vocab(cfg.vocab_size), d), "embed"),
        "final_norm": ((d,), "ones"),
        "layers": [block(kind) for kind in layer_kinds(cfg)],
    }


def init(cfg: ModelConfig, *, seed: int = 0, device=None) -> dict:
    """Random weights at the JAX package's scales, from a seeded
    ``torch.Generator`` on the target device."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def build(tree):
        if isinstance(tree, list):
            return [build(t) for t in tree]
        if isinstance(tree, dict):
            return {k: build(v) for k, v in tree.items()}
        shape, kind = tree
        return L.init_leaf(shape, kind, cfg.dtype, generator=gen,
                           device=dev)

    return build(param_shapes(cfg))


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int) -> list:
    check_family(cfg)
    return [attn_lib.kv_cache_shapes(cfg, batch, max_len)
            for _ in range(cfg.num_layers)]


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device=None) -> list:
    dev = resolve_device(device)
    return [{name: torch.zeros(shape, dtype=dt, device=dev)
             for name, (shape, dt) in layer.items()}
            for layer in cache_shapes(cfg, batch, max_len)]


def _run_stack(params, cfg, x, positions, *, table, caches=None,
               cache_pos=None, block_tables=None):
    for i, p in enumerate(params["layers"]):
        with kops.layer_scope(i):
            h = L.rms_norm(x, p["attn_norm"], cfg.norm_eps)
            a, _ = attn_lib.attention(
                p["attn"], cfg, h, positions,
                cache=caches[i] if caches is not None else None,
                cache_pos=cache_pos, block_tables=block_tables)
            x = x + a
            h = L.rms_norm(x, p["mlp_norm"], cfg.norm_eps)
            if "moe" in p:
                x = x + moe(p["moe"], cfg, h, table=table)
            else:
                x = x + mlp(p["mlp"], cfg, h, table=table)
    return x


def prefill(params, cfg: ModelConfig, batch: dict, cache: list, *,
            table=DEFAULT_TABLE, cache_pos=None, block_tables=None,
            all_logits: bool = False):
    """Write the chunk's KV starting at ``cache_pos`` (default 0; an int
    or a per-row ``(B,)`` tensor) and return the logits at its last
    position (B, 1, V) — or at every position with ``all_logits``.
    ``block_tables`` (B, nb) routes the writes through the paged pool."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = L.embed_lookup(params["embed"], tokens)
    if cache_pos is None:
        cache_pos = 0
    ar = torch.arange(s, device=tokens.device)
    if attn_lib.rowwise_pos(cache_pos):
        positions = cache_pos.to(tokens.device)[:, None] + ar[None, :]
    else:
        positions = (int(cache_pos) + ar)[None, :].expand(b, s)
    x = _run_stack(params, cfg, x, positions, table=table, caches=cache,
                   cache_pos=cache_pos, block_tables=block_tables)
    if not all_logits:
        x = x[:, -1:, :]
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(x, params["embed"]), cache


def decode_step(params, cfg: ModelConfig, tokens: Tensor, cache: list,
                pos, *, table=DEFAULT_TABLE, block_tables=None):
    """One token per row: tokens (B, 1); ``pos`` an int (whole batch at
    one length) or a per-row ``(B,)`` tensor. With ``block_tables`` the
    cache is the paged pool and decode attention runs in place on it."""
    b = tokens.shape[0]
    x = L.embed_lookup(params["embed"], tokens)
    if attn_lib.rowwise_pos(pos):
        positions = pos.to(tokens.device)[:, None]
    else:
        positions = torch.full((b, 1), int(pos), dtype=torch.int64,
                               device=tokens.device)
    x = _run_stack(params, cfg, x, positions, table=table, caches=cache,
                   cache_pos=pos, block_tables=block_tables)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(x, params["embed"]), cache
