"""Decoder-only transformer LM (mirror of ``repro.models.transformer``):
GQA or MLA attention, then a dense MLP or a MoE block, by the layer plan
(``first_dense_layers`` dense blocks, then MoE blocks, for a config with
experts; for the VLM, ``num_layers // cross_attn_every`` groups of
``cross_attn_every - 1`` dense blocks and one gated cross block).

Model API (see ``registry.py``):

  param_shapes(cfg)                           -> shape/initializer tree
  init(cfg, *, seed, device)                  -> params
  cache_shapes(cfg, batch, max_len)           -> per-layer cache shapes
  init_cache(cfg, batch, max_len, *, device)  -> per-layer cache dicts
  prefill(params, cfg, batch, cache, ...)     -> (logits, cache)
  decode_step(params, cfg, tokens, cache, pos, ...) -> (logits, cache)
  forward(params, cfg, batch)                 -> logits (training)
  loss(params, cfg, batch)                    -> mean token NLL

Layout: ``params["layers"]`` and the cache are LISTS of per-layer dicts
in layer order (the JAX package stacks each kind of layer on a leading
L axis for its scan, ``blocks["dense"]`` then ``blocks["moe"]``, and
the VLM's groups as ``blocks["vlm_group"]`` {"self" [G][n_self],
"cross" [G]}; ``repro_torch.bridge`` converts). A dense layer's dict
holds ``mlp``, a MoE layer's ``moe``; a cross layer's also holds
``xattn``, ``xattn_norm`` and the fp32 (1,) gates ``xattn_gate`` and
``xmlp_gate``. Every layer runs under ``kops.layer_scope(i)``, so a
layer-indexed ``ExecutionPlan`` resolves per layer (the Server takes one
for dense and MoE only, as the JAX package's, whose VLM groups always
scan). Cache updates are in place.

Image memory (the VLM): ``forward`` and ``prefill`` read
``batch.get("image_embeds")`` (B, T_img, D), ``decode_step`` takes it as
``memory``. With it, a cross layer adds tanh(xattn_gate) x the
cross-attention to that memory after its self-attention and scales its
MLP by tanh(xmlp_gate) (both gates cast to x's type); without it the
layer is a plain dense block, as in the JAX package.

Rematerialisation (``cfg.remat``, the JAX package's ``_remat`` per
layer): when gradients are on and no cache is carried, "full" wraps
each layer in ``torch.utils.checkpoint`` (its activations recomputed in
the backward) and "dots" saves the outputs of the layer's un-batched
matrix products (``aten.mm``; the JAX policy
``checkpoint_dots_with_no_batch_dims``) and recomputes the rest. The
recompute enters the same ``layer_scope``, so a layer-indexed plan
resolves alike on both passes.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.function_table import DEFAULT_TABLE
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models.mlp import mlp, mlp_param_pspecs, mlp_param_shapes
from repro_torch.models.moe import moe, moe_param_pspecs, moe_param_shapes
from repro_torch.parallel import tp

Tensor = torch.Tensor


FAMILIES = ("dense", "moe", "vlm")


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} has its own stack "
            f"(``registry.get_model``); the transformer serves "
            f"{', '.join(FAMILIES)}")


def layer_plan(cfg: ModelConfig) -> list[tuple[str, int]]:
    """[(kind, count)] in layer order (``_layer_plan`` of the JAX
    package): the VLM's ``vlm_group``s; with experts,
    ``first_dense_layers`` dense blocks, then MoE blocks."""
    if cfg.family == "vlm" and cfg.cross_attn_every:
        return [("vlm_group", cfg.num_layers // cfg.cross_attn_every)]
    if cfg.num_experts:
        plan = []
        if cfg.first_dense_layers:
            plan.append(("dense", cfg.first_dense_layers))
        plan.append(("moe", cfg.num_layers - cfg.first_dense_layers))
        return plan
    return [("dense", cfg.num_layers)]


def layer_kinds(cfg: ModelConfig) -> list[str]:
    """The kind of each layer, by global layer index (a VLM group: its
    dense layers, then "cross")."""
    kinds = []
    for kind, n in layer_plan(cfg):
        if kind == "vlm_group":
            kinds += (["dense"] * (cfg.cross_attn_every - 1)
                      + ["cross"]) * n
        else:
            kinds += [kind] * n
    return kinds


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
        if kind == "cross":
            # gated cross-attention (llama-3.2-vision style: tanh gates)
            out["xattn"] = attn_lib.gqa_param_shapes(cfg)
            out["xattn_norm"] = ((d,), "ones")
            out["xattn_gate"] = ((1,), "zeros", torch.float32)
            out["xmlp_gate"] = ((1,), "zeros", torch.float32)
        return out

    return {
        "embed": ((L.padded_vocab(cfg.vocab_size), d), "embed"),
        "final_norm": ((d,), "ones"),
        "layers": [block(kind) for kind in layer_kinds(cfg)],
    }


def param_pspecs(cfg: ModelConfig) -> dict:
    """The sharding description of ``param_shapes``, leaf for leaf: the
    model-only partition of each tensor (the vocab-row-sharded embedding,
    column / row-parallel attention and MLPs, experts over "model";
    norms and gates replicated)."""
    check_family(cfg)

    def block(kind):
        out = {"attn_norm": (), "mlp_norm": (),
               "attn": attn_lib.attn_param_pspecs(cfg)}
        if kind == "moe":
            out["moe"] = moe_param_pspecs(cfg)
        else:
            out["mlp"] = mlp_param_pspecs(cfg)
        if kind == "cross":
            out["xattn"] = attn_lib.gqa_param_pspecs(cfg)
            out.update(xattn_norm=(), xattn_gate=(), xmlp_gate=())
        return out

    return {"embed": ("model",), "final_norm": (),
            "layers": [block(kind) for kind in layer_kinds(cfg)]}


def cache_pspecs(cfg: ModelConfig) -> list:
    """The sharding description of a cache (slab or pool), per layer."""
    check_family(cfg)
    return [attn_lib.kv_cache_pspecs(cfg) for _ in layer_kinds(cfg)]


def init(cfg: ModelConfig, *, seed: int = 0, device=None) -> dict:
    """Random weights at the JAX package's scales, from a seeded
    ``torch.Generator`` on the target device."""
    return L.materialize(param_shapes(cfg), cfg.dtype, seed=seed,
                         device=resolve_device(device))


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int) -> list:
    check_family(cfg)
    return [attn_lib.kv_cache_shapes(cfg, batch, max_len)
            for _ in layer_kinds(cfg)]


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device=None) -> list:
    return L.zeros(cache_shapes(cfg, batch, max_len), resolve_device(device))


def _block(i, p, cfg, x, positions, *, table, cache, cache_pos,
           block_tables, memory=None):
    """Decoder layer ``i``, under its ``layer_scope``."""
    with kops.layer_scope(i):
        h = L.rms_norm(x, p["attn_norm"], cfg.norm_eps)
        a, _ = attn_lib.attention(p["attn"], cfg, h, positions, cache=cache,
                                  cache_pos=cache_pos,
                                  block_tables=block_tables)
        x = x + a
        cross = memory is not None and "xattn" in p
        if cross:
            h = L.rms_norm(x, p["xattn_norm"], cfg.norm_eps)
            xa, _ = attn_lib.gqa_attention(p["xattn"], cfg, h, positions,
                                           causal=False, memory=memory)
            x = x + torch.tanh(p["xattn_gate"]).to(x.dtype) * xa
        h = L.rms_norm(x, p["mlp_norm"], cfg.norm_eps)
        if "moe" in p:
            return x + moe(p["moe"], cfg, h, table=table)
        y = mlp(p["mlp"], cfg, h, table=table)
        if cross:
            y = torch.tanh(p["xmlp_gate"]).to(x.dtype) * y
        return x + y


def _run_stack(params, cfg, x, positions, *, table, caches=None,
               cache_pos=None, block_tables=None, memory=None):
    remat = L.remat_kwargs(cfg) if caches is None else None
    for i, p in enumerate(params["layers"]):
        kw = dict(table=table,
                  cache=caches[i] if caches is not None else None,
                  cache_pos=cache_pos, block_tables=block_tables,
                  memory=memory)
        if remat is None:
            x = _block(i, p, cfg, x, positions, **kw)
        else:
            x = checkpoint(functools.partial(_block, i, **kw), p, cfg, x,
                           positions, **remat)
    return x


def forward(params, cfg: ModelConfig, batch: dict, *,
            table=DEFAULT_TABLE) -> Tensor:
    """Training forward (no cache): batch {"tokens": (B, S) [,
    "image_embeds"]} -> fp32 logits (B, S, V_pad). With ``cfg.use_pallas`` and S a multiple of
    128 the attention goes through the flash kernel and the MLP through
    its Sidebar kernel; neither has a backward, so on the card that
    forward runs under ``torch.no_grad()`` (the kernels raise
    otherwise)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = L.embed_lookup(params["embed"], tokens,
                       sharded=tp.active() is not None)
    positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
    x = _run_stack(params, cfg, x, positions, table=table,
                   memory=batch.get("image_embeds"))
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(x, params["embed"])


def next_token_loss(cfg: ModelConfig, logits: Tensor,
                    labels: Tensor) -> Tensor:
    """Mean NLL of logits (B, S, V_pad) at positions 0..S-2 against
    ``labels`` at 1..S-1 (padded vocab masked)."""
    return L.softmax_cross_entropy(
        logits[:, :-1, :].reshape(-1, logits.shape[-1]),
        labels[:, 1:].reshape(-1), vocab=cfg.vocab_size)


def loss(params, cfg: ModelConfig, batch: dict, *,
         table=DEFAULT_TABLE) -> Tensor:
    """Mean next-token NLL of ``forward``'s logits against
    ``batch["labels"]``."""
    return next_token_loss(cfg, forward(params, cfg, batch, table=table),
                           batch["labels"])


def prefill(params, cfg: ModelConfig, batch: dict, cache: list, *,
            table=DEFAULT_TABLE, cache_pos=None, block_tables=None,
            all_logits: bool = False):
    """Write the chunk's KV starting at ``cache_pos`` (default 0; an int
    or a per-row ``(B,)`` tensor) and return the logits at its last
    position (B, 1, V) — or at every position with ``all_logits``.
    ``block_tables`` (B, nb) routes the writes through the paged pool."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = L.embed_lookup(params["embed"], tokens,
                       sharded=tp.active() is not None)
    if cache_pos is None:
        cache_pos = 0
    ar = torch.arange(s, device=tokens.device)
    if attn_lib.rowwise_pos(cache_pos):
        positions = cache_pos.to(tokens.device)[:, None] + ar[None, :]
    else:
        positions = (int(cache_pos) + ar)[None, :].expand(b, s)
    x = _run_stack(params, cfg, x, positions, table=table, caches=cache,
                   cache_pos=cache_pos, block_tables=block_tables,
                   memory=batch.get("image_embeds"))
    if not all_logits:
        x = x[:, -1:, :]
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(x, params["embed"]), cache


def decode_step(params, cfg: ModelConfig, tokens: Tensor, cache: list,
                pos, *, table=DEFAULT_TABLE, block_tables=None,
                memory: Tensor | None = None):
    """One token per row: tokens (B, 1); ``pos`` an int (whole batch at
    one length) or a per-row ``(B,)`` tensor. With ``block_tables`` the
    cache is the paged pool and decode attention runs in place on it.
    ``memory`` is the VLM's image embeddings (B, T_img, D)."""
    b = tokens.shape[0]
    x = L.embed_lookup(params["embed"], tokens,
                       sharded=tp.active() is not None)
    if attn_lib.rowwise_pos(pos):
        positions = pos.to(tokens.device)[:, None]
    else:
        positions = torch.full((b, 1), int(pos), dtype=torch.int64,
                               device=tokens.device)
    x = _run_stack(params, cfg, x, positions, table=table, caches=cache,
                   cache_pos=pos, block_tables=block_tables, memory=memory)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(x, params["embed"]), cache
