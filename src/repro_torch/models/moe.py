"""Mixture-of-Experts, the host (single-device) path of
``repro.models.moe`` (deepseek-v3).

Token-choice routing with per-expert capacity, as in the JAX package:

  * the router (softmax + top-k, weights renormalized) is the flexible
    op; the expert MLPs are static primitives (plain products: the JAX
    package runs them as ``jnp.dot`` outside any Pallas kernel);
  * capacity: each expert takes the top ``cap`` tokens by the weight the
    tokens routed to it (``_capacity``), so a dropping
    ``capacity_factor`` drops the same tokens as the JAX package. Ties
    go to the lower token index, as ``jax.lax.top_k`` breaks them: the
    port selects through a stable descending sort;
  * the shared experts run dense on every token.

What differs from the literal JAX formulation, and why it gives the same
sum: the JAX pass multiplies every expert's output on all ``cap``
selected tokens by their weight, which is 0.0 for a selected token that
did not route to the expert; those products add nothing. Here only the
(expert, token) pairs with a nonzero selected weight are computed, and
experts that no such pair reaches are skipped. At decode (4 rows, so
``cap`` = 4) the literal form would run all 256 experts of deepseek-v3
on every token and read 22.5 GB a layer a step; this reads the experts
the tokens chose. Finding them takes one device-to-host copy of the
selection mask per MoE layer.

The routed sum accumulates in fp32 in a fixed order: expert by expert
in ascending id, with distinct token indices within an expert (no two
writes of one ``index_add_`` meet), so a token's result depends only on
its own row: paged == slab == solo stays bit-exact on the CPU, and the
card gives the same result run to run. The sum is rounded once to the
activation type before the shared experts are added (the JAX package
sums the experts' parts in that type).

Which experts the tokens chose is copied to the host once a call (the
experts run as host-indexed products), so a MoE model's steps cannot be
captured in a CUDA graph (``launch.graphs``; ROADMAP Queue 1 item 2).
Tensor parallelism (``tp.active()``) and the ``shard_map`` expert-
parallel branch of the JAX module are not ported (ROADMAP Queue 1 item
6).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.function_table import DEFAULT_TABLE, FunctionTable
from repro_torch.kernels.ref import dot, softmax

Tensor = torch.Tensor


def moe_param_shapes(cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    shapes = {
        "router": ((d, e), "normal"),
        "w_gate": ((e, d, f), "normal"),
        "w_up": ((e, d, f), "normal"),
        "w_down": ((e, f, d), "normal"),
    }
    if cfg.num_shared_experts:
        fs = cfg.moe_d_ff * cfg.num_shared_experts
        shapes["shared"] = {
            "w_gate": ((d, fs), "normal"),
            "w_up": ((d, fs), "normal"),
            "w_down": ((fs, d), "normal"),
        }
    return shapes


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    c = math.ceil(tokens * cfg.experts_per_token / cfg.num_experts
                  * cfg.capacity_factor)
    return min(tokens, max(8, (c + 7) // 8 * 8))


def _dot32(a: Tensor, b: Tensor) -> Tensor:
    """``jnp.dot(a, b, preferred_element_type=float32)``: bf16 operands
    on the card go through one GEMM with an fp32 output (no fp32 copy of
    the expert's weights); elsewhere ``ref.dot``."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return dot(a, b)


def _expert_mlp(x: Tensor, wg: Tensor, wu: Tensor, wd: Tensor,
                act) -> Tensor:
    """(C, D) tokens through one expert: fp32 gate and up, f on the
    gate, their product in x's type, fp32 down product, x's type out."""
    g = act(_dot32(x, wg))
    u = _dot32(x, wu)
    return _dot32((g * u).to(x.dtype), wd).to(x.dtype)


def _top(x: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """``jax.lax.top_k`` over the last dim: the k largest, descending,
    ties to the lower index (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(x: Tensor, router_w: Tensor, cfg: ModelConfig
           ) -> tuple[Tensor, Tensor]:
    """Router softmax + top-k: x (T, D) -> weights (T, k) fp32, renormalized
    over the k, and expert ids (T, k)."""
    probs = softmax(_dot32(x, router_w))
    weights, ids = _top(probs, cfg.experts_per_token)
    weights = weights / torch.clamp_min(weights.sum(-1, keepdim=True), 1e-9)
    return weights.float(), ids


def _local_expert_pass(x: Tensor, weights: Tensor, ids: Tensor,
                       w_gate: Tensor, w_up: Tensor, w_down: Tensor,
                       cfg: ModelConfig, act) -> Tensor:
    """Every expert over the T tokens, each on its top-``cap`` tokens by
    routed weight; returns the (T, D) routed sum, fp32."""
    t, e = x.shape[0], w_gate.shape[0]
    cap = _capacity(t, cfg)
    # score[e, t]: the weight token t routed to expert e, else 0 (a
    # token's k ids are distinct, so each entry gets at most one weight)
    score = torch.zeros((t, e), dtype=weights.dtype, device=x.device)
    score.scatter_(1, ids, weights)
    top_w, top_idx = _top(score.t(), cap)                      # (E, cap)
    keep = (top_w != 0).cpu().numpy()
    counts = keep.sum(1)
    flat = torch.as_tensor(np.flatnonzero(keep), device=x.device)
    tok = top_idx.reshape(-1)[flat]
    w = top_w.reshape(-1)[flat]
    acc = torch.zeros((t, x.shape[1]), dtype=torch.float32, device=x.device)
    start = 0
    for j in np.flatnonzero(counts):
        rows = tok[start:start + counts[j]]
        ye = _expert_mlp(x[rows], w_gate[j], w_up[j], w_down[j], act)
        ye = ye * w[start:start + counts[j], None].to(ye.dtype)
        acc.index_add_(0, rows, ye.float())
        start += counts[j]
    return acc


def moe(params: dict, cfg: ModelConfig, x: Tensor, *,
        table: FunctionTable = DEFAULT_TABLE) -> Tensor:
    """x (B, S, D) -> (B, S, D): routed experts plus the shared ones."""
    act = table.lookup(cfg.activation)
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    weights, ids = _route(x2, params["router"], cfg)
    y = _local_expert_pass(x2, weights, ids, params["w_gate"],
                           params["w_up"], params["w_down"], cfg,
                           act).to(x.dtype)
    if cfg.num_shared_experts:
        sh = params["shared"]
        y = y + _expert_mlp(x2, sh["w_gate"], sh["w_up"], sh["w_down"], act)
    return y.reshape(b, s, d)
