"""Mixture-of-Experts, the host (single-device) path of
``repro.models.moe`` (deepseek-v3, llama4-scout).

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

How the pass runs (``_local_expert_pass``), with every shape fixed by the
token count T and the config, so nothing is read on the host and a CUDA
graph can hold the layer. Two forms, one sum:

  * the plain form (``cfg.use_pallas`` off: the config default, and the
    differentiable one) is the JAX package's own: each expert gathers
    its top-``cap`` tokens, the three products run as one batched
    product each over all E experts (a token an expert selected but
    that did not route to it has weight 0.0 and adds nothing), and each
    expert's part is added in ascending expert id. It reads every
    expert's weights and does E·cap rows of work (about 1.25·T·k at
    training sizes);
  * the kernel form (``cfg.use_pallas``) takes the T·k routed (token,
    expert) pairs, marks them kept or dropped by capacity, sorts them
    stably by expert id (dropped pairs last), and runs the three
    products as grouped products over those groups
    (``kernels.moe_experts.grouped_mm``, the hand-written kernel on the
    card). A group reads its own expert's weights, so an expert no token
    chose is never read: at decode (4 rows, so ``cap`` = 4) the plain
    form runs all 256 experts of deepseek-v3 on every token and reads
    22.5 GB a layer a step; the kernel reads the at most 32 experts the
    tokens chose. It refuses autograd on the card.

Rounding points are the JAX package's: fp32 gate and up products, f on
the gate, their product in x's type, an fp32 down product, x's type
out, times the routed weight in x's type. In both forms each token's k
contributions then add in fp32 in ascending expert id, starting from
zero (a dropped pair adds nothing), so a token's result depends only on
its own row and the two forms agree bit for bit on the CPU:
paged == slab == solo stays bit-exact on the CPU, and the card gives
the same result run to run. The sum is rounded once to the activation
type before the shared experts are added (the JAX package sums the
experts' parts in that type).

Tensor-parallel serving (``tp.active()``, the JAX module's branch of
the same name): the router stays replicated, so routing and capacity
are decided over GLOBAL expert ids; the expert stacks hold the rank's
E_local experts, run at its offset (``tp.shard_offset(E_local)``): a
pair of another rank's expert is not kept here. The shared experts'
column / row slices add their own partial, and ONE reduction over the
model axis reassembles the layer's output.

Training on a mesh (the JAX module's ``shard_map`` dispatch,
``cfg.moe_dispatch == "shard_map"``, the default): the layer's experts
arrive gathered over fsdp by the stack's ZeRO-3 gather (at model size 1
too), each rank routes its DATA-LOCAL tokens and runs its E_local
experts at its offset, and the partial is summed over "model". Capacity
comes from the data-local token count, as inside the JAX module's
``shard_map``: with data > 1 and a dropping capacity the drops differ
from a one-device run's, as the reference's do. The routing weights and
x enter the local pass through ``tp.copy_to_model`` (the router is
replicated over "model"; the pass is not). ``moe_dispatch == "dense"``
is the host rule over the GLOBAL tokens (GSPMD's partition of it in the
JAX package): the rank gathers every data shard's tokens, routes and
runs the pass over all of them, and keeps its own rows.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.function_table import DEFAULT_TABLE, FunctionTable
from repro_torch.kernels.moe_experts import grouped_mm
from repro_torch.kernels.ref import dot, softmax
from repro_torch.models.layers import MeshInfo, _maybe
from repro_torch.parallel import tp

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


def moe_param_specs(cfg: ModelConfig, m: MeshInfo) -> dict:
    """The description (``attention.gqa_param_specs``): the router
    replicated over "model", the expert stacks over experts (EP) and
    FSDP over d, the shared experts as a column / row-parallel MLP."""
    fsdp = tuple(m.fsdp) or None
    specs = {"router": _maybe(m, fsdp, None),
             "w_gate": _maybe(m, "model", fsdp, None),
             "w_up": _maybe(m, "model", fsdp, None),
             "w_down": _maybe(m, "model", None, fsdp)}
    if cfg.num_shared_experts:
        specs["shared"] = {"w_gate": _maybe(m, fsdp, "model"),
                           "w_up": _maybe(m, fsdp, "model"),
                           "w_down": _maybe(m, "model", fsdp)}
    return specs


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    c = math.ceil(tokens * cfg.experts_per_token / cfg.num_experts
                  * cfg.capacity_factor)
    return min(tokens, max(8, (c + 7) // 8 * 8))


class _Dot32(torch.autograd.Function):
    """a (..., M, K) @ b (..., K, N), bf16, with an fp32 output in one
    GEMM (``torch.mm``/``torch.bmm`` with ``out_dtype``, which have no
    gradient of their own), and its gradient: the fp32 cotangent rounded
    to the operands' type, then the two products of the backward in that
    type (fp32 accumulation inside). No fp32 copy of a weight is made on
    either pass."""

    @staticmethod
    def forward(ctx, a: Tensor, b: Tensor) -> Tensor:
        ctx.save_for_backward(a, b)
        mm = torch.bmm if a.ndim == 3 else torch.mm
        return mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g: Tensor):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = g @ b.transpose(-1, -2) if ctx.needs_input_grad[0] else None
        gb = a.transpose(-1, -2) @ g if ctx.needs_input_grad[1] else None
        return ga, gb


def _dot32(a: Tensor, b: Tensor) -> Tensor:
    """``jnp.dot(a, b, preferred_element_type=float32)`` for 2-D or
    batched 3-D operands: bf16 operands on the card go through one GEMM
    with an fp32 output (``_Dot32``); elsewhere ``ref.dot``."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        return _Dot32.apply(a, b)
    return dot(a, b)


def _expert_mlp(x: Tensor, wg: Tensor, wu: Tensor, wd: Tensor,
                act) -> Tensor:
    """(C, D) tokens through one expert, or (E, C, D) through E at once
    (w (E, D, F)): fp32 gate and up, f on the gate, their product in x's
    type, fp32 down product, x's type out."""
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


def _pairs(weights: Tensor, ids: Tensor, cap: int, e: int,
           e_offset: int = 0, e_local: int | None = None
           ) -> tuple[Tensor, Tensor, Tensor]:
    """The T·k routed (token, expert) pairs, flattened token-major, and
    which of them an expert keeps: a pair is kept when its token ranks
    below ``cap`` in the expert's descending stable order of routed
    weight (``_top``: ties to the lower token), its weight is not 0 and
    its expert is one of the ``e_local`` local experts from
    ``e_offset`` (default: all E). Returns (order, offsets, kept):
    ``order`` (T·k,) the pairs sorted stably by local expert id,
    dropped pairs last; ``offsets`` (E_local + 1,) int32 the local
    expert groups in that order; ``kept`` (T, k)."""
    t, k = ids.shape
    e_local = e if e_local is None else e_local
    # score[t, e]: the weight token t routed to expert e, else 0 (a
    # token's k ids are distinct, so each entry gets at most one weight)
    score = torch.zeros((t, e), dtype=weights.dtype, device=ids.device)
    score.scatter_(1, ids, weights)
    _, by_weight = torch.sort(score.t(), dim=-1, descending=True,
                              stable=True)                    # (E, T)
    rank = torch.empty_like(by_weight)
    rank.scatter_(1, by_weight, torch.arange(
        t, device=ids.device).expand(e, t).contiguous())
    local = ids - e_offset
    kept = ((torch.gather(rank.t(), 1, ids) < cap) & (weights != 0)
            & (local >= 0) & (local < e_local))
    key = torch.where(kept, local,
                      torch.full_like(ids, e_local)).reshape(-1)
    order = torch.sort(key, stable=True).indices
    counts = torch.zeros((e_local + 1,), dtype=torch.int32,
                         device=ids.device)
    counts.scatter_add_(0, key, torch.ones_like(key, dtype=torch.int32))
    offsets = torch.cat([counts.new_zeros(1),
                         torch.cumsum(counts[:e_local], 0,
                                      dtype=torch.int32)])
    return order, offsets, kept


def _local_expert_pass(x: Tensor, weights: Tensor, ids: Tensor,
                       w_gate: Tensor, w_up: Tensor, w_down: Tensor,
                       cfg: ModelConfig, act, e_offset: int = 0) -> Tensor:
    """The E_local experts of the stacks (global ids from ``e_offset``)
    over the T tokens, each on its top-``cap`` tokens by routed weight;
    returns the (T, D) routed sum of those experts, fp32. Every shape
    depends on T and the config alone: no host read. The kernel form
    with ``cfg.use_pallas``, else the plain one (module docstring)."""
    pass_ = _grouped_pass if cfg.use_pallas else _plain_pass
    return pass_(x, weights, ids, w_gate, w_up, w_down,
                 _capacity(x.shape[0], cfg), act, e_offset, cfg.num_experts)


def _plain_pass(x: Tensor, weights: Tensor, ids: Tensor, w_gate: Tensor,
                w_up: Tensor, w_down: Tensor, cap: int, act,
                e_offset: int, e: int) -> Tensor:
    """The JAX package's form: each expert's top-``cap`` tokens through
    one batched product a weight, each expert's part added in ascending
    id (an expert's ``cap`` token indices are distinct)."""
    t, e_local = x.shape[0], w_gate.shape[0]
    # score[t, e]: the weight token t routed to expert e, else 0 (a
    # token's k ids are distinct, so each entry gets at most one weight)
    score = torch.zeros((t, e), dtype=weights.dtype, device=x.device)
    score.scatter_(1, ids, weights)
    score = score[:, e_offset:e_offset + e_local]
    top_w, top_idx = _top(score.t(), cap)               # (E_local, cap)
    ye = _expert_mlp(x[top_idx], w_gate, w_up, w_down, act)  # (E, cap, D)
    ye = (ye * top_w[..., None].to(ye.dtype)).float()
    acc = torch.zeros((t, x.shape[1]), dtype=torch.float32, device=x.device)
    for j in range(e_local):
        acc.index_add_(0, top_idx[j], ye[j])
    return acc


def _grouped_pass(x: Tensor, weights: Tensor, ids: Tensor, w_gate: Tensor,
                  w_up: Tensor, w_down: Tensor, cap: int, act,
                  e_offset: int, e: int) -> Tensor:
    """The kernel form: the kept pairs of the local experts grouped by
    expert through ``grouped_mm``, each token's pairs gathered back in
    ascending expert id."""
    t, k = ids.shape
    order, offsets, kept = _pairs(weights, ids, cap, e, e_offset,
                                  w_gate.shape[0])
    xs = x.index_select(0, order // k)                        # (T·k, D)
    g = act(grouped_mm(xs, w_gate, offsets))
    u = grouped_mm(xs, w_up, offsets)
    ys = grouped_mm((g * u).to(x.dtype), w_down, offsets).to(x.dtype)
    ys = ys * weights.reshape(-1).index_select(0, order)[:, None].to(
        ys.dtype)
    # each token's pairs back in ascending expert id, summed from zero
    where = torch.empty_like(order)
    where.scatter_(0, order, torch.arange(order.numel(), device=x.device))
    _, j = torch.sort(ids, dim=-1)
    slot = torch.gather(where.view(t, k), 1, j)                  # (T, k)
    keep = torch.gather(kept, 1, j)
    acc = torch.zeros((t, x.shape[1]), dtype=torch.float32, device=x.device)
    for m in range(k):
        y_m = ys.index_select(0, slot[:, m]).float()
        acc = acc + torch.where(keep[:, m:m + 1], y_m, 0.0)
    return acc


def moe(params: dict, cfg: ModelConfig, x: Tensor, *,
        table: FunctionTable = DEFAULT_TABLE) -> Tensor:
    """x (B, S, D) -> (B, S, D): routed experts plus the shared ones."""
    act = table.lookup(cfg.activation)
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    xm = tp.copy_to_model(x2)
    # "dense" on a mesh: every data shard's tokens (identity elsewhere)
    dense = cfg.moe_dispatch == "dense"
    xt = tp.gather_rows(x2) if dense else x2
    weights, ids = _route(xt, params["router"], cfg)
    # under TP: the rank's experts at its offset, a partial sum
    y = _local_expert_pass(tp.copy_to_model(xt) if dense else xm,
                           tp.copy_to_model(weights), ids, params["w_gate"],
                           params["w_up"], params["w_down"], cfg, act,
                           tp.shard_offset(params["w_gate"].shape[0]))
    if dense:
        y = tp.fsdp_rows(y)
    y = y.to(x.dtype)
    if cfg.num_shared_experts:
        sh = params["shared"]
        y = y + _expert_mlp(xm, sh["w_gate"], sh["w_up"], sh["w_down"], act)
    return tp.psum_partial(y).reshape(b, s, d)
