"""AdamW + schedule + clipping over trees of tensors (port of
``repro.optim.optimizer``).

fp32 update math whatever the parameter and moment types
(``moment_dtype``: bf16 moments halve optimizer memory for the largest
configs). Unlike the JAX package's pure functions, ``adamw_update``
updates the parameters and the moments IN PLACE and walks each leaf in
chunks of ``CHUNK`` elements: at nemotron-4-15b's width the embedding
alone is 1.57 B parameters, and the JAX formulation's whole-leaf fp32
temporaries (gradient, both moments, the update) would need ~30 GB
beside the 28 GB of parameters, gradients and moments. The arithmetic
is elementwise, so the chunks give the same numbers as whole leaves.

On a mesh (inside a training ``parallel.tp`` context) every tree holds
the rank's shards: the moments are sharded like their parameters
(``state_shardings``), the update runs on the shard, and
``global_norm`` covers the whole tree: each leaf's local sum of squares
is divided by the number of ranks holding the same shard (a leaf
replicated over an axis is counted once, not once a rank), and the sum
is all-reduced over the fsdp and "model" groups. Clipping and the
``grad_norm`` metric then equal the one-device values.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import tree
from repro_torch.configs.base import TrainConfig
from repro_torch.parallel import tp

Tensor = torch.Tensor

CHUNK = 1 << 24           # elements of one leaf updated at a time


class AdamState(NamedTuple):
    step: Tensor          # scalar int32
    mu: Any               # first moment tree
    nu: Any               # second moment tree


def init_state(params, tcfg: TrainConfig) -> AdamState:
    """Zero moments in ``tcfg.moment_dtype``, on each parameter's
    device; step 0 on the first parameter's."""
    first = tree.leaves(params)[0]

    def zeros(p):
        return torch.zeros(p.shape, dtype=tcfg.moment_dtype, device=p.device)

    return AdamState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        mu=tree.map_leaves(zeros, params),
        nu=tree.map_leaves(zeros, params))


def lr_schedule(tcfg: TrainConfig, step: Tensor) -> Tensor:
    """Linear warmup then inverse-sqrt decay (fp32)."""
    s = torch.as_tensor(step).float()
    warm = torch.clamp(s / max(tcfg.warmup_steps, 1), max=1.0)
    decay = torch.rsqrt(torch.clamp(s, min=float(tcfg.warmup_steps))
                        / float(tcfg.warmup_steps))
    return tcfg.learning_rate * warm * decay


def _chunks(t: Tensor) -> tuple[Tensor, ...]:
    return t.reshape(-1).split(CHUNK)


def state_shardings(param_shardings, mesh) -> AdamState:
    """The optimizer state's placement mirrors the parameters' (ZeRO):
    the step is replicated (None), each moment placed like its
    parameter."""
    return AdamState(step=None, mu=param_shardings, nu=param_shardings)


def _replicas(spec, ctx) -> int:
    """How many ranks of the mesh hold the same shard of a leaf."""
    n = 1 if tp.fsdp_dim(spec) is not None else ctx.fsdp_size
    return n if "model" in tuple(spec) else n * ctx.size


def global_norm(grads) -> Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares
    (of the whole leaf, on a mesh)."""
    ctx = tp.active()
    specs = None if ctx is None else ctx.specs
    reps = ([1] * len(tree.leaves(grads)) if specs is None else
            [_replicas(s, ctx) for s in tree.leaf_specs(grads, specs)])
    total = None
    for g, n in zip(tree.leaves(grads), reps):
        sq = sum(torch.sum(torch.square(c.float())) for c in _chunks(g))
        if n > 1:
            sq = sq / n
        total = sq if total is None else total + sq
    if specs is not None:
        total = tp.all_reduce(tp.all_reduce(total, "fsdp"), "model")
    return torch.sqrt(total)


def _clip_scale(norm: Tensor, max_norm: float) -> Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, in their
    own types; the norm before clipping)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree.map_leaves(
        lambda g: (g.float() * scale).to(g.dtype), grads), norm


def adamw_update(params, grads, state: AdamState, tcfg: TrainConfig):
    """One AdamW step with global-norm clipping, IN PLACE on ``params``
    and on ``state``'s moments. fp32 math; parameters and moments keep
    their types. Returns (params, AdamState, {"grad_norm", "lr"})."""
    gnorm = global_norm(grads)
    clip = _clip_scale(gnorm, tcfg.grad_clip)
    step = state.step + 1
    lr = lr_schedule(tcfg, step)
    sf = step.float()
    b1, b2, eps, wd = tcfg.beta1, tcfg.beta2, tcfg.eps, tcfg.weight_decay
    bc1 = 1.0 - torch.pow(torch.tensor(b1, device=sf.device), sf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, device=sf.device), sf)
    with torch.no_grad():
        for p, g, m, v in zip(tree.leaves(params), tree.leaves(grads),
                              tree.leaves(state.mu), tree.leaves(state.nu)):
            if not (p.is_contiguous() and m.is_contiguous()
                    and v.is_contiguous()):
                raise ValueError("adamw_update updates contiguous leaves "
                                 "in place")
            for pc, gc, mc, vc in zip(_chunks(p), _chunks(g), _chunks(m),
                                      _chunks(v)):
                # the clipped gradient rounds to its own type first
                gf = (gc.float() * clip).to(gc.dtype).float()
                mf = b1 * mc.float() + (1 - b1) * gf
                vf = b2 * vc.float() + (1 - b2) * gf * gf
                delta = (mf / bc1) / (torch.sqrt(vf / bc2) + eps) \
                    + wd * pc.float()
                pc.copy_(pc.float() - lr * delta)
                mc.copy_(mf)
                vc.copy_(vf)
    return params, AdamState(step, state.mu, state.nu), \
        {"grad_norm": gnorm, "lr": lr}
