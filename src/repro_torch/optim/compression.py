"""Gradient compression with error feedback (port of
``repro.optim.compression``), applied between gradient accumulation and
the optimizer:

  * ``none``    — the gradients as they are;
  * ``bf16``    — cast down to bf16 and back;
  * ``int8_ef`` — per-leaf int8 quantization with **error feedback**:
    the quantization residual is carried in ``EFState`` and added to the
    next step's gradient, so cumulative compressed updates track
    cumulative true gradients to O(1) error, not O(steps).

On a mesh (inside a training ``parallel.tp`` context) the gradients and
the residual are the rank's shards (the residual sharded like its
parameter), and ``int8_ef``'s scale is the WHOLE tensor's amax: the
local amax all-reduced (max) over the groups the leaf is sharded over,
so every shard quantizes exactly as the one-device leaf would.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import tree
from repro_torch.parallel import tp

Tensor = torch.Tensor

KINDS = ("none", "bf16", "int8_ef")


class EFState(NamedTuple):
    residual: Any  # error-feedback buffer: fp32, shaped like the grads


def init_ef(grads_like) -> EFState:
    return EFState(tree.map_leaves(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads_like))


def _amax(x: Tensor, spec) -> Tensor:
    """The amax of the whole leaf ``x`` is a shard of (``spec``: its
    description on a mesh, None elsewhere)."""
    amax = x.abs().max()
    if spec is not None:
        if tp.fsdp_dim(spec) is not None:
            amax = tp.all_reduce(amax, "fsdp", "max")
        if "model" in tuple(spec):
            amax = tp.all_reduce(amax, "model", "max")
    return amax


def _quantize_int8(x: Tensor, spec=None) -> tuple[Tensor, Tensor]:
    scale = torch.clamp(_amax(x, spec) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compress(grads, kind: str, ef: EFState | None = None):
    """Returns (decoded grads, new EFState): the decoded values are what
    a reduce would carry."""
    if kind == "none":
        return grads, ef
    if kind == "bf16":
        return tree.map_leaves(
            lambda g: g.to(torch.bfloat16).float().to(g.dtype), grads), ef
    if kind == "int8_ef":
        if ef is None:
            raise ValueError("int8_ef needs an EFState (init_ef)")
        ctx = tp.active()
        specs = (tree.leaf_specs(grads, ctx.specs)
                 if ctx is not None and ctx.specs is not None
                 else [None] * len(tree.leaves(grads)))
        outs = []
        for g, r, spec in zip(tree.leaves(grads), tree.leaves(ef.residual),
                              specs):
            gf = g.float() + r
            q, scale = _quantize_int8(gf, spec)
            dec = q.float() * scale
            outs.append((dec.to(g.dtype), gf - dec))
        return (tree.unflatten(grads, [o[0] for o in outs]),
                EFState(tree.unflatten(ef.residual, [o[1] for o in outs])))
    raise ValueError(f"unknown compression kind {kind!r}; one of {KINDS}")
