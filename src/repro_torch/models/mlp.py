"""MLP block (mirror of ``repro.models.mlp``), plain branch:
y = f(x @ W1) @ W2 (nemotron's squared ReLU).

With ``cfg.use_pallas`` every call goes through ``kops.sidebar_mlp``:
the ambient plan's route for the layer (the serial or ring Sidebar
kernel, or the FLEXIBLE_DMA three launches) on a CUDA tensor, at any row
count — the TPU's rows % 8 rule is a TPU tile rule — and the plain
version on a CPU tensor.
Without it the block is two ``linear``s around the activation, as in
the JAX package's non-kernel branch.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.function_table import DEFAULT_TABLE, FunctionTable
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import linear


def _require_plain(cfg: ModelConfig) -> None:
    if cfg.gated_mlp:
        raise NotImplementedError(
            "the gated MLP needs sidebar_gated_mlp, not ported yet "
            "(ROADMAP Queue 2 item 2)")


def mlp_param_shapes(cfg: ModelConfig) -> dict:
    _require_plain(cfg)
    d, f = cfg.d_model, cfg.d_ff
    return {"w_up": ((d, f), "normal"), "w_down": ((f, d), "normal")}


def mlp(params: dict, cfg: ModelConfig, x: torch.Tensor, *,
        table: FunctionTable = DEFAULT_TABLE,
        activation: str | None = None) -> torch.Tensor:
    """x (..., D) -> (..., D)."""
    _require_plain(cfg)
    act_name = activation or cfg.activation
    d = x.shape[-1]
    if cfg.use_pallas and x.ndim >= 2:
        rows = math.prod(x.shape[:-1])
        y = kops.sidebar_mlp(x.reshape(rows, d).contiguous(),
                             params["w_up"], params["w_down"], act_name,
                             table=table)
        return y.reshape(x.shape)
    h = table.lookup(act_name)(linear(x, params["w_up"]))
    return linear(h.to(x.dtype), params["w_down"])
