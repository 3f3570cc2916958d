"""MLP blocks (mirror of ``repro.models.mlp``):

  * gated (the llama family, deepseek-7b's SwiGLU):
    y = (f(x @ Wg) * (x @ Wu)) @ Wd;
  * plain (nemotron's squared ReLU): y = f(x @ W1) @ W2.

With ``cfg.use_pallas`` every call goes through the op of its kind:
``kops.sidebar_gated_mlp`` (the fused gated kernel under every plan) or
``kops.sidebar_mlp`` (the ambient plan's route for the layer: the serial
or ring Sidebar kernel, or the FLEXIBLE_DMA three launches), on a CUDA
tensor at any row count — the TPU's rows % 8 rule is a TPU tile rule —
and the plain version on a CPU tensor. Without it the block is
``linear``s around the activation, as in the JAX package's non-kernel
branch.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.function_table import DEFAULT_TABLE, FunctionTable
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import MeshInfo, _maybe, linear
from repro_torch.parallel import tp


def mlp_param_shapes(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    shapes = {"w_up": ((d, f), "normal"), "w_down": ((f, d), "normal")}
    if cfg.gated_mlp:
        shapes["w_gate"] = ((d, f), "normal")
    return shapes


def mlp_param_specs(cfg: ModelConfig, m: MeshInfo) -> dict:
    """The description (``attention.gqa_param_specs``): the up / gate
    products column-parallel over d_ff, the down one row-parallel, each
    FSDP-sharded over d."""
    fsdp = tuple(m.fsdp) or None
    specs = {"w_up": _maybe(m, fsdp, "model"),
             "w_down": _maybe(m, "model", fsdp)}
    if cfg.gated_mlp:
        specs["w_gate"] = _maybe(m, fsdp, "model")
    return specs


def mlp(params: dict, cfg: ModelConfig, x: torch.Tensor, *,
        table: FunctionTable = DEFAULT_TABLE,
        activation: str | None = None) -> torch.Tensor:
    """x (..., D) -> (..., D)."""
    act_name = activation or cfg.activation
    d = x.shape[-1]
    x = tp.copy_to_model(x)      # replicated x into the d_ff-sharded products
    if cfg.use_pallas and x.ndim >= 2:
        x2 = x.reshape(math.prod(x.shape[:-1]), d).contiguous()
        if cfg.gated_mlp:
            y = kops.sidebar_gated_mlp(x2, params["w_gate"], params["w_up"],
                                       params["w_down"], act_name,
                                       table=table)
        else:
            y = kops.sidebar_mlp(x2, params["w_up"], params["w_down"],
                                 act_name, table=table)
        return tp.psum_partial(y.reshape(x.shape))
    act = table.lookup(act_name)
    if cfg.gated_mlp:
        g = act(linear(x, params["w_gate"]))
        u = linear(x, params["w_up"])
        return tp.psum_partial(
            linear((g * u).to(x.dtype), params["w_down"]))
    h = act(linear(x, params["w_up"]))
    return tp.psum_partial(linear(h.to(x.dtype), params["w_down"]))
