"""Shapes and placements of every model input (mirror of
``repro.launch.input_specs``).

``input_specs(cfg, cell)`` — the data batch of one step at the cell's
global shape, as ``(shape, dtype)`` leaves (the JAX package's
``ShapeDtypeStruct`` stand-ins). ``batch_shardings(...)`` — the matching
description: the batch dim over the mesh's batch axes, sanitized
(``data.pipeline.shard_batch`` cuts a rank's rows by it).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.models.layers import MeshInfo, sanitize_pspec


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    b, s = cell.global_batch, cell.seq_len
    specs = {"tokens": ((b, 1 if cell.kind == "decode" else s),
                        torch.int32)}
    if cell.kind == "train":
        specs["labels"] = ((b, s), torch.int32)
    if cfg.family == "audio":
        specs["frames"] = ((b, cfg.encoder_seq, cfg.d_model), cfg.dtype)
    if cfg.family == "vlm":
        specs["image_embeds"] = ((b, cfg.num_image_tokens, cfg.d_model),
                                 cfg.dtype)
    return specs


def batch_pspec(minfo: MeshInfo, ndim: int) -> tuple:
    """The batch dim over the batch axes, the rest replicated."""
    return (tuple(minfo.batch_axes) or None,) + (None,) * (ndim - 1)


def batch_shardings(cfg: ModelConfig, cell: ShapeCell, mesh,
                    minfo: MeshInfo) -> dict:
    return {k: sanitize_pspec(mesh, batch_pspec(minfo, len(shape)), shape)
            for k, (shape, _) in input_specs(cfg, cell).items()}
