"""Model registry: family -> model API (mirror of
``repro.models.registry``, for the ported families: dense and moe, both
the transformer): serving (``prefill``, ``decode_step``) and training
(``forward``, ``loss``)."""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class ModelApi:
    param_shapes: Callable
    init: Callable
    cache_shapes: Callable
    init_cache: Callable
    prefill: Callable
    decode_step: Callable
    forward: Callable
    loss: Callable
    # decode_step takes a per-row (B,) position vector
    rowwise_decode_pos: bool = False


def get_model(cfg: ModelConfig) -> ModelApi:
    transformer.check_family(cfg)
    return ModelApi(
        param_shapes=transformer.param_shapes,
        init=transformer.init,
        cache_shapes=transformer.cache_shapes,
        init_cache=transformer.init_cache,
        prefill=transformer.prefill,
        decode_step=transformer.decode_step,
        forward=transformer.forward,
        loss=transformer.loss,
        rowwise_decode_pos=True,
    )
