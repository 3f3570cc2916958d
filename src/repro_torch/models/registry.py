"""Model registry: family -> model API (mirror of
``repro.models.registry``): the transformer for dense, moe and vlm,
RWKV6 for ssm, the Mamba2 hybrid for hybrid, whisper for audio. Serving
(``prefill``, ``decode_step``) and training (``forward``, ``loss``)."""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import rwkv_model, transformer, whisper, zamba


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
    # decode_step takes a per-row (B,) position vector (the schedulers'
    # batched segments over unaligned slots need it); the recurrent
    # stacks carry one state a row and the audio decoder takes the
    # batch's one position
    rowwise_decode_pos: bool = False
    # the sharding descriptions of the params and of a cache
    # (``transformer.param_pspecs`` / ``cache_pspecs``): None for the
    # families whose tensor-parallel serving is not ported
    param_pspecs: Callable | None = None
    cache_pspecs: Callable | None = None


def _api(mod, *, rowwise_decode_pos: bool = False) -> ModelApi:
    return ModelApi(
        param_shapes=mod.param_shapes,
        init=mod.init,
        cache_shapes=mod.cache_shapes,
        init_cache=mod.init_cache,
        prefill=mod.prefill,
        decode_step=mod.decode_step,
        forward=mod.forward,
        loss=mod.loss,
        rowwise_decode_pos=rowwise_decode_pos,
        param_pspecs=getattr(mod, "param_pspecs", None),
        cache_pspecs=getattr(mod, "cache_pspecs", None),
    )


def get_model(cfg: ModelConfig) -> ModelApi:
    if cfg.family == "hybrid":
        return _api(zamba)
    if cfg.family == "ssm":
        return _api(rwkv_model)
    if cfg.family == "audio":
        return _api(whisper)
    transformer.check_family(cfg)
    return _api(transformer, rowwise_decode_pos=True)
