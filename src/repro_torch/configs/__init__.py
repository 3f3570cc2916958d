"""Config registry for the architectures the port serves."""

from __future__ import annotations

from repro_torch.configs import (deepseek_7b, deepseek_v3_671b,
                                 llama3_405b, llama4_scout_17b,
                                 llama32_vision_90b, nemotron_4_15b,
                                 qwen3_14b, rwkv6_7b, whisper_medium,
                                 zamba2_7b)
from repro_torch.configs.base import ModelConfig

_MODULES = {
    "nemotron-4-15b": nemotron_4_15b,
    "deepseek-7b": deepseek_7b,
    "deepseek-v3-671b": deepseek_v3_671b,
    "qwen3-14b": qwen3_14b,
    "llama3-405b": llama3_405b,
    "llama4-scout-17b-a16e": llama4_scout_17b,
    "rwkv6-7b": rwkv6_7b,
    "zamba2-7b": zamba2_7b,
    "whisper-medium": whisper_medium,
    "llama-3.2-vision-90b": llama32_vision_90b,
}

ARCH_IDS = tuple(_MODULES)


def _module(arch_id: str):
    try:
        return _MODULES[arch_id]
    except KeyError:
        raise KeyError(f"unknown arch {arch_id!r}; the port serves "
                       f"{sorted(_MODULES)}") from None


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).FULL


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke()


__all__ = ["ARCH_IDS", "ModelConfig", "get_config", "get_smoke_config"]
