"""Config registry for the architectures the port serves so far."""

from __future__ import annotations

from repro_torch.configs import deepseek_7b, deepseek_v3_671b, nemotron_4_15b
from repro_torch.configs.base import ModelConfig

_MODULES = {
    "nemotron-4-15b": nemotron_4_15b,
    "deepseek-7b": deepseek_7b,
    "deepseek-v3-671b": deepseek_v3_671b,
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
