"""llama3-405b [dense]: 126L d=16384 128H (GQA kv=8) d_ff=53248
vocab=128256 [arXiv:2407.21783]. int8 KV cache for the decode cells
(256 v5e chips cannot hold a 32k bf16 cache at batch 128)."""

import torch

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    arch_id="llama3-405b",
    family="dense",
    num_layers=126,
    d_model=16384,
    num_heads=128,
    num_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    activation="silu",
    rope_theta=500000.0,
    kv_cache_dtype=torch.int8,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="llama3-405b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=8,
        num_kv_heads=2,
        d_ff=192,
        vocab_size=256,
        activation="silu",
        rope_theta=500000.0,
        dtype=torch.float32,
        kv_cache_dtype=torch.float32,
    )
