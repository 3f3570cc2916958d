"""deepseek-7b [dense]: 30L d=4096 32H (kv=32, MHA) d_ff=11008
vocab=102400 [arXiv:2401.02954] — llama architecture: gated SiLU MLP."""

import torch

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    arch_id="deepseek-7b",
    family="dense",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=11008,
    vocab_size=102400,
    activation="silu",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="deepseek-7b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=192,
        vocab_size=512,
        activation="silu",
        dtype=torch.float32,
        kv_cache_dtype=torch.float32,
    )
