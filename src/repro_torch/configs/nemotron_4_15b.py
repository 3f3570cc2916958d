"""nemotron-4-15b [dense]: 32L d=6144 48H (GQA kv=8) d_ff=24576
vocab=256000 [arXiv:2402.16819]. Squared-ReLU, non-gated MLP."""

import torch

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    arch_id="nemotron-4-15b",
    family="dense",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=256000,
    activation="squared_relu",
    gated_mlp=False,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="nemotron-4-15b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=8,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        activation="squared_relu",
        gated_mlp=False,
        dtype=torch.float32,
        kv_cache_dtype=torch.float32,
    )
