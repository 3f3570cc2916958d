"""rwkv6-7b [ssm]: 32L d=4096 (attention-free) d_ff=14336 vocab=65536 —
'Finch' with data-dependent decay [arXiv:2404.05892]. The decay
w = exp(-exp(x)) is a function-table entry ('exp_decay')."""

import torch

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    arch_id="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    d_ff=14336,
    vocab_size=65536,
    rwkv_head_dim=64,
    activation="squared_relu",   # channel-mix
)


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="rwkv6-7b-smoke",
        family="ssm",
        num_layers=2,
        d_model=64,
        num_heads=0,
        num_kv_heads=0,
        d_ff=128,
        vocab_size=256,
        rwkv_head_dim=16,
        activation="squared_relu",
        dtype=torch.float32,
    )
