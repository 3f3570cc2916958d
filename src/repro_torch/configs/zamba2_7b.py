"""zamba2-7b [hybrid]: Mamba2 backbone + shared attention block.

81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000, ssm_state=64
[arXiv:2411.15242]. Shared attn block invoked every 6 layers (weights
shared across invocations, per-invocation KV cache).
"""

import torch

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    arch_id="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    attn_every=6,
    activation="silu",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="zamba2-7b-smoke",
        family="hybrid",
        num_layers=7,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        ssm_state=16,
        ssm_head_dim=16,
        ssm_chunk=8,
        attn_every=3,
        activation="silu",
        dtype=torch.float32,
        kv_cache_dtype=torch.float32,
    )
