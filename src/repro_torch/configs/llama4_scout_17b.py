"""llama4-scout-17b-a16e [moe]: 48L d=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1 + 1 shared expert
[hf:meta-llama/Llama-4-Scout-17B-16E]. Early-fusion multimodality is a
frontend concern; the backbone here is the text MoE decoder."""

import torch

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    arch_id="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    num_experts=16,
    experts_per_token=1,
    num_shared_experts=1,
    moe_d_ff=8192,
    activation="silu",
    rope_theta=500000.0,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="llama4-scout-17b-a16e-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        num_experts=4,
        experts_per_token=1,
        num_shared_experts=1,
        moe_d_ff=128,
        activation="silu",
        dtype=torch.float32,
        kv_cache_dtype=torch.float32,
    )
