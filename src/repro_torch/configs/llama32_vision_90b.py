"""llama-3.2-vision-90b [vlm]: 100L d=8192 64H (GQA kv=8) d_ff=28672
vocab=128256, gated cross-attention image layers every 5th layer
[hf:meta-llama/Llama-3.2-11B-Vision, scaled]. Vision frontend is a STUB:
the caller provides patch embeddings (B, 1600, d_model). int8 KV for
decode (100 layers x 32k cache)."""

import torch

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    arch_id="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    cross_attn_every=5,
    num_image_tokens=1600,
    activation="silu",
    rope_theta=500000.0,
    kv_cache_dtype=torch.int8,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="llama-3.2-vision-90b-smoke",
        family="vlm",
        num_layers=4,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        cross_attn_every=2,
        num_image_tokens=8,
        activation="silu",
        dtype=torch.float32,
        kv_cache_dtype=torch.float32,
    )
