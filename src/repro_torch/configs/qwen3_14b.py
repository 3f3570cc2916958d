"""qwen3-14b [dense]: 40L d=5120 40H (GQA kv=8) d_ff=17408 vocab=151936
[hf:Qwen/Qwen3-8B family] — qk-RMSNorm (an EXTRA flexible op inside
attention: the function-table entry 'rmsnorm' applied to q/k heads)."""

import torch

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    arch_id="qwen3-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=17408,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    activation="silu",
    rope_theta=1000000.0,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="qwen3-14b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=192,
        vocab_size=512,
        head_dim=16,
        qk_norm=True,
        activation="silu",
        dtype=torch.float32,
        kv_cache_dtype=torch.float32,
    )
