"""whisper-medium [audio]: 24 enc + 24 dec layers, d=1024 16H (kv=16)
d_ff=4096 vocab=51865 [arXiv:2212.04356]. Conv frontend is a STUB:
the caller provides precomputed frame embeddings (B, 1500, d_model).
GELU MLPs (non-gated)."""

import torch

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    arch_id="whisper-medium",
    family="audio",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    encoder_layers=24,
    encoder_seq=1500,
    activation="gelu",
    gated_mlp=False,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="whisper-medium-smoke",
        family="audio",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        encoder_layers=2,
        encoder_seq=24,
        activation="gelu",
        gated_mlp=False,
        dtype=torch.float32,
        kv_cache_dtype=torch.float32,
    )
