"""deepseek-v3-671b [moe]: 61L d=7168 128H d_ff(expert)=2048
vocab=129280, MoE 1 shared + 256 routed top-8, MLA [arXiv:2412.19437].

MLA dims per the paper: q_lora=1536, kv_lora=512, rope_head=64,
nope_head=128, v_head=128. The first 3 layers are dense (gated SiLU,
d_ff=18432). MTP (multi-token prediction) is out of scope, as in the
JAX package. The compressed MLA cache holds (512 + 64) values a token
and layer.
"""

import torch

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    arch_id="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    d_ff=18432,            # dense (first 3) layers
    vocab_size=129280,
    num_experts=256,
    experts_per_token=8,
    num_shared_experts=1,
    moe_d_ff=2048,
    first_dense_layers=3,
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    rope_head_dim=64,
    nope_head_dim=128,
    v_head_dim=128,
    activation="silu",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="deepseek-v3-671b-smoke",
        family="moe",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=160,
        vocab_size=512,
        num_experts=8,
        experts_per_token=2,
        num_shared_experts=1,
        moe_d_ff=64,
        first_dense_layers=1,
        use_mla=True,
        q_lora_rank=48,
        kv_lora_rank=32,
        rope_head_dim=8,
        nope_head_dim=16,
        v_head_dim=16,
        activation="silu",
        dtype=torch.float32,
        kv_cache_dtype=torch.float32,
    )
