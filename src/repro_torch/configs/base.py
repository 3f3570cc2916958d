"""Model configuration with torch dtypes (mirror of ``repro.configs.base``).

Only the fields the ported serving paths read are kept: the dense GQA
family and deepseek-v3's MoE + MLA family. The JAX config's SSM, audio
and VLM fields come with the slices that port those families.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                    # dense | moe (the families ported)
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads

    # flexible functions (function-table keys)
    activation: str = "silu"
    gated_mlp: bool = True

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0              # per-expert hidden (d_ff if 0)
    capacity_factor: float = 1.25
    first_dense_layers: int = 0    # deepseek-v3: first k layers stay dense

    # MLA (deepseek-v3)
    use_mla: bool = False
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128

    # numerics
    dtype: torch.dtype = torch.bfloat16
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    use_pallas: bool = False       # MLP through the fused Sidebar kernel
                                   # (name kept from the JAX config)
    kv_cache_dtype: torch.dtype = torch.bfloat16  # int8 => quantized KV
                                   # (GQA; the MLA cache is in ``dtype``)

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.num_heads, 1))
        if self.num_experts and self.moe_d_ff == 0:
            object.__setattr__(self, "moe_d_ff", self.d_ff)
