"""Model configuration with torch dtypes (mirror of ``repro.configs.base``).

Only the fields the dense GQA serving path reads are kept; the JAX
config's MoE, MLA, SSM, audio and VLM fields come with the slices that
port those families.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                    # dense (the only family ported so far)
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

    # numerics
    dtype: torch.dtype = torch.bfloat16
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    use_pallas: bool = False       # MLP through the fused Sidebar kernel
                                   # (name kept from the JAX config)
    kv_cache_dtype: torch.dtype = torch.bfloat16  # int8 => quantized KV

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.num_heads, 1))
