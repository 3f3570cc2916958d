"""Model, shape-cell and training configuration with torch dtypes
(mirror of ``repro.configs.base``).

Only the fields the ported paths read are kept: the dense GQA family
(qk-norm included) and the MoE family (GQA or MLA attention), served
and trained. The JAX config's SSM, audio and VLM fields come with the
slices that port those families.
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
    qk_norm: bool = False          # qwen3: RMSNorm on q and k heads

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
    remat: str = "full"            # full | dots | none (per layer, when
                                   # the forward is differentiated)
    use_pallas: bool = False       # MLP through the fused Sidebar kernel,
                                   # cache-free attention through flash
                                   # (name kept from the JAX config)
    kv_cache_dtype: torch.dtype = torch.bfloat16  # int8 => quantized KV
                                   # (GQA; the MLA cache is in ``dtype``)

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.num_heads, 1))
        if self.num_experts and self.moe_d_ff == 0:
            object.__setattr__(self, "moe_d_ff", self.d_ff)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (input-shape) column of the assignment table."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeCell("train_4k", 4_096, 256, "train")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    microbatch_per_device: int = 1   # grad-accumulation microbatch size
    moment_dtype: torch.dtype = torch.float32  # bf16 for the largest configs
    grad_compression: str = "none"   # none | bf16 | int8_ef
