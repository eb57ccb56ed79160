"""Model architecture config (copy of ``llmd_tpu/models/config.py``)."""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class ModelConfig:
    name: str = "tiny"
    vocab_size: int = 288  # byte-level tokenizer (256 bytes + specials), padded to tile
    hidden_size: int = 128
    intermediate_size: int = 384
    num_layers: int = 2
    num_heads: int = 4
    num_kv_heads: int = 2
    head_dim: int = 32
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    max_position: int = 32768
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    # Per-head RMSNorm on q/k before RoPE (Qwen3-family checkpoints).
    qk_norm: bool = False
    # Bias terms on the q/k/v projections (Qwen2-family checkpoints).
    attn_bias: bool = False
    # MoE (0 experts = dense).
    moe_num_experts: int = 0
    moe_top_k: int = 2
    moe_intermediate_size: int = 0
    moe_num_shared_experts: int = 0
    moe_capacity_factor: float = 1.25
    moe_dbo: bool = False
    # Multimodal (vision tower): 0 mm_tokens = text-only.
    mm_tokens: int = 0
    mm_placeholder_id: int = 0
    vision_patch: int = 8
    vision_image_size: int = 32
    vision_layers: int = 0
    vision_hidden: int = 0
    vision_heads: int = 4
    # Multi-head latent attention (DeepSeek-V2/V3 family); 0 = standard GQA.
    mla_kv_lora_rank: int = 0
    mla_rope_dim: int = 0
    mla_qk_nope_dim: int = 0
    mla_v_head_dim: int = 0

    @property
    def has_vision(self) -> bool:
        return self.mm_tokens > 0 and self.vision_layers > 0

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.dtype]

    @property
    def is_moe(self) -> bool:
        return self.moe_num_experts > 0

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def is_mla(self) -> bool:
        return self.mla_kv_lora_rank > 0

    @property
    def kv_cache_heads(self) -> int:
        """KV heads as stored in the paged pool (1 for MLA's shared latent)."""
        return 1 if self.is_mla else self.num_kv_heads

    @property
    def kv_cache_head_dim(self) -> int:
        """Per-token per-head KV width in the pool (latent + rope key for MLA)."""
        return (self.mla_kv_lora_rank + self.mla_rope_dim) if self.is_mla \
            else self.head_dim
