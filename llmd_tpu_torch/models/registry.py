"""Named model configs (copy of ``llmd_tpu/models/registry.py``, same names and
shapes). The port serves the dense, MoE, MLA and vision entries."""

from __future__ import annotations

from llmd_tpu_torch.models.config import ModelConfig

MODEL_REGISTRY: dict[str, ModelConfig] = {
    # CI-size models (CPU-runnable, byte-level vocab)
    "tiny": ModelConfig(
        name="tiny", vocab_size=288, hidden_size=128, intermediate_size=384,
        num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
    ),
    "tiny-vl": ModelConfig(
        name="tiny-vl", vocab_size=288, hidden_size=128, intermediate_size=384,
        num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
        mm_tokens=4, mm_placeholder_id=287, vision_patch=8, vision_image_size=32,
        vision_layers=2, vision_hidden=64, vision_heads=4,
    ),
    "tiny64": ModelConfig(
        name="tiny64", vocab_size=288, hidden_size=128, intermediate_size=384,
        num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
    ),
    "tiny-moe": ModelConfig(
        name="tiny-moe", vocab_size=288, hidden_size=128, intermediate_size=256,
        num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
        moe_num_experts=8, moe_top_k=2, moe_intermediate_size=128,
        moe_num_shared_experts=1,
    ),
    # Llama-3.2-1B-shaped (~1.1B params in bf16).
    "llama-1b": ModelConfig(
        name="llama-1b", vocab_size=32768, hidden_size=2048, intermediate_size=8192,
        num_layers=16, num_heads=32, num_kv_heads=8, head_dim=64,
        rope_theta=500000.0, tie_embeddings=True,
    ),
    # Llama-3-8B shape.
    "llama-8b": ModelConfig(
        name="llama-8b", vocab_size=128256, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
        rope_theta=500000.0, tie_embeddings=False,
    ),
    # Qwen3-32B shape.
    "qwen-32b": ModelConfig(
        name="qwen-32b", vocab_size=151936, hidden_size=5120, intermediate_size=25600,
        num_layers=64, num_heads=64, num_kv_heads=8, head_dim=128,
        rope_theta=1000000.0, tie_embeddings=False,
    ),
    "moe-wide-sim": ModelConfig(
        name="moe-wide-sim", vocab_size=32768, hidden_size=1024, intermediate_size=2048,
        num_layers=4, num_heads=16, num_kv_heads=4, head_dim=64,
        moe_num_experts=32, moe_top_k=4, moe_intermediate_size=512,
        moe_num_shared_experts=1,
    ),
    "tiny-mla": ModelConfig(
        name="tiny-mla", vocab_size=288, hidden_size=128, intermediate_size=384,
        num_layers=2, num_heads=4, num_kv_heads=4, head_dim=32,
        mla_kv_lora_rank=64, mla_rope_dim=16, mla_qk_nope_dim=16,
        mla_v_head_dim=16,
    ),
    "tiny-mla-moe": ModelConfig(
        name="tiny-mla-moe", vocab_size=288, hidden_size=128,
        intermediate_size=256, num_layers=2, num_heads=4, num_kv_heads=4,
        head_dim=32, mla_kv_lora_rank=64, mla_rope_dim=16, mla_qk_nope_dim=16,
        mla_v_head_dim=16, moe_num_experts=8, moe_top_k=2,
        moe_intermediate_size=128, moe_num_shared_experts=1,
    ),
    "moe-wide-mla": ModelConfig(
        name="moe-wide-mla", vocab_size=32768, hidden_size=1024,
        intermediate_size=2048, num_layers=4, num_heads=16, num_kv_heads=16,
        head_dim=64, mla_kv_lora_rank=128, mla_rope_dim=32,
        mla_qk_nope_dim=32, mla_v_head_dim=32,
        moe_num_experts=32, moe_top_k=4, moe_intermediate_size=512,
        moe_num_shared_experts=1,
    ),
}


def get_model_config(name: str) -> ModelConfig:
    try:
        return MODEL_REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; known: {sorted(MODEL_REGISTRY)}") from None
