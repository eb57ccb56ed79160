"""Decoder models over a paged KV cache (dense, MoE, MLA), in PyTorch."""

from llmd_tpu_torch.models.config import ModelConfig  # noqa: F401
from llmd_tpu_torch.models.registry import MODEL_REGISTRY, get_model_config  # noqa: F401


def resolve_model(name_or_path: str, dtype: str = "bfloat16"):
    """(ModelConfig, params or None) from a registry name or an HF checkpoint
    directory (reference ``llmd_tpu.models.resolve_model``): a registry name
    gives ``params=None`` (the caller draws random weights), a checkpoint
    directory its weights through ``models/hf_loader``, on the host."""
    from llmd_tpu_torch.models.hf_loader import is_hf_checkpoint, load_model

    if is_hf_checkpoint(name_or_path):
        return load_model(name_or_path, dtype=dtype)
    return get_model_config(name_or_path), None
