"""Dense GQA decoder over a paged KV cache, in PyTorch."""

from llmd_tpu_torch.models.config import ModelConfig  # noqa: F401
from llmd_tpu_torch.models.registry import MODEL_REGISTRY, get_model_config  # noqa: F401
