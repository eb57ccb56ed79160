"""Serving engine: continuous batching over the paged KV cache, HTTP front end."""

from llmd_tpu_torch.engine.config import EngineConfig  # noqa: F401
from llmd_tpu_torch.engine.engine import EngineOutput, LLMEngine  # noqa: F401
