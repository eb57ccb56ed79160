"""Batch plane: OpenAI Batch Gateway + queue-driven Async Processor (port of
``llmd_tpu/batch``, on ``router/http.py`` and ``sqlite3``).

Parity: reference docs/architecture/advanced/batch/ (SURVEY §2.6 A3-A4).
"""

from llmd_tpu_torch.batch.async_processor import (
    AsyncItem,
    AsyncProcessor,
    AsyncProcessorConfig,
    BudgetGate,
    ConstantGate,
    FileSpoolPuller,
    GATE_REGISTRY,
    MemoryQueuePuller,
    PrometheusBudgetGate,
    PrometheusSaturationGate,
)
from llmd_tpu_torch.batch.files import FileStore, validate_batch_input
from llmd_tpu_torch.batch.gateway import BatchGateway, BatchGatewayConfig
from llmd_tpu_torch.batch.store import BatchRow, BatchStore

__all__ = [
    "AsyncItem", "AsyncProcessor", "AsyncProcessorConfig", "BatchGateway",
    "BatchGatewayConfig", "BatchRow", "BatchStore", "BudgetGate", "ConstantGate",
    "FileSpoolPuller", "FileStore", "GATE_REGISTRY", "MemoryQueuePuller",
    "PrometheusBudgetGate", "PrometheusSaturationGate", "validate_batch_input",
]
