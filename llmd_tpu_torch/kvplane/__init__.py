"""Global KV plane: precise prefix-cache routing + cross-engine prefix pulls
(port of ``llmd_tpu/kvplane``).

- ``kvplane.plane``: the router side. ``KVPlane`` resolves the mode from
  ``LLMD_KV_PLANE`` (``precise`` | ``approx`` | ``off``), swaps producers and
  scorers on the live scheduler, degrades a request to the approx LRU while
  the index is cold or stale, and plans cross-engine pulls (``plan_pull``).
- ``kvplane.pull``: the engine side, the ``prefix_provider`` serving a peer's
  pull and the puller that injects and credits the local prefix cache.
"""

from llmd_tpu_torch.kvplane.plane import (  # noqa: F401
    LABEL_KV_TRANSFER_ADDR,
    LABEL_KV_TRANSFER_PORT,
    STATE_KV_PLANE,
    KVPlane,
    KVPlaneProducer,
    plane_mode,
)
from llmd_tpu_torch.kvplane.pull import pull_prefix_into, serve_prefix  # noqa: F401
