"""The engine side of the global KV plane (port of ``llmd_tpu/kvplane/pull.py``
and ``plane_mode``). The router side (``KVPlane``, the producers) is not
ported: it drives port engines over HTTP and the transfer wire unchanged."""

from llmd_tpu_torch.kvplane.pull import plane_mode, pull_prefix_into, serve_prefix  # noqa: F401
