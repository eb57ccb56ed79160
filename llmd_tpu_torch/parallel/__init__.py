"""Expert-parallel load balancing (numpy only; one device in this slice)."""

from llmd_tpu_torch.parallel.eplb import EPLBConfig  # noqa: F401
