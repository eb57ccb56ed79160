"""The mesh and expert-parallel load balancing: ``mesh`` (the (dp, sp, ep,
tp) rank mesh over ``torch.distributed``), ``rows`` (a step's rows split
over it), ``launch`` / ``worker`` (worlds of rank processes), ``checks``
(rank-side checks), ``eplb`` (numpy only)."""

from llmd_tpu_torch.parallel.eplb import EPLBConfig  # noqa: F401
from llmd_tpu_torch.parallel.mesh import MeshConfig  # noqa: F401
