"""Pool controller: replica lifecycle closing the autoscaling loop (port of
``llmd_tpu/pool``).

The autoscaling policies (``autoscaling/``) decide *how many*
replicas a pool should run; this package owns *making it so*:

- ``launcher``  — start/stop endpoint processes (in-process fakes for CI,
  ``engine/serve.py`` subprocesses on device) with snapshot-aware warm start;
- ``snapshot``  — engine-config-fingerprinted snapshot store so a 0→1
  transition skips the cold engine build;
- ``controller`` — the reconcile loop: live router metrics → WVA/HPA
  decision → launch/drain/retire, registering every replica with router
  discovery so the datalayer, scheduler, and breakers track the live set;
- ``traces``    — bursty / diurnal / multi-tenant ramp load generators;
- ``harness``   — open-loop trace replay against the router with SLO
  attainment accounting (tools/slo_check.py drives it in CI).
"""

from llmd_tpu_torch.pool.controller import (
    PoolConfig,
    PoolController,
    replica_metrics_from_endpoint,
)
from llmd_tpu_torch.pool.launcher import (
    FakeReplicaLauncher,
    ProcessReplicaLauncher,
    ReplicaHandle,
    ReplicaLauncher,
    engine_argv,
)
from llmd_tpu_torch.pool.snapshot import PoolSnapshotStore, config_fingerprint

__all__ = [
    "FakeReplicaLauncher",
    "PoolConfig",
    "PoolController",
    "PoolSnapshotStore",
    "ProcessReplicaLauncher",
    "ReplicaHandle",
    "ReplicaLauncher",
    "config_fingerprint",
    "engine_argv",
    "replica_metrics_from_endpoint",
]
