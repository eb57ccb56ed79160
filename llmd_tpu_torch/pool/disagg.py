"""DisaggPoolSet: two role-labeled pools under one controller plane (copy of
``llmd_tpu/pool/disagg.py``).

P/D disaggregation (docs/pd-disaggregation.md) splits a deployment into a
*prefill* pool and a *decode* pool with independent scaling laws:

- **prefill replicas** are sized by TTFT pressure — the router's flow-control
  queue depth is the fastest proxy for "prompts are waiting to be chunked",
  so the prefill controller defaults to the HPA policy fed the live flow
  depth (igw_queue_depth target) plus running totals;
- **decode replicas** are sized by KV residency and sustained tok/s — the
  decode controller defaults to the WVA saturation policy over per-replica
  ``kv_usage``/queue spare capacity, with the flow-depth input zeroed so a
  prompt backlog never inflates the decode pool (prefill owns that signal).

Both controllers share the *router's* EndpointPool: every replica lands in
discovery with ``role=prefill|decode`` threaded from the launcher handle
through :meth:`PoolController._launch_one`, which is what the scheduler's
``prefill-endpoints-filter`` / ``decode-endpoints-filter`` profiles key on —
live role attributes, not static config lists.

Each role reads its own env namespace (``LLMD_POOL_PREFILL_*`` /
``LLMD_POOL_DECODE_*``, deploy/ENV_VARS.md) and falls back to the shared
``LLMD_POOL_*`` defaults via :meth:`PoolConfig.from_env` overrides.

The per-role controllers get ``fleet = None``: the router-wide fleet rollup
sums *all* replicas' running requests, which would let decode load leak into
the prefill controller's HPA input (and vice versa); the per-replica
fallback in ``_running_total`` only sums the controller's own role.
"""

from __future__ import annotations

import asyncio
from typing import Any, Optional

from llmd_tpu_torch.pool.controller import PoolConfig, PoolController, _env_f, _env_i
from llmd_tpu_torch.pool.launcher import ReplicaLauncher


def prefill_pool_config(**overrides: Any) -> PoolConfig:
    """Prefill-pool knobs: LLMD_POOL_PREFILL_* over the shared defaults."""
    import os

    cfg = PoolConfig.from_env(role="prefill")
    cfg.min_replicas = _env_i("LLMD_POOL_PREFILL_MIN_REPLICAS",
                              cfg.min_replicas)
    cfg.max_replicas = _env_i("LLMD_POOL_PREFILL_MAX_REPLICAS",
                              cfg.max_replicas)
    cfg.interval_s = _env_f("LLMD_POOL_PREFILL_INTERVAL_S", cfg.interval_s)
    # queue-depth-driven by default: TTFT pressure shows up as flow backlog
    cfg.policy = os.environ.get("LLMD_POOL_PREFILL_POLICY", "hpa")
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg


def decode_pool_config(**overrides: Any) -> PoolConfig:
    """Decode-pool knobs: LLMD_POOL_DECODE_* over the shared defaults."""
    import os

    cfg = PoolConfig.from_env(role="decode")
    cfg.min_replicas = _env_i("LLMD_POOL_DECODE_MIN_REPLICAS",
                              cfg.min_replicas)
    cfg.max_replicas = _env_i("LLMD_POOL_DECODE_MAX_REPLICAS",
                              cfg.max_replicas)
    cfg.interval_s = _env_f("LLMD_POOL_DECODE_INTERVAL_S", cfg.interval_s)
    # KV-residency-driven by default: WVA saturation over kv spare capacity
    cfg.policy = os.environ.get("LLMD_POOL_DECODE_POLICY", "wva")
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg


class DisaggPoolSet:
    """Two role-labeled PoolControllers over one shared router pool.

    ``prefill_launcher`` should hand out ``role="prefill"`` replicas and
    ``decode_launcher`` ``role="decode"`` ones (optionally sidecar-fronted);
    the set itself only wires signals and aggregates lifecycle/status.
    """

    def __init__(self, prefill_launcher: ReplicaLauncher,
                 decode_launcher: ReplicaLauncher,
                 router: Any = None,
                 prefill_cfg: Optional[PoolConfig] = None,
                 decode_cfg: Optional[PoolConfig] = None) -> None:
        pcfg = prefill_cfg if prefill_cfg is not None else \
            prefill_pool_config()
        dcfg = decode_cfg if decode_cfg is not None else decode_pool_config()
        pcfg.role, dcfg.role = "prefill", "decode"
        self.prefill = PoolController(
            pcfg, prefill_launcher, router=router,
            flow_depth_fn=self._prefill_queue_depth(router))
        # the HPA default target (8 queued) is sized for pools of large
        # replicas; prefill replicas admit ~2 concurrent chunked prefills,
        # so the TTFT-pressure target is its own knob (deploy/ENV_VARS.md)
        from llmd_tpu_torch.autoscaling.hpa import ExternalMetric

        self.prefill.hpa.metrics = [
            ExternalMetric("igw_queue_depth",
                           target=_env_f("LLMD_POOL_PREFILL_QUEUE_TARGET",
                                         8.0),
                           target_type="Value"),
            ExternalMetric("igw_running_requests", target=16.0,
                           target_type="AverageValue"),
        ]
        # decode scaling must not see the prompt backlog: zero its flow input
        # so WVA reacts to per-replica KV residency / queue spare, not TTFT
        self.decode = PoolController(dcfg, decode_launcher, router=router,
                                     flow_depth_fn=lambda: 0.0)
        # router-wide rollups mix roles; force the per-replica fallback
        self.prefill.fleet = None
        self.decode.fleet = None

    @staticmethod
    def _prefill_queue_depth(router: Any):
        """TTFT-pressure signal for the prefill pool's HPA: the router's
        flow backlog (prompts not yet dispatched) plus outstanding prefill
        work on the prefill replicas themselves — queued behind the P
        pool's admission limit or already mid-prefill (a replica running
        at its admission limit is pressure, not steady state)."""
        from llmd_tpu_torch.core.endpoint import EndpointRole
        from llmd_tpu_torch.core.metrics_contract import StdMetric

        def depth() -> float:
            total = 0.0
            if router is not None and getattr(router, "flow", None) is not None:
                total += float(router.flow._total_queued())
            if router is not None:
                for ep in router.pool.list():
                    if ep.role == EndpointRole.PREFILL:
                        total += float(ep.metric(StdMetric.QUEUED_REQUESTS))
                        total += float(ep.metric(StdMetric.RUNNING_REQUESTS))
            return total

        return depth

    # ------------------------------------------------------------ lifecycle
    async def start(self) -> None:
        await asyncio.gather(self.prefill.start(), self.decode.start())

    async def stop(self) -> None:
        await asyncio.gather(self.prefill.stop(), self.decode.stop())

    async def step(self) -> None:
        """One synchronous reconcile pass over both roles (tests/gates)."""
        await self.prefill.step()
        await self.decode.step()

    # ---------------------------------------------------------------- status
    def status(self) -> dict:
        return {"prefill": self.prefill.status(),
                "decode": self.decode.status()}
