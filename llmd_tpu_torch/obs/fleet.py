"""Fleet rollup plane: one router scrape answers fleet health (copy of
``llmd_tpu/obs/fleet.py``).

``FleetRollup`` rides the router's ``MetricsPoller`` extractor chain
(duck-typed to the datalayer ``Extractor`` interface — ``name`` +
``extract(ep, raw)`` — so ``obs/`` stays free of router imports). Every
per-replica scrape updates that replica's cached sample in O(one pass over
its raw samples); the aggregate ``llmd_tpu:fleet_*`` gauges are computed at
router scrape time over the cached samples — no second fan-out, no
re-scraping, and the pool controller reads the same rollup instead of
re-summing per-replica attributes itself.

Boundedness under churn: state is one fixed-size ``_ReplicaSample`` per
*live* endpoint; ``forget(address)`` (cascaded from ``MetricsPoller.forget``
when discovery drops a replica) deletes it, so 100 replicas cycling through
the pool leave exactly the live set behind.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

__all__ = ["FleetRollup"]

_DECODE_TOKENS = "llmd_tpu:decode_tokens_total"
_RUNNING = "vllm:num_requests_running"
_WAITING = "vllm:num_requests_waiting"
_KV_USAGE = "vllm:kv_cache_usage_perc"
_HBM_USE = "llmd_tpu:device_hbm_bytes_in_use"
_HBM_LIMIT = "llmd_tpu:device_hbm_limit_bytes"
_FABRIC = "llmd_tpu:device_fabric_alive"
_STALLED = "llmd_tpu:engine_stalled"
_GOODPUT = "llmd_tpu:goodput_tokens_total"
_MFU = "llmd_tpu:program_mfu"


class _ReplicaSample:
    """Last-scrape rollup inputs for one replica. Fixed size by design."""

    __slots__ = ("t_mono", "tokens", "tok_per_s", "running", "waiting",
                 "kv_usage", "hbm_headroom", "fabric_alive", "stalled",
                 "gp_committed", "gp_all", "gp_committed_delta",
                 "gp_all_delta", "mfu_mean")

    def __init__(self):
        self.t_mono: Optional[float] = None
        self.tokens: Optional[float] = None
        self.tok_per_s = 0.0
        self.running = 0.0
        self.waiting = 0.0
        self.kv_usage: Optional[float] = None
        self.hbm_headroom: Optional[float] = None
        self.fabric_alive = True
        self.stalled = False
        # utilization plane: cumulative goodput counters (for deltas) and
        # the replica's mean per-program MFU sample (None off-device)
        self.gp_committed: Optional[float] = None
        self.gp_all: Optional[float] = None
        self.gp_committed_delta = 0.0
        self.gp_all_delta = 0.0
        self.mfu_mean: Optional[float] = None


class FleetRollup:
    """MetricsPoller extractor aggregating per-replica scrapes."""

    name = "fleet-rollup"

    def __init__(self, now_fn: Callable[[], float] = time.monotonic):
        self.now_fn = now_fn
        self._replicas: Dict[str, _ReplicaSample] = {}

    # ------------------------------------------------------------ extraction
    def extract(self, ep, raw: list) -> None:
        """One pass over a replica's parsed /metrics samples."""
        s = self._replicas.get(ep.address)
        if s is None:
            s = self._replicas[ep.address] = _ReplicaSample()
        tokens = None
        hbm_use: Dict[str, float] = {}
        hbm_limit: Dict[str, float] = {}
        kv = None
        fabric: Optional[float] = None
        stalled: Optional[float] = None
        running = waiting = 0.0
        gp_committed = gp_all = None
        mfu_samples: list = []
        for name, labels, value in raw:
            if name == _DECODE_TOKENS:
                tokens = value
            elif name == _RUNNING:
                running = value
            elif name == _WAITING:
                waiting = value
            elif name == _KV_USAGE:
                kv = value
            elif name == _HBM_USE:
                hbm_use[labels.get("device", "")] = value
            elif name == _HBM_LIMIT:
                hbm_limit[labels.get("device", "")] = value
            elif name == _FABRIC:
                fabric = value
            elif name == _STALLED:
                stalled = value
            elif name == _GOODPUT:
                gp_all = (gp_all or 0.0) + value
                if labels.get("kind") == "committed":
                    gp_committed = (gp_committed or 0.0) + value
            elif name == _MFU:
                mfu_samples.append(value)
        now = self.now_fn()
        if tokens is not None and s.tokens is not None and s.t_mono is not None:
            dt = now - s.t_mono
            delta = tokens - s.tokens
            # counter reset (replica restart) → re-baseline, don't go negative
            s.tok_per_s = delta / dt if dt > 0 and delta >= 0 else 0.0
        # goodput ratio comes from scrape-to-scrape counter deltas (same
        # reset discipline as tok_per_s: negative delta = replica restart)
        if gp_all is not None and s.gp_all is not None:
            d_all = gp_all - s.gp_all
            d_com = (gp_committed or 0.0) - (s.gp_committed or 0.0)
            if d_all >= 0 and d_com >= 0:
                s.gp_all_delta, s.gp_committed_delta = d_all, d_com
            else:
                s.gp_all_delta = s.gp_committed_delta = 0.0
        s.gp_all = gp_all
        s.gp_committed = gp_committed
        s.mfu_mean = (sum(mfu_samples) / len(mfu_samples)
                      if mfu_samples else None)
        s.t_mono = now
        s.tokens = tokens
        s.running = running
        s.waiting = waiting
        s.kv_usage = kv
        headroom = sum(limit - hbm_use.get(dev, 0.0)
                       for dev, limit in hbm_limit.items())
        s.hbm_headroom = headroom if hbm_limit else None
        # device-plane gauges are absent on backends without them (CPU):
        # absent means "no evidence of trouble", not dead/stalled
        s.fabric_alive = fabric != 0.0 if fabric is not None else True
        s.stalled = stalled == 1.0 if stalled is not None else False

    def forget(self, address: str) -> None:
        self._replicas.pop(address, None)

    # -------------------------------------------------------------- rollups
    def __len__(self) -> int:
        return len(self._replicas)

    def snapshot(self) -> dict:
        """Aggregate over cached replica samples (router scrape time)."""
        reps = list(self._replicas.values())
        headrooms = [s.hbm_headroom for s in reps if s.hbm_headroom is not None]
        kvs = [s.kv_usage for s in reps if s.kv_usage is not None]
        mfus = [s.mfu_mean for s in reps if s.mfu_mean is not None]
        gp_all = sum(s.gp_all_delta for s in reps)
        gp_com = sum(s.gp_committed_delta for s in reps)
        return {
            "replicas": len(reps),
            "tokens_per_second": sum(s.tok_per_s for s in reps),
            "running": sum(s.running for s in reps),
            "waiting": sum(s.waiting for s in reps),
            "hbm_headroom_min": min(headrooms) if headrooms else 0.0,
            "hbm_headroom_total": sum(headrooms) if headrooms else 0.0,
            "kv_utilization_mean": sum(kvs) / len(kvs) if kvs else 0.0,
            "fabric_alive": sum(1 for s in reps if s.fabric_alive),
            "stalled": sum(1 for s in reps if s.stalled),
            # token-weighted fleet goodput over the last scrape interval
            "goodput_committed_ratio": gp_com / gp_all if gp_all > 0 else 0.0,
            "mfu_mean": sum(mfus) / len(mfus) if mfus else 0.0,
        }

    def running_total(self) -> float:
        """Pool-controller consumption path (in-flight fleet-wide)."""
        return sum(s.running for s in self._replicas.values())

    def waiting_total(self) -> float:
        return sum(s.waiting for s in self._replicas.values())

    def bind_gauges(self, rm) -> None:
        """Point the RouterMetrics fleet gauges at this rollup (scrape-time
        callbacks — the gauges always expose the freshest aggregate)."""
        rm.fleet_replicas.set_function(lambda: len(self._replicas))
        rm.fleet_tokens_per_second.set_function(
            lambda: self.snapshot()["tokens_per_second"])
        rm.fleet_running.set_function(self.running_total)
        rm.fleet_waiting.set_function(self.waiting_total)
        rm.fleet_hbm_headroom_min.set_function(
            lambda: self.snapshot()["hbm_headroom_min"])
        rm.fleet_hbm_headroom_total.set_function(
            lambda: self.snapshot()["hbm_headroom_total"])
        rm.fleet_kv_utilization.set_function(
            lambda: self.snapshot()["kv_utilization_mean"])
        rm.fleet_fabric_alive.set_function(
            lambda: self.snapshot()["fabric_alive"])
        rm.fleet_stalled.set_function(lambda: self.snapshot()["stalled"])
        rm.fleet_goodput_ratio.set_function(
            lambda: self.snapshot()["goodput_committed_ratio"])
        rm.fleet_mfu.set_function(lambda: self.snapshot()["mfu_mean"])
