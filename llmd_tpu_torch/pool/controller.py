"""Pool controller: the reconcile loop that closes the autoscaling loop (copy
of ``llmd_tpu/pool/controller.py``; the drain and health probes on
``router/http.py``'s client, where the reference uses aiohttp).

The policy layer (``autoscaling/wva.py``, ``autoscaling/hpa.py``) has always
been able to *decide* replica counts; this controller makes the decisions
real and feeds them real inputs:

- **live metrics in** — ``PoolMetrics`` is built from the router's endpoint
  pool (the attrs the MetricsPoller scrapes under the ``StdMetric`` keys)
  plus the flow-control queue depth as the EPP queue signal, not hand-built
  fixtures;
- **lifecycle out** — scale-up launches replicas through a
  :class:`~llmd_tpu_torch.pool.launcher.ReplicaLauncher` (fakes in CI, engine
  subprocesses on device) and registers them with router discovery
  (``EndpointPool.upsert``), so the datalayer, scheduler, and breakers track
  the live set; scale-down marks the victim draining, runs the ``POST
  /drain`` handshake, deregisters, then stops the process;
- **scale-to-zero / scale-from-zero** — the WVA enforcer's retention window
  drives 0, the fast tick watches the flow queue and launches 1 the moment
  requests pile up at an empty pool (flow control holds dispatch while the
  pool is empty, so nothing is lost); launches are warm when the snapshot
  store has the config fingerprint, and every launch reports its duration
  to the ``llmd_tpu:pool_warm_start_seconds`` histogram by kind;
- **self-healing** — a periodic ``/health`` probe retires dead replicas
  (killed processes, not drained ones) and the next reconcile replaces
  them, which is what lets chaos tooling kill replicas mid-traffic.

All knobs are ``LLMD_POOL_*`` env vars (deploy/ENV_VARS.md) with
constructor overrides for tests.
"""

from __future__ import annotations

import asyncio
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from llmd_tpu_torch.autoscaling.hpa import HPAEvaluator
from llmd_tpu_torch.autoscaling.wva import (
    Enforcer,
    PoolMetrics,
    ReplicaMetrics,
    Variant,
    WVAEngine,
)
from llmd_tpu_torch.core.endpoint import Endpoint, EndpointPool, EndpointRole
from llmd_tpu_torch.core.metrics_contract import StdMetric
from llmd_tpu_torch.obs.metrics import register_pool_metrics
from llmd_tpu_torch.pool.launcher import ReplicaHandle, ReplicaLauncher
from llmd_tpu_torch.predictor.model import LatencySample, heuristic_latency
from llmd_tpu_torch.router.http import HTTPClient


def _env_f(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def _env_i(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


@dataclass
class PoolConfig:
    """Controller knobs (env-backed; see deploy/ENV_VARS.md)."""

    model: str = "fake/model"
    min_replicas: int = 1
    max_replicas: int = 4
    scale_to_zero: bool = False
    retention_s: float = 600.0  # idle window before scale-to-zero
    interval_s: float = 30.0  # full analyze/reconcile cadence
    sfz_interval_s: float = 0.1  # scale-from-zero fast-tick cadence
    drain_timeout_s: float = 10.0
    ready_timeout_s: float = 60.0
    policy: str = "max"  # "wva" | "hpa" | "max" (max of both)
    health_timeout_s: float = 1.0
    role: str = "both"  # prefill | decode | both — stamped on Endpoints

    @classmethod
    def from_env(cls, **overrides: Any) -> "PoolConfig":
        cfg = cls(
            min_replicas=_env_i("LLMD_POOL_MIN_REPLICAS", 1),
            max_replicas=_env_i("LLMD_POOL_MAX_REPLICAS", 4),
            scale_to_zero=os.environ.get("LLMD_POOL_SCALE_TO_ZERO", "0")
            not in ("0", "", "false", "False"),
            retention_s=_env_f("LLMD_POOL_RETENTION_S", 600.0),
            interval_s=_env_f("LLMD_POOL_INTERVAL_S", 30.0),
            drain_timeout_s=_env_f("LLMD_POOL_DRAIN_TIMEOUT_S", 10.0),
            ready_timeout_s=_env_f("LLMD_POOL_READY_TIMEOUT_S", 60.0),
            policy=os.environ.get("LLMD_POOL_POLICY", "max"),
        )
        for k, v in overrides.items():
            setattr(cfg, k, v)
        return cfg


def replica_metrics_from_endpoint(ep: Endpoint) -> ReplicaMetrics:
    """One live endpoint's scraped attrs → the WVA analyzer's input row."""
    kv = ep.metric(StdMetric.KV_UTILIZATION)
    num_blocks = int(ep.metric(StdMetric.NUM_BLOCKS) or 0)
    block_size = int(ep.metric(StdMetric.BLOCK_SIZE) or 16)
    return ReplicaMetrics(
        kv_usage=kv,
        queue_len=ep.metric(StdMetric.QUEUED_REQUESTS),
        num_blocks=num_blocks,
        block_size=block_size,
        tokens_in_use=kv * num_blocks * block_size,
    )


@dataclass
class LaunchRecord:
    kind: str  # "cold" | "warm"
    seconds: float
    address: str


class PoolController:
    """Reconcile loop for one model pool (one WVA variant).

    ``router`` (a RouterServer) is optional but is the production wiring:
    it supplies discovery (``router.pool``), the drain/breaker integration
    (``router.resilience``), the flow queue depth (EPP queue signal), the
    shared metrics registry, and the flight recorder. Unit tests can pass a
    bare ``EndpointPool`` and stubs instead.
    """

    def __init__(self, cfg: PoolConfig, launcher: ReplicaLauncher,
                 pool: Optional[EndpointPool] = None, router: Any = None,
                 registry: Any = None, flight: Any = None,
                 flow_depth_fn: Optional[Callable[[], float]] = None) -> None:
        self.cfg = cfg
        self.launcher = launcher
        self.router = router
        self.pool = pool if pool is not None else (
            router.pool if router is not None else EndpointPool())
        self.resilience = getattr(router, "resilience", None)
        # fleet rollup (obs/fleet.py): when the router aggregates replica
        # scrapes, the controller consumes the rollup instead of re-summing
        # per-replica attributes on every reconcile tick
        self.fleet = getattr(router, "fleet", None)
        self.flight = flight if flight is not None else getattr(
            router, "flight", None)
        if flow_depth_fn is not None:
            self._flow_depth = flow_depth_fn
        elif router is not None and getattr(router, "flow", None) is not None:
            self._flow_depth = router.flow._total_queued
        else:
            self._flow_depth = lambda: 0.0

        self.replicas: dict[str, ReplicaHandle] = {}
        self.launch_records: list[LaunchRecord] = []
        self._last_traffic = time.monotonic()
        self._lock = asyncio.Lock()
        self._task: Optional[asyncio.Task] = None
        self._session: Optional[HTTPClient] = None  # drain/health probes

        self.variant = Variant(
            name=f"{cfg.model}-pool", model_id=cfg.model,
            min_replicas=cfg.min_replicas, max_replicas=cfg.max_replicas,
            current_replicas=0, desired_replicas=0)
        self.wva = WVAEngine(
            pools={cfg.model: [self.variant]},
            metrics_fn=lambda _mid: self._pool_metrics(),
            enforcer=Enforcer(scale_to_zero=cfg.scale_to_zero,
                              retention_s=cfg.retention_s),
            interval_s=cfg.interval_s)
        self.hpa = HPAEvaluator(
            min_replicas=0 if cfg.scale_to_zero else cfg.min_replicas,
            max_replicas=cfg.max_replicas)

        registry = registry if registry is not None else getattr(
            router, "registry", None)
        self.families = None
        if registry is not None:
            self.families = register_pool_metrics(registry)
            self.families.desired_replicas.set_function(
                lambda: self.variant.desired_replicas)
            self.families.ready_replicas.set_function(
                lambda: len(self.replicas))

    # ------------------------------------------------------------ lifecycle
    async def start(self) -> None:
        self._session = HTTPClient()
        if self.cfg.min_replicas > 0:
            self.variant.desired_replicas = self.cfg.min_replicas
            await self._reconcile("floor")
        self._task = asyncio.get_running_loop().create_task(self._loop())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        async with self._lock:
            for address in list(self.replicas):
                await self._deregister(address)
                await self.launcher.stop(self.replicas.pop(address))
        if self._session is not None:
            await self._session.close()
            self._session = None

    async def _loop(self) -> None:
        last_full = 0.0
        while True:
            await asyncio.sleep(self.cfg.sfz_interval_s)
            try:
                now = time.monotonic()
                if now - last_full >= self.cfg.interval_s:
                    last_full = now
                    await self.step()
                else:
                    await self._fast_tick()
            except asyncio.CancelledError:
                raise
            except Exception:
                pass  # one bad tick never kills the controller

    # -------------------------------------------------------------- signals
    def _predicted_latency(self, ep: Endpoint):
        """Router predictor state → (ttft_s, itl_s), None without a predictor.

        When the router runs the predicted-latency-producer, its model (or the
        composite heuristic while cold) turns the endpoint's scraped load into
        the latency estimates the WVA SLOAnalyzer consumes — so SLO-driven
        scaling sees the same predictor the scheduler scores with."""
        ctx = getattr(self.router, "ctx", None)
        predictor = ctx.get("latency_predictor") if ctx else None
        if predictor is None:
            return None
        sample = LatencySample(
            kv_usage=ep.metric(StdMetric.KV_UTILIZATION),
            input_len=0.0,
            queue_depth=ep.metric(StdMetric.QUEUED_REQUESTS),
            running_requests=ep.metric(StdMetric.RUNNING_REQUESTS),
            prefix_match_pct=0.0,
            inflight_tokens=ep.metric(StdMetric.WAITING_TOKENS))
        try:
            preds = predictor.predict([sample])
        except Exception:
            return None
        pred = preds[0] if preds else None
        if pred is None or pred[0] is None or pred[1] is None:
            pred = heuristic_latency(sample)
        return pred[0] / 1e3, pred[1] / 1e3  # ms → s

    def _live_metrics(self) -> list[ReplicaMetrics]:
        out = []
        for address in self.replicas:
            ep = self.pool.get(address)
            if ep is not None and ep.ready:
                rm = replica_metrics_from_endpoint(ep)
                pred = self._predicted_latency(ep)
                if pred is not None:
                    rm.avg_ttft_s, rm.avg_itl_s = pred
                out.append(rm)
        return out

    def _running_total(self) -> float:
        if self.fleet is not None and len(self.fleet) > 0:
            return self.fleet.running_total()
        return sum(
            self.pool.get(a).metric(StdMetric.RUNNING_REQUESTS)
            for a in self.replicas if self.pool.get(a) is not None)

    def _pool_metrics(self) -> PoolMetrics:
        reps = self._live_metrics()
        depth = float(self._flow_depth())
        busy = depth > 0 or any(r.queue_len > 0 for r in reps) \
            or self._running_total() > 0
        now = time.monotonic()
        if busy:
            self._last_traffic = now
        in_retention = 1.0 if (now - self._last_traffic
                               <= self.cfg.retention_s) else 0.0
        return PoolMetrics(
            replicas={self.variant.name: reps},
            epp_queue_size=depth,
            requests_in_retention=in_retention)

    # ---------------------------------------------------------------- steps
    async def step(self) -> None:
        """One full pass: health-check, analyze (WVA + HPA), reconcile."""
        await self._health_sweep()
        self.variant.current_replicas = len(self.replicas)
        self.variant.pending_replicas = 0
        before = self.variant.desired_replicas
        reason = "steady"

        if self.cfg.policy in ("wva", "max"):
            signals = self.wva.step()
            sig = signals.get(self.cfg.model)
            if sig is not None and self.variant.desired_replicas != before:
                reason = "wva_saturated" if sig.scale_up else "wva_spare"
        if self.cfg.policy in ("hpa", "max"):
            want_hpa = self.hpa.desired_replicas(
                max(1, len(self.replicas)),
                {"igw_queue_depth": float(self._flow_depth()),
                 "igw_running_requests": self._running_total()})
            if self.cfg.policy == "hpa":
                self.variant.desired_replicas = want_hpa
                reason = "hpa"
            elif want_hpa > self.variant.desired_replicas:
                self.variant.desired_replicas = want_hpa
                reason = "hpa"
        if (self.cfg.scale_to_zero and before > 0
                and self.variant.desired_replicas == 0):
            reason = "scale_to_zero"
        await self._reconcile(reason)

    async def _fast_tick(self) -> None:
        """Scale-from-zero fast path (WVA's 100ms loop analogue)."""
        if self.replicas or self.variant.desired_replicas > 0:
            return
        self.variant.current_replicas = 0
        self.wva.scale_from_zero_step()
        if self.variant.desired_replicas > 0:
            await self._reconcile("scale_from_zero")

    async def scale_to(self, n: int, reason: str = "manual") -> None:
        """Explicit override (operators, tests, the SLO gate's epilogue)."""
        self.variant.desired_replicas = n
        await self._reconcile(reason)

    # ------------------------------------------------------------ reconcile
    async def _reconcile(self, reason: str) -> None:
        async with self._lock:
            desired = self.variant.desired_replicas
            current = len(self.replicas)
            if desired != current and self.families is not None:
                self.families.scale_decisions.labels(reason=reason).inc()
            if desired > current:
                await asyncio.gather(*(
                    self._launch_one(reason)
                    for _ in range(desired - current)))
            elif desired < current:
                for address in self._retire_candidates(current - desired):
                    await self._retire_one(address, reason)
            self.variant.current_replicas = len(self.replicas)
            self.variant.pending_replicas = 0

    async def _launch_one(self, reason: str) -> None:
        t0 = time.monotonic()
        try:
            handle = await self.launcher.launch()
        except Exception:
            return  # next tick retries; desired > current persists
        dt = time.monotonic() - t0
        kind = "warm" if handle.warm else "cold"
        self.launch_records.append(LaunchRecord(kind, dt, handle.address))
        if self.families is not None:
            self.families.warm_start.labels(kind=kind).observe(dt)
        self.replicas[handle.address] = handle
        role = getattr(handle, "role", None) or self.cfg.role
        self.pool.upsert(Endpoint(
            address=handle.address, name=handle.name,
            role=EndpointRole(role),
            labels={"llmd.ai/pool": self.cfg.model,
                    "llmd.ai/role": role}))
        if self.flight is not None:
            self.flight.record_system(
                "pool_warm_start", endpoint=handle.address, kind=kind,
                seconds=round(dt, 3))
            self.flight.record_system(
                "pool_scale_up", endpoint=handle.address, reason=reason,
                replicas=len(self.replicas))

    def _retire_candidates(self, n: int) -> list[str]:
        """Least-loaded first: retiring the busiest replica maximizes the
        drain wait and the KV state thrown away."""

        def load(address: str) -> float:
            ep = self.pool.get(address)
            if ep is None:
                return 0.0
            return (ep.metric(StdMetric.RUNNING_REQUESTS)
                    + ep.metric(StdMetric.QUEUED_REQUESTS))

        return sorted(self.replicas, key=load)[:n]

    async def _deregister(self, address: str) -> None:
        """Drop from discovery; the router's pool listener then evicts the
        breaker/poller state so churned replicas don't leak."""
        self.pool.remove(address)

    async def _retire_one(self, address: str, reason: str) -> None:
        handle = self.replicas.get(address)
        if handle is None:
            return
        if self.resilience is not None:  # stop new picks immediately
            self.resilience.set_draining(address, True)
        await self._drain(address)
        await self._deregister(address)
        del self.replicas[address]
        await self.launcher.stop(handle)
        if self.flight is not None:
            self.flight.record_system(
                "pool_scale_down", endpoint=address, reason=reason,
                replicas=len(self.replicas))

    async def _drain(self, address: str) -> None:
        if self._session is None:
            return
        try:
            r = await self._session.request(
                "POST", f"http://{address}/drain"
                f"?timeout_s={self.cfg.drain_timeout_s}",
                timeout=self.cfg.drain_timeout_s + 2.0)
            await r.read()
        except Exception:
            pass  # a dead replica can't drain; retire proceeds

    # ---------------------------------------------------------- self-healing
    async def _health_sweep(self) -> None:
        """Retire replicas whose /health stopped answering (killed, not
        drained). The reconcile that follows replaces them."""
        if self._session is None or not self.replicas:
            return

        async def probe(address: str) -> tuple[str, bool, str]:
            """Returns (address, healthy, detail). A 5xx body's structured
            reason (engine_stalled / fabric_dead from the device watchdog,
            obs/device.py) rides along so the retirement event says WHY the
            replica died, not just that it did."""
            try:
                r = await self._session.request(
                    "GET", f"http://{address}/health",
                    timeout=self.cfg.health_timeout_s)
                try:
                    detail = ""
                    if r.status >= 500:
                        try:
                            body = await r.json()
                            detail = str(body.get("reason")
                                         or body.get("status") or "")
                        except Exception:
                            detail = ""
                    else:
                        await r.read()
                    return address, r.status < 500, detail
                finally:
                    r.close()
            except Exception:
                return address, False, "unreachable"

        results = await asyncio.gather(*(probe(a) for a in list(self.replicas)))
        dead = [(a, detail) for a, ok, detail in results if not ok]
        if not dead:
            return
        async with self._lock:
            for address, detail in dead:
                handle = self.replicas.pop(address, None)
                if handle is None:
                    continue
                await self._deregister(address)
                try:
                    await self.launcher.kill(handle)
                except Exception:
                    pass
                if self.families is not None:
                    self.families.scale_decisions.labels(
                        reason="replica_dead").inc()
                if self.flight is not None:
                    self.flight.record_system(
                        "pool_scale_down", endpoint=address,
                        reason="replica_dead", detail=detail or "no_response",
                        replicas=len(self.replicas))
            self.variant.current_replicas = len(self.replicas)

    # ---------------------------------------------------------------- status
    def status(self) -> dict:
        return {
            "model": self.cfg.model,
            "desired_replicas": self.variant.desired_replicas,
            "ready_replicas": len(self.replicas),
            "replicas": sorted(self.replicas),
            "launches": [
                {"kind": r.kind, "seconds": round(r.seconds, 3),
                 "address": r.address}
                for r in self.launch_records],
        }
