"""Flow control: pool defense by priority bands, fairness, ordering and a
saturation gate (copy of ``llmd_tpu/router/flowcontrol.py``).

- FlowKey = (fairness id, priority); dispatch goes priority, then fairness,
  then ordering; a band is bounded by ``maxBytes`` / ``maxRequests`` and a TTL.
- Fairness: round-robin or global-strict; ordering: fcfs, edf or
  slo-deadline.
- A saturation detector (utilization by default, or concurrency) holds the
  dispatch loop.
- Queues live in memory only; ``core.request.RequestOutcome`` maps outcomes
  onto HTTP codes (429 / 503 / 500 / 504).
"""

from __future__ import annotations

import asyncio
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Any, Callable, Optional

from llmd_tpu_torch.core.config import FlowControlSpec, PriorityBandSpec
from llmd_tpu_torch.core.endpoint import EndpointPool
from llmd_tpu_torch.core.metrics_contract import StdMetric
from llmd_tpu_torch.core.request import InferenceRequest, RequestOutcome


@dataclass
class QueuedItem:
    req: InferenceRequest
    enqueue_time: float
    future: asyncio.Future  # resolves to RequestOutcome
    byte_size: int

    def deadline(self) -> float:
        """EDF deadline: SLO-TTFT if present, else arrival+TTL ordering proxy."""
        if self.req.slo_ttft_ms is not None:
            return self.req.arrival_time + self.req.slo_ttft_ms / 1000.0
        return self.enqueue_time + 3600.0


class SaturationDetector:
    def saturated(self, pool: EndpointPool) -> bool:
        raise NotImplementedError


class UtilizationDetector(SaturationDetector):
    """Saturated when every endpoint is above kv-util or queue thresholds
    (flow-control.md utilization-detector defaults)."""

    def __init__(self, kv_threshold: float = 0.95, queue_threshold: int = 5) -> None:
        self.kv_threshold = kv_threshold
        self.queue_threshold = queue_threshold

    def saturated(self, pool: EndpointPool) -> bool:
        eps = pool.list()
        if not eps:
            return True
        return all(
            e.metric(StdMetric.KV_UTILIZATION) >= self.kv_threshold
            or e.metric(StdMetric.QUEUED_REQUESTS) >= self.queue_threshold
            for e in eps
        )


class ConcurrencyDetector(SaturationDetector):
    def __init__(self, max_inflight_per_endpoint: int = 64,
                 inflight: Optional[dict[str, int]] = None) -> None:
        self.limit = max_inflight_per_endpoint
        self.inflight = inflight if inflight is not None else {}

    def saturated(self, pool: EndpointPool) -> bool:
        eps = pool.list()
        if not eps:
            return True
        return all(self.inflight.get(e.address, 0) >= self.limit for e in eps)


DETECTORS: dict[str, Callable[..., SaturationDetector]] = {
    "utilization-detector": UtilizationDetector,
    "concurrency-detector": ConcurrencyDetector,
}


class PriorityBand:
    """One priority level: per-fairness-id flow queues + fairness + ordering policy."""

    def __init__(self, spec: PriorityBandSpec) -> None:
        self.spec = spec
        self.flows: OrderedDict[str, deque[QueuedItem]] = OrderedDict()
        self.bytes = 0
        self.count = 0

    def over_capacity(self, item_bytes: int) -> bool:
        return (self.count + 1 > self.spec.max_requests
                or self.bytes + item_bytes > self.spec.max_bytes)

    def push(self, item: QueuedItem) -> None:
        fid = item.req.fairness_id
        q = self.flows.get(fid)
        if q is None:
            q = self.flows[fid] = deque()
        q.append(item)
        self.bytes += item.byte_size
        self.count += 1

    def _order_key(self, item: QueuedItem) -> float:
        if self.spec.ordering_policy == "fcfs":
            return item.enqueue_time
        if self.spec.ordering_policy in ("edf", "slo-deadline"):
            return item.deadline()
        return item.enqueue_time

    def pop(self) -> Optional[QueuedItem]:
        """Fairness across flows, ordering within the chosen flow."""
        while self.flows:
            if self.spec.fairness_policy == "global-strict":
                # globally best item across all flows by ordering key
                best_fid, best_item = None, None
                for fid, q in self.flows.items():
                    if not q:
                        continue
                    cand = min(q, key=self._order_key)
                    if best_item is None or self._order_key(cand) < self._order_key(best_item):
                        best_fid, best_item = fid, cand
                if best_item is None:
                    return None
                self.flows[best_fid].remove(best_item)
                if not self.flows[best_fid]:
                    del self.flows[best_fid]
                item = best_item
            else:  # round-robin over flows
                fid, q = next(iter(self.flows.items()))
                self.flows.move_to_end(fid)
                if not q:
                    del self.flows[fid]
                    continue
                item = min(q, key=self._order_key) if self.spec.ordering_policy != "fcfs" else q[0]
                q.remove(item)
                if not q:
                    del self.flows[fid]
            self.bytes -= item.byte_size
            self.count -= 1
            return item
        return None

    def evict_expired(self, now: float) -> list[tuple[QueuedItem, str]]:
        """Drop TTL-expired and deadline-expired items; returns (item, why)
        with why in {"ttl", "deadline"}. A request whose client budget ran
        out while queued must NOT dispatch with a stale budget — it gets a
        504 here instead of timing out downstream after wasting an endpoint."""
        out: list[tuple[QueuedItem, str]] = []
        for fid in list(self.flows):
            q = self.flows[fid]
            keep: deque[QueuedItem] = deque()
            for item in q:
                dl = item.req.deadline()
                if dl is not None and now >= dl:
                    out.append((item, "deadline"))
                elif now - item.enqueue_time > self.spec.ttl_s:
                    out.append((item, "ttl"))
                else:
                    keep.append(item)
                    continue
                self.bytes -= item.byte_size
                self.count -= 1
            if keep:
                self.flows[fid] = keep
            else:
                del self.flows[fid]
        return out


class FlowController:
    """EnqueueAndWait front + saturation-gated dispatch worker (flow-control.md:258-295)."""

    def __init__(self, spec: FlowControlSpec, pool: EndpointPool,
                 ctx: Optional[dict[str, Any]] = None) -> None:
        self.spec = spec
        self.pool = pool
        if not spec.bands:
            spec.bands = [PriorityBandSpec(priority=0, name="default")]
        # higher priority value = more important; dispatch highest first
        self.bands: dict[int, PriorityBand] = {
            b.priority: PriorityBand(b) for b in spec.bands
        }
        det_cls = DETECTORS.get(spec.saturation_detector, UtilizationDetector)
        if spec.saturation_detector == "concurrency-detector":
            self.detector = det_cls(inflight=(ctx or {}).get("inflight_requests"))
        else:
            self.detector = det_cls()
        self._task: Optional[asyncio.Task] = None
        self._wake = asyncio.Event()
        self.metrics = {
            "enqueued_total": 0, "dispatched_total": 0, "rejected_capacity_total": 0,
            "evicted_ttl_total": 0, "evicted_deadline_total": 0, "queue_depth": 0,
        }
        # obs.metrics Histogram observing enqueue→dispatch wait; attached by
        # the router (llm_d_epp_flow_queue_wait_seconds), None standalone
        self.queue_wait_histogram = None
        # obs.events FlightRecorder; attached by the router, None standalone
        self.flight = None
        self._shutdown = False

    # -- API ---------------------------------------------------------------
    async def enqueue_and_wait(self, req: InferenceRequest) -> RequestOutcome:
        rem = req.remaining_s()
        if rem is not None and rem <= 0:
            # budget already spent before queueing (tiny client timeout or a
            # slow parse): don't occupy queue capacity just to evict it later
            self.metrics["evicted_deadline_total"] += 1
            if self.flight is not None:
                self.flight.record(req.request_id, "deadline_exceeded",
                                   where="flow_enqueue")
            return RequestOutcome.EVICTED_DEADLINE
        band = self.bands.get(req.priority)
        if band is None:
            # snap to nearest lower band, else lowest
            lower = [p for p in self.bands if p <= req.priority]
            band = self.bands[max(lower)] if lower else self.bands[min(self.bands)]
        size = req.byte_size or 1024
        if band.over_capacity(size):
            self.metrics["rejected_capacity_total"] += 1
            if self.flight is not None:
                self.flight.record(req.request_id, "flow_reject",
                                   reason="capacity", band=band.spec.name)
            return RequestOutcome.REJECTED_CAPACITY
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        band.push(QueuedItem(req=req, enqueue_time=time.monotonic(), future=fut, byte_size=size))
        self.metrics["enqueued_total"] += 1
        if self.flight is not None:
            self.flight.record(req.request_id, "flow_enqueue",
                               priority=req.priority, band=band.spec.name,
                               queue_depth=self._total_queued(),
                               tenant=req.tenant or None)
        self._wake.set()
        return await fut

    async def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._dispatch_loop())

    async def stop(self) -> None:
        self._shutdown = True
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
        for band in self.bands.values():
            while (item := band.pop()) is not None:
                if not item.future.done():
                    item.future.set_result(RequestOutcome.EVICTED_SHUTDOWN)

    # -- worker ------------------------------------------------------------
    def _total_queued(self) -> int:
        return sum(b.count for b in self.bands.values())

    async def _dispatch_loop(self) -> None:
        while True:
            if self._total_queued() == 0:
                self._wake.clear()
                await self._wake.wait()
            now = time.monotonic()
            for band in self.bands.values():
                for item, why in band.evict_expired(now):
                    if why == "deadline":
                        self.metrics["evicted_deadline_total"] += 1
                        if self.flight is not None:
                            self.flight.record(
                                item.req.request_id, "deadline_exceeded",
                                where="flow_control",
                                waited_ms=round((now - item.enqueue_time) * 1e3, 3))
                        if not item.future.done():
                            item.future.set_result(RequestOutcome.EVICTED_DEADLINE)
                        continue
                    self.metrics["evicted_ttl_total"] += 1
                    if self.flight is not None:
                        self.flight.record(
                            item.req.request_id, "flow_reject", reason="ttl",
                            waited_ms=round((now - item.enqueue_time) * 1e3, 3))
                    if not item.future.done():
                        item.future.set_result(RequestOutcome.EVICTED_TTL)
            if self.detector.saturated(self.pool):
                await asyncio.sleep(0.01)  # hold dispatch while pool is saturated
                continue
            item = None
            for prio in sorted(self.bands, reverse=True):
                item = self.bands[prio].pop()
                if item is not None:
                    break
            if item is None:
                continue
            self.metrics["dispatched_total"] += 1
            self.metrics["queue_depth"] = self._total_queued()
            if self.queue_wait_histogram is not None:
                self.queue_wait_histogram.observe(
                    time.monotonic() - item.enqueue_time)
            if self.flight is not None:
                self.flight.record(
                    item.req.request_id, "flow_dispatch",
                    wait_ms=round((time.monotonic() - item.enqueue_time) * 1e3, 3))
            if not item.future.done():
                item.future.set_result(RequestOutcome.DISPATCHED)
            await asyncio.sleep(0)  # yield so dispatched request can start
