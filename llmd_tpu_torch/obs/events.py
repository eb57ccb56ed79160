"""Per-request flight recorder: bounded, always-on lifecycle timelines (copy
of ``llmd_tpu/obs/events.py``: the same catalog, record shape, bounds, tail
capture and ``/debug/requests`` bodies).

Traces sample, so the tail request an operator needs is usually one that was
not sampled. The recorder is the layer between aggregate metrics and sampled
spans: every request gets a structured event timeline (arrival, admission,
prefill and decode progress, preemption, KV offload, reload and pull,
retirement) held in a lock-protected ring with hard memory bounds, queryable
live at ``/debug/requests``.

Bounds (environment):

* ``LLMD_FLIGHT_MAX_REQUESTS``: ring capacity; the oldest record that is not
  retained is evicted past it.
* ``LLMD_FLIGHT_MAX_EVENTS``: per-request event cap; excess events count in
  ``events_dropped`` (terminal events always land).
* ``LLMD_FLIGHT_SLO_MS``: tail capture. A request finishing slower than this
  is retained past ring eviction and force-sampled into the tracer (a
  ``flight.slo_breach`` span carrying the timeline exports even when the
  sampler said no).
* ``LLMD_FLIGHT_TAIL_KEEP``: cap on retained records.

Threading: engine events come from the engine-loop thread and ``/debug``
reads from the HTTP threads; every mutation and snapshot takes the recorder
lock.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional

__all__ = ["EVENT_CATALOG", "FlightRecorder", "RequestRecord",
           "debug_list_response", "debug_detail_response"]

# The event-name catalog, equal to the reference's (router and pool names
# included, so the two can be compared); tests/test_torch_flight.py holds it
# and every name the port emits against it.
EVENT_CATALOG = (
    # router plane
    "arrival",
    "flow_enqueue",
    "flow_dispatch",
    "flow_reject",
    "routing_decision",
    "route_decision",
    "kv_pull_stamped",
    "forward",
    "response",
    "rejected",
    "error",
    # router resilience plane (router/resilience.py + server retry loop)
    "deadline_exceeded",
    "retry",
    "hedge",
    "breaker_open",
    "breaker_close",
    "slo_breach",
    # engine plane
    "admitted",
    "prefill_start",
    "prefill_end",
    "first_token",
    "decode",
    "chain_dispatch",
    "chain_retire",
    "spec_draft",
    "spec_verify",
    "structured_compile",
    "structured_mask",
    "preempted",
    "kv_reload",
    "kv_offload",
    "kv_pull",
    "kv_flush",
    "kv_durable_get",
    "retired",
    "aborted",
    "drain_start",
    "drain_done",
    # pool plane (pool/controller.py replica lifecycle; system events —
    # replica churn has no owning request)
    "pool_scale_up",
    "pool_scale_down",
    "pool_warm_start",
    # device plane (obs/device.py DeviceMonitor; system events — a hung TPU
    # or wedged fabric has no owning request either)
    "engine_stalled",
    "engine_recovered",
    "fabric_dead",
    "fabric_recovered",
    "profile_capture",
)

_TERMINAL_STATUS = {"finished", "aborted", "rejected", "error"}


class RequestRecord:
    """One request's timeline. Mutated only under the recorder lock."""

    __slots__ = ("request_id", "model", "trace_id", "tenant", "status",
                 "t0_mono", "t0_wall", "events", "events_dropped",
                 "finish_reason", "e2e_s", "retained")

    def __init__(self, request_id: str, model: str, trace_id: str,
                 tenant: str = "") -> None:
        self.request_id = request_id
        self.model = model
        self.trace_id = trace_id
        self.tenant = tenant
        self.status = "active"
        self.t0_mono = time.monotonic()
        self.t0_wall = time.time()
        self.events: List[dict] = []
        self.events_dropped = 0
        self.finish_reason: Optional[str] = None
        self.e2e_s: Optional[float] = None
        self.retained = False

    def latency_s(self) -> float:
        """Final e2e for finished records, age-so-far for active ones."""
        if self.e2e_s is not None:
            return self.e2e_s
        return time.monotonic() - self.t0_mono

    def summary(self) -> dict:
        return {
            "request_id": self.request_id,
            "model": self.model,
            "trace_id": self.trace_id,
            "tenant": self.tenant,
            "status": self.status,
            "start_unix": round(self.t0_wall, 3),
            "latency_ms": round(self.latency_s() * 1e3, 3),
            "finish_reason": self.finish_reason,
            "n_events": len(self.events),
            "events_dropped": self.events_dropped,
            "retained": self.retained,
        }

    def to_dict(self) -> dict:
        d = self.summary()
        d["events"] = list(self.events)
        return d


class FlightRecorder:
    """Lock-protected ring buffer of per-request event timelines."""

    def __init__(self, max_requests: int = 512, max_events: int = 256,
                 slo_ms: float = 0.0, tail_keep: int = 64,
                 tracer=None) -> None:
        self.max_requests = max(1, int(max_requests))
        self.max_events = max(1, int(max_events))
        self.slo_ms = float(slo_ms)
        self.tail_keep = max(0, int(tail_keep))
        self.tracer = tracer
        # Owner-set retire hook: called with the finished record's to_dict()
        # AFTER the lock is released (the attribution exporter hangs here).
        self.on_finish = None
        self._lock = threading.Lock()
        self._records: "OrderedDict[str, RequestRecord]" = OrderedDict()
        # non-request-scoped events (offload-tier demotions etc.)
        self._system: deque = deque(maxlen=256)

    @classmethod
    def from_env(cls, tracer=None) -> "FlightRecorder":
        return cls(
            max_requests=int(os.environ.get("LLMD_FLIGHT_MAX_REQUESTS", "512")),
            max_events=int(os.environ.get("LLMD_FLIGHT_MAX_EVENTS", "256")),
            slo_ms=float(os.environ.get("LLMD_FLIGHT_SLO_MS", "0")),
            tail_keep=int(os.environ.get("LLMD_FLIGHT_TAIL_KEEP", "64")),
            tracer=tracer,
        )

    # ------------------------------------------------------------- recording
    def start(self, request_id: str, model: str = "",
              trace_id: str = "", tenant: str = "") -> None:
        """Open a record (idempotent: a re-start keeps the existing timeline
        but backfills model/trace/tenant if the first opener didn't know
        them)."""
        with self._lock:
            rec = self._records.get(request_id)
            if rec is not None:
                rec.model = rec.model or model
                rec.trace_id = rec.trace_id or trace_id
                rec.tenant = rec.tenant or tenant
                return
            self._records[request_id] = RequestRecord(request_id, model,
                                                      trace_id, tenant)
            self._evict_locked()

    def record(self, request_id: str, event: str, **attrs: Any) -> None:
        """Append one timestamped event; unknown request ids are a no-op (the
        emitter must never crash the step loop over a missed start)."""
        with self._lock:
            rec = self._records.get(request_id)
            if rec is None:
                return
            self._append_locked(rec, event, attrs, force=False)

    def record_system(self, event: str, **attrs: Any) -> None:
        """Events with no owning request (batch offload demotions)."""
        entry = {"event": event, "t_unix": round(time.time(), 3)}
        entry.update(attrs)
        with self._lock:
            self._system.append(entry)

    def finish(self, request_id: str, event: str = "retired",
               status: str = "finished", **attrs: Any) -> None:
        """Terminal transition: records ``event`` (bypassing the per-request
        cap), stamps e2e latency, and applies SLO tail capture."""
        breach: Optional[RequestRecord] = None
        finished: Optional[dict] = None
        with self._lock:
            rec = self._records.get(request_id)
            if rec is None or rec.status in _TERMINAL_STATUS:
                return
            rec.status = status if status in _TERMINAL_STATUS else "finished"
            rec.e2e_s = time.monotonic() - rec.t0_mono
            rec.finish_reason = str(attrs.get("reason", "")) or rec.finish_reason
            self._append_locked(rec, event, attrs, force=True)
            if self.slo_ms > 0 and rec.e2e_s * 1e3 >= self.slo_ms:
                rec.retained = True
                self._trim_tail_locked()
                breach = rec
            if self.on_finish is not None:
                finished = rec.to_dict()
        if breach is not None:
            self._force_trace(breach)
        if finished is not None:
            try:
                self.on_finish(finished)
            except Exception:
                pass  # exporters must never take down retirement

    # --------------------------------------------------------------- queries
    def get(self, request_id: str) -> Optional[dict]:
        with self._lock:
            rec = self._records.get(request_id)
            return rec.to_dict() if rec is not None else None

    def snapshot(self, status: Optional[str] = None,
                 model: Optional[str] = None,
                 min_latency_ms: Optional[float] = None,
                 trace_id: Optional[str] = None,
                 limit: int = 100) -> List[dict]:
        """Newest-first summaries, filtered by status/model/min-latency/
        trace id (the trace filter is how a sampled span is correlated back
        to its full flight timeline — see tools/dump_flight.py --trace)."""
        with self._lock:
            recs = list(self._records.values())
        out = []
        for rec in reversed(recs):
            if status and rec.status != status:
                continue
            if model and rec.model != model:
                continue
            if trace_id and rec.trace_id != trace_id:
                continue
            if min_latency_ms is not None and rec.latency_s() * 1e3 < min_latency_ms:
                continue
            out.append(rec.summary())
            if len(out) >= max(1, limit):
                break
        return out

    def system_events(self) -> List[dict]:
        with self._lock:
            return list(self._system)

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    # ------------------------------------------------------------- internals
    def _append_locked(self, rec: RequestRecord, event: str, attrs: dict,
                       force: bool) -> None:
        if not force and len(rec.events) >= self.max_events:
            rec.events_dropped += 1
            return
        entry: Dict[str, Any] = {
            "event": event,
            "t_ms": round((time.monotonic() - rec.t0_mono) * 1e3, 3),
        }
        for k, v in attrs.items():
            if v is not None:
                entry[k] = v
        rec.events.append(entry)

    def _evict_locked(self) -> None:
        """Ring semantics: drop the oldest non-retained record. Tail-captured
        records survive eviction (that's the point of tail capture); if
        somehow everything is retained, the oldest goes anyway — the memory
        bound is hard."""
        while len(self._records) > self.max_requests:
            victim = next(
                (rid for rid, r in self._records.items() if not r.retained),
                None,
            )
            if victim is None:
                self._records.popitem(last=False)
            else:
                del self._records[victim]

    def _trim_tail_locked(self) -> None:
        retained = [rid for rid, r in self._records.items() if r.retained]
        while len(retained) > self.tail_keep:
            del self._records[retained.pop(0)]

    def _force_trace(self, rec: RequestRecord) -> None:
        """Force-sample an SLO breach into the tracer: export a synthetic
        ``flight.slo_breach`` span carrying the timeline even when the
        head-based sampler dropped the trace — Grafana's exemplar jump then
        always lands on a trace for the slow tail."""
        tracer = self.tracer
        if tracer is None or not getattr(tracer.cfg, "enabled", False):
            return
        try:
            from llmd_tpu_torch.obs.tracing import Span, SpanContext, _rand_hex

            trace_id = rec.trace_id or _rand_hex(16)
            span = Span(
                name="flight.slo_breach", tracer=tracer,
                context=SpanContext(trace_id=trace_id, span_id=_rand_hex(8),
                                    sampled=True),
                start_ns=int(rec.t0_wall * 1e9),
            )
            span.attributes.update({
                "service.name": tracer.cfg.service_name,
                "llm_d.request_id": rec.request_id,
                "llm_d.model": rec.model,
                "llm_d.e2e_ms": round((rec.e2e_s or 0.0) * 1e3, 3),
                "llm_d.slo_ms": self.slo_ms,
                "llm_d.finish_reason": rec.finish_reason or "",
            })
            for ev in rec.events[:64]:
                span.events.append({
                    "name": ev["event"],
                    "time_ns": int((rec.t0_wall + ev["t_ms"] / 1e3) * 1e9),
                    "attributes": {k: v for k, v in ev.items()
                                   if k not in ("event", "t_ms")},
                })
            span.end()
        except Exception:
            pass  # tail capture must never take down the serving path


# --------------------------------------------------------------------------
# The /debug handler bodies: the reference's query contract, so
# tools/dump_flight.py renders a port engine's output as it renders a JAX one's.
# --------------------------------------------------------------------------


def debug_list_response(flight: FlightRecorder, query) -> tuple:
    """``GET /debug/requests`` body: (http_status, payload). Query params:
    ``status``, ``model``, ``min_latency_ms``, ``trace``, ``limit``."""
    try:
        min_ms = (float(query["min_latency_ms"])
                  if "min_latency_ms" in query else None)
        limit = int(query.get("limit", "100"))
    except (TypeError, ValueError):
        return 400, {"error": "min_latency_ms/limit must be numeric"}
    return 200, {
        "requests": flight.snapshot(
            status=query.get("status") or None,
            model=query.get("model") or None,
            min_latency_ms=min_ms,
            trace_id=query.get("trace") or None,
            limit=limit),
        "system": flight.system_events(),
    }


def debug_detail_response(flight: FlightRecorder, request_id: str) -> tuple:
    """``GET /debug/requests/<id>`` body: (http_status, payload). The detail
    view embeds the phase-attribution ledger so "where did the time go" is
    answerable from the same fetch as "what happened", and the decision
    ledger so "why did we route here, and was it right" comes with it."""
    rec = flight.get(request_id)
    if rec is None:
        return 404, {"error": f"unknown request id {request_id!r}"}
    try:
        from llmd_tpu_torch.obs.attribution import build_ledger

        rec["phase_ledger"] = build_ledger(rec)
    except Exception:
        pass
    try:
        from llmd_tpu_torch.obs.decisions import build_decision

        decision = build_decision(rec)
        if decision is not None:
            rec["decision"] = decision
    except Exception:
        pass
    return 200, rec
