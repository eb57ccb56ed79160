"""Distributed tracing, OTel-shaped and dependency-free (copy of
``llmd_tpu/obs/tracing.py``: the same spans, ids, sampler, exporters and
environment knobs, so a port engine joins the traces a router starts).

- ``Tracer.start_span(name, parent=ctx)`` returns a ``Span`` (a context
  manager) with attributes, events and a status; span and trace ids are W3C
  hex.
- Propagation: ``extract_traceparent(headers)`` / ``span.traceparent()``;
  any hop that forwards the header joins the trace.
- Sampling: parent-based trace-id ratio. A sampled parent forces sampling; a
  root samples iff ``trace_id mod 2^56 < ratio * 2^56`` (deterministic per
  trace, as OTel's TraceIdRatioBased).
- Export: ``memory`` (tests), ``jsonl`` (one OTLP-flavoured span per line),
  ``otlp`` (an HTTP POST of OTLP/JSON to ``<endpoint>/v1/traces`` through one
  background worker draining a bounded queue: a slow or absent collector
  drops spans and counts them in ``spans_dropped``), or ``none``.

Environment: ``LLMD_OTEL_EXPORTER``, ``LLMD_OTEL_ENDPOINT``,
``LLMD_OTEL_SAMPLE_RATIO``, ``LLMD_OTEL_JSONL_PATH``, ``OTEL_SERVICE_NAME``.
"""

from __future__ import annotations

import json
import os
import queue
import random
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Optional

_TRACE_ID_BITS = 128
_RATIO_BITS = 56  # OTel TraceIdRatioBased compares the low 56 bits


def _rand_hex(nbytes: int) -> str:
    return random.getrandbits(nbytes * 8).to_bytes(nbytes, "big").hex()


@dataclass
class SpanContext:
    trace_id: str  # 32 hex chars
    span_id: str   # 16 hex chars
    sampled: bool


def extract_traceparent(headers: dict) -> Optional[SpanContext]:
    """Parse a W3C `traceparent: 00-<trace>-<span>-<flags>` header (case-insensitive
    lookup). Returns None for absent or malformed values."""
    raw = None
    for k, v in headers.items():
        if k.lower() == "traceparent":
            raw = v
            break
    if not raw:
        return None
    parts = raw.strip().split("-")
    if len(parts) != 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
        return None
    try:
        int(parts[1], 16), int(parts[2], 16)
        flags = int(parts[3], 16)
    except ValueError:
        return None
    if int(parts[1], 16) == 0 or int(parts[2], 16) == 0:
        return None
    return SpanContext(trace_id=parts[1], span_id=parts[2], sampled=bool(flags & 1))


def format_traceparent(ctx: SpanContext) -> str:
    return f"00-{ctx.trace_id}-{ctx.span_id}-{'01' if ctx.sampled else '00'}"


@dataclass
class Span:
    name: str
    tracer: "Tracer"
    context: SpanContext
    parent_span_id: Optional[str] = None
    start_ns: int = 0
    end_ns: int = 0
    attributes: dict[str, Any] = field(default_factory=dict)
    events: list[dict] = field(default_factory=list)
    status: str = "OK"

    def set_attribute(self, key: str, value: Any) -> "Span":
        self.attributes[key] = value
        return self

    def add_event(self, name: str, **attrs: Any) -> None:
        self.events.append({"name": name, "time_ns": time.time_ns(),
                            "attributes": attrs})

    def set_error(self, message: str) -> None:
        self.status = "ERROR"
        self.attributes["error.message"] = message

    def traceparent(self) -> str:
        return format_traceparent(self.context)

    def end(self) -> None:
        if self.end_ns:
            return
        self.end_ns = time.time_ns()
        if self.context.sampled:
            self.tracer._export(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc is not None:
            self.set_error(f"{type(exc).__name__}: {exc}")
        self.end()

    def to_otlp(self) -> dict:
        """One span in OTLP/JSON field naming."""
        return {
            "traceId": self.context.trace_id,
            "spanId": self.context.span_id,
            "parentSpanId": self.parent_span_id or "",
            "name": self.name,
            "startTimeUnixNano": str(self.start_ns),
            "endTimeUnixNano": str(self.end_ns),
            "attributes": [
                {"key": k, "value": {"stringValue": str(v)}}
                for k, v in self.attributes.items()
            ],
            "events": [
                {"name": e["name"], "timeUnixNano": str(e["time_ns"]),
                 "attributes": [{"key": k, "value": {"stringValue": str(v)}}
                                for k, v in e["attributes"].items()]}
                for e in self.events
            ],
            "status": {"code": 2 if self.status == "ERROR" else 1},
        }


@dataclass
class TracingConfig:
    enabled: bool = False
    service_name: str = "llmd-tpu"
    sample_ratio: float = 0.1       # reference prod default (tracing.md)
    exporter: str = "memory"        # none | memory | jsonl | otlp
    jsonl_path: Optional[str] = None
    otlp_endpoint: Optional[str] = None  # e.g. http://collector:4318

    @classmethod
    def from_env(cls) -> "TracingConfig":
        exporter = os.environ.get("LLMD_OTEL_EXPORTER", "")
        return cls(
            enabled=bool(exporter),
            service_name=os.environ.get("OTEL_SERVICE_NAME", "llmd-tpu"),
            sample_ratio=float(os.environ.get("LLMD_OTEL_SAMPLE_RATIO", "0.1")),
            exporter=exporter or "none",
            jsonl_path=os.environ.get("LLMD_OTEL_JSONL_PATH"),
            otlp_endpoint=os.environ.get("LLMD_OTEL_ENDPOINT"),
        )


class Tracer:
    # bound on spans waiting for the OTLP worker; past it spans are dropped
    # (and counted) rather than buffered without limit
    OTLP_QUEUE_MAX = 1024

    def __init__(self, cfg: Optional[TracingConfig] = None) -> None:
        self.cfg = cfg or TracingConfig()
        self.spans: list[Span] = []  # memory exporter sink
        self._lock = threading.Lock()
        self._jsonl_file = None
        self.export_errors = 0
        self.spans_dropped = 0  # otlp queue overflow (guarded by _lock)
        self._otlp_queue: "queue.Queue[Optional[Span]]" = queue.Queue(
            maxsize=self.OTLP_QUEUE_MAX)
        self._otlp_worker: Optional[threading.Thread] = None

    # ------------------------------------------------------------- sampling
    def _sample_root(self, trace_id: str) -> bool:
        """TraceIdRatioBased: deterministic on the low 56 bits of the trace id."""
        if self.cfg.sample_ratio >= 1.0:
            return True
        if self.cfg.sample_ratio <= 0.0:
            return False
        low = int(trace_id, 16) & ((1 << _RATIO_BITS) - 1)
        return low < int(self.cfg.sample_ratio * (1 << _RATIO_BITS))

    # ---------------------------------------------------------------- spans
    def start_span(self, name: str, parent: Optional[SpanContext] = None,
                   **attributes: Any) -> Span:
        if parent is not None:
            # parentbased: inherit the parent's decision (tracing.md sampler)
            trace_id, sampled = parent.trace_id, parent.sampled
            parent_span_id = parent.span_id
        else:
            trace_id = _rand_hex(16)
            sampled = self.cfg.enabled and self._sample_root(trace_id)
            parent_span_id = None
        span = Span(
            name=name, tracer=self,
            context=SpanContext(trace_id=trace_id, span_id=_rand_hex(8),
                                sampled=sampled and self.cfg.enabled),
            parent_span_id=parent_span_id,
            start_ns=time.time_ns(),
        )
        span.attributes.update(attributes)
        span.attributes.setdefault("service.name", self.cfg.service_name)
        return span

    # --------------------------------------------------------------- export
    def _export(self, span: Span) -> None:
        mode = self.cfg.exporter
        if mode == "none" or not self.cfg.enabled:
            return
        if mode == "memory":
            with self._lock:
                self.spans.append(span)
                if len(self.spans) > 10_000:
                    del self.spans[:5_000]
            return
        if mode == "jsonl":
            try:
                with self._lock:
                    if self._jsonl_file is None:
                        self._jsonl_file = open(
                            self.cfg.jsonl_path or os.path.join(
                                tempfile.gettempdir(), "llmd-traces.jsonl"), "a")
                    self._jsonl_file.write(json.dumps(span.to_otlp()) + "\n")
                    self._jsonl_file.flush()
            except OSError:
                self.export_errors += 1
            return
        if mode == "otlp":
            self._enqueue_otlp(span)

    def _enqueue_otlp(self, span: Optional[Span]) -> None:
        """Hand a span to the single OTLP worker (started lazily on first
        export). One daemon thread per *tracer*, not per span: under load the
        old per-span threads piled up behind a slow collector without bound.
        A full queue drops the span and counts it — export is best-effort,
        the serving path never blocks on the collector."""
        with self._lock:
            if self._otlp_worker is None:
                self._otlp_worker = threading.Thread(
                    target=self._otlp_drain, name="llmd-otlp-export",
                    daemon=True)
                self._otlp_worker.start()
        try:
            self._otlp_queue.put_nowait(span)
        except queue.Full:
            with self._lock:
                self.spans_dropped += 1

    def _otlp_drain(self) -> None:
        while True:
            span = self._otlp_queue.get()
            if span is None:  # close() sentinel
                return
            self._post_otlp(span)

    def _post_otlp(self, span: Span) -> None:
        """Fire-and-forget OTLP/JSON POST (collector absent → counted, dropped)."""
        import urllib.request

        payload = json.dumps({
            "resourceSpans": [{
                "resource": {"attributes": [{
                    "key": "service.name",
                    "value": {"stringValue": self.cfg.service_name}}]},
                "scopeSpans": [{"scope": {"name": "llmd-tpu"},
                                "spans": [span.to_otlp()]}],
            }]
        }).encode()
        try:
            req = urllib.request.Request(
                f"{self.cfg.otlp_endpoint}/v1/traces", data=payload,
                headers={"Content-Type": "application/json"})
            urllib.request.urlopen(req, timeout=2).close()
        except Exception:
            self.export_errors += 1

    def close(self) -> None:
        with self._lock:
            if self._jsonl_file is not None:
                self._jsonl_file.close()
                self._jsonl_file = None
            worker = self._otlp_worker
            self._otlp_worker = None
        if worker is not None:
            try:
                self._otlp_queue.put_nowait(None)  # wake + stop the drain
            except queue.Full:
                pass  # worker is far behind; daemon thread dies with us
            worker.join(timeout=2.0)


_GLOBAL: Optional[Tracer] = None


def global_tracer() -> Tracer:
    """Process-wide tracer bootstrapped from env (reference OTEL_* knobs)."""
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = Tracer(TracingConfig.from_env())
    return _GLOBAL
