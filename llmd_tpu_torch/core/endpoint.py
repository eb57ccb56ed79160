"""Endpoint and its thread-safe typed attribute map, the router's unit of state
(copy of ``llmd_tpu/core/endpoint.py``).

Each endpoint (one per ``host:port``; data-parallel ranks are distinct endpoints)
carries an attribute map written by the data layer's extractors and read by the
scheduler's plugins. ``EndpointPool`` is the live set, with add / remove
listeners.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Optional


class EndpointRole(str, Enum):
    BOTH = "both"
    PREFILL = "prefill"
    DECODE = "decode"


class AttributeMap:
    """Thread-safe typed attribute store (datalayer.md 'Attribute' runtime)."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._data: dict[str, Any] = {}
        self._stamp: dict[str, float] = {}

    def put(self, key: str, value: Any) -> None:
        with self._lock:
            self._data[key] = value
            self._stamp[key] = time.monotonic()

    def get(self, key: str, default: Any = None) -> Any:
        with self._lock:
            return self._data.get(key, default)

    def age(self, key: str) -> float:
        """Seconds since `key` was last written; +inf if never."""
        with self._lock:
            ts = self._stamp.get(key)
        return float("inf") if ts is None else time.monotonic() - ts

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            return dict(self._data)


@dataclass
class Endpoint:
    """A routable model-server endpoint (pod/rank)."""

    address: str  # "ip:port"
    name: str = ""
    role: EndpointRole = EndpointRole.BOTH
    labels: dict[str, str] = field(default_factory=dict)
    engine_type: str = "llmd-tpu"  # llm-d.ai/engine-type label analogue
    attrs: AttributeMap = field(default_factory=AttributeMap)
    ready: bool = True

    def __post_init__(self) -> None:
        if not self.name:
            self.name = self.address

    @property
    def host(self) -> str:
        if ":" not in self.address:
            return self.address
        return self.address.rsplit(":", 1)[0]

    @property
    def port(self) -> int:
        """Port part of the address; 0 when absent/unparseable (portless or bare IPv6)."""
        if ":" not in self.address:
            return 0
        try:
            return int(self.address.rsplit(":", 1)[1])
        except ValueError:
            return 0

    # Convenience accessors for the standard metrics (metrics_contract.StdMetric keys).
    def metric(self, key: str, default: float = 0.0) -> float:
        v = self.attrs.get(key)
        return default if v is None else float(v)

    def mark_scrape_failed(self) -> None:
        """Called by the metrics poller when this endpoint's scrape fails: the
        last-known metrics stay readable but are flagged stale so consumers
        (breaker passive health, /v1/models aggregation) can discount them."""
        self.attrs.put("scrape_failed", True)

    def mark_scrape_ok(self) -> None:
        self.attrs.put("scrape_failed", False)
        self.attrs.put("last_poll_ok", time.monotonic())

    def stale(self, max_age_s: float = 10.0) -> bool:
        """True when the last scrape failed, or no successful scrape landed
        within ``max_age_s`` (and at least one scrape was ever attempted —
        a never-polled endpoint, e.g. unit tests without a poller, is not
        stale)."""
        if self.attrs.get("scrape_failed"):
            return True
        age = self.attrs.age("last_poll_ok")
        return age != float("inf") and age > max_age_s

    def __hash__(self) -> int:
        return hash(self.address)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Endpoint) and other.address == self.address


class EndpointPool:
    """Live set of endpoints (InferencePool analogue, inferencepool.md §Dynamic Membership).

    Membership changes arrive from a discovery source (static file / k8s watch); consumers
    (scheduler, pollers) read a consistent snapshot.
    """

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._eps: dict[str, Endpoint] = {}
        self._listeners: list[Any] = []  # guarded-by: _lock

    def upsert(self, ep: Endpoint) -> None:
        with self._lock:
            existing = self._eps.get(ep.address)
            if existing is not None:
                existing.role = ep.role
                existing.labels = ep.labels
                existing.ready = ep.ready
                return
            self._eps[ep.address] = ep
            listeners = list(self._listeners)
        for fn in listeners:  # callbacks run outside the lock
            fn("added", ep)

    def remove(self, address: str) -> Optional[Endpoint]:
        with self._lock:
            ep = self._eps.pop(address, None)
            listeners = list(self._listeners) if ep is not None else []
        if ep is not None:
            for fn in listeners:  # callbacks run outside the lock
                fn("removed", ep)
        return ep

    def list(self, role: Optional[EndpointRole] = None) -> list[Endpoint]:
        with self._lock:
            eps = [e for e in self._eps.values() if e.ready]
        if role is None or role == EndpointRole.BOTH:
            return eps
        return [e for e in eps if e.role in (role, EndpointRole.BOTH)]

    def get(self, address: str) -> Optional[Endpoint]:
        with self._lock:
            return self._eps.get(address)

    def subscribe(self, fn: Any) -> None:
        """fn(event: 'added'|'removed', endpoint) — endpoint-notification-source analogue."""
        with self._lock:
            self._listeners.append(fn)

    def unsubscribe(self, fn: Any) -> None:
        with self._lock:
            try:
                self._listeners.remove(fn)
            except ValueError:
                pass

    def __len__(self) -> int:
        with self._lock:
            return len(self._eps)
