"""SLO objectives, rolling attainment, and multi-window burn rates (copy of
``llmd_tpu/obs/slo.py``).

The router declares latency objectives via environment (``LLMD_SLO_TTFT_MS``,
``LLMD_SLO_E2E_MS``, ``LLMD_SLO_TARGET``) with optional per-tenant overrides
(``LLMD_SLO_TENANT_OVERRIDES``, e.g.
``gold:ttft_ms=200,e2e_ms=2000,target=0.999;bronze:e2e_ms=10000``), then feeds
every request's TTFT/e2e into this engine. The engine keeps minute-bucketed
good/total counts per (tenant, objective) and answers, at scrape time:

* **attainment** — fraction of requests meeting the objective over a rolling
  window (5m and 1h), and
* **burn rate** — ``(1 - attainment) / (1 - target)``: how many times faster
  than "exactly at target" the error budget is being spent. 1.0 means the
  budget lasts precisely its period; 14.4 over 5m is the classic page-now
  threshold (see observability/slo-attribution.md).

Memory is bounded: each (tenant, objective) series holds at most
``window_minutes + 1`` minute buckets, and tenants idle past the long window
are pruned — so a tenant-label cardinality attack costs O(active tenants),
not O(all tenants ever seen).

Clock is injectable (``now_fn``) so window-boundary math is unit-testable.
"""

from __future__ import annotations

import os
import time
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional, Tuple

__all__ = ["SLOConfig", "SLOEngine", "WINDOWS_S"]

# Rolling windows exposed as gauge label values: (label, seconds).
WINDOWS_S: Tuple[Tuple[str, int], ...] = (("5m", 300), ("1h", 3600))

_OBJECTIVE_KEYS = {"ttft_ms": "ttft", "e2e_ms": "e2e"}


class SLOConfig:
    """Per-tenant objective thresholds (ms) and attainment target."""

    __slots__ = ("ttft_ms", "e2e_ms", "target")

    def __init__(self, ttft_ms: float = 0.0, e2e_ms: float = 0.0,
                 target: float = 0.99):
        self.ttft_ms = float(ttft_ms)
        self.e2e_ms = float(e2e_ms)
        # target is the attainment objective (0 < target < 1); clamp so the
        # burn-rate denominator (1 - target) stays sane
        self.target = min(0.9999, max(0.5, float(target)))

    def threshold_ms(self, objective: str) -> float:
        return self.ttft_ms if objective == "ttft" else self.e2e_ms

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"SLOConfig(ttft_ms={self.ttft_ms}, e2e_ms={self.e2e_ms}, "
                f"target={self.target})")


def _parse_overrides(spec: str, base: SLOConfig) -> Dict[str, SLOConfig]:
    """``tenant:key=val,key=val;tenant2:...`` → per-tenant configs layered
    over the defaults. Malformed entries are skipped, never fatal."""
    out: Dict[str, SLOConfig] = {}
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry or ":" not in entry:
            continue
        tenant, _, kvs = entry.partition(":")
        tenant = tenant.strip()
        if not tenant:
            continue
        cfg = SLOConfig(base.ttft_ms, base.e2e_ms, base.target)
        for kv in kvs.split(","):
            k, _, v = kv.partition("=")
            k = k.strip()
            try:
                val = float(v)
            except (TypeError, ValueError):
                continue
            if k in ("ttft_ms", "e2e_ms", "target"):
                setattr(cfg, k, val if k != "target"
                        else min(0.9999, max(0.5, val)))
        out[tenant] = cfg
    return out


class _Series:
    """Minute-bucketed good/total counts for one (tenant, objective)."""

    __slots__ = ("buckets",)

    def __init__(self):
        # deque of [minute_epoch, good, total]; newest last
        self.buckets: deque = deque()

    def add(self, minute: int, good: bool) -> None:
        if self.buckets and self.buckets[-1][0] == minute:
            b = self.buckets[-1]
        else:
            b = [minute, 0, 0]
            self.buckets.append(b)
            # bound: longest window + the in-progress minute
            max_keep = WINDOWS_S[-1][1] // 60 + 1
            while len(self.buckets) > max_keep:
                self.buckets.popleft()
        b[1] += 1 if good else 0
        b[2] += 1

    def counts(self, now_minute: int, window_minutes: int) -> Tuple[int, int]:
        """(good, total) over [now_minute - window_minutes + 1, now_minute]:
        the in-progress minute counts toward its window."""
        lo = now_minute - window_minutes + 1
        good = total = 0
        for minute, g, t in self.buckets:
            if minute >= lo:
                good += g
                total += t
        return good, total

    def newest_minute(self) -> int:
        return self.buckets[-1][0] if self.buckets else 0


class SLOEngine:
    """Feed per-request latencies in; read attainment/burn gauges out.

    Single-threaded by construction on the router (asyncio loop observes,
    the scrape handler reads on the same loop) — no lock needed; the
    engine never blocks."""

    def __init__(self, default: Optional[SLOConfig] = None,
                 overrides: Optional[Dict[str, SLOConfig]] = None,
                 now_fn: Callable[[], float] = time.time):
        self.default = default or SLOConfig()
        self.overrides = dict(overrides or {})
        self.now_fn = now_fn
        self._series: Dict[Tuple[str, str], _Series] = {}
        self.breach_counter = None  # optional: llm_d_epp_slo_breaches_total

    @classmethod
    def from_env(cls, environ=os.environ,
                 now_fn: Callable[[], float] = time.time) -> "SLOEngine":
        base = SLOConfig(
            ttft_ms=float(environ.get("LLMD_SLO_TTFT_MS", "0") or 0),
            e2e_ms=float(environ.get("LLMD_SLO_E2E_MS", "0") or 0),
            target=float(environ.get("LLMD_SLO_TARGET", "0.99") or 0.99),
        )
        overrides = _parse_overrides(
            environ.get("LLMD_SLO_TENANT_OVERRIDES", ""), base)
        return cls(default=base, overrides=overrides, now_fn=now_fn)

    @property
    def enabled(self) -> bool:
        if self.default.ttft_ms > 0 or self.default.e2e_ms > 0:
            return True
        return any(c.ttft_ms > 0 or c.e2e_ms > 0
                   for c in self.overrides.values())

    def config_for(self, tenant: str) -> SLOConfig:
        return self.overrides.get(tenant, self.default)

    # --------------------------------------------------------------- feeding
    def observe(self, tenant: str, objective: str,
                latency_s: float) -> bool:
        """Record one request's latency against an objective ('ttft'|'e2e').
        Returns True when the request BREACHED (caller emits the flight
        event); objectives with no threshold configured are ignored."""
        cfg = self.config_for(tenant)
        threshold_ms = cfg.threshold_ms(objective)
        if threshold_ms <= 0:
            return False
        good = latency_s * 1e3 <= threshold_ms
        minute = int(self.now_fn() // 60)
        key = (tenant, objective)
        series = self._series.get(key)
        if series is None:
            series = self._series[key] = _Series()
        series.add(minute, good)
        if not good and self.breach_counter is not None:
            self.breach_counter.labels(tenant=tenant,
                                       objective=objective).inc()
        return not good

    # --------------------------------------------------------------- reading
    def attainment(self, tenant: str, objective: str,
                   window_s: int) -> Optional[float]:
        series = self._series.get((tenant, objective))
        if series is None:
            return None
        now_minute = int(self.now_fn() // 60)
        good, total = series.counts(now_minute, max(1, window_s // 60))
        if total == 0:
            return None
        return good / total

    def burn_rate(self, tenant: str, objective: str,
                  window_s: int) -> Optional[float]:
        att = self.attainment(tenant, objective, window_s)
        if att is None:
            return None
        cfg = self.config_for(tenant)
        return (1.0 - att) / (1.0 - cfg.target)

    def gauge_samples(self, kind: str) -> List[Tuple[Dict[str, str], float]]:
        """Scrape-time callback body for set_labels_function:
        kind='attainment' or 'burn'. Prunes tenants idle past the long
        window so gauge cardinality tracks *active* tenants."""
        now_minute = int(self.now_fn() // 60)
        horizon = now_minute - (WINDOWS_S[-1][1] // 60 + 1)
        dead = [k for k, s in self._series.items()
                if s.newest_minute() < horizon]
        for k in dead:
            del self._series[k]
        out: List[Tuple[Dict[str, str], float]] = []
        for (tenant, objective) in self._series:
            for label, window_s in WINDOWS_S:
                v = (self.attainment(tenant, objective, window_s)
                     if kind == "attainment"
                     else self.burn_rate(tenant, objective, window_s))
                if v is None:
                    continue
                out.append(({"tenant": tenant, "objective": objective,
                             "window": label}, round(v, 6)))
        return out
