"""Router resilience layer: deadlines, retries, breakers, drain, hedging
(copy of ``llmd_tpu/router/resilience.py``).

The reference stack leans on Envoy + gateway health checks to move traffic
off sick pods (ha.py cites exactly this); standalone mode has no Envoy, so
this module is the router's own survival kit:

- **End-to-end deadlines** — the client's ``x-request-timeout`` budget (or
  ``LLMD_REQUEST_TIMEOUT_S`` default) becomes an absolute deadline on the
  InferenceRequest; flow-control wait and scheduling decrement it implicitly,
  each forward attempt uses the remainder as its timeout, and the remainder
  is propagated to the engine under the same header.
- **Bounded retries with jittered exponential backoff** — connect errors,
  attempt timeouts, and 502/503/504 *before the first streamed byte* are
  re-scheduled on a different endpoint (the failed set is excluded from the
  re-pick, like llm-d's ``excluded_runner_ids``). Mid-stream failures are
  never retried: the client already saw bytes, a replay would duplicate them.
- **Per-endpoint circuit breakers with passive health** — forward outcomes
  (and metrics-scrape failures) feed consecutive-failure and failure-rate
  tracking per endpoint; an open breaker filters the endpoint out of
  scheduling, a half-open probe re-admits it after a cooldown. The shape
  follows Envoy's outlier-detection model the reference gateway relies on.
- **Graceful drain** — an endpoint announcing ``draining`` (via its /health,
  observed on breaker probes, or marked administratively) stops being picked
  while its in-flight requests finish.
- **Hedging** (optional) — short non-streaming requests get a second attempt
  on another endpoint after a P99-based delay (Dean & Barroso, "The Tail at
  Scale", CACM 2013); first response wins, the loser is cancelled.

All knobs are env vars (``LLMD_RETRY_*`` / ``LLMD_BREAKER_*`` /
``LLMD_HEDGE_*``, and ``LLMD_REQUEST_TIMEOUT_S``), as the reference's.

Threading: the scheduler runs on its own worker thread while forward
outcomes land on the asyncio loop, so the manager takes a threading.Lock
around all breaker state.
"""

from __future__ import annotations

import os
import random
import threading
import time
from dataclasses import dataclass
from enum import Enum
from typing import Iterable, List, Optional

from llmd_tpu_torch.core.endpoint import Endpoint

__all__ = [
    "BreakerState",
    "EndpointBreaker",
    "ResilienceConfig",
    "ResilienceManager",
    "RETRYABLE_STATUSES",
]

# Gateway-retryable upstream statuses: the request never reached a healthy
# serving path, so a replay on another endpoint is safe and invisible.
RETRYABLE_STATUSES = frozenset({502, 503, 504})


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
class ResilienceConfig:
    """Knob set for the whole layer (see observability/resilience.md)."""

    # deadlines
    request_timeout_s: float = 600.0  # default budget when no header arrives
    # retries
    retry_max_attempts: int = 3  # total attempts (1 initial + N-1 retries)
    retry_backoff_ms: float = 25.0  # base of the exponential schedule
    retry_backoff_max_ms: float = 1000.0
    # breaker
    breaker_consecutive_failures: int = 5
    breaker_failure_rate: float = 0.5  # open when window rate exceeds this
    breaker_window: int = 20  # sliding window of recent outcomes
    breaker_min_volume: int = 10  # rate check needs at least this many samples
    breaker_cooldown_s: float = 5.0  # open → half-open delay
    breaker_half_open_successes: int = 2  # probe successes required to close
    # hedging
    hedge_enabled: bool = False
    hedge_delay_ms: float = 0.0  # 0 = auto (observed P99 of non-streaming e2e)
    hedge_max_tokens: int = 32  # only hedge short generations

    @classmethod
    def from_env(cls) -> "ResilienceConfig":
        return cls(
            request_timeout_s=_env_f("LLMD_REQUEST_TIMEOUT_S", 600.0),
            retry_max_attempts=max(1, _env_i("LLMD_RETRY_MAX_ATTEMPTS", 3)),
            retry_backoff_ms=_env_f("LLMD_RETRY_BACKOFF_MS", 25.0),
            retry_backoff_max_ms=_env_f("LLMD_RETRY_BACKOFF_MAX_MS", 1000.0),
            breaker_consecutive_failures=max(
                1, _env_i("LLMD_BREAKER_CONSECUTIVE_FAILURES", 5)),
            breaker_failure_rate=_env_f("LLMD_BREAKER_FAILURE_RATE", 0.5),
            breaker_window=max(1, _env_i("LLMD_BREAKER_WINDOW", 20)),
            breaker_min_volume=max(1, _env_i("LLMD_BREAKER_MIN_VOLUME", 10)),
            breaker_cooldown_s=_env_f("LLMD_BREAKER_COOLDOWN_S", 5.0),
            breaker_half_open_successes=max(
                1, _env_i("LLMD_BREAKER_HALF_OPEN_SUCCESSES", 2)),
            hedge_enabled=os.environ.get("LLMD_HEDGE_ENABLED", "0")
            not in ("0", "", "false", "False"),
            hedge_delay_ms=_env_f("LLMD_HEDGE_DELAY_MS", 0.0),
            hedge_max_tokens=_env_i("LLMD_HEDGE_MAX_TOKENS", 32),
        )


class BreakerState(str, Enum):
    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"


class EndpointBreaker:
    """One endpoint's outlier-ejection state. Mutated only under the
    manager's lock — no locking of its own."""

    __slots__ = ("state", "consecutive_failures", "window", "opened_at",
                 "open_until", "half_open_successes", "half_open_inflight",
                 "probe_admitted_at", "open_count")

    def __init__(self) -> None:
        self.state = BreakerState.CLOSED
        self.consecutive_failures = 0
        self.window: list = []  # recent outcomes, True = failure
        self.opened_at = 0.0
        self.open_until = 0.0
        self.half_open_successes = 0
        self.half_open_inflight = 0
        self.probe_admitted_at = 0.0
        self.open_count = 0  # lifetime opens (for snapshots)

    def _note(self, failed: bool, window: int) -> None:
        self.window.append(failed)
        if len(self.window) > window:
            del self.window[: len(self.window) - window]

    def failure_rate(self) -> float:
        if not self.window:
            return 0.0
        return sum(self.window) / len(self.window)


class ResilienceManager:
    """Shared breaker/drain/hedge state + the retry policy.

    The scheduler consults :meth:`filter_endpoints` on every pick; the router
    proxy reports attempt outcomes through :meth:`on_success` /
    :meth:`on_failure`; the metrics poller feeds scrape failures in as a
    passive health signal via :meth:`note_scrape_error`.
    """

    def __init__(self, cfg: Optional[ResilienceConfig] = None,
                 metrics=None, flight=None) -> None:
        self.cfg = cfg or ResilienceConfig.from_env()
        self.metrics = metrics  # RouterMetrics (may be None in unit tests)
        self.flight = flight  # FlightRecorder (system events)
        self._lock = threading.Lock()
        self._breakers: dict[str, EndpointBreaker] = {}
        self._draining: set[str] = set()
        # reservoir of recent non-streaming e2e latencies for the auto hedge
        # delay (ring of 256 keeps the P99 tracking the current regime)
        self._latencies: list[float] = []
        self._lat_idx = 0
        self._rng = random.Random(0xC1BC)

    # ------------------------------------------------------------- breakers
    def _breaker(self, address: str) -> EndpointBreaker:
        br = self._breakers.get(address)
        if br is None:
            br = self._breakers[address] = EndpointBreaker()
        return br

    def _transition(self, address: str, br: EndpointBreaker,
                    state: BreakerState, reason: str = "") -> None:
        prev, br.state = br.state, state
        if state is BreakerState.OPEN and prev is not BreakerState.OPEN:
            br.opened_at = time.monotonic()
            br.open_until = br.opened_at + self.cfg.breaker_cooldown_s
            br.open_count += 1
            br.half_open_successes = 0
            if self.metrics is not None:
                self.metrics.breaker_opens.inc()
            if self.flight is not None:
                self.flight.record_system("breaker_open", endpoint=address,
                                          reason=reason or None,
                                          consecutive=br.consecutive_failures,
                                          failure_rate=round(br.failure_rate(), 3))
        elif state is BreakerState.CLOSED and prev is not BreakerState.CLOSED:
            br.consecutive_failures = 0
            br.window.clear()
            br.half_open_successes = 0
            br.half_open_inflight = 0
            if self.metrics is not None:
                self.metrics.breaker_closes.inc()
            if self.flight is not None:
                self.flight.record_system(
                    "breaker_close", endpoint=address,
                    open_ms=round((time.monotonic() - br.opened_at) * 1e3, 1))

    def allow(self, address: str, now: Optional[float] = None) -> bool:
        """May this endpoint receive a request right now? An expired-cooldown
        OPEN breaker transitions to HALF_OPEN and admits a single probe."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if address in self._draining:
                return False
            br = self._breakers.get(address)
            if br is None or br.state is BreakerState.CLOSED:
                return True
            if br.state is BreakerState.OPEN:
                if now < br.open_until:
                    return False
                br.state = BreakerState.HALF_OPEN
                br.half_open_inflight = 0
            # HALF_OPEN: one probe in flight at a time. The slot expires after
            # a cooldown — filter_endpoints() consumes it for every pick the
            # endpoint is merely a CANDIDATE in, and when the scheduler then
            # chooses someone else no outcome ever lands here to release it.
            # Without the expiry that stale slot ejects the endpoint forever.
            if (br.half_open_inflight >= 1
                    and now - br.probe_admitted_at < self.cfg.breaker_cooldown_s):
                return False
            br.half_open_inflight = 1
            br.probe_admitted_at = now
            return True

    def on_success(self, address: str) -> None:
        with self._lock:
            br = self._breakers.get(address)
            if br is None:
                return
            br.consecutive_failures = 0
            br._note(False, self.cfg.breaker_window)
            if br.state is BreakerState.HALF_OPEN:
                br.half_open_inflight = max(0, br.half_open_inflight - 1)
                br.half_open_successes += 1
                if br.half_open_successes >= self.cfg.breaker_half_open_successes:
                    self._transition(address, br, BreakerState.CLOSED)

    def on_failure(self, address: str, reason: str = "") -> None:
        with self._lock:
            br = self._breaker(address)
            br.consecutive_failures += 1
            br._note(True, self.cfg.breaker_window)
            if br.state is BreakerState.HALF_OPEN:
                # failed probe: straight back to OPEN for another cooldown
                br.half_open_inflight = max(0, br.half_open_inflight - 1)
                br.state = BreakerState.OPEN  # suppress re-open event spam
                br.open_until = time.monotonic() + self.cfg.breaker_cooldown_s
                return
            if br.state is BreakerState.CLOSED and (
                br.consecutive_failures >= self.cfg.breaker_consecutive_failures
                or (len(br.window) >= self.cfg.breaker_min_volume
                    and br.failure_rate() >= self.cfg.breaker_failure_rate)
            ):
                self._transition(address, br, BreakerState.OPEN, reason=reason)

    def forget(self, address: str) -> None:
        """Drop every trace of an endpoint that left discovery. Replica
        churn (pool scale cycles) would otherwise grow the breaker map and
        the draining set without bound — and a re-used address would
        inherit a dead replica's open breaker."""
        with self._lock:
            self._breakers.pop(address, None)
            self._draining.discard(address)

    def note_scrape_error(self, address: str) -> None:
        """Metrics-scrape failure: a passive health signal. An endpoint whose
        /metrics stops answering is almost always one whose serving path is
        about to stop answering too — feeding the breaker here ejects it
        BEFORE a client request has to pay for the discovery."""
        self.on_failure(address, reason="scrape_error")

    # --------------------------------------------------------------- drain
    def set_draining(self, address: str, draining: bool = True) -> None:
        with self._lock:
            if draining:
                self._draining.add(address)
            else:
                self._draining.discard(address)

    def is_draining(self, address: str) -> bool:
        with self._lock:
            return address in self._draining

    def healthy(self, address: str) -> bool:
        """Non-mutating view for read-only consumers (/v1/models aggregation):
        not draining and breaker not currently OPEN. Unlike :meth:`allow`
        this never admits a half-open probe — listing models must not
        consume the one probe slot a recovering endpoint gets."""
        now = time.monotonic()
        with self._lock:
            if address in self._draining:
                return False
            br = self._breakers.get(address)
            if br is None:
                return True
            return not (br.state is BreakerState.OPEN and now < br.open_until)

    # ---------------------------------------------------------- scheduling
    def filter_endpoints(self, endpoints: Iterable[Endpoint]) -> List[Endpoint]:
        """Scheduling-time filter: drop breaker-open and draining endpoints.

        Fail-open: if the filter would empty the candidate set (every breaker
        open — e.g. the fault is actually downstream of the pool), the
        original set is returned so the pool never self-ejects entirely
        (Envoy's max_ejection_percent backstop)."""
        eps = list(endpoints)
        allowed = [e for e in eps if self.allow(e.address)]
        return allowed if allowed else eps

    def open_endpoints(self) -> list[str]:
        now = time.monotonic()
        with self._lock:
            return [a for a, br in self._breakers.items()
                    if br.state is BreakerState.OPEN and now < br.open_until]

    def attempt_states(self, addresses: Iterable[str]) -> dict[str, dict]:
        """Per-address breaker view for the routing decision ledger
        (obs/decisions.py): only non-pristine entries are reported, so the
        ledger records WHY resilience dropped candidates without bloating
        the common all-healthy case."""
        out: dict[str, dict] = {}
        with self._lock:
            for a in addresses:
                br = self._breakers.get(a)
                draining = a in self._draining
                if br is None and not draining:
                    continue
                if br is not None and br.state is BreakerState.CLOSED \
                        and not br.consecutive_failures and not draining:
                    continue
                entry: dict = {}
                if br is not None:
                    entry["state"] = br.state.value
                    if br.consecutive_failures:
                        entry["consecutive_failures"] = br.consecutive_failures
                if draining:
                    entry["draining"] = True
                out[a] = entry
        return out

    def snapshot(self) -> dict:
        """Breaker/drain state for /health and debugging."""
        with self._lock:
            return {
                "breakers": {
                    a: {"state": br.state.value,
                        "consecutive_failures": br.consecutive_failures,
                        "failure_rate": round(br.failure_rate(), 3),
                        "open_count": br.open_count}
                    for a, br in self._breakers.items()
                    if br.state is not BreakerState.CLOSED or br.window
                },
                "draining": sorted(self._draining),
            }

    # -------------------------------------------------------------- retries
    def retryable_status(self, status: int) -> bool:
        return status in RETRYABLE_STATUSES

    def backoff_s(self, attempt: int) -> float:
        """Full-jitter exponential backoff for retry ``attempt`` (1-based):
        uniform in (0, min(base * 2^(attempt-1), max)]."""
        cap = self.cfg.retry_backoff_max_ms / 1e3
        span = min(cap, self.cfg.retry_backoff_ms / 1e3 * (2 ** max(0, attempt - 1)))
        with self._lock:
            return self._rng.uniform(0, span)

    # -------------------------------------------------------------- hedging
    def note_latency(self, seconds: float) -> None:
        """Feed one non-streaming e2e sample into the hedge-delay reservoir."""
        with self._lock:
            if len(self._latencies) < 256:
                self._latencies.append(seconds)
            else:
                self._latencies[self._lat_idx % 256] = seconds
            self._lat_idx += 1

    def hedge_delay_s(self) -> float:
        """Delay before firing the hedged attempt: the configured value, or
        the observed P99 of recent non-streaming e2e (min 50 ms until enough
        samples accumulate — hedging against noise wastes capacity)."""
        if self.cfg.hedge_delay_ms > 0:
            return self.cfg.hedge_delay_ms / 1e3
        with self._lock:
            lats = sorted(self._latencies)
        if len(lats) < 20:
            return 0.05
        return max(0.05, lats[int(len(lats) * 0.99)])

    def hedge_eligible(self, req) -> bool:
        """Hedge only short non-streaming requests: duplicated work must be
        cheap, and streaming replays would duplicate client-visible bytes."""
        return (self.cfg.hedge_enabled
                and not req.streaming
                and req.sampling.max_tokens <= self.cfg.hedge_max_tokens)
