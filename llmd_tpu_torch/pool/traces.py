"""Trace generators for the pool-scale load harness (copy of
``llmd_tpu/pool/traces.py``: the same seeded draws, lists and JSONL).

A trace is a list of :class:`TraceRequest` — arrival offsets plus request
shape — replayed open-loop by ``pool/harness.py``. Three generators cover
the autoscaling regimes the SLO gate exercises:

- :func:`bursty_trace`      — steady base rate with a 10x (configurable)
  burst window: the scale-up/scale-down swing;
- :func:`diurnal_trace`     — sinusoidal day/night rate: slow-follow
  tracking;
- :func:`multi_tenant_ramp` — per-tenant linear ramps with staggered
  starts: fairness under mixed growth.

Arrivals are inhomogeneous-Poisson (exponential gaps at the instantaneous
rate), seeded, so runs replay deterministically. Traces serialize to JSONL
(one request per line, keys = dataclass fields) for file-driven replays:

    {"t": 0.134, "tenant": "default", "prompt_tokens": 48, "max_tokens": 8,
     "stream": false}
"""

from __future__ import annotations

import json
import random
from dataclasses import asdict, dataclass
from typing import Callable, Optional


@dataclass
class TraceRequest:
    """One arrival: offset from trace start + request shape."""

    t: float  # seconds from trace start
    tenant: str = "default"
    prompt_tokens: int = 32
    max_tokens: int = 8
    stream: bool = False


def _poisson_arrivals(rate_fn: Callable[[float], float], duration_s: float,
                      rng: random.Random, tenant: str,
                      prompt_tokens: int, max_tokens: int,
                      stream: bool) -> list[TraceRequest]:
    """Inhomogeneous Poisson via thinning (Ogata): draw candidate gaps at the
    trace's peak rate, accept each with rate(t)/peak. Stepping gaps at the
    *instantaneous* rate would be wrong — one near-zero stretch (a tenant
    before its ramp onset) draws a gap past the whole trace."""
    peak = max(rate_fn(duration_s * k / 1000.0) for k in range(1001))
    peak = max(1e-6, peak)
    out: list[TraceRequest] = []
    t = 0.0
    while True:
        t += rng.expovariate(peak)
        if t >= duration_s:
            return out
        if rng.random() * peak > rate_fn(t):
            continue  # thinned out: instantaneous rate below peak
        out.append(TraceRequest(
            t=round(t, 4), tenant=tenant,
            prompt_tokens=max(1, int(rng.gauss(prompt_tokens,
                                               prompt_tokens * 0.2))),
            max_tokens=max(1, int(rng.gauss(max_tokens, max_tokens * 0.2))),
            stream=stream))


def bursty_trace(duration_s: float = 10.0, base_rps: float = 5.0,
                 burst_rps: float = 50.0, burst_start_s: float = 4.0,
                 burst_end_s: float = 6.0, seed: int = 0,
                 prompt_tokens: int = 32, max_tokens: int = 8,
                 stream: bool = False) -> list[TraceRequest]:
    """Steady base rate with one rectangular burst window (default 10x)."""
    rng = random.Random(seed)

    def rate(t: float) -> float:
        return burst_rps if burst_start_s <= t < burst_end_s else base_rps

    return _poisson_arrivals(rate, duration_s, rng, "default",
                             prompt_tokens, max_tokens, stream)


def diurnal_trace(duration_s: float = 60.0, min_rps: float = 1.0,
                  peak_rps: float = 20.0, period_s: float = 30.0,
                  seed: int = 0, prompt_tokens: int = 32,
                  max_tokens: int = 8,
                  stream: bool = False) -> list[TraceRequest]:
    """Sinusoidal rate between min and peak (period = one 'day')."""
    import math

    rng = random.Random(seed)
    mid = (peak_rps + min_rps) / 2.0
    amp = (peak_rps - min_rps) / 2.0

    def rate(t: float) -> float:
        return mid + amp * math.sin(2.0 * math.pi * t / period_s)

    return _poisson_arrivals(rate, duration_s, rng, "default",
                             prompt_tokens, max_tokens, stream)


def multi_tenant_ramp(duration_s: float = 30.0,
                      tenants: Optional[list[str]] = None,
                      start_rps: float = 1.0, end_rps: float = 10.0,
                      stagger_s: float = 5.0, seed: int = 0,
                      prompt_tokens: int = 32, max_tokens: int = 8,
                      stream: bool = False) -> list[TraceRequest]:
    """Per-tenant linear ramps with staggered onsets, merged time-sorted."""
    tenants = tenants or ["tenant-a", "tenant-b", "tenant-c"]
    out: list[TraceRequest] = []
    for i, tenant in enumerate(tenants):
        rng = random.Random(seed + i)
        onset = i * stagger_s

        def rate(t: float, onset: float = onset) -> float:
            if t < onset:
                return 1e-6
            frac = (t - onset) / max(1e-6, duration_s - onset)
            return start_rps + (end_rps - start_rps) * min(1.0, frac)

        out.extend(_poisson_arrivals(rate, duration_s, rng, tenant,
                                     prompt_tokens, max_tokens, stream))
    out.sort(key=lambda r: r.t)
    return out


def dump_jsonl(trace: list[TraceRequest], path: str) -> None:
    with open(path, "w") as f:
        for req in trace:
            f.write(json.dumps(asdict(req)) + "\n")


def load_jsonl(path: str) -> list[TraceRequest]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(TraceRequest(**json.loads(line)))
    out.sort(key=lambda r: r.t)
    return out
