"""Flow-control calibrator: band capacities from engine capacity + workload
(copy of ``llmd_tpu/router/calibrator.py``).

The reference ships its flow-control tuning math as an offline wizard
(`guides/flow-control/scripts/tuning_wizard.py:1-30` — Little's-law compute
constraint + CLT KV-memory constraint); SURVEY hard-part #5 calls for that math
to be a BUILT-IN calibrator. This module is it: given the serving fleet's KV
capacity and an observed workload (token rates, ISL/OSL moments, request
sizes), it computes the system's sustainable concurrency and sizes every
priority band's ``maxRequests`` / ``maxBytes`` / ``ttl_s`` so the queue
buffers what the fleet can actually absorb — no starvation from bands sized
too small, no unbounded memory from bands sized "just big".

The two constraints (same model as the reference wizard, same defaults):

- **Compute (Little's law)**: a fleet sustaining ``throughput`` requests/s at
  mean latency ``W`` holds ``L = throughput x W`` requests in service; queued
  work beyond that waits.
- **KV memory (CLT)**: n concurrent requests' paged-KV footprint is
  approximately ``n*mu + z*sqrt(n)*sigma`` tokens (mu/sigma the per-request
  footprint moments over an autoregressive lifetime: ISL + OSL/2, with the
  output variance of a uniformly-progressing decode). The largest n keeping
  that under the usable pool solves ``mu*s^2 + z*sigma*s - available = 0``
  for ``s = sqrt(n)``.

The queue then buffers a bounded multiple of the binding constraint, split
across bands by weight.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Optional

from llmd_tpu_torch.core.config import FlowControlSpec, PriorityBandSpec


@dataclass
class EngineCapacity:
    """The fleet's KV pool, as engines report it (vllm:cache_config_info)."""

    num_pages: int  # total KV blocks across the pool's engines
    page_size: int = 16
    paged_attention_efficiency: float = 0.90  # fragmentation headroom
    shared_prefix_tokens: int = 0  # static system prompt covered by the cache
    enable_prefix_caching: bool = True
    max_num_batched_tokens: int = 2048


@dataclass
class WorkloadObservation:
    """Observed workload moments (engine traces / EPP metrics window)."""

    throughput_rps: float  # completed requests per second
    latency_s: float  # mean end-to-end seconds
    isl_mean: float
    osl_mean: float
    # exponential-distribution fallback matches the wizard: std = mean
    isl_std: Optional[float] = None
    osl_std: Optional[float] = None
    isl_osl_correlation: float = 0.0
    mean_request_bytes: int = 2048  # JSON body size, for maxBytes

    def __post_init__(self) -> None:
        if self.isl_std is None:
            self.isl_std = self.isl_mean
        if self.osl_std is None:
            self.osl_std = self.osl_mean


@dataclass
class Calibration:
    compute_limit: int
    memory_limit: int
    lookahead_buffer: int
    footprint_cv: float  # coefficient of variation of the KV footprint
    spec: FlowControlSpec = field(default_factory=FlowControlSpec)

    @property
    def concurrency_limit(self) -> int:
        return min(self.compute_limit, self.memory_limit)

    @property
    def binding_constraint(self) -> str:
        return "compute" if self.compute_limit <= self.memory_limit else "memory"


def compute_constraint(throughput_rps: float, latency_s: float) -> int:
    """Little's law: L = lambda x W."""
    return max(1, math.floor(throughput_rps * latency_s))


def memory_constraint(cap: EngineCapacity, wl: WorkloadObservation,
                      z_score: float = 2.0) -> tuple[int, float]:
    """Max concurrency before KV exhaustion; returns (limit, footprint CV)."""
    effective = cap.num_pages * cap.page_size * cap.paged_attention_efficiency
    if cap.enable_prefix_caching:
        available = max(0.0, effective - cap.shared_prefix_tokens)
        marginal_isl = max(0.0, wl.isl_mean - cap.shared_prefix_tokens)
    else:
        available, marginal_isl = effective, wl.isl_mean
    isl_std = wl.isl_std if marginal_isl > 0 else 0.0

    # mean KV held over a request's life: full prompt + half the output ramp
    mu = marginal_isl + wl.osl_mean / 2.0
    var_output = wl.osl_std ** 2 / 3.0 + wl.osl_mean ** 2 / 12.0
    var = isl_std ** 2 + var_output + wl.isl_osl_correlation * isl_std * wl.osl_std
    sigma = math.sqrt(max(0.0, var))
    cv = sigma / mu if mu > 0 else 0.0
    if mu <= 0:
        return 1, cv
    # n*mu + z*sqrt(n)*sigma <= available, s = sqrt(n)
    disc = (z_score * sigma) ** 2 + 4 * mu * available
    s = (-z_score * sigma + math.sqrt(disc)) / (2 * mu)
    return max(1, int(s ** 2)), cv


def lookahead_buffer(active_batch: int, max_num_batched_tokens: int,
                     isl_mean: Optional[float]) -> int:
    """Engine-local queue depth keeping continuous batching fed — capped at
    15% of the active batch (the wizard's starvation-vs-HOL compromise)."""
    cap15 = math.ceil(active_batch * 0.15)
    if not isl_mean or isl_mean <= 0:
        return max(1, cap15)
    return max(1, min(math.ceil(max_num_batched_tokens / isl_mean), cap15))


def calibrate(cap: EngineCapacity, wl: WorkloadObservation,
              bands: Optional[list[PriorityBandSpec]] = None,
              band_weights: Optional[dict[int, float]] = None,
              z_score: float = 2.0, queue_factor: float = 2.0,
              ttl_margin: float = 3.0) -> Calibration:
    """Size every band from the binding constraint.

    - total queue budget = ``queue_factor`` x concurrency limit (absorb a
      burst of that multiple before shedding — beyond it, waiting requests
      would outlive any sane deadline anyway);
    - per band: the budget splits by ``band_weights`` (default: equal);
    - ``maxBytes`` = that request budget x observed mean request size;
    - ``ttl_s`` = ``ttl_margin`` x (service latency + expected full-queue
      drain time at observed throughput): a request older than that has
      missed its window — evict instead of serving into a timeout.
    """
    comp = compute_constraint(wl.throughput_rps, wl.latency_s)
    mem, cv = memory_constraint(cap, wl, z_score=z_score)
    limit = min(comp, mem)
    bands = [replace(b) for b in (bands or [PriorityBandSpec(priority=0,
                                                             name="default")])]
    weights = {b.priority: (band_weights or {}).get(b.priority, 1.0)
               for b in bands}
    wsum = sum(weights.values()) or 1.0
    queue_budget = max(len(bands), math.ceil(limit * queue_factor))
    drain_s = (queue_budget / wl.throughput_rps
               if wl.throughput_rps > 0 else 60.0)
    ttl = ttl_margin * (wl.latency_s + drain_s)
    for b in bands:
        share = weights[b.priority] / wsum
        b.max_requests = max(1, math.ceil(queue_budget * share))
        b.max_bytes = b.max_requests * max(1, wl.mean_request_bytes)
        b.ttl_s = ttl
    return Calibration(
        compute_limit=comp, memory_limit=mem,
        lookahead_buffer=lookahead_buffer(limit, cap.max_num_batched_tokens,
                                          wl.isl_mean),
        footprint_cv=cv,
        spec=FlowControlSpec(enabled=True, bands=bands),
    )


def main() -> None:
    """CLI twin of the reference wizard (non-interactive): prints the
    calibrated flowControl block for the router config, as JSON.

        python -m llmd_tpu_torch.router.calibrator --throughput 20 \
            --latency-sec 4 --num-pages 8192 --isl-mean 1024 --osl-mean 256"""
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--throughput", type=float, required=True, help="mean RPS")
    ap.add_argument("--latency-sec", type=float, required=True)
    ap.add_argument("--num-pages", type=int, required=True,
                    help="total KV blocks across the fleet")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--isl-mean", type=float, required=True)
    ap.add_argument("--isl-std", type=float, default=None)
    ap.add_argument("--osl-mean", type=float, required=True)
    ap.add_argument("--osl-std", type=float, default=None)
    ap.add_argument("--shared-prefix", type=int, default=0)
    ap.add_argument("--no-prefix-caching", action="store_true")
    ap.add_argument("--max-num-batched-tokens", type=int, default=2048)
    ap.add_argument("--mean-request-bytes", type=int, default=2048)
    ap.add_argument("--z-score", type=float, default=2.0)
    ap.add_argument("--queue-factor", type=float, default=2.0)
    ap.add_argument("--bands", default="0",
                    help="comma-separated priority[:weight] list, e.g. 0:1,10:3")
    args = ap.parse_args()

    bands, weights = [], {}
    for part in args.bands.split(","):
        prio, _, w = part.partition(":")
        bands.append(PriorityBandSpec(priority=int(prio), name=f"band{prio}"))
        weights[int(prio)] = float(w) if w else 1.0
    cal = calibrate(
        EngineCapacity(num_pages=args.num_pages, page_size=args.page_size,
                       shared_prefix_tokens=args.shared_prefix,
                       enable_prefix_caching=not args.no_prefix_caching,
                       max_num_batched_tokens=args.max_num_batched_tokens),
        WorkloadObservation(throughput_rps=args.throughput,
                            latency_s=args.latency_sec,
                            isl_mean=args.isl_mean, isl_std=args.isl_std,
                            osl_mean=args.osl_mean, osl_std=args.osl_std,
                            mean_request_bytes=args.mean_request_bytes),
        bands=bands, band_weights=weights,
        z_score=args.z_score, queue_factor=args.queue_factor,
    )
    print(json.dumps({
        "compute_limit": cal.compute_limit,
        "memory_limit": cal.memory_limit,
        "binding_constraint": cal.binding_constraint,
        "concurrency_limit": cal.concurrency_limit,
        "lookahead_buffer": cal.lookahead_buffer,
        "footprint_cv": round(cal.footprint_cv, 3),
        "flowControl": {
            "enabled": True,
            "bands": [{
                "priority": b.priority, "name": b.name,
                "maxRequests": b.max_requests, "maxBytes": b.max_bytes,
                "ttl_s": round(b.ttl_s, 1),
            } for b in cal.spec.bands],
        },
    }, indent=2))


if __name__ == "__main__":
    main()
