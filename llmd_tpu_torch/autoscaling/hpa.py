"""HPA/KEDA external-metrics path over the EPP metrics (copy of
``llmd_tpu/autoscaling/hpa.py``; pure arithmetic).

Parity: reference hpa-keda.md:14-118 — Prometheus Adapter exposes two external
metrics from the EPP, HPA takes the max of both desired counts:

- ``igw_queue_depth`` (target type Value): pool-level queued requests; desired =
  ceil(current / target) — queue is a pool property, not per-replica,
- ``igw_running_requests`` (target type AverageValue): desired =
  ceil(current / (target × replicas)) scaled back to replicas.

The router already serves both series on /metrics; this evaluator reproduces the
HPA arithmetic so the policy is testable (and usable directly in no-k8s mode).
Scale-to-zero (0→1) is KEDA's job in the reference; here the WVA engine's
scale-from-zero loop covers it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional


@dataclass
class ExternalMetric:
    name: str
    target: float
    target_type: str = "Value"  # "Value" | "AverageValue"


class HPAEvaluator:
    """Dual-metric max rule (hpa-keda.md:64-90) with HPA's tolerance band."""

    def __init__(self, metrics: Optional[list[ExternalMetric]] = None,
                 min_replicas: int = 1, max_replicas: int = 10,
                 tolerance: float = 0.1) -> None:
        self.metrics = metrics or [
            ExternalMetric("igw_queue_depth", target=8.0, target_type="Value"),
            ExternalMetric("igw_running_requests", target=16.0, target_type="AverageValue"),
        ]
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.tolerance = tolerance

    def desired_replicas(self, current_replicas: int, values: dict[str, float]) -> int:
        desired = []
        for m in self.metrics:
            v = values.get(m.name)
            if v is None:
                continue
            if m.target_type == "AverageValue":
                ratio = v / (m.target * max(1, current_replicas))
            else:  # Value: pool-level quantity
                ratio = v / m.target
            if abs(ratio - 1.0) <= self.tolerance:
                desired.append(current_replicas)
            else:
                desired.append(math.ceil(ratio * max(1, current_replicas)))
        want = max(desired) if desired else current_replicas
        return min(self.max_replicas, max(self.min_replicas, want))
