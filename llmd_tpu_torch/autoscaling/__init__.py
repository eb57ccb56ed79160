"""Autoscaling plane: HPA/KEDA metrics path + Workload Variant Autoscaler
(port of ``llmd_tpu/autoscaling``).

Parity: reference docs/architecture/advanced/autoscaling/ — hpa-keda.md (external
metrics igw_queue_depth / igw_running_requests, dual-metric max, scale-to-zero) and
wva.md (variants, Analyzer→Optimizer→Enforcer pipeline, saturation-percentage and
saturation-token analyzers, Kalman/queueing SLO analyzer, scale-to/from-zero).
"""

from llmd_tpu_torch.autoscaling.wva import (
    CostAwareOptimizer,
    Enforcer,
    GreedyByScoreOptimizer,
    KalmanTuner,
    PoolMetrics,
    ReplicaMetrics,
    SaturationAnalyzer,
    SLOAnalyzer,
    TokenSaturationAnalyzer,
    Variant,
    WVAEngine,
)
from llmd_tpu_torch.autoscaling.hpa import HPAEvaluator, ExternalMetric

__all__ = [
    "CostAwareOptimizer",
    "Enforcer",
    "ExternalMetric",
    "GreedyByScoreOptimizer",
    "HPAEvaluator",
    "KalmanTuner",
    "PoolMetrics",
    "ReplicaMetrics",
    "SLOAnalyzer",
    "SaturationAnalyzer",
    "TokenSaturationAnalyzer",
    "Variant",
    "WVAEngine",
]
