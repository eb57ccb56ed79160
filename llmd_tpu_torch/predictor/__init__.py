"""Latency predictor: online-trained TTFT/TPOT models + EPP plugins (port of
``llmd_tpu/predictor``: numpy and the standard library; the regressor is a
numpy histogram GBDT, ``gbdt.py``, and the sidecars serve on
``router/http.py``).

Parity: reference docs/architecture/advanced/latency-predictor.md — training sidecar
(sliding window, stratified bucketing) + prediction sidecars sharing a model volume
(:20-57), feature sets (:76-97), EPP plugin suite (:108-140), heuristic fallback on
outage (:52), actual-vs-predicted observability (:142-160). XGBoost → scikit-learn's
HistGradientBoosting algorithm in the reference, re-implemented here in numpy.
"""

from llmd_tpu_torch.predictor.model import (
    LatencyModel,
    LatencySample,
    StratifiedWindow,
    ttft_features,
    tpot_features,
)
from llmd_tpu_torch.predictor.client import LocalPredictor, SidecarPredictorClient

__all__ = [
    "LatencyModel",
    "LatencySample",
    "StratifiedWindow",
    "LocalPredictor",
    "SidecarPredictorClient",
    "ttft_features",
    "tpot_features",
]
