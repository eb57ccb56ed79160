"""TTFT/TPOT regression models + the stratified sliding training window
(copy of ``llmd_tpu/predictor/model.py``; the regressor is the port's own
numpy histogram GBDT, ``predictor/gbdt.py``, the same algorithm as the
reference's scikit-learn one).

Reference latency-predictor.md:70-97: two GBDT regressors retrained on a sliding
window of completed requests; stratified bucketing partitions samples by KV-cache
utilization (10% steps) and prefix-hit rate (0.25 steps) with a per-bucket cap so
rare regimes survive in the window; ~5% MAPE is the reference's accuracy bar.
"""

from __future__ import annotations

import pickle
import threading
from collections import deque
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np

from llmd_tpu_torch.predictor.gbdt import HistGradientBoostingRegressor

# TTFT features (latency-predictor.md:78-87)
TTFT_FEATURES = (
    "kv_usage", "input_len", "queue_depth", "running_requests",
    "prefix_match_pct", "inflight_tokens",
)
# TPOT features (:89-97)
TPOT_FEATURES = (
    "kv_usage", "input_len", "queue_depth", "running_requests", "tokens_generated",
)


@dataclass
class LatencySample:
    """One completed request's pod-state features + observed latencies."""

    kv_usage: float = 0.0  # [0, 1]
    input_len: float = 0.0
    queue_depth: float = 0.0
    running_requests: float = 0.0
    prefix_match_pct: float = 0.0  # [0, 1]
    inflight_tokens: float = 0.0
    tokens_generated: float = 0.0
    ttft_ms: Optional[float] = None
    tpot_ms: Optional[float] = None

    def features(self, names: tuple[str, ...]) -> list[float]:
        return [float(getattr(self, n)) for n in names]


def ttft_features(sample: LatencySample) -> list[float]:
    return sample.features(TTFT_FEATURES)


def tpot_features(sample: LatencySample) -> list[float]:
    return sample.features(TPOT_FEATURES)


class StratifiedWindow:
    """Sliding window bucketed by (kv-util decile, prefix-hit quartile).

    Each bucket is its own bounded deque, so a regime that is rare in current
    traffic (cold cache at low load) keeps its samples while hot regimes churn
    theirs (latency-predictor.md:74).
    """

    def __init__(self, per_bucket_cap: int = 256) -> None:
        self.cap = per_bucket_cap
        self.buckets: dict[tuple[int, int], deque[LatencySample]] = {}
        self._lock = threading.Lock()

    @staticmethod
    def bucket_key(s: LatencySample) -> tuple[int, int]:
        kv = min(9, int(s.kv_usage * 10))  # 10% steps
        ph = min(3, int(s.prefix_match_pct * 4))  # 0.25 steps
        return (kv, ph)

    def add(self, sample: LatencySample) -> None:
        key = self.bucket_key(sample)
        with self._lock:
            dq = self.buckets.get(key)
            if dq is None:
                dq = self.buckets[key] = deque(maxlen=self.cap)
            dq.append(sample)

    def snapshot(self) -> list[LatencySample]:
        with self._lock:
            return [s for dq in self.buckets.values() for s in dq]

    def __len__(self) -> int:
        with self._lock:
            return sum(len(dq) for dq in self.buckets.values())


class LatencyModel:
    """The two regressors (TTFT, TPOT) + fit/predict/serialize.

    A histogram GBDT plays XGBoost's role; with <min_samples the model is
    unfit and callers fall back to the composite heuristic. ``rng`` draws
    the regressors' early-stopping split (above 10,000 rows only); the
    reference's is unseeded.
    """

    MIN_SAMPLES = 32

    def __init__(self, rng: Optional[np.random.Generator] = None) -> None:
        self.rng = rng
        self.ttft = None
        self.tpot = None
        self.version = 0
        self.train_count = 0
        self.mape = {"ttft": None, "tpot": None}  # on the training window (holdout tail)

    # ------------------------------------------------------------------ train
    def fit(self, samples: list[LatencySample]) -> bool:
        ttft_rows = [(ttft_features(s), s.ttft_ms) for s in samples if s.ttft_ms is not None]
        tpot_rows = [(tpot_features(s), s.tpot_ms) for s in samples if s.tpot_ms is not None]
        fitted = False
        for name, rows in (("ttft", ttft_rows), ("tpot", tpot_rows)):
            if len(rows) < self.MIN_SAMPLES:
                continue
            X = np.asarray([r[0] for r in rows], np.float64)
            y = np.asarray([r[1] for r in rows], np.float64)
            n_hold = max(1, len(rows) // 10)
            model = HistGradientBoostingRegressor(
                max_iter=100, max_depth=6, learning_rate=0.1, min_samples_leaf=4,
                rng=self.rng,
            )
            model.fit(X[:-n_hold] if len(rows) > n_hold else X,
                      y[:-n_hold] if len(rows) > n_hold else y)
            pred = model.predict(X[-n_hold:])
            denom = np.maximum(np.abs(y[-n_hold:]), 1e-6)
            self.mape[name] = float(np.mean(np.abs(pred - y[-n_hold:]) / denom))
            setattr(self, name, model)
            fitted = True
        if fitted:
            self.version += 1
            self.train_count += 1
        return fitted

    # ---------------------------------------------------------------- predict
    def is_fit(self) -> bool:
        return self.ttft is not None

    def predict(self, samples: list[LatencySample]) -> list[tuple[Optional[float], Optional[float]]]:
        """Per sample: (predicted ttft_ms, predicted tpot_ms); None when unfit."""
        if not samples:
            return []
        out_t: list[Optional[float]] = [None] * len(samples)
        out_p: list[Optional[float]] = [None] * len(samples)
        if self.ttft is not None:
            X = np.asarray([ttft_features(s) for s in samples], np.float64)
            out_t = [max(0.0, float(v)) for v in self.ttft.predict(X)]
        if self.tpot is not None:
            X = np.asarray([tpot_features(s) for s in samples], np.float64)
            out_p = [max(0.0, float(v)) for v in self.tpot.predict(X)]
        return list(zip(out_t, out_p))

    # -------------------------------------------------------------- serialize
    def save(self, path: str | Path) -> None:
        """Atomic write to the shared model volume (training→prediction handoff)."""
        path = Path(path)
        tmp = path.with_suffix(f".tmp{self.version}")
        with open(tmp, "wb") as f:
            pickle.dump({"ttft": self.ttft, "tpot": self.tpot,
                         "version": self.version, "mape": self.mape}, f)
        tmp.replace(path)

    @classmethod
    def load(cls, path: str | Path) -> "LatencyModel":
        with open(path, "rb") as f:
            d = pickle.load(f)
        m = cls()
        m.ttft, m.tpot = d["ttft"], d["tpot"]
        m.version, m.mape = d["version"], d.get("mape", m.mape)
        return m


def heuristic_latency(sample: LatencySample) -> tuple[float, float]:
    """Composite fallback when the predictor is unavailable
    (latency-predictor.md:52): a fixed-form estimate from KV utilization, queue
    depth, and prefix match — units are pseudo-ms, only the ordering matters."""
    uncached = sample.input_len * (1.0 - sample.prefix_match_pct)
    ttft = (
        0.2 * uncached
        + 50.0 * sample.queue_depth
        + 200.0 * max(0.0, sample.kv_usage - 0.8)
        + 0.02 * sample.inflight_tokens
    )
    tpot = 5.0 + 2.0 * sample.running_requests + 100.0 * max(0.0, sample.kv_usage - 0.9)
    return ttft, tpot
