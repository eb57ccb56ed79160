"""Predictor access for the EPP producer: in-process or sidecar HTTP (copy of
``llmd_tpu/predictor/client.py``).

Two modes (both satisfy the same interface the plugins consume):

- ``LocalPredictor`` — model + window live in the router process (standalone /
  no-Kubernetes mode; zero hot-path RPC). Retraining runs on a background thread.
- ``SidecarPredictorClient`` — blocking HTTP to the prediction sidecars with a tight
  timeout and round-robin over replicas; samples go to the training sidecar
  fire-and-forget. Failure → None, and callers fall back to the composite heuristic
  (latency-predictor.md:52).

The sidecar client draws its first replica from ``rng`` (the reference: the
global ``random``); the latency producer hands it the scheduler's.
"""

from __future__ import annotations

import json
import random
import threading
import time
import urllib.request
from typing import Optional, Sequence

from llmd_tpu_torch.predictor.model import (
    LatencyModel,
    LatencySample,
    StratifiedWindow,
    heuristic_latency,
)


class LocalPredictor:
    """In-process train+predict (the single-binary deployment shape)."""

    def __init__(self, retrain_interval_s: float = 5.0, per_bucket_cap: int = 256) -> None:
        self.window = StratifiedWindow(per_bucket_cap)
        self.model = LatencyModel()
        self.retrain_interval = retrain_interval_s
        self._lock = threading.Lock()
        self._last_fit = 0.0

    def predict(self, samples: Sequence[LatencySample]) -> Optional[list[tuple[float, float]]]:
        with self._lock:
            if not self.model.is_fit():
                return None
            preds = self.model.predict(list(samples))
        return [(t if t is not None else heuristic_latency(s)[0],
                 p if p is not None else heuristic_latency(s)[1])
                for (t, p), s in zip(preds, samples)]

    def record(self, sample: LatencySample) -> None:
        self.window.add(sample)
        now = time.monotonic()
        if now - self._last_fit >= self.retrain_interval:
            self._last_fit = now
            threading.Thread(target=self._fit, daemon=True).start()

    def _fit(self) -> None:
        samples = self.window.snapshot()
        if not samples:
            return
        model = LatencyModel()
        with self._lock:
            model.version = self.model.version
        if model.fit(samples):
            with self._lock:
                model.train_count = self.model.train_count + 1
                self.model = model

    def fit_now(self) -> bool:
        """Synchronous refit (tests/calibration)."""
        samples = self.window.snapshot()
        if not samples:
            return False
        with self._lock:
            return self.model.fit(samples)


class SidecarPredictorClient:
    """Talks to prediction/training sidecars (latency-predictor.md deployment)."""

    def __init__(self, predict_urls: Sequence[str], train_url: Optional[str] = None,
                 timeout_s: float = 0.15) -> None:
        self.predict_urls = list(predict_urls)
        self.train_url = train_url
        self.timeout_s = timeout_s
        self.failures = 0
        self.rng = random.Random()

    def _post(self, url: str, payload: dict, timeout: float) -> Optional[dict]:
        data = json.dumps(payload).encode()
        req = urllib.request.Request(
            url, data=data, headers={"Content-Type": "application/json"}
        )
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return json.loads(resp.read())
        except Exception:
            return None

    def predict(self, samples: Sequence[LatencySample]) -> Optional[list[tuple[float, float]]]:
        if not self.predict_urls or not samples:
            return None
        urls = self.predict_urls
        start = self.rng.randrange(len(urls))
        for i in range(len(urls)):  # round-robin with failover
            url = urls[(start + i) % len(urls)]
            out = self._post(f"{url}/predict", {
                "samples": [s.__dict__ for s in samples]
            }, self.timeout_s)
            if out and out.get("predictions"):
                return [
                    (d["ttft_ms"] if d["ttft_ms"] is not None else heuristic_latency(s)[0],
                     d["tpot_ms"] if d["tpot_ms"] is not None else heuristic_latency(s)[1])
                    for d, s in zip(out["predictions"], samples)
                ]
        self.failures += 1
        return None

    def record(self, sample: LatencySample) -> None:
        if self.train_url is None:
            return
        threading.Thread(  # fire-and-forget; training is off the hot path
            target=self._post,
            args=(f"{self.train_url}/samples", {"samples": [sample.__dict__]}, 2.0),
            daemon=True,
        ).start()
