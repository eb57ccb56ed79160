"""Predicted-latency EPP plugins (copy of ``llmd_tpu/router/latency_plugins.py``).

Parity: reference latency-predictor.md:108-140 — ``predicted-latency-producer``
(predict per candidate, train on completion, streamingMode), ``latency-scorer``
(lowest-latency or SLO-headroom least/most), ``slo-headroom-tier-filter``
(positive/negative tier + exploration), ``latency-slo-admitter`` (shed sheddable
requests no endpoint can serve in SLO). All SLO plugins are no-ops without SLO
headers, so one pipeline serves both traffic kinds.

The reference draws from the global ``random`` module (the tier filter's
exploration, the sidecar client's first replica). Here both draw from an
``rng`` (a ``random.Random``) that the scheduler replaces with its own, as
``filters_pickers.py`` does, so one seed fixes the draws in the reference's
order.
"""

from __future__ import annotations

import random
from typing import Any, Optional

from llmd_tpu_torch.core.endpoint import Endpoint
from llmd_tpu_torch.core.metrics_contract import StdMetric
from llmd_tpu_torch.core.request import InferenceRequest
from llmd_tpu_torch.predictor.client import LocalPredictor, SidecarPredictorClient
from llmd_tpu_torch.predictor.model import LatencySample, heuristic_latency
from llmd_tpu_torch.router.plugins import Admitter, DataProducer, register_plugin
from llmd_tpu_torch.router.scorers import (
    STATE_PREDICTED,
    STATE_PREFIX_HITS,
    STATE_TOKEN_IDS,
    _normalize_inverse,
)

CTX_PREDICTOR = "latency_predictor"
STATE_LATENCY_SAMPLES = "latency_samples"  # endpoint.address → LatencySample


def slo_headroom_ms(req: InferenceRequest, pred: tuple[float, float]) -> Optional[float]:
    """min over the SLOs present of (slo − predicted); None when no SLO headers."""
    ttft, tpot = pred
    hs = []
    if req.slo_ttft_ms is not None:
        hs.append(req.slo_ttft_ms - ttft)
    if req.slo_tpot_ms is not None:
        hs.append(req.slo_tpot_ms - tpot)
    return min(hs) if hs else None


def predicted_e2e_ms(req: InferenceRequest, pred: tuple[float, float]) -> float:
    """E2E estimate from a (ttft_ms, tpot_ms) prediction — the same
    max-tokens extrapolation LatencyScorer ranks by in the no-SLO case. The
    decision ledger (obs/decisions.py) stamps this on ``route_decision`` so
    calibration error can be joined against the observed wall clock."""
    ttft, tpot = pred
    return float(ttft) + float(tpot) * req.sampling.max_tokens


@register_plugin("predicted-latency-producer")
class PredictedLatencyProducer(DataProducer):
    """Predict TTFT/TPOT per candidate; feed observed latencies back as training.

    ``mode``: "local" (in-process model) or "sidecar" (predictUrls/trainUrl).
    ``streamingMode``: false → TTFT trained on e2e latency, TPOT untrained
    (latency-predictor.md:112-118).
    """

    needs_ctx = True

    def __init__(self, ctx: dict[str, Any], mode: str = "local",
                 streamingMode: bool = False, predictUrls: Optional[list[str]] = None,
                 trainUrl: Optional[str] = None, retrainIntervalS: float = 5.0) -> None:
        self.ctx = ctx
        self.streaming_mode = streamingMode
        if CTX_PREDICTOR not in ctx:
            if mode == "sidecar":
                ctx[CTX_PREDICTOR] = SidecarPredictorClient(predictUrls or [], trainUrl)
            else:
                ctx[CTX_PREDICTOR] = LocalPredictor(retrain_interval_s=retrainIntervalS)
        self.predictor = ctx[CTX_PREDICTOR]
        self._rng = random.Random()
        self.stats = {
            "predictions_total": 0, "fallbacks_total": 0, "samples_total": 0,
            "ttft_violations_total": 0, "tpot_violations_total": 0,
            "actual_ttft_sum_ms": 0.0, "predicted_ttft_sum_ms": 0.0, "ttft_obs": 0,
        }

    @property
    def rng(self) -> random.Random:
        """The draw source: the sidecar client's when it has one."""
        return getattr(self.predictor, "rng", self._rng)

    @rng.setter
    def rng(self, value: random.Random) -> None:
        self._rng = value
        if isinstance(getattr(self.predictor, "rng", None), random.Random):
            self.predictor.rng = value

    @staticmethod
    def _sample_for(req: InferenceRequest, e: Endpoint) -> LatencySample:
        n_tokens = len(req.state.get(STATE_TOKEN_IDS) or req.prompt_text().encode())
        hits = req.state.get(STATE_PREFIX_HITS) or {}
        return LatencySample(
            kv_usage=e.metric(StdMetric.KV_UTILIZATION),
            input_len=float(n_tokens),
            queue_depth=e.metric(StdMetric.QUEUED_REQUESTS),
            running_requests=e.metric(StdMetric.RUNNING_REQUESTS),
            prefix_match_pct=hits.get(e.address, 0) / max(1, n_tokens),
            inflight_tokens=e.metric(StdMetric.WAITING_TOKENS),
        )

    def produce(self, req: InferenceRequest, endpoints: list[Endpoint]) -> None:
        samples = {e.address: self._sample_for(req, e) for e in endpoints}
        preds = self.predictor.predict(list(samples.values()))
        if preds is None:  # predictor cold/unreachable → composite heuristic
            preds = [heuristic_latency(s) for s in samples.values()]
            self.stats["fallbacks_total"] += 1
        self.stats["predictions_total"] += len(preds)
        req.state[STATE_PREDICTED] = dict(zip(samples.keys(), preds))
        req.state[STATE_LATENCY_SAMPLES] = samples

    def post_response(self, req: InferenceRequest, endpoint: Endpoint,
                      response_info: dict[str, Any]) -> None:
        sample = (req.state.get(STATE_LATENCY_SAMPLES) or {}).get(endpoint.address)
        if sample is None:
            return
        if self.streaming_mode:
            sample.ttft_ms = response_info.get("ttft_ms")
            sample.tpot_ms = response_info.get("itl_ms")
        else:
            sample.ttft_ms = response_info.get("e2e_ms")  # e2e-as-TTFT mode
        usage = response_info.get("usage") or {}
        sample.tokens_generated = float(usage.get("completion_tokens", 0))
        if sample.ttft_ms is None and sample.tpot_ms is None:
            return
        self.predictor.record(sample)
        self.stats["samples_total"] += 1
        pred = (req.state.get(STATE_PREDICTED) or {}).get(endpoint.address)
        if pred and sample.ttft_ms is not None:
            self.stats["actual_ttft_sum_ms"] += sample.ttft_ms
            self.stats["predicted_ttft_sum_ms"] += pred[0]
            self.stats["ttft_obs"] += 1
        if req.slo_ttft_ms is not None and sample.ttft_ms is not None \
                and sample.ttft_ms > req.slo_ttft_ms:
            self.stats["ttft_violations_total"] += 1
        if req.slo_tpot_ms is not None and sample.tpot_ms is not None \
                and sample.tpot_ms > req.slo_tpot_ms:
            self.stats["tpot_violations_total"] += 1

    def prometheus_lines(self) -> list[str]:
        s = self.stats
        return [
            f"llm_d_epp_latency_predictions_total {s['predictions_total']}",
            f"llm_d_epp_latency_fallbacks_total {s['fallbacks_total']}",
            f"llm_d_epp_latency_samples_total {s['samples_total']}",
            f"inference_objective_request_ttft_slo_violation_total {s['ttft_violations_total']}",
            f"inference_objective_request_tpot_slo_violation_total {s['tpot_violations_total']}",
            f"inference_objective_request_ttft_seconds_sum {s['actual_ttft_sum_ms'] / 1e3:.6f}",
            f"inference_objective_request_predicted_ttft_seconds_sum {s['predicted_ttft_sum_ms'] / 1e3:.6f}",
            f"inference_objective_request_ttft_seconds_count {s['ttft_obs']}",
        ]


@register_plugin("latency-scorer")
class LatencyScorer:
    """No SLO → lowest predicted latency wins. With SLO → headroom strategy:
    ``least`` bin-packs against the SLO boundary, ``most`` spreads; negative
    headroom always uses least-deficit (latency-predictor.md:128-133)."""

    def __init__(self, headroomSelectionStrategy: str = "least") -> None:
        assert headroomSelectionStrategy in ("least", "most")
        self.strategy = headroomSelectionStrategy

    def score(self, req: InferenceRequest, endpoints: list[Endpoint]) -> dict[Endpoint, float]:
        preds = req.state.get(STATE_PREDICTED) or {}
        if not preds:
            return {e: 0.0 for e in endpoints}
        if req.slo_ttft_ms is None and req.slo_tpot_ms is None:
            lat = {
                e: preds[e.address][0] + preds[e.address][1] * req.sampling.max_tokens
                for e in endpoints if e.address in preds
            }
            return _normalize_inverse(lat)
        out: dict[Endpoint, float] = {}
        for e in endpoints:
            p = preds.get(e.address)
            if p is None:
                out[e] = 0.0
                continue
            h = slo_headroom_ms(req, p)
            if h is None:
                out[e] = 0.0
            elif h < 0:  # deficit: least-bad, scores in (0, 0.5)
                out[e] = 0.5 / (1.0 + (-h) / 100.0)
            elif self.strategy == "least":  # bin-pack: near boundary, (0.5, 1]
                out[e] = 0.5 + 0.5 / (1.0 + h / 100.0)
            else:  # most: spread, increasing in h, (0.5, 1)
                out[e] = 0.5 + 0.5 * (h / (h + 100.0))
        return out


@register_plugin("slo-headroom-tier-filter")
class SLOHeadroomTierFilter:
    """Positive tier (meets SLO) wins; the negative tier gets explored with
    probability ``exploreNegativeProb`` so recovering pods see traffic."""

    def __init__(self, exploreNegativeProb: float = 0.02) -> None:
        self.rng = random.Random()
        self.explore = exploreNegativeProb

    def filter(self, req: InferenceRequest, endpoints: list[Endpoint]) -> list[Endpoint]:
        if req.slo_ttft_ms is None and req.slo_tpot_ms is None:
            return endpoints  # no-op without SLO headers
        preds = req.state.get(STATE_PREDICTED) or {}
        positive = [
            e for e in endpoints
            if e.address in preds and (slo_headroom_ms(req, preds[e.address]) or -1) >= 0
        ]
        if not positive or self.rng.random() < self.explore:
            return endpoints
        return positive


@register_plugin("latency-slo-admitter")
class LatencySLOAdmitter(Admitter):
    """Reject sheddable requests (priority < 0) that no endpoint can serve within
    SLO — don't spend capacity on a guaranteed miss (latency-predictor.md:136)."""

    def admit(self, req: InferenceRequest, endpoints: list[Endpoint]) -> tuple[bool, str]:
        if req.priority >= 0:
            return True, ""
        if req.slo_ttft_ms is None and req.slo_tpot_ms is None:
            return True, ""
        preds = req.state.get(STATE_PREDICTED) or {}
        if not preds:
            return True, ""
        for e in endpoints:
            p = preds.get(e.address)
            if p is not None and (slo_headroom_ms(req, p) or -1) >= 0:
                return True, ""
        return False, "no endpoint within SLO for sheddable request"
