"""Filter and Picker plugins (copy of ``llmd_tpu/router/filters_pickers.py``).

The reference draws from the global ``random`` module. Here every plugin that
draws holds an ``rng`` (a ``random.Random``): a fresh one of its own, replaced
by the scheduler's, so one seed fixes every draw of a scheduler and its
plugins, in the reference's order."""

from __future__ import annotations

import random
from typing import Optional

from llmd_tpu_torch.core.endpoint import Endpoint, EndpointRole
from llmd_tpu_torch.core.metrics_contract import StdMetric
from llmd_tpu_torch.core.request import InferenceRequest
from llmd_tpu_torch.router.plugins import register_plugin
from llmd_tpu_torch.router.scorers import STATE_PREFIX_HITS


@register_plugin("label-selector-filter")
class LabelSelectorFilter:
    def __init__(self, **labels: str) -> None:
        self.labels = labels

    def filter(self, req: InferenceRequest, endpoints: list[Endpoint]) -> list[Endpoint]:
        return [
            e for e in endpoints
            if all(e.labels.get(k) == v for k, v in self.labels.items())
        ]


@register_plugin("prefill-endpoints-filter")
class PrefillEndpointsFilter:
    def filter(self, req: InferenceRequest, endpoints: list[Endpoint]) -> list[Endpoint]:
        return [e for e in endpoints if e.role in (EndpointRole.PREFILL, EndpointRole.BOTH)]


@register_plugin("decode-endpoints-filter")
class DecodeEndpointsFilter:
    def filter(self, req: InferenceRequest, endpoints: list[Endpoint]) -> list[Endpoint]:
        return [e for e in endpoints if e.role in (EndpointRole.DECODE, EndpointRole.BOTH)]


@register_plugin("prefix-cache-affinity-filter")
class PrefixCacheAffinityFilter:
    """Epsilon-greedy prefix affinity with load gates (latency-predictor.md:110-115):
    exploit cache-warm endpoints, explore with probability epsilon, and break
    affinity when the warm pods are materially slower — by queue depth always, and
    by predicted TTFT when the latency producer has run (the TTFT load gate)."""

    def __init__(self, epsilon: float = 0.05, queue_gate: float = 16.0,
                 ttft_penalty_ms: float = 500.0) -> None:
        self.rng = random.Random()
        self.epsilon = epsilon
        self.queue_gate = queue_gate
        self.ttft_penalty_ms = ttft_penalty_ms

    def filter(self, req: InferenceRequest, endpoints: list[Endpoint]) -> list[Endpoint]:
        hits = req.state.get(STATE_PREFIX_HITS) or {}
        if not hits or self.rng.random() < self.epsilon:
            return endpoints
        best = max(hits.values())
        if best <= 0:
            return endpoints
        keep = [
            e for e in endpoints
            if hits.get(e.address, 0) == best
            and e.metric(StdMetric.QUEUED_REQUESTS) < self.queue_gate
        ]
        if not keep:
            return endpoints
        preds = req.state.get("predicted_latency") or {}
        if preds:  # TTFT load gate: saturated warm pod must not hoard its prefix
            warm_best = min(
                (preds[e.address][0] for e in keep if e.address in preds), default=None
            )
            overall_best = min(
                (preds[e.address][0] for e in endpoints if e.address in preds),
                default=None,
            )
            if warm_best is not None and overall_best is not None \
                    and warm_best - overall_best > self.ttft_penalty_ms:
                return endpoints
        return keep


@register_plugin("max-score-picker")
class MaxScorePicker:
    def __init__(self) -> None:
        self.rng = random.Random()

    def pick(self, req: InferenceRequest, scored: dict[Endpoint, float]) -> Optional[Endpoint]:
        if not scored:
            return None
        mx = max(scored.values())
        best = [e for e, s in scored.items() if s >= mx - 1e-9]
        return self.rng.choice(best)  # tie-break uniformly


@register_plugin("random-picker")
class RandomPicker:
    def __init__(self) -> None:
        self.rng = random.Random()

    def pick(self, req: InferenceRequest, scored: dict[Endpoint, float]) -> Optional[Endpoint]:
        return self.rng.choice(list(scored)) if scored else None


@register_plugin("weighted-random-picker")
class WeightedRandomPicker:
    def __init__(self) -> None:
        self.rng = random.Random()

    def pick(self, req: InferenceRequest, scored: dict[Endpoint, float]) -> Optional[Endpoint]:
        if not scored:
            return None
        eps = 1e-6
        eps_weights = [s + eps for s in scored.values()]
        return self.rng.choices(list(scored), weights=eps_weights, k=1)[0]
