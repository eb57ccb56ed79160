"""Scorer plugins and the approximate prefix-cache producer (copy of
``llmd_tpu/router/scorers.py``).

All scorers return normalized scores in [0, 1] per endpoint (higher = better), combined
by weighted sum in the scheduler.
"""

from __future__ import annotations

import hashlib
import time
from collections import OrderedDict
from typing import Any

from llmd_tpu_torch.core.endpoint import Endpoint
from llmd_tpu_torch.core.kv_events import block_keys_for_tokens
from llmd_tpu_torch.core.metrics_contract import StdMetric
from llmd_tpu_torch.core.request import InferenceRequest
from llmd_tpu_torch.router.plugins import DataProducer, register_plugin

STATE_TOKEN_IDS = "token_ids"  # set by token-producer (render+tokenize once)
STATE_BLOCK_KEYS = "block_keys"
STATE_PREFIX_HITS = "prefix_hits"  # endpoint.address → matched tokens
STATE_PREDICTED = "predicted_latency"


def _normalize_inverse(values: dict[Endpoint, float]) -> dict[Endpoint, float]:
    """Map raw 'lower is better' values to [0,1] where lowest → 1."""
    if not values:
        return {}
    mx = max(values.values())
    if mx <= 0:
        return {e: 1.0 for e in values}
    return {e: 1.0 - v / mx for e, v in values.items()}


def clamp_scores(scores: dict[Endpoint, float],
                 within: dict[Endpoint, Any]) -> dict[Endpoint, float]:
    """Clamp a scorer result to the post-filter candidate set ``within``.

    Scorers are handed the surviving candidates, but one working off cached
    state (a stale snapshot taken before a filter pass) can hand back scores
    for endpoints that were filtered out. Entries outside the candidate set
    are dropped, and if the dropped entry held the normalization max the
    survivors are rescaled so the best of them is 1.0 again — otherwise a
    stale scorer's effective weight silently shrinks relative to its peers
    in the weighted sum. Well-behaved scorers pass through untouched."""
    if all(e in within for e in scores):
        return scores
    kept = {e: s for e, s in scores.items() if e in within}
    mx = max(kept.values(), default=0.0)
    if 0.0 < mx < 1.0:
        inv = 1.0 / mx
        kept = {e: s * inv for e, s in kept.items()}
    return kept


@register_plugin("queue-depth-scorer")
class QueueDepthScorer:
    def score(self, req: InferenceRequest, endpoints: list[Endpoint]) -> dict[Endpoint, float]:
        return _normalize_inverse({e: e.metric(StdMetric.QUEUED_REQUESTS) for e in endpoints})


@register_plugin("kv-cache-utilization-scorer")
class KVCacheUtilizationScorer:
    def score(self, req: InferenceRequest, endpoints: list[Endpoint]) -> dict[Endpoint, float]:
        return {e: 1.0 - min(1.0, e.metric(StdMetric.KV_UTILIZATION)) for e in endpoints}


@register_plugin("running-requests-scorer")
class RunningRequestsScorer:
    def score(self, req: InferenceRequest, endpoints: list[Endpoint]) -> dict[Endpoint, float]:
        return _normalize_inverse({e: e.metric(StdMetric.RUNNING_REQUESTS) for e in endpoints})


@register_plugin("token-load-scorer")
class TokenLoadScorer:
    """Approximate per-endpoint in-flight token load (scheduling.md token-load)."""

    needs_ctx = True

    def __init__(self, ctx: dict[str, Any]) -> None:
        self.inflight = ctx.setdefault("inflight_tokens", {})

    def score(self, req: InferenceRequest, endpoints: list[Endpoint]) -> dict[Endpoint, float]:
        return _normalize_inverse({e: float(self.inflight.get(e.address, 0)) for e in endpoints})


@register_plugin("session-affinity-scorer")
class SessionAffinityScorer:
    """Stable-hash the fairness/session id onto endpoints (scheduling.md session-affinity)."""

    def score(self, req: InferenceRequest, endpoints: list[Endpoint]) -> dict[Endpoint, float]:
        sid = req.fairness_id or req.request_id
        if not endpoints:
            return {}
        h = int(hashlib.md5(sid.encode()).hexdigest()[:8], 16)
        chosen = sorted(endpoints, key=lambda e: e.address)[h % len(endpoints)]
        return {e: (1.0 if e == chosen else 0.0) for e in endpoints}


@register_plugin("lora-affinity-scorer")
class LoraAffinityScorer:
    """Prefer endpoints already serving the requested adapter (model-servers.md:55-75)."""

    def __init__(self, loaded_weight: float = 1.0, waiting_weight: float = 0.6,
                 free_weight: float = 0.3) -> None:
        self.loaded_weight, self.waiting_weight, self.free_weight = (
            loaded_weight, waiting_weight, free_weight)

    def score(self, req: InferenceRequest, endpoints: list[Endpoint]) -> dict[Endpoint, float]:
        adapter = req.lora_adapter or req.model
        out: dict[Endpoint, float] = {}
        for e in endpoints:
            info = e.attrs.get(StdMetric.LORA_INFO) or {}
            running = info.get("running", [])
            waiting = info.get("waiting", [])
            max_lora = info.get("max_lora", 0)
            if adapter in running:
                out[e] = self.loaded_weight
            elif adapter in waiting:
                out[e] = self.waiting_weight
            elif max_lora and len(running) < max_lora:
                out[e] = self.free_weight
            else:
                out[e] = 0.0
        return out


class _LRUSet:
    def __init__(self, capacity: int) -> None:
        self.capacity = capacity
        self._d: OrderedDict[Any, float] = OrderedDict()

    def add(self, key: Any) -> None:
        self._d[key] = time.monotonic()
        self._d.move_to_end(key)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)

    def __contains__(self, key: Any) -> bool:
        return key in self._d


@register_plugin("approx-prefix-cache-producer")
class ApproxPrefixCacheProducer(DataProducer):
    """Router-side model of each endpoint's prefix cache (no KV events needed):
    hash prompt blocks, remember which endpoint served which block chain (LRU
    per endpoint), score by the longest consecutive match. The precise,
    event-driven variant is ``kv/plugins.py`` over ``kv/indexer.py``."""

    needs_ctx = True

    def __init__(self, ctx: dict[str, Any], blockSize: int = 16,
                 lruCapacityPerServer: int = 31250, maxPrefixBlocks: int = 256) -> None:
        self.block_size = blockSize
        self.capacity = lruCapacityPerServer
        self.max_blocks = maxPrefixBlocks
        self.tables: dict[str, _LRUSet] = ctx.setdefault("approx_prefix_tables", {})

    def _table(self, address: str) -> _LRUSet:
        t = self.tables.get(address)
        if t is None:
            t = self.tables[address] = _LRUSet(self.capacity)
        return t

    def produce(self, req: InferenceRequest, endpoints: list[Endpoint]) -> None:
        token_ids = req.state.get(STATE_TOKEN_IDS)
        if token_ids is None:
            token_ids = [b for b in req.prompt_text().encode("utf-8")]
            req.state[STATE_TOKEN_IDS] = token_ids
        # The approx index is router-internal, so its lora term only needs to
        # ISOLATE traffic classes: `lora_adapter or model` covers the canary flow
        # where the adapter is addressed as the model name (adapter-rollout.md) —
        # adapter traffic then builds affinity separately from base traffic.
        # (The precise producer must instead match engine-computed hashes, which
        # requires the explicit lora_adapter field.)
        keys = block_keys_for_tokens(token_ids, self.block_size,
                                     req.lora_adapter or req.model,
                                     req.mm_hashes)[: self.max_blocks]
        req.state[STATE_BLOCK_KEYS] = keys
        hits: dict[str, int] = {}
        for e in endpoints:
            t = self._table(e.address)
            n = 0
            for k in keys:
                if k in t:
                    n += 1
                else:
                    break
            hits[e.address] = n * self.block_size
        req.state[STATE_PREFIX_HITS] = hits

    def pre_request(self, req: InferenceRequest, endpoint: Endpoint) -> None:
        # speculative insert: assume the chosen endpoint now caches the whole chain
        t = self._table(endpoint.address)
        for k in req.state.get(STATE_BLOCK_KEYS, []):
            t.add(k)


@register_plugin("prefix-cache-scorer")
class PrefixCacheScorer:
    """Score = matched-prefix fraction (uses producer output; precise or approx)."""

    def score(self, req: InferenceRequest, endpoints: list[Endpoint]) -> dict[Endpoint, float]:
        hits = req.state.get(STATE_PREFIX_HITS) or {}
        n_tokens = max(1, len(req.state.get(STATE_TOKEN_IDS) or req.prompt_text().encode()))
        return {e: min(1.0, hits.get(e.address, 0) / n_tokens) for e in endpoints}


@register_plugin("no-hit-lru-scorer")
class NoHitLRUScorer:
    """When nothing has the prefix, steer to the endpoint least-recently given a
    no-hit request — spreads fresh prefixes across the pool instead of piling them on
    the current best-scored pod (reference tiered-prefix-cache values, scheduling.md).
    """

    needs_ctx = True

    def __init__(self, ctx: dict[str, Any]) -> None:
        self.last_no_hit: dict[str, float] = ctx.setdefault("no_hit_lru", {})

    def score(self, req: InferenceRequest, endpoints: list[Endpoint]) -> dict[Endpoint, float]:
        hits = req.state.get(STATE_PREFIX_HITS) or {}
        if any(v > 0 for v in hits.values()):
            return {e: 0.0 for e in endpoints}
        raw = {e: self.last_no_hit.get(e.address, 0.0) for e in endpoints}
        return _normalize_inverse({e: v - min(raw.values()) for e, v in raw.items()})

    def note_pick(self, endpoint: Endpoint) -> None:
        self.last_no_hit[endpoint.address] = time.monotonic()


@register_plugin("inflight-load-producer")
class InflightLoadProducer(DataProducer):
    """PreRequest++ / ResponseBody-- in-flight counters (request-handling.md)."""

    needs_ctx = True

    def __init__(self, ctx: dict[str, Any]) -> None:
        self.counts: dict[str, int] = ctx.setdefault("inflight_requests", {})
        self.tokens: dict[str, int] = ctx.setdefault("inflight_tokens", {})

    def pre_request(self, req: InferenceRequest, endpoint: Endpoint) -> None:
        self.counts[endpoint.address] = self.counts.get(endpoint.address, 0) + 1
        n = len(req.state.get(STATE_TOKEN_IDS) or []) + req.sampling.max_tokens
        self.tokens[endpoint.address] = self.tokens.get(endpoint.address, 0) + n

    def post_response(self, req: InferenceRequest, endpoint: Endpoint,
                      response_info: dict[str, Any]) -> None:
        self.counts[endpoint.address] = max(0, self.counts.get(endpoint.address, 0) - 1)
        n = len(req.state.get(STATE_TOKEN_IDS) or []) + req.sampling.max_tokens
        self.tokens[endpoint.address] = max(0, self.tokens.get(endpoint.address, 0) - n)
