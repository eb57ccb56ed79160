"""Router plugins for precise (event-driven) prefix-cache routing (copy of
``llmd_tpu/kv/plugins.py``).

The precise path tokenizes the prompt once through a model server's render
route (``token-producer``), chains block keys with the engine's block size
(``blockSize`` must equal the engine's page size), walks the event-fed
``KVBlockIndex`` per candidate pod and speculatively indexes the chosen pod's
keys. The render call goes over the router's standard-library HTTP client
(``router/http.py``) under the reference's timeout.
"""

from __future__ import annotations

import time
from typing import Any, Optional

from llmd_tpu_torch.core.endpoint import Endpoint
from llmd_tpu_torch.core.kv_events import block_keys_for_tokens
from llmd_tpu_torch.core.request import InferenceRequest
from llmd_tpu_torch.kv.indexer import KVBlockIndex
from llmd_tpu_torch.router.plugins import DataProducer, register_plugin
from llmd_tpu_torch.router.scorers import STATE_BLOCK_KEYS, STATE_PREFIX_HITS, STATE_TOKEN_IDS

CTX_KV_INDEX = "kv_index"
STATE_PREFIX_WEIGHTED = "prefix_weighted"  # endpoint.address → tier-weighted block sum


@register_plugin("token-producer")
class TokenProducer(DataProducer):
    """Tokenize the prompt once via a model server's render endpoint.

    The router server awaits ``aproduce`` before scheduling (the scheduler itself is
    synchronous); ``produce`` falls back to deterministic byte-level tokens when no
    render call happened (e.g. no endpoints yet) so downstream block hashing always
    has input — that matches the fake fixture's tokenizer and keeps approx routing
    self-consistent even without real tokenization.
    """

    def __init__(self, renderTimeout: float = 0.5) -> None:
        self.timeout = float(renderTimeout)
        self.render_calls = 0
        self.render_errors = 0
        self._last_good: Optional[str] = None  # avoid re-paying a dead endpoint's timeout
        self._cooldown_until = 0.0  # negative cache: all endpoints failed recently

    async def aproduce(self, req: InferenceRequest, endpoints: list[Endpoint],
                       client) -> None:
        """``client``: the router's ``router.http.HTTPClient``."""
        if req.token_ids is not None:
            req.state[STATE_TOKEN_IDS] = list(req.token_ids)
            return
        if STATE_TOKEN_IDS in req.state:
            return
        path = "/v1/chat/completions/render" if req.messages is not None else "/v1/completions/render"
        body: dict[str, Any] = {"model": req.model}
        if req.messages is not None:
            body["messages"] = req.messages
        else:
            body["prompt"] = req.prompt or ""
        if time.monotonic() < self._cooldown_until:
            return  # every endpoint failed recently; fall back to byte-level tokens
        ordered = sorted(endpoints, key=lambda e: e.address != self._last_good)
        for ep in ordered:
            try:
                resp = await client.request("POST", f"http://{ep.address}{path}",
                                            json_body=body, timeout=self.timeout)
                try:
                    data = await resp.json()
                finally:
                    resp.close()
                ids = data.get("prompt_token_ids")
                if ids is not None:
                    req.state[STATE_TOKEN_IDS] = [int(t) for t in ids]
                    self.render_calls += 1
                    self._last_good = ep.address
                    return
            except Exception:
                self.render_errors += 1
                if ep.address == self._last_good:
                    self._last_good = None
                continue
        if endpoints:
            self._cooldown_until = time.monotonic() + 2.0

    def produce(self, req: InferenceRequest, endpoints: list[Endpoint]) -> None:
        if STATE_TOKEN_IDS not in req.state:
            req.state[STATE_TOKEN_IDS] = list(req.prompt_text().encode("utf-8"))


@register_plugin("precise-prefix-cache-producer")
class PrecisePrefixCacheProducer(DataProducer):
    """Walk the event-fed KV index per endpoint; speculatively index the pick."""

    needs_ctx = True

    def __init__(self, ctx: dict[str, Any], blockSize: int = 16,
                 maxPrefixBlocks: int = 1024, maxKeys: int = 1_000_000,
                 maxPodsPerKey: int = 10, speculativeTTL: float = 2.0,
                 tierWeights: Optional[dict[str, float]] = None,
                 indexBackend: str = "in-memory",
                 indexParams: Optional[dict[str, Any]] = None) -> None:
        self.block_size = blockSize
        self.max_blocks = maxPrefixBlocks
        if indexBackend == "in-memory":
            index = KVBlockIndex(
                max_keys=maxKeys, max_pods_per_key=maxPodsPerKey,
                tier_weights=tierWeights, speculative_ttl_s=speculativeTTL)
        else:
            # cost-aware (external is refused by build_index) —
            # byte/host sizing lives in indexParams; the shared knobs
            # (maxPodsPerKey etc.) carry over rather than silently resetting
            # to backend defaults
            from llmd_tpu_torch.kv.index_backends import build_index

            index = build_index(indexBackend, tier_weights=tierWeights,
                                speculative_ttl_s=speculativeTTL,
                                max_pods_per_key=maxPodsPerKey,
                                **(indexParams or {}))
        self.index: KVBlockIndex = ctx.setdefault(CTX_KV_INDEX, index)

    def produce(self, req: InferenceRequest, endpoints: list[Endpoint]) -> None:
        token_ids = req.state.get(STATE_TOKEN_IDS)
        if token_ids is None:
            token_ids = list(req.prompt_text().encode("utf-8"))
            req.state[STATE_TOKEN_IDS] = token_ids
        # Engines hash blocks under the generation-scoped adapter key
        # 'name@digest' (engine._lora_hash_key); hash with the index's learned
        # mapping or router-side keys never match engine-published ones.
        lora_key = self.index.resolve_lora_key(req.lora_adapter)
        keys = block_keys_for_tokens(token_ids, self.block_size, lora_key,
                                     req.mm_hashes)[: self.max_blocks]
        req.state[STATE_BLOCK_KEYS] = keys
        matches = self.index.lookup(keys, [e.address for e in endpoints])
        req.state[STATE_PREFIX_HITS] = {
            a: m.blocks * self.block_size for a, m in matches.items()
        }
        req.state[STATE_PREFIX_WEIGHTED] = {a: m.weighted for a, m in matches.items()}

    def pre_request(self, req: InferenceRequest, endpoint: Endpoint) -> None:
        keys = req.state.get(STATE_BLOCK_KEYS)
        if keys:
            self.index.add_speculative(endpoint.address, keys)


@register_plugin("precise-prefix-cache-scorer")
class PrecisePrefixCacheScorer:
    """Tier-weighted prefix score: HBM-resident prefixes beat CPU/FS-resident ones
    of the same length (kv-indexer.md tier weights gpu=1.0/cpu=0.8)."""

    def score(self, req: InferenceRequest, endpoints: list[Endpoint]) -> dict[Endpoint, float]:
        weighted = req.state.get(STATE_PREFIX_WEIGHTED)
        if weighted is None:  # fell back to approx producer: use plain hits
            hits = req.state.get(STATE_PREFIX_HITS) or {}
            n = max(1, len(req.state.get(STATE_TOKEN_IDS) or [1]))
            return {e: min(1.0, hits.get(e.address, 0) / n) for e in endpoints}
        n_blocks = max(1, len(req.state.get(STATE_BLOCK_KEYS) or [1]))
        return {e: min(1.0, weighted.get(e.address, 0.0) / n_blocks) for e in endpoints}
