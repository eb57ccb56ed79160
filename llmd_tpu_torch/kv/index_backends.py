"""KV-index backends behind one interface (copy of the in-memory and cost-aware
parts of ``llmd_tpu/kv/index_backends.py``).

- ``in-memory`` (default): the two-level LRU ``KVBlockIndex``, bounded by entry
  count.
- ``cost-aware``: bounded by estimated bytes, with a doorkeeper that admits a
  never-seen key under pressure only on its second sighting, so one-shot scans
  cannot flush the working set.

``external`` (the index in a Redis-wire store shared by router replicas) is
refused by name until ROADMAP Queue A item 12 brings it.
"""

from __future__ import annotations

from llmd_tpu_torch.kv.indexer import KVBlockIndex

# ---------------------------------------------------------------------------
# Cost-aware backend
# ---------------------------------------------------------------------------

# rough CPython heap costs: dict slot + int key + OrderedDict node overhead
KEY_COST_BYTES = 120
POD_ENTRY_COST_BYTES = 160


class CostAwareKVBlockIndex(KVBlockIndex):
    """Byte-budget LRU with doorkeeper admission (the Ristretto role)."""

    def __init__(self, max_bytes: int = 64 << 20,
                 doorkeeper_size: int = 4096, **kw) -> None:
        kw.setdefault("max_keys", 1 << 62)  # bytes, not entry count, bound us
        super().__init__(**kw)
        self.max_bytes = max_bytes
        self._doorkeeper: set[int] = set()
        self._doorkeeper_size = doorkeeper_size
        self._pod_entries = 0  # total (block, pod) pairs, kept incrementally

    # account (block, pod) pair lifecycle — every removal path funnels
    # through _drop in the base class
    def _drop(self, pod: str, block_hash: int) -> None:
        self._pod_entries -= 1
        super()._drop(pod, block_hash)

    def estimated_bytes(self) -> int:
        with self._lock:  # reentrant: _store calls this with the lock held
            return (len(self._index) * KEY_COST_BYTES
                    + self._pod_entries * POD_ENTRY_COST_BYTES)

    def _store(self, pod: str, block_hash: int, tier: str,
               spec_expiry: float) -> None:
        is_new_key = block_hash not in self._index
        if is_new_key and self.estimated_bytes() >= self.max_bytes:
            # under pressure a never-seen key must knock twice: one-shot scans
            # (a crawler, a mass warmup) otherwise flush the hot working set
            if block_hash not in self._doorkeeper:
                if len(self._doorkeeper) >= self._doorkeeper_size:
                    self._doorkeeper.clear()
                self._doorkeeper.add(block_hash)
                return
            self._doorkeeper.discard(block_hash)
        pods_before = self._index.get(block_hash)
        had_pod = pods_before is not None and pod in pods_before
        super()._store(pod, block_hash, tier, spec_expiry)
        if not had_pod and pod in self._index.get(block_hash, {}):
            self._pod_entries += 1
        while (self.estimated_bytes() > self.max_bytes and len(self._index) > 1):
            evicted_hash, evicted_pods = self._index.popitem(last=False)
            for p in evicted_pods:
                self._drop(p, evicted_hash)
            self.stats.evictions += 1


BACKENDS = {
    "in-memory": KVBlockIndex,
    "cost-aware": CostAwareKVBlockIndex,
}


def build_index(backend: str = "in-memory", **params):
    """Index factory for config selection (kvEvents.indexBackend /
    precise-prefix producer ``indexBackend``)."""
    if backend == "external":
        raise NotImplementedError(
            "index backend 'external' (the RESP client) is not ported yet: ROADMAP "
            "Queue A item 12 (kvplane/plane.py, the external index and ha.py)")
    try:
        cls = BACKENDS[backend]
    except KeyError:
        raise KeyError(
            f"unknown index backend {backend!r}; known: {sorted(BACKENDS)}")
    return cls(**params)
