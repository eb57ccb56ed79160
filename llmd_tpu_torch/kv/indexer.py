"""KV-cache indexer: the router's view of which pod caches which KV block, on
which tier (copy of ``llmd_tpu/kv/indexer.py``).

- A two-level LRU (block -> pod -> tiers), both levels capacity-bounded.
- Longest-consecutive-prefix lookup, tier-weighted (HBM 1.0, CPU 0.8, FS 0.5).
- Speculative indexing: after a pick, the prompt's block keys are inserted for
  the chosen pod with a short TTL (2 s), so back-to-back prompts stay sticky
  before the engine's own events arrive.
- Events: BlockStored / BlockRemoved / AllBlocksCleared per pod.

Thread-safe: written from the KV-event subscriber, read on every schedule.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Optional, Sequence

from llmd_tpu_torch.core.kv_events import (
    AllBlocksCleared,
    BlockRemoved,
    BlockStored,
    KVEvent,
    MEDIUM_CPU,
    MEDIUM_FS,
    MEDIUM_HBM,
)

DEFAULT_TIER_WEIGHTS = {MEDIUM_HBM: 1.0, MEDIUM_CPU: 0.8, MEDIUM_FS: 0.5}

SPECULATIVE_TTL_S = 2.0  # kv-indexer.md speculative indexing TTL


@dataclass
class _PodEntry:
    """Per-(block, pod) residency. A block can live on SEVERAL tiers of one pod at
    once (HBM evicted→CPU while still indexed, CPU demoted→FS), so tiers is a map
    tier → confirmation: 0.0 = confirmed by an engine event, else the monotonic
    expiry of a speculative entry."""

    tiers: dict[str, float] = field(default_factory=dict)

    def live(self, now: float) -> bool:
        return any(exp == 0.0 or now < exp for exp in self.tiers.values())

    def best_weight(self, weights: dict[str, float], now: float) -> float:
        live = [t for t, exp in self.tiers.items() if exp == 0.0 or now < exp]
        return max((weights.get(t, 0.0) for t in live), default=0.0)


@dataclass
class PrefixMatch:
    """Result of the longest-consecutive-prefix walk for one pod."""

    blocks: int = 0  # consecutive blocks matched from the start
    weighted: float = 0.0  # sum of tier weights over matched blocks


@dataclass
class IndexStats:
    events_applied: int = 0
    blocks_stored: int = 0
    blocks_removed: int = 0
    clears: int = 0
    lookups: int = 0
    evictions: int = 0
    speculative_inserts: int = 0


class KVBlockIndex:
    """Two-level LRU: block_hash → (pod → tier), both levels capacity-bounded."""

    def __init__(
        self,
        max_keys: int = 1_000_000,
        max_pods_per_key: int = 10,
        tier_weights: Optional[dict[str, float]] = None,
        speculative_ttl_s: float = SPECULATIVE_TTL_S,
    ) -> None:
        self.max_keys = max_keys
        self.max_pods_per_key = max_pods_per_key
        self.tier_weights = dict(tier_weights or DEFAULT_TIER_WEIGHTS)
        self.spec_ttl = speculative_ttl_s
        # adapter name → generation-scoped hash key learned from BlockStored
        # events (see apply()); consulted by the precise prefix producer
        self._lora_keys: dict[str, str] = {}
        self._lock = threading.RLock()
        # level 1: block_hash → level 2 (pod → entry), LRU on level 1.
        self._index: OrderedDict[int, OrderedDict[str, _PodEntry]] = OrderedDict()
        # reverse map pod → its keys, so AllBlocksCleared / pod removal are
        # O(keys-for-that-pod), not O(max_keys) under the lock.
        self._pod_keys: dict[str, set[int]] = {}
        self.stats = IndexStats()

    def resolve_lora_key(self, name: Optional[str]) -> Optional[str]:
        """Adapter name → generation-scoped 'name@digest' key learned from
        BlockStored events; falls back to the plain name before any engine has
        published blocks for the adapter (those hashes simply won't match yet)."""
        if not name:
            return name
        with self._lock:
            return self._lora_keys.get(name, name)

    def _drop(self, pod: str, block_hash: int) -> None:
        keys = self._pod_keys.get(pod)
        if keys is not None:
            keys.discard(block_hash)
            if not keys:
                del self._pod_keys[pod]

    # ---------------------------------------------------------------- events
    def apply(self, pod: str, event: KVEvent) -> None:
        with self._lock:
            self.stats.events_applied += 1
            if isinstance(event, BlockStored):
                if event.lora_id and "@" in event.lora_id:
                    # Engines hash blocks under the GENERATION-scoped adapter key
                    # 'name@<weights-digest>' (engine._lora_hash_key). Learn the
                    # mapping from the event stream so router-side producers hash
                    # with the same term — a plain-name hash would never match.
                    self._lora_keys[event.lora_id.split("@", 1)[0]] = event.lora_id
                for h in event.block_hashes:
                    self._store(pod, h, event.medium, spec_expiry=0.0)
                self.stats.blocks_stored += len(event.block_hashes)
            elif isinstance(event, BlockRemoved):
                for h in event.block_hashes:
                    pods = self._index.get(h)
                    if pods is None:
                        continue
                    entry = pods.get(pod)
                    # Only remove the matching tier: a gpu-tier removal right after
                    # an offload's BlockStored(cpu) must keep the CPU-tier entry.
                    if entry is not None:
                        entry.tiers.pop(event.medium, None)
                        if not entry.tiers:
                            del pods[pod]
                            self._drop(pod, h)
                            if not pods:
                                del self._index[h]
                self.stats.blocks_removed += len(event.block_hashes)
            elif isinstance(event, AllBlocksCleared):
                for h in self._pod_keys.pop(pod, ()):
                    pods = self._index.get(h)
                    if pods is not None:
                        pods.pop(pod, None)
                        if not pods:
                            del self._index[h]
                self.stats.clears += 1

    def apply_batch(self, pod: str, events: Sequence[KVEvent]) -> None:
        for ev in events:
            self.apply(pod, ev)

    def _store(self, pod: str, block_hash: int, tier: str, spec_expiry: float) -> None:
        pods = self._index.get(block_hash)
        if pods is None:
            pods = self._index[block_hash] = OrderedDict()
        existing = pods.get(pod)
        if existing is not None:
            cur = existing.tiers.get(tier)
            # a confirmed tier entry never downgrades back to speculative
            if spec_expiry == 0.0 or cur is None or cur != 0.0:
                existing.tiers[tier] = spec_expiry
            pods.move_to_end(pod)
        else:
            pods[pod] = _PodEntry(tiers={tier: spec_expiry})
            self._pod_keys.setdefault(pod, set()).add(block_hash)
            while len(pods) > self.max_pods_per_key:
                evicted_pod, _ = pods.popitem(last=False)
                self._drop(evicted_pod, block_hash)
                self.stats.evictions += 1
        self._index.move_to_end(block_hash)
        while len(self._index) > self.max_keys:
            evicted_hash, evicted_pods = self._index.popitem(last=False)
            for p in evicted_pods:
                self._drop(p, evicted_hash)
            self.stats.evictions += 1

    # ------------------------------------------------------------- speculative
    def add_speculative(self, pod: str, block_hashes: Sequence[int],
                        tier: str = MEDIUM_HBM) -> None:
        """Insert short-TTL entries after a scheduling pick (kv-indexer.md:104-143)."""
        expiry = time.monotonic() + self.spec_ttl
        with self._lock:
            for h in block_hashes:
                self._store(pod, h, tier, spec_expiry=expiry)
            self.stats.speculative_inserts += len(block_hashes)

    # ----------------------------------------------------------------- lookup
    def lookup(self, block_hashes: Sequence[int],
               pods: Sequence[str]) -> dict[str, PrefixMatch]:
        """Longest-consecutive-prefix walk per candidate pod (HOT: every request)."""
        now = time.monotonic()
        out = {p: PrefixMatch() for p in pods}
        live = set(pods)
        with self._lock:
            self.stats.lookups += 1
            for h in block_hashes:
                if not live:
                    break
                entry_pods = self._index.get(h)
                if not entry_pods:
                    break
                matched_any = False
                for p in list(live):
                    e = entry_pods.get(p)
                    if e is None or not e.live(now):
                        live.discard(p)
                        continue
                    m = out[p]
                    m.blocks += 1
                    m.weighted += e.best_weight(self.tier_weights, now)
                    matched_any = True
                if not matched_any:
                    break
        return out

    def pods_for_block(self, block_hash: int) -> dict[str, list[str]]:
        now = time.monotonic()
        with self._lock:
            pods = self._index.get(block_hash) or {}
            return {
                p: [t for t, exp in e.tiers.items() if exp == 0.0 or now < exp]
                for p, e in pods.items() if e.live(now)
            }

    def remove_pod(self, pod: str) -> None:
        """Drop every entry for a departed pod (endpoint removed from the pool)."""
        with self._lock:
            for h in self._pod_keys.pop(pod, ()):
                pods = self._index.get(h)
                if pods is not None:
                    pods.pop(pod, None)
                    if not pods:
                        del self._index[h]

    def __len__(self) -> int:
        with self._lock:
            return len(self._index)
