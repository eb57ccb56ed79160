"""Router side of the global KV plane (copy of ``llmd_tpu/kvplane/plane.py``).

``KVPlane`` is built once per RouterServer from the ``LLMD_KV_PLANE`` env knob
and installed onto the live scheduler:

- ``precise``: every ``approx-prefix-cache-producer`` in the config is replaced
  by a ``KVPlaneProducer`` (event-fed index lookups, degrading per-request to
  the approx LRU while the index is cold or the event feed stale), every plain
  ``prefix-cache-scorer`` by the tier-weighted precise scorer, and the router
  stamps cross-engine prefix pulls (``plan_pull``) onto requests routed past a
  better-indexed peer.
- ``approx``: the operator kill switch — precise producers/scorers in the
  config are swapped back to the approx pair; no index, no pulls.
- ``off`` (default when unset): the plane is inert; the config graph behaves
  bitwise-identically to a build without this subsystem.
"""

from __future__ import annotations

import os
import time
from typing import Any, Optional

from llmd_tpu_torch.core.endpoint import Endpoint, EndpointPool
from llmd_tpu_torch.core.request import InferenceRequest
from llmd_tpu_torch.kv.plugins import (
    CTX_KV_INDEX,
    PrecisePrefixCacheProducer,
    PrecisePrefixCacheScorer,
)
from llmd_tpu_torch.router.plugins import DataProducer
from llmd_tpu_torch.router.scorers import (
    STATE_BLOCK_KEYS,
    STATE_PREFIX_HITS,
    ApproxPrefixCacheProducer,
    PrefixCacheScorer,
)

# Endpoint labels advertising the engine's KV-transfer side channel (the
# kv_events_* analogues; port-only label uses the endpoint host).
LABEL_KV_TRANSFER_ADDR = "kv_transfer_address"
LABEL_KV_TRANSFER_PORT = "kv_transfer_port"

STATE_KV_PLANE = "kv_plane_path"  # "precise" | "degraded" (unset when inert)

ENV_MODE = "LLMD_KV_PLANE"
ENV_PULL_THRESHOLD = "LLMD_KV_PLANE_PULL_THRESHOLD_BLOCKS"
ENV_STALE_S = "LLMD_KV_PLANE_STALE_S"

MODES = ("off", "approx", "precise")


def plane_mode() -> str:
    """Resolve the plane mode from ``LLMD_KV_PLANE`` (unset/unknown → off)."""
    mode = os.environ.get("LLMD_KV_PLANE", "off").strip().lower()
    return mode if mode in MODES else "off"


def transfer_address(ep: Endpoint) -> tuple[Optional[str], Optional[int]]:
    """(host, port) of an endpoint's KV-transfer side channel, from labels."""
    addr = ep.labels.get(LABEL_KV_TRANSFER_ADDR)
    if addr and ":" in addr:
        host, port = addr.rsplit(":", 1)
        try:
            return host, int(port)
        except ValueError:
            return None, None
    port_s = ep.labels.get(LABEL_KV_TRANSFER_PORT)
    if port_s:
        try:
            return ep.host, int(port_s)
        except ValueError:
            return None, None
    return None, None


class KVPlaneProducer(DataProducer):
    """Precise producer with built-in degradation to the approx LRU.

    Chooses per request: the event-fed index when it is warm (``precise``),
    the router-side LRU otherwise (``degraded``). The path taken is recorded
    in ``req.state[STATE_KV_PLANE]`` so pull planning only ever acts on
    index-backed hits, and ``pre_request`` warms whichever model produced.
    """

    def __init__(self, ctx: dict[str, Any], plane: "KVPlane",
                 blockSize: int = 16,
                 precise_params: Optional[dict[str, Any]] = None,
                 approx_params: Optional[dict[str, Any]] = None) -> None:
        self.plane = plane
        self.block_size = blockSize
        self.precise = PrecisePrefixCacheProducer(
            ctx, blockSize=blockSize, **(precise_params or {}))
        self.approx = ApproxPrefixCacheProducer(
            ctx, blockSize=blockSize, **(approx_params or {}))
        plane.block_size = blockSize

    def produce(self, req: InferenceRequest, endpoints: list[Endpoint]) -> None:
        stats = self.plane.stats
        if self.plane.index_ready():
            self.precise.produce(req, endpoints)
            req.state[STATE_KV_PLANE] = "precise"
            stats["precise_requests"] += 1
            stats["lookups"] += 1
            hits = req.state.get(STATE_PREFIX_HITS) or {}
            if any(v > 0 for v in hits.values()):
                stats["lookup_hits"] += 1
        else:
            self.approx.produce(req, endpoints)
            req.state[STATE_KV_PLANE] = "degraded"
            stats["degraded_requests"] += 1

    def pre_request(self, req: InferenceRequest, endpoint: Endpoint) -> None:
        # warm only the model that produced this request's keys: the two paths
        # hash under different lora terms, so cross-feeding stores dead keys
        if req.state.get(STATE_KV_PLANE) == "precise":
            self.precise.pre_request(req, endpoint)
        else:
            self.approx.pre_request(req, endpoint)


class KVPlane:
    """Mode resolution + scheduler install + cross-engine pull planning."""

    def __init__(self, mode: str, ctx: dict[str, Any], pool: EndpointPool,
                 pull_threshold_blocks: int = 4, stale_s: float = 30.0) -> None:
        self.mode = mode
        self.ctx = ctx
        self.pool = pool
        self.pull_threshold_blocks = pull_threshold_blocks
        self.stale_s = stale_s  # 0 disables the staleness check
        self.block_size = 16  # overwritten by the installed producer
        self.subscriber = None  # KVEventSubscriberManager, set by RouterServer
        self.swaps: list[str] = []  # "name: old-type->new-type" install log
        self.stats = {
            "precise_requests": 0, "degraded_requests": 0,
            "lookups": 0, "lookup_hits": 0, "pulls_planned": 0,
            "durable_pulls_planned": 0,
        }
        # durable-tier probe: a DurableStoreClient (kv/writeback.py) the
        # ladder consults when no live peer qualifies — the store outlives
        # replica churn, so its answer survives where the index's cannot
        self.durable_probe = None
        self._feed_batches = -1  # last observed subscriber batch count
        self._feed_seen_t = time.monotonic()

    @classmethod
    def from_env(cls, ctx: dict[str, Any], pool: EndpointPool) -> "KVPlane":
        mode = plane_mode()
        thr = int(os.environ.get("LLMD_KV_PLANE_PULL_THRESHOLD_BLOCKS", "4"))
        stale = float(os.environ.get("LLMD_KV_PLANE_STALE_S", "30"))
        plane = cls(mode, ctx, pool, pull_threshold_blocks=thr, stale_s=stale)
        if mode == "precise":
            from llmd_tpu_torch.kv.writeback import (DurableStoreClient,
                                                     DurableStoreConfig)

            durable_cfg = DurableStoreConfig.from_env()
            if durable_cfg.enabled:
                plane.durable_probe = DurableStoreClient(durable_cfg)
        return plane

    @property
    def active(self) -> bool:
        return self.mode == "precise"

    @property
    def index(self):
        return self.ctx.get(CTX_KV_INDEX)

    # ------------------------------------------------------------- install
    def install(self, scheduler) -> list[str]:
        """Swap producers/scorers on a built Scheduler according to the mode.

        ``off`` is a strict no-op: the scheduler keeps the exact plugin
        instances the config graph built.
        """
        if self.mode == "off":
            return []
        replaced = False
        for name, plugin in list(scheduler.plugins.items()):
            if self.mode == "precise":
                if isinstance(plugin, ApproxPrefixCacheProducer):
                    scheduler.plugins[name] = KVPlaneProducer(
                        scheduler.ctx, self, blockSize=plugin.block_size)
                    self.swaps.append(f"{name}: approx-producer->kv-plane-producer")
                    replaced = True
                elif isinstance(plugin, PrecisePrefixCacheProducer):
                    # already precise in config: wrap it so degradation +
                    # path marking still apply (reuse its shared ctx index)
                    wrapper = KVPlaneProducer(scheduler.ctx, self,
                                              blockSize=plugin.block_size)
                    wrapper.precise = plugin
                    scheduler.plugins[name] = wrapper
                    self.swaps.append(f"{name}: precise-producer->kv-plane-producer")
                    replaced = True
                elif isinstance(plugin, PrefixCacheScorer):
                    scheduler.plugins[name] = PrecisePrefixCacheScorer()
                    self.swaps.append(f"{name}: prefix-scorer->precise-scorer")
                    replaced = True
            elif self.mode == "approx":
                if isinstance(plugin, (PrecisePrefixCacheProducer, KVPlaneProducer)):
                    scheduler.plugins[name] = ApproxPrefixCacheProducer(
                        scheduler.ctx, blockSize=plugin.block_size)
                    self.swaps.append(f"{name}: precise-producer->approx-producer")
                    replaced = True
                elif isinstance(plugin, PrecisePrefixCacheScorer):
                    scheduler.plugins[name] = PrefixCacheScorer()
                    self.swaps.append(f"{name}: precise-scorer->prefix-scorer")
                    replaced = True
        if replaced:
            self._rebuild(scheduler)
        return self.swaps

    @staticmethod
    def _rebuild(scheduler) -> None:
        """Re-derive profiles/producer lists after a plugin swap (mirrors
        Scheduler.__init__'s wiring, same plugin-name references)."""
        from llmd_tpu_torch.router.scheduler import Profile

        for prof in scheduler.config.scheduling_profiles:
            entries = [(scheduler.plugins[r.plugin_ref], r.weight)
                       for r in prof.plugins]
            scheduler.profiles[prof.name] = Profile(prof.name, entries)
        scheduler.producers = [p for p in scheduler.plugins.values()
                               if isinstance(p, DataProducer)]

    # ------------------------------------------------------------- health
    def index_ready(self) -> bool:
        """True when the index can answer precisely: non-empty, and the event
        feed has delivered within ``stale_s`` of its last delivery change."""
        idx = self.index
        if idx is None or len(idx) == 0:
            return False  # cold
        sub = self.subscriber
        if sub is not None and self.stale_s > 0:
            now = time.monotonic()
            batches = sub.batches_received
            if batches != self._feed_batches:
                self._feed_batches = batches
                self._feed_seen_t = now
            elif now - self._feed_seen_t > self.stale_s:
                return False  # feed stale: no batch movement in stale_s
        return True

    def feed_age_s(self) -> float:
        """Seconds since the event feed last showed batch movement (0 while
        batches keep arriving) — the index-staleness gauge/alert input."""
        sub = self.subscriber
        if sub is None:
            return 0.0
        now = time.monotonic()
        if sub.batches_received != self._feed_batches:
            # movement since last check: index_ready() will re-stamp; report
            # fresh without mutating its bookkeeping here
            return 0.0
        return max(0.0, now - self._feed_seen_t)

    # ------------------------------------------------------------- pulls
    def plan_pull(self, req: InferenceRequest, target_address: str) -> Optional[dict]:
        """KV-transfer params to stamp on ``req`` bound for ``target_address``,
        or None. Fires only on index-backed hits when a peer holds at least
        ``pull_threshold_blocks`` more prefix than the chosen target and
        advertises a transfer side channel."""
        if not self.active or req.state.get(STATE_KV_PLANE) != "precise":
            return None
        keys = req.state.get(STATE_BLOCK_KEYS) or []
        hits = req.state.get(STATE_PREFIX_HITS) or {}
        if not keys:
            return None
        target_tokens = int(hits.get(target_address, 0))
        peer_addr, peer_tokens = None, target_tokens
        for addr, h in hits.items():
            if addr != target_address and h > peer_tokens:
                peer_addr, peer_tokens = addr, int(h)
        bs = max(1, self.block_size)
        if peer_addr is None:
            # no live peer holds more than the target: the durable-tier rung.
            # The store's probe (tight deadline, breaker-guarded) stands in
            # for the index — its contents survive the churn that emptied it.
            return self._plan_durable_pull(req, keys, target_tokens, bs)
        if peer_tokens - target_tokens < self.pull_threshold_blocks * bs:
            return None
        ep = self.pool.get(peer_addr)
        if ep is None:
            return None
        host, port = transfer_address(ep)
        if host is None or port is None:
            return None
        n_blocks = min(len(keys), peer_tokens // bs)
        if n_blocks <= 0:
            return None
        self.stats["pulls_planned"] += 1
        return {
            "do_prefix_pull": True,
            "remote_host": host,
            "remote_port": port,
            "remote_request_id": req.request_id,
            "num_blocks": n_blocks,
            "block_hashes": keys[:n_blocks],
            # observability only; the router pops both before stamping
            # (engines would ignore them anyway). saved_tokens_est is the
            # re-prefill the pull avoids: prefix the peer holds beyond what
            # the chosen target already had — the decision ledger weighs it
            # against kv_transfer_prefix_pull_seconds actually spent.
            "peer": peer_addr,
            "saved_tokens_est": peer_tokens - target_tokens,
        }

    def _plan_durable_pull(self, req: InferenceRequest, keys: list[int],
                           target_tokens: int, bs: int) -> Optional[dict]:
        """Durable-store rung of the pull ladder: probe the cluster store for
        the consecutive prefix and stamp a tier="durable" pull when it beats
        the target by the same threshold a peer would have to. The engine
        resolves the stamp against its own client — the router never moves
        KV bytes, it only routes the decision."""
        if self.durable_probe is None:
            return None
        found = self.durable_probe.probe(keys)
        if found <= 0:
            return None
        if found * bs - target_tokens < self.pull_threshold_blocks * bs:
            return None
        self.stats["durable_pulls_planned"] += 1
        return {
            "do_prefix_pull": True,
            "tier": "durable",
            "num_blocks": found,
            "block_hashes": keys[:found],
            "peer": "durable-store",
            "saved_tokens_est": found * bs - target_tokens,
        }
