"""KV-index backends behind one interface (copy of
``llmd_tpu/kv/index_backends.py``).

- ``in-memory`` (default): the two-level LRU ``KVBlockIndex``, bounded by entry
  count.
- ``cost-aware``: bounded by estimated bytes, with a doorkeeper that admits a
  never-seen key under pressure only on its second sighting, so one-shot scans
  cannot flush the working set.
- ``external``: the index in a Redis/Valkey-wire store shared by every router
  replica, over a minimal pipelined RESP2 client (``ExternalKVBlockIndex``;
  ``testing/resp_server.py`` is the in-repo store). The store owns its memory
  policy.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Optional, Sequence

from llmd_tpu_torch.core.kv_events import (
    AllBlocksCleared,
    BlockRemoved,
    BlockStored,
    KVEvent,
    MEDIUM_HBM,
)
from llmd_tpu_torch.kv.indexer import (
    DEFAULT_TIER_WEIGHTS,
    IndexStats,
    KVBlockIndex,
    PrefixMatch,
)

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


# ---------------------------------------------------------------------------
# External (Redis/Valkey wire) backend
# ---------------------------------------------------------------------------


def _resp_encode(*parts: bytes) -> bytes:
    out = [b"*%d\r\n" % len(parts)]
    for p in parts:
        out.append(b"$%d\r\n%s\r\n" % (len(p), p))
    return b"".join(out)


class _RespClient:
    """Minimal pipelined RESP2 client (SET-free subset the index needs)."""

    def __init__(self, host: str, port: int, timeout_s: float = 5.0) -> None:
        self.host, self.port, self.timeout_s = host, port, timeout_s
        self._sock: Optional[socket.socket] = None
        self._buf = b""
        self._lock = threading.Lock()

    def _connect(self) -> None:
        # llmd-lint: allow[lock-blocking-call] the lock serialises whole RESP round trips over one socket; connect is timeout-bounded and only ever runs under it
        self._sock = socket.create_connection((self.host, self.port),
                                              timeout=self.timeout_s)
        self._buf = b""

    def _read_line(self) -> bytes:
        while b"\r\n" not in self._buf:
            # llmd-lint: allow[lock-blocking-call] reply reads are part of the locked round trip; socket timeout bounds the wait
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("RESP peer closed")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\r\n", 1)
        return line

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n + 2:
            # llmd-lint: allow[lock-blocking-call] reply reads are part of the locked round trip; socket timeout bounds the wait
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("RESP peer closed")
            self._buf += chunk
        data, self._buf = self._buf[:n], self._buf[n + 2:]
        return data

    def _read_reply(self):
        line = self._read_line()
        t, rest = line[:1], line[1:]
        if t == b"+":
            return rest.decode()
        if t == b"-":
            raise RuntimeError(f"RESP error: {rest.decode()}")
        if t == b":":
            return int(rest)
        if t == b"$":
            n = int(rest)
            return None if n == -1 else self._read_exact(n)
        if t == b"*":
            n = int(rest)
            return None if n == -1 else [self._read_reply() for _ in range(n)]
        raise RuntimeError(f"bad RESP type {line!r}")

    def pipeline(self, commands: Sequence[Sequence[bytes]]) -> list:
        """Send all commands in one write, read all replies — the index's
        multi-block operations are one round trip each."""
        if not commands:
            return []
        with self._lock:
            if self._sock is None:
                self._connect()
            try:
                # llmd-lint: allow[lock-blocking-call] pipelining contract: one writer sends the whole batch and drains every reply before the lock is released
                self._sock.sendall(b"".join(_resp_encode(*c) for c in commands))
                return [self._read_reply() for _ in commands]
            except (OSError, ConnectionError):
                self._sock = None
                raise

    def cmd(self, *parts: bytes):
        return self.pipeline([parts])[0]

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                self._sock.close()
                self._sock = None


def _enc_tiers(tiers: dict[str, float]) -> bytes:
    return ",".join(f"{t}:{e}" for t, e in tiers.items()).encode()


def _dec_tiers(raw: bytes) -> dict[str, float]:
    out: dict[str, float] = {}
    for part in raw.decode().split(","):
        if part:
            t, _, e = part.partition(":")
            out[t] = float(e)
    return out


class ExternalKVBlockIndex:
    """KVBlockIndex semantics over a Redis/Valkey-wire store.

    Layout: hash ``kv:<block>`` maps pod → "tier:expiry,..." (0 = confirmed by
    an engine event, else absolute time.time() expiry of a speculative entry —
    wall clock, not monotonic: entries are read by OTHER replicas/processes);
    set ``kvpod:<pod>`` tracks the pod's blocks for clears/removal; hash
    ``kvlora`` holds learned adapter generation keys. Failures degrade to
    "no external hits" — serving never depends on the store answering.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 6379,
                 tier_weights: Optional[dict[str, float]] = None,
                 speculative_ttl_s: float = 2.0, timeout_s: float = 5.0,
                 max_keys: Optional[int] = None,
                 max_pods_per_key: Optional[int] = None) -> None:
        # max_keys / max_pods_per_key accepted for config uniformity but the
        # STORE owns its memory policy (maxmemory-lru on a real Valkey)
        del max_keys, max_pods_per_key
        self.client = _RespClient(host, port, timeout_s)
        self.tier_weights = dict(tier_weights or DEFAULT_TIER_WEIGHTS)
        self.spec_ttl = speculative_ttl_s
        self._lora_cache: dict[str, str] = {}
        self.stats = IndexStats()

    # -- helpers -----------------------------------------------------------
    @staticmethod
    def _key(h: int) -> bytes:
        return b"kv:%d" % h

    def _merge_tier(self, h: int, pod: str, tier: str, expiry: float) -> None:
        key, p = self._key(h), pod.encode()
        raw = self.client.cmd(b"HGET", key, p)
        tiers = _dec_tiers(raw) if raw else {}
        cur = tiers.get(tier)
        if expiry == 0.0 or cur is None or cur != 0.0:
            tiers[tier] = expiry
        self.client.pipeline([
            (b"HSET", key, p, _enc_tiers(tiers)),
            (b"SADD", b"kvpod:" + p, b"%d" % h),
        ])

    # -- events ------------------------------------------------------------
    def apply(self, pod: str, event: KVEvent) -> None:
        try:
            self._apply(pod, event)
            self.stats.events_applied += 1
        except (OSError, ConnectionError, RuntimeError):
            pass  # store outage: the index degrades to no-hits

    def _apply(self, pod: str, event: KVEvent) -> None:
        if isinstance(event, BlockStored):
            if event.lora_id and "@" in event.lora_id:
                name = event.lora_id.split("@", 1)[0]
                self._lora_cache[name] = event.lora_id
                self.client.cmd(b"HSET", b"kvlora", name.encode(),
                                event.lora_id.encode())
            for h in event.block_hashes:
                self._merge_tier(h, pod, event.medium, 0.0)
            self.stats.blocks_stored += len(event.block_hashes)
        elif isinstance(event, BlockRemoved):
            p = pod.encode()
            for h in event.block_hashes:
                key = self._key(h)
                raw = self.client.cmd(b"HGET", key, p)
                if raw is None:
                    continue
                tiers = _dec_tiers(raw)
                tiers.pop(event.medium, None)
                if tiers:
                    self.client.cmd(b"HSET", key, p, _enc_tiers(tiers))
                else:
                    self.client.pipeline([
                        (b"HDEL", key, p),
                        (b"SREM", b"kvpod:" + p, b"%d" % h),
                    ])
            self.stats.blocks_removed += len(event.block_hashes)
        elif isinstance(event, AllBlocksCleared):
            self.remove_pod(pod)
            self.stats.clears += 1

    def apply_batch(self, pod: str, events: Sequence[KVEvent]) -> None:
        for ev in events:
            self.apply(pod, ev)

    # -- speculative -------------------------------------------------------
    def add_speculative(self, pod: str, block_hashes: Sequence[int],
                        tier: str = MEDIUM_HBM) -> None:
        expiry = time.time() + self.spec_ttl
        try:
            for h in block_hashes:
                self._merge_tier(h, pod, tier, expiry)
            self.stats.speculative_inserts += len(block_hashes)
        except (OSError, ConnectionError, RuntimeError):
            pass

    # -- lookup ------------------------------------------------------------
    def lookup(self, block_hashes: Sequence[int],
               pods: Sequence[str]) -> dict[str, PrefixMatch]:
        out = {p: PrefixMatch() for p in pods}
        self.stats.lookups += 1
        if not block_hashes:
            return out
        try:
            replies = self.client.pipeline(
                [(b"HGETALL", self._key(h)) for h in block_hashes])
        except (OSError, ConnectionError, RuntimeError):
            return out
        now = time.time()
        live = set(pods)
        for reply in replies:
            if not live or not reply:
                break
            entry = {reply[i].decode(): _dec_tiers(reply[i + 1])
                     for i in range(0, len(reply), 2)}
            matched_any = False
            for p in list(live):
                tiers = entry.get(p)
                live_tiers = [t for t, e in (tiers or {}).items()
                              if e == 0.0 or now < e]
                if not live_tiers:
                    live.discard(p)
                    continue
                m = out[p]
                m.blocks += 1
                m.weighted += max(self.tier_weights.get(t, 0.0)
                                  for t in live_tiers)
                matched_any = True
            if not matched_any:
                break
        return out

    def pods_for_block(self, block_hash: int) -> dict[str, list[str]]:
        now = time.time()
        try:
            reply = self.client.cmd(b"HGETALL", self._key(block_hash)) or []
        except (OSError, ConnectionError, RuntimeError):
            return {}
        out = {}
        for i in range(0, len(reply), 2):
            tiers = _dec_tiers(reply[i + 1])
            live = [t for t, e in tiers.items() if e == 0.0 or now < e]
            if live:
                out[reply[i].decode()] = live
        return out

    # -- lifecycle ---------------------------------------------------------
    def resolve_lora_key(self, name: Optional[str]) -> Optional[str]:
        if not name:
            return name
        if name in self._lora_cache:
            return self._lora_cache[name]
        try:
            raw = self.client.cmd(b"HGET", b"kvlora", name.encode())
        except (OSError, ConnectionError, RuntimeError):
            return name
        if raw:
            self._lora_cache[name] = raw.decode()
            return self._lora_cache[name]
        return name

    def remove_pod(self, pod: str) -> None:
        p = pod.encode()
        try:
            members = self.client.cmd(b"SMEMBERS", b"kvpod:" + p) or []
            if members:
                self.client.pipeline(
                    [(b"HDEL", b"kv:" + m, p) for m in members]
                    + [(b"DEL", b"kvpod:" + p)])
            else:
                self.client.cmd(b"DEL", b"kvpod:" + p)
        except (OSError, ConnectionError, RuntimeError):
            pass

    def __len__(self) -> int:
        try:
            return int(self.client.cmd(b"DBSIZE"))
        except (OSError, ConnectionError, RuntimeError):
            return 0


# ---------------------------------------------------------------------------

BACKENDS = {
    "in-memory": KVBlockIndex,
    "cost-aware": CostAwareKVBlockIndex,
    "external": ExternalKVBlockIndex,
}


def build_index(backend: str = "in-memory", **params):
    """Index factory for config selection (kvEvents.indexBackend /
    precise-prefix producer ``indexBackend``)."""
    try:
        cls = BACKENDS[backend]
    except KeyError:
        raise KeyError(
            f"unknown index backend {backend!r}; known: {sorted(BACKENDS)}")
    return cls(**params)
