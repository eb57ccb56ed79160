"""Durable prefix tier: write-back flush queue + hardened store client (port
of ``llmd_tpu/kv/writeback.py``: the same ``LLMD_KV_DURABLE_*`` variables,
KVS1 frames, breaker and queue; host blocks are torch CPU tensors).

The remote store (kv/remote_store.py) gives the cluster a content-addressed
block store that outlives any replica; this module is the serving-path half
that makes it a real tier:

- ``DurableStoreClient`` — per-op deadlines, full-jitter retry, and a
  PR-3-shaped circuit breaker (consecutive failures OR windowed failure rate
  opens; cooldown -> half-open single trial; success closes). Store down,
  slow, or corrupt degrades to today's behavior — never a client error.
- ``WritebackQueue`` — async bounded flush queue feeding prefix blocks to the
  store on eviction and drain. ``offer`` is non-blocking (drop-oldest on
  overflow) so the step loop never waits on DCN; ``flush_for_drain`` empties
  it synchronously under a hard budget so PoolController._drain retires on
  time even against a hung store (the remainder is counted ``abandoned``).
- ``stage_resident_blocks`` — cheap device-side gather of the resident prefix
  working set (MLA engines hold latent pages, so flushed bytes stay honest).

Config comes from ``LLMD_KV_DURABLE_*`` (deploy/ENV_VARS.md); the tier is off
unless ``LLMD_KV_DURABLE_STORE=host:port`` is set.
"""

from __future__ import annotations

import os
import random
import socket
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from llmd_tpu_torch.kv import dtypes
from llmd_tpu_torch.kv.remote_store import (_recv_exact, _recv_frame, _send_frame,
                                            verify_crc_prefix)


def _env_f(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def _env_i(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


@dataclass
class DurableStoreConfig:
    host: str = ""
    port: int = 0
    op_timeout_s: float = 2.0      # bulk get/put deadline per attempt
    probe_timeout_s: float = 0.25  # admission-adjacent probe deadline
    retries: int = 2               # extra attempts after the first (bulk only)
    backoff_ms: float = 25.0       # full-jitter base
    backoff_max_ms: float = 250.0  # full-jitter cap
    breaker_failures: int = 3      # consecutive failures that open the breaker
    breaker_window: int = 20       # sliding window of recent outcomes
    breaker_failure_rate: float = 0.5
    breaker_min_volume: int = 10   # rate check needs at least this many samples
    breaker_cooldown_s: float = 10.0
    queue_blocks: int = 512        # flush-queue bound (blocks, not entries)
    drain_budget_s: float = 5.0    # hard cap on drain-time synchronous flush

    @property
    def enabled(self) -> bool:
        return bool(self.host) and self.port > 0

    @classmethod
    def from_env(cls) -> "DurableStoreConfig":
        addr = os.environ.get("LLMD_KV_DURABLE_STORE", "")
        host, port = "", 0
        if addr:
            h, _, p = addr.rpartition(":")
            try:
                host, port = (h or "127.0.0.1"), int(p)
            except ValueError:
                host, port = "", 0
        return cls(
            host=host, port=port,
            op_timeout_s=_env_f("LLMD_KV_DURABLE_OP_TIMEOUT_S", 2.0),
            probe_timeout_s=_env_f("LLMD_KV_DURABLE_PROBE_TIMEOUT_S", 0.25),
            retries=max(0, _env_i("LLMD_KV_DURABLE_RETRIES", 2)),
            backoff_ms=_env_f("LLMD_KV_DURABLE_BACKOFF_MS", 25.0),
            backoff_max_ms=_env_f("LLMD_KV_DURABLE_BACKOFF_MAX_MS", 250.0),
            breaker_failures=max(
                1, _env_i("LLMD_KV_DURABLE_BREAKER_FAILURES", 3)),
            breaker_window=max(1, _env_i("LLMD_KV_DURABLE_BREAKER_WINDOW", 20)),
            breaker_failure_rate=_env_f("LLMD_KV_DURABLE_BREAKER_RATE", 0.5),
            breaker_min_volume=max(
                1, _env_i("LLMD_KV_DURABLE_BREAKER_MIN_VOLUME", 10)),
            breaker_cooldown_s=_env_f("LLMD_KV_DURABLE_BREAKER_COOLDOWN_S",
                                      10.0),
            queue_blocks=max(1, _env_i("LLMD_KV_DURABLE_QUEUE_BLOCKS", 512)),
            drain_budget_s=_env_f("LLMD_KV_DURABLE_DRAIN_BUDGET_S", 5.0),
        )


class DurableStoreClient:
    """KVS1 client with deadlines, full-jitter retry, and a circuit breaker.

    The breaker is the router's PR-3 shape (resilience.py EndpointBreaker),
    scoped to one store: consecutive-failure fast path for a dead store, a
    windowed failure-rate path for a flapping one, and a half-open single
    trial after cooldown so recovery is automatic.
    """

    def __init__(self, cfg: DurableStoreConfig) -> None:
        self.cfg = cfg
        self._lock = threading.Lock()
        self._rng = random.Random()
        # breaker state — guarded-by: _lock
        self._state = "closed"        # closed | open | half_open
        self._consec = 0
        self._window: list = []       # recent outcomes, True = failure
        self._open_until = 0.0
        self._half_open_inflight = False
        # guarded-by: _lock
        self.stats = {"gets": 0, "puts": 0, "probes": 0, "errors": 0,
                      "corrupt": 0, "breaker_trips": 0, "breaker_skips": 0}

    # -- breaker -----------------------------------------------------------
    def _allow(self) -> bool:
        now = time.monotonic()
        with self._lock:
            if self._state == "closed":
                return True
            if self._state == "open":
                if now < self._open_until:
                    self.stats["breaker_skips"] += 1
                    return False
                self._state = "half_open"
                self._half_open_inflight = False
            # half-open: exactly one trial probes the store; the rest skip
            if self._half_open_inflight:
                self.stats["breaker_skips"] += 1
                return False
            self._half_open_inflight = True
            return True

    def _record(self, ok: bool) -> None:
        with self._lock:
            if self._state == "half_open":
                self._half_open_inflight = False
                if ok:
                    self._state = "closed"
                    self._consec = 0
                    self._window.clear()
                else:
                    self._state = "open"
                    self._open_until = (time.monotonic()
                                        + self.cfg.breaker_cooldown_s)
                    self.stats["errors"] += 1
                return
            self._window.append(not ok)
            if len(self._window) > self.cfg.breaker_window:
                del self._window[: len(self._window) - self.cfg.breaker_window]
            if ok:
                self._consec = 0
                return
            self.stats["errors"] += 1
            self._consec += 1
            rate_open = (len(self._window) >= self.cfg.breaker_min_volume
                         and (sum(self._window) / len(self._window)
                              >= self.cfg.breaker_failure_rate))
            if self._consec >= self.cfg.breaker_failures or rate_open:
                self._state = "open"
                self._open_until = (time.monotonic()
                                    + self.cfg.breaker_cooldown_s)
                self.stats["breaker_trips"] += 1

    def breaker_state(self) -> float:
        """0 closed, 0.5 half-open, 1 open — shaped for a gauge."""
        with self._lock:
            return {"closed": 0.0, "half_open": 0.5, "open": 1.0}[self._state]

    def _jitter_s(self, attempt: int) -> float:
        cap = min(self.cfg.backoff_ms * (2 ** attempt),
                  self.cfg.backoff_max_ms)
        return self._rng.uniform(0.0, cap) / 1000.0

    # -- wire --------------------------------------------------------------
    def _rpc(self, header: dict, payload=b"",
             timeout: Optional[float] = None) -> tuple[dict, bytearray]:
        with socket.create_connection(
                (self.cfg.host, self.cfg.port),
                timeout=timeout or self.cfg.op_timeout_s) as conn:
            _send_frame(conn, header, payload)
            resp, _ = _recv_frame(conn)
            body = (_recv_exact(conn, int(resp["nbytes"]))
                    if resp.get("nbytes") else b"")
            return resp, body

    # -- ops ---------------------------------------------------------------
    def probe(self, hashes: list[int]) -> int:
        """Consecutive found prefix; 0 on any failure. No retry — this sits
        next to routing decisions, so it pays at most one tight deadline."""
        if not self._allow():
            return 0
        with self._lock:
            self.stats["probes"] += 1
        try:
            resp, _ = self._rpc({"op": "probe", "hashes": list(hashes)},
                                timeout=self.cfg.probe_timeout_s)
            if "error" in resp:
                raise ValueError(resp["error"])
            self._record(ok=True)
            return int(resp.get("found", 0))
        except (OSError, ConnectionError, KeyError, ValueError):
            self._record(ok=False)
            return 0

    def get(self, hashes: list[int]) -> tuple[int, Optional[torch.Tensor], str]:
        """Fetch the consecutive verified prefix of ``hashes``.

        Returns ``(n, blocks[n, L, ...] | None, outcome)`` with outcome in
        {ok, miss, corrupt, error, breaker_open}. A checksum mismatch
        truncates to the verified prefix (still usable) and counts as a
        path failure so a corrupting store trips the breaker.
        """
        if not self._allow():
            return 0, None, "breaker_open"
        with self._lock:
            self.stats["gets"] += 1
        for attempt in range(self.cfg.retries + 1):
            try:
                resp, body = self._rpc({"op": "get", "hashes": list(hashes)})
                if "error" in resp:
                    raise ValueError(resp["error"])
                n = int(resp.get("found", 0))
                if n == 0:
                    self._record(ok=True)
                    return 0, None, "miss"
                good = verify_crc_prefix(body, n, resp.get("crc"))
                per = len(body) // n
                if good < n:
                    with self._lock:
                        self.stats["corrupt"] += 1
                    self._record(ok=False)
                    if good == 0:
                        return 0, None, "corrupt"
                else:
                    self._record(ok=True)
                blocks = dtypes.from_bytes(memoryview(body)[: good * per], resp["dtype"],
                                           (good, *resp["shape"]))
                return good, blocks, ("ok" if good == n else "corrupt")
            except (OSError, ConnectionError, KeyError, ValueError, TypeError):
                self._record(ok=False)
                if attempt < self.cfg.retries and self._allow_retry():
                    time.sleep(self._jitter_s(attempt))
                else:
                    break
        return 0, None, "error"

    def put(self, hashes: list[int], blocks: torch.Tensor,
            timeout: Optional[float] = None,
            retries: Optional[int] = None) -> str:
        """Store ``blocks[n, L, ...]`` under ``hashes``; outcome in
        {ok, error, breaker_open}. ``timeout``/``retries`` let drain-time
        flushing clamp each attempt to the remaining budget."""
        if not self._allow():
            return "breaker_open"
        with self._lock:
            self.stats["puts"] += 1
        arr = blocks.contiguous()
        tries = self.cfg.retries if retries is None else retries
        for attempt in range(tries + 1):
            try:
                resp, _ = self._rpc(
                    {"op": "put", "hashes": [int(h) for h in hashes],
                     "dtype": dtypes.dtype_name(arr.dtype), "shape": list(arr.shape[1:]),
                     "nbytes": dtypes.nbytes(arr)}, dtypes.to_bytes(arr), timeout=timeout)
                if "error" in resp:
                    raise ValueError(resp["error"])
                self._record(ok=True)
                return "ok"
            except (OSError, ConnectionError, KeyError, ValueError):
                self._record(ok=False)
                if attempt < tries and self._allow_retry():
                    time.sleep(self._jitter_s(attempt))
                else:
                    break
        return "error"

    def _allow_retry(self) -> bool:
        # retrying into an open breaker just burns the backoff sleep
        with self._lock:
            return self._state != "open"


class WritebackQueue:
    """Bounded async flush queue: prefix blocks -> durable store.

    ``offer`` runs on eviction/drain paths adjacent to the step loop, so it
    only appends under a condition variable — never any socket or device
    work. The daemon worker does the DCN puts. Overflow drops the OLDEST
    entries: under pressure the freshest working set is the one a future
    replica will want back.
    """

    def __init__(self, client: DurableStoreClient, max_blocks: int = 512,
                 on_flush: Optional[Callable[[str, int], None]] = None) -> None:
        self.client = client
        self.max_blocks = max_blocks
        self.on_flush = on_flush
        self._cond = threading.Condition()
        self._q: deque = deque()  # guarded-by: _cond — (hashes, blocks)
        self._depth = 0           # guarded-by: _cond — total queued blocks
        self._stopped = False     # guarded-by: _cond
        # guarded-by: _cond — all in BLOCKS, matching the flush counter
        self.counts = {"ok": 0, "error": 0, "dropped": 0, "abandoned": 0}
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="kv-writeback")
        self._thread.start()

    def depth(self) -> int:
        with self._cond:
            return self._depth

    def offer(self, hashes: list[int], blocks: torch.Tensor) -> bool:
        """Enqueue without blocking; drop-oldest keeps the bound."""
        n = len(hashes)
        if n == 0:
            return True
        dropped = 0
        with self._cond:
            if self._stopped:
                return False
            self._q.append(([int(h) for h in hashes], blocks))
            self._depth += n
            while self._depth > self.max_blocks and len(self._q) > 1:
                old_hashes, _old = self._q.popleft()
                self._depth -= len(old_hashes)
                dropped += len(old_hashes)
            self.counts["dropped"] += dropped
            self._cond.notify()
        if dropped and self.on_flush is not None:
            try:
                self.on_flush("dropped", dropped)
            except Exception:
                pass
        return True

    def _worker(self) -> None:
        while True:
            with self._cond:
                while not self._q and not self._stopped:
                    self._cond.wait(timeout=0.5)
                if not self._q:
                    if self._stopped:
                        return
                    continue
                hashes, blocks = self._q.popleft()
                self._depth -= len(hashes)
            self._flush_one(hashes, blocks)

    def _flush_one(self, hashes: list[int], blocks) -> str:
        outcome = self.client.put(hashes, blocks)
        key = "ok" if outcome == "ok" else "error"
        with self._cond:
            self.counts[key] += len(hashes)
        if self.on_flush is not None:
            try:
                self.on_flush(key, len(hashes))
            except Exception:
                pass  # observability must not break the flush path
        return outcome

    def flush_for_drain(self, budget_s: float) -> tuple[int, int]:
        """Synchronously empty the queue within ``budget_s`` seconds.

        Each put attempt is clamped to the remaining budget with no retries,
        and an open breaker fails instantly — so a hung store cannot push
        drain past its timeout. Every block that does not land — a failed
        drain-time put or whatever is still queued at the deadline — is
        counted ``abandoned`` (drain accounting: the replica retires and
        those blocks are gone). Returns (flushed_blocks, abandoned_blocks).
        """
        deadline = time.monotonic() + max(0.0, budget_s)
        flushed = 0
        abandoned = 0
        while True:
            remaining = deadline - time.monotonic()
            with self._cond:
                if not self._q:
                    break
                if remaining <= 0.05:
                    abandoned += self._depth
                    self._q.clear()
                    self._depth = 0
                    break
                hashes, blocks = self._q.popleft()
                self._depth -= len(hashes)
            outcome = self.client.put(
                hashes, blocks,
                timeout=min(self.client.cfg.op_timeout_s, remaining),
                retries=0)
            if outcome == "ok":
                flushed += len(hashes)
                with self._cond:
                    self.counts["ok"] += len(hashes)
                if self.on_flush is not None:
                    try:
                        self.on_flush("ok", len(hashes))
                    except Exception:
                        pass
            else:
                abandoned += len(hashes)
        if abandoned:
            with self._cond:
                self.counts["abandoned"] += abandoned
            if self.on_flush is not None:
                try:
                    self.on_flush("abandoned", abandoned)
                except Exception:
                    pass
        return flushed, abandoned

    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        self._thread.join(timeout=2.0)


def stage_resident_blocks(engine, max_blocks: int) -> tuple[list[int], list]:
    """Staged gather of up to ``max_blocks`` resident prefix blocks.

    MUST run under the engine lock (run_locked): it only gathers the pages
    and starts their copies, the cheap half of the offload split; call
    ``drain_staged(parts)`` OFF the lock to materialize host bytes. Takes the
    tail of the prefix-cache insertion order, i.e. the freshest blocks.
    MLA engines store latent pages in the pool, so the staged bytes are
    already the compact latent layout. A meshed engine's ``kv_pool``
    gathers its tp planes first: the bytes are the one-card pool's.
    """
    from llmd_tpu_torch.disagg.transfer import stage_pages

    pairs = list(engine.alloc.cached.items())[-max_blocks:]
    if not pairs:
        return [], []
    hashes = [int(h) for h, _pid in pairs]
    pids = [pid for _h, pid in pairs]
    with engine._on_stream():
        parts = stage_pages(engine.kv_pool.gather, pids, engine.cfg.offload_staging_blocks)
    return hashes, parts
