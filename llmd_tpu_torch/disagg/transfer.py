"""KV transfer: pull-model block movement between prefill and decode engines
(port of ``llmd_tpu/disagg/transfer.py``, same names, wire and semantics).

- **prefill (producer)**: once a request's prompt is computed, its complete KV
  blocks are gathered from the pool into ONE contiguous host buffer and
  registered under the request id;
- **decode (consumer)**: pulls the blocks over a TCP side channel, checks the
  chained block hashes against its own prompt, writes them into freshly
  allocated pages and commits them to its prefix cache, so admission reuses
  them as local prefix hits; any failure degrades to recompute;
- **release**: the consumer's notify frees the producer's export; a TTL
  reaper frees abandoned ones.

The wire is the reference's, byte for byte: a request is ``KVT1`` ‖ u32be len
‖ JSON; a response is u32be len ‖ JSON header (``found``, ``block_hashes``,
``token_chunks``, ``dtype``, ``block_shape``, ``nbytes``) ‖ payload, the
blocks block-major ``[n, L, ps, 2Hk, D]`` (``[n, L, ps, 1, r + dr]`` for an
MLA latent pool), dtype named as numpy names it (``kv/dtypes.py``). So a JAX
engine and a port engine pull from each other wherever their block shapes
agree (the reference pads head_dim to 128 lanes, the port does not; a
mismatch is refused at inject, as the reference refuses it).

Two departures from the reference, both forced by torch's mutable pool:

- the pool is written **in place** (``index_copy_`` through ``uint8`` views,
  which also carry fp8 on the CPU): the decode program's CUDA graph captured
  the pool's address, so ``insert_blocks`` returns the same tensor it was
  given;
- the port's pool has one more row than the reference's, the scratch row
  ``L*P`` at its end (``models/transformer.init_cache``): L is
  ``(rows - 1) // P``; page id -1 (padding) writes there; no export reads it.

Staging (``stage_pages`` / ``drain_staged``): the reference's gathers read
"the cache value as of dispatch". Here the gather runs on the engine's stream
(the caller holds the engine lock and is on that stream), so any later step
that writes a released page is ordered after it; on the card the copy to
pinned host memory runs on a side stream behind an event recorded after the
gather, and ``drain_staged`` waits on that copy's own event, off the engine
lock, never on the whole device.

An engine's pool is read and written here only through ``engine.kv_pool``
(:class:`PoolView`), whose reads and writes are the engine's ``pages_out``
and ``pages_in`` ops. On one device they gather and insert in place; a
meshed engine's pool is sharded over its tp ranks, and there ``pages_out``
all-gathers the tp planes to rank 0 before the staging copy and
``pages_in`` scatters each rank its planes from rank 0's device, so the
wire bytes are the one-card pool's and a meshed P feeds a one-card D, and
the reverse.

``transport``: ``"native"`` = the C++ data plane (``csrc/kv_transfer.cpp``,
built with g++ at first use; raises if the build fails), ``"python"`` =
threaded sockets, ``"auto"`` = native unless a ``prefix_provider`` is set
(the C++ server does not speak ``pull_prefix``).
"""

from __future__ import annotations

import ctypes
import json
import socket
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from llmd_tpu_torch.kv.dtypes import dtype_name, from_bytes, nbytes, to_bytes

MAGIC = b"KVT1"
_FP8_MAX = 448.0  # models/transformer._FP8_MAX: e4m3 has no inf, writes clamp


# ---------------------------------------------------------------------------
# Device <-> host block staging
# ---------------------------------------------------------------------------


def _layers(cache: torch.Tensor, pages_per_layer: Optional[int]) -> tuple[int, int]:
    """(L, P) of the flat pool [L*P + 1, ps, planes, D] (last row: scratch)."""
    P = pages_per_layer or cache.shape[0] - 1
    return (cache.shape[0] - 1) // P, P


def _rows(cache: torch.Tensor, page_ids, pages_per_layer: Optional[int]) -> torch.Tensor:
    """[L, n] pool rows of the pages; page id -1 maps to the scratch row."""
    L, P = _layers(cache, pages_per_layer)
    pids = torch.as_tensor(list(page_ids), dtype=torch.int64)
    rows = torch.arange(L, dtype=torch.int64)[:, None] * P + pids[None, :]
    rows = torch.where(pids[None, :] >= 0, rows, torch.full_like(rows, cache.shape[0] - 1))
    return rows.to(cache.device)


def gather_pages(cache: torch.Tensor, page_ids, pages_per_layer: Optional[int]) -> torch.Tensor:
    """The pages' rows of every layer as block-major [n, L, ps, planes, D] on
    the pool's device, in the pool's dtype (one gather on the current stream)."""
    rows = _rows(cache, page_ids, pages_per_layer)
    L, n = rows.shape
    raw = cache.view(torch.uint8).index_select(0, rows.reshape(-1))
    raw = raw.reshape(L, n, *raw.shape[1:]).transpose(0, 1).contiguous()
    return raw.view(cache.dtype)


def as_pool_dtype(blocks: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``blocks`` in a pool's ``dtype``."""
    if blocks.dtype == dtype:
        return blocks
    if dtype == torch.float8_e4m3fn:
        # a wider peer's blocks into an fp8 pool: clamp as the engine's own
        # write path does, so no value depends on the cast's overflow
        return blocks.float().clamp(-_FP8_MAX, _FP8_MAX).to(dtype)
    return blocks.to(dtype)


def extract_blocks(cache: torch.Tensor, page_ids: list[int],
                   pages_per_layer: Optional[int] = None) -> torch.Tensor:
    """Gather logical pages into one contiguous host tensor [n, L, ps, 2Hk, D]
    (block-major, so each block is a contiguous byte range). ``None`` pages
    per layer: a single-layer pool."""
    part = gather_pages(cache, page_ids, pages_per_layer)
    return part if part.device.type == "cpu" else part.cpu()


def insert_blocks(cache: torch.Tensor, page_ids: list[int], blocks: torch.Tensor,
                  pages_per_layer: Optional[int] = None) -> torch.Tensor:
    """Write pulled blocks ([n, L, ps, 2Hk, D]) into the pages' rows, in
    place, on the current stream; page id -1 writes the scratch row. Returns
    ``cache`` itself (the reference returns a new array)."""
    rows = _rows(cache, page_ids, pages_per_layer)
    L, n = rows.shape
    dev = as_pool_dtype(blocks.to(cache.device, non_blocking=True), cache.dtype)
    dev = dev.transpose(0, 1).reshape(L * n, *cache.shape[1:])
    cache.view(torch.uint8).index_copy_(0, rows.reshape(-1), dev.contiguous().view(torch.uint8))
    return cache


# ---------------------------------------------------------------------------
# Transfer params (the vLLM kv_transfer_params analogue, JSON-serializable)
# ---------------------------------------------------------------------------


@dataclass
class KVTransferParams:
    """Carried in request/response bodies between sidecar, P and D engines."""

    do_remote_decode: bool = False  # request to P: keep KV, return transfer handle
    do_remote_prefill: bool = False  # request to D: pull KV before compute
    do_prefix_pull: bool = False  # KV plane: pull a cached prefix from a peer engine
    remote_host: Optional[str] = None
    remote_port: Optional[int] = None
    remote_request_id: Optional[str] = None
    num_blocks: int = 0
    block_hashes: list[int] = field(default_factory=list)  # prefix chain to pull
    tier: str = "peer"  # prefix-pull source: "peer" engine | "durable" store

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "KVTransferParams":
        d = d or {}
        return cls(
            do_remote_decode=bool(d.get("do_remote_decode")),
            do_remote_prefill=bool(d.get("do_remote_prefill")),
            do_prefix_pull=bool(d.get("do_prefix_pull")),
            remote_host=d.get("remote_host"),
            remote_port=d.get("remote_port"),
            remote_request_id=d.get("remote_request_id"),
            num_blocks=int(d.get("num_blocks", 0)),
            block_hashes=[int(h) for h in d.get("block_hashes") or []],
            tier=str(d.get("tier") or "peer"),
        )

    def to_dict(self) -> dict:
        return {k: v for k, v in self.__dict__.items()
                if v not in (None, False, 0) and v != []}


# ---------------------------------------------------------------------------
# Producer side: exported-block registry + side-channel server
# ---------------------------------------------------------------------------


@dataclass
class ExportedKV:
    block_hashes: list[int]
    token_chunks: list[list[int]]
    payload: memoryview  # contiguous staging buffer (n blocks back to back)
    dtype: str
    block_shape: tuple[int, ...]  # [L, ps, 2Hk, D]
    created: float = field(default_factory=time.monotonic)


def _recv_exact(conn: socket.socket, n: int) -> bytearray:
    buf = bytearray(n)
    view, got = memoryview(buf), 0
    while got < n:
        k = conn.recv_into(view[got:], min(1 << 20, n - got))
        if not k:
            raise ConnectionError("peer closed mid-frame")
        got += k
    return buf


def _pull_header(block_hashes, token_chunks, dtype: str, block_shape, nbytes: int) -> bytes:
    """The pull-response header: ONE composer shared by both transports."""
    return json.dumps({
        "found": True, "block_hashes": list(block_hashes),
        "token_chunks": [list(c) for c in token_chunks], "dtype": dtype,
        "block_shape": list(block_shape), "nbytes": nbytes,
    }).encode()


_STATS = ("exports", "pulls", "notifies", "expired", "misses")


class KVTransferSource:
    """Prefill-side export registry + TCP pull server.

    Protocol (shared by both transports):
      request:  MAGIC ‖ u32 len ‖ JSON {"op": "pull"|"pull_prefix"|"notify",
                                        "id": str, "hashes"?: [int]}
      response: u32 len ‖ JSON header ‖ payload[header["nbytes"]]

    ``prefix_provider`` (KV plane): optional callback
    ``(block_hashes, request_id) -> Optional[(hashes, token_chunks, blocks)]``
    that resolves an on-demand prefix export for a ``pull_prefix`` request;
    set it before ``start()``.
    """

    def __init__(self, host: str = "0.0.0.0", port: int = 0, ttl_s: float = 120.0,
                 transport: str = "auto") -> None:
        if transport not in ("auto", "native", "python"):
            raise ValueError(f"transport must be auto|native|python, got {transport!r}")
        self.host, self.port = host, port
        self.ttl_s = ttl_s
        self.transport = transport
        self.prefix_provider = None
        self.native = None  # (lib, handle) when the C++ server is live
        self.exports: dict[str, ExportedKV] = {}
        self._lock = threading.Lock()
        self._srv: Optional[socket.socket] = None
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._stats = {k: 0 for k in _STATS}

    @property
    def stats(self) -> dict[str, int]:
        if self.native is not None:
            lib, h = self.native
            return {k: int(lib.kvt_stat(h, k.encode())) for k in _STATS}
        with self._lock:  # snapshot: serving threads bump these counters
            return dict(self._stats)

    # -- registry ----------------------------------------------------------
    def register(self, request_id: str, block_hashes: list[int],
                 token_chunks: list[list[int]], blocks: torch.Tensor) -> int:
        """Register host blocks [n, L, ...] under ``request_id``; returns bytes."""
        blocks = blocks.contiguous()
        name, shape, size = dtype_name(blocks.dtype), tuple(blocks.shape[1:]), nbytes(blocks)
        if self.native is not None:
            lib, h = self.native
            hdr = _pull_header(block_hashes, token_chunks, name, shape, size)
            # the C++ side copies the payload before returning
            lib.kvt_register(h, request_id.encode(), hdr, len(hdr), blocks.data_ptr(), size)
            return size
        ex = ExportedKV(
            block_hashes=list(block_hashes),
            token_chunks=[list(c) for c in token_chunks],
            payload=to_bytes(blocks),
            dtype=name,
            block_shape=shape,
        )
        with self._lock:
            self.exports[request_id] = ex
            self._stats["exports"] += 1
        return size

    def release(self, request_id: str) -> None:
        if self.native is not None:
            lib, h = self.native
            lib.kvt_release(h, request_id.encode())
            return
        with self._lock:
            self.exports.pop(request_id, None)

    def __len__(self) -> int:
        if self.native is not None:
            lib, h = self.native
            return int(lib.kvt_count(h))
        with self._lock:
            return len(self.exports)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        prefer_native = (self.transport == "native"
                         or (self.transport == "auto" and self.prefix_provider is None))
        if prefer_native and self._start_native():
            return
        if self.transport == "native":
            raise RuntimeError("native kv_transfer transport unavailable (g++ build failed)")
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((self.host, self.port))
        self._srv.listen(64)
        self.port = self._srv.getsockname()[1]
        self._srv.settimeout(0.25)
        for target, name in ((self._accept_loop, "kvt-accept"), (self._reaper, "kvt-reaper")):
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)

    def _start_native(self) -> bool:
        from llmd_tpu_torch.native.build import BuildError, load_host

        try:
            lib = load_host("kv_transfer").lib
        except (BuildError, OSError):
            return False
        lib.kvt_server_create.restype = ctypes.c_void_p
        lib.kvt_server_create.argtypes = [ctypes.c_int]
        lib.kvt_server_port.argtypes = [ctypes.c_void_p]
        lib.kvt_server_port.restype = ctypes.c_int
        lib.kvt_register.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_long,
        ]
        lib.kvt_register.restype = None
        lib.kvt_release.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.kvt_release.restype = None
        lib.kvt_count.argtypes = [ctypes.c_void_p]
        lib.kvt_count.restype = ctypes.c_int
        lib.kvt_reap.argtypes = [ctypes.c_void_p, ctypes.c_double]
        lib.kvt_reap.restype = ctypes.c_int
        lib.kvt_stat.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.kvt_stat.restype = ctypes.c_long
        lib.kvt_server_destroy.argtypes = [ctypes.c_void_p]
        lib.kvt_server_destroy.restype = None
        h = lib.kvt_server_create(self.port)
        if not h:
            return False
        self.native = (lib, h)
        self.port = int(lib.kvt_server_port(h))
        r = threading.Thread(target=self._native_reaper, name="kvt-reaper", daemon=True)
        r.start()
        self._threads.append(r)
        return True

    def stop(self) -> None:
        self._stop.set()
        if self.native is not None:
            lib, h = self.native
            self.native = None
            lib.kvt_server_destroy(h)
        if self._srv is not None:
            self._srv.close()
        for t in self._threads:
            t.join(timeout=2.0)

    def _native_reaper(self) -> None:
        while not self._stop.wait(min(5.0, self.ttl_s / 4)):
            native = self.native
            if native is None:
                return
            lib, h = native
            lib.kvt_reap(h, self.ttl_s)

    def _reaper(self) -> None:
        while not self._stop.wait(min(5.0, self.ttl_s / 4)):
            cutoff = time.monotonic() - self.ttl_s
            with self._lock:
                dead = [rid for rid, ex in self.exports.items() if ex.created < cutoff]
                for rid in dead:
                    del self.exports[rid]
                    self._stats["expired"] += 1

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,), daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            with conn:
                conn.settimeout(30.0)
                # one connection may carry several requests (handshake reuse)
                while not self._stop.is_set():
                    try:
                        magic = _recv_exact(conn, 4)
                    except ConnectionError:
                        return
                    if magic != MAGIC:
                        return
                    (ln,) = struct.unpack(">I", _recv_exact(conn, 4))
                    req = json.loads(_recv_exact(conn, ln))
                    self._handle(conn, req)
        except (OSError, ConnectionError, ValueError):
            pass  # connection-scoped failure; the peer retries or recomputes

    def _send_export(self, conn: socket.socket, ex: ExportedKV) -> None:
        hdr = _pull_header(ex.block_hashes, ex.token_chunks, ex.dtype,
                           ex.block_shape, len(ex.payload))
        conn.sendall(struct.pack(">I", len(hdr)) + hdr)
        conn.sendall(ex.payload)

    def _send_miss(self, conn: socket.socket) -> None:
        hdr = json.dumps({"found": False, "nbytes": 0}).encode()
        conn.sendall(struct.pack(">I", len(hdr)) + hdr)

    def _handle(self, conn: socket.socket, req: dict) -> None:
        op, rid = req.get("op"), req.get("id", "")
        if op == "pull":
            with self._lock:
                ex = self.exports.get(rid)
                self._stats["pulls" if ex else "misses"] += 1
            if ex is None:
                self._send_miss(conn)
            else:
                self._send_export(conn, ex)
        elif op == "pull_prefix":
            provider = self.prefix_provider
            hashes = [int(h) for h in req.get("hashes") or []]
            res = None
            if provider is not None and hashes:
                try:
                    res = provider(hashes, rid)
                except Exception:  # noqa: BLE001 — a provider failure is a miss
                    res = None  # the puller re-prefills
            if res is None:
                with self._lock:
                    self._stats["misses"] += 1
                self._send_miss(conn)
                return
            got_hashes, chunks, blocks = res
            # registered under the PULLER's request id: freed by its notify
            # (or abort-release / TTL) exactly like a P/D export
            self.register(rid, got_hashes, chunks, blocks)
            with self._lock:
                ex = self.exports[rid]
                self._stats["pulls"] += 1
            self._send_export(conn, ex)
        elif op == "notify":
            with self._lock:
                self.exports.pop(rid, None)
                self._stats["notifies"] += 1
            hdr = json.dumps({"ok": True, "nbytes": 0}).encode()
            conn.sendall(struct.pack(">I", len(hdr)) + hdr)


# ---------------------------------------------------------------------------
# Consumer side
# ---------------------------------------------------------------------------


@dataclass
class PulledKV:
    block_hashes: list[int]
    token_chunks: list[list[int]]
    blocks: torch.Tensor  # [n, L, ps, 2Hk, D], CPU


class KVTransferClient:
    """Decode-side puller (blocking; callers run it off the engine loop)."""

    def __init__(self, timeout_s: float = 30.0) -> None:
        self.timeout_s = timeout_s

    def _request(self, host: str, port: int, req: dict) -> tuple[dict, bytearray]:
        with socket.create_connection((host, port), timeout=self.timeout_s) as conn:
            body = json.dumps(req).encode()
            conn.sendall(MAGIC + struct.pack(">I", len(body)) + body)
            (ln,) = struct.unpack(">I", _recv_exact(conn, 4))
            hdr = json.loads(_recv_exact(conn, ln))
            n = hdr.get("nbytes", 0)
            return hdr, (_recv_exact(conn, n) if n else bytearray())

    @staticmethod
    def _decode(hdr: dict, payload: bytearray) -> Optional[PulledKV]:
        if not hdr.get("found"):
            return None
        n = len(hdr["block_hashes"])
        blocks = from_bytes(payload, hdr["dtype"], (n, *hdr["block_shape"]))
        return PulledKV(hdr["block_hashes"], hdr["token_chunks"], blocks)

    def pull(self, host: str, port: int, request_id: str) -> Optional[PulledKV]:
        hdr, payload = self._request(host, port, {"op": "pull", "id": request_id})
        return self._decode(hdr, payload)

    def pull_prefix(self, host: str, port: int, request_id: str,
                    block_hashes: Sequence[int]) -> Optional[PulledKV]:
        """KV-plane pull: ask a peer engine for whatever prefix of the given
        block-hash chain it still holds, in one round trip."""
        hdr, payload = self._request(host, port, {
            "op": "pull_prefix", "id": request_id,
            "hashes": [int(h) for h in block_hashes]})
        return self._decode(hdr, payload)

    def notify(self, host: str, port: int, request_id: str) -> bool:
        try:
            hdr, _ = self._request(host, port, {"op": "notify", "id": request_id})
            return bool(hdr.get("ok"))
        except OSError:
            return False  # producer gone; its TTL reaper cleans up


# ---------------------------------------------------------------------------
# Engine-side connector glue
# ---------------------------------------------------------------------------

_COPY_STREAMS: dict[int, "torch.cuda.Stream"] = {}
_COPY_LOCK = threading.Lock()


def _copy_stream(device: torch.device) -> "torch.cuda.Stream":
    """One side stream per card for device-to-host staging copies."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    with _COPY_LOCK:
        s = _COPY_STREAMS.get(idx)
        if s is None:
            s = _COPY_STREAMS[idx] = torch.cuda.Stream(device)
        return s


@dataclass
class StagedPart:
    """One staged gather: ``host`` holds its bytes once ``done`` has fired
    (None: already there); ``device`` keeps the gathered tensor alive until
    the copy has read it. On the card every part's ``host`` is a slice of
    one pinned buffer, ``whole``."""

    host: torch.Tensor
    done: Optional["torch.cuda.Event"] = None
    device: Optional[torch.Tensor] = None
    whole: Optional[torch.Tensor] = None


def stage_pages(gather: Callable[[list[int]], torch.Tensor], page_ids: list[int],
                staging_pages: int = 16) -> list[StagedPart]:
    """Gather the pages in chunks of ``staging_pages`` on the current stream
    (the engine's; ``gather(ids)`` gives a chunk's blocks on a device, as
    :meth:`PoolView.gather` does) and start each chunk's copy into its slice
    of one pinned host buffer, on a side stream behind an event; returns the
    in-flight parts ([n_i, L, ps, 2Hk, D] each). Cheap (no host wait): safe
    under the engine lock, and a later step that rewrites a released page is
    ordered after the gather."""
    parts: list[StagedPart] = []
    step = max(1, staging_pages)
    whole = None
    for i in range(0, len(page_ids), step):
        part = gather(page_ids[i : i + step])
        if part.device.type != "cuda":
            parts.append(StagedPart(part))
            continue
        if whole is None:
            whole = torch.empty((len(page_ids), *part.shape[1:]), dtype=part.dtype,
                                pin_memory=True)
        gathered = torch.cuda.Event()
        gathered.record()
        side = _copy_stream(part.device)
        side.wait_event(gathered)
        host = whole[i : i + part.shape[0]]
        with torch.cuda.stream(side):
            host.copy_(part, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        part.record_stream(side)
        parts.append(StagedPart(host, done, part, whole))
    return parts


def drain_staged(parts: list[StagedPart]) -> torch.Tensor:
    """Blocking half: wait for each part's own copy and return the blocks as
    one contiguous block-major host tensor ([n, L, ps, 2Hk, D]; on the card
    the pinned buffer the copies landed in). Run OFF the engine lock."""
    for p in parts:
        if p.done is not None:
            p.done.synchronize()
        p.device = None
    if parts[0].whole is not None:
        return parts[0].whole
    if len(parts) == 1:
        return parts[0].host
    return torch.cat([p.host for p in parts], dim=0)


class PoolView:
    """An engine's pool as the KV data plane reads and writes it (``LLMEngine.
    kv_pool``): whole blocks ``[n, L, ps, planes, D]`` out and in through the
    engine's ``pages_out`` / ``pages_in`` ops, which a meshed engine runs on
    every rank in command order. ``shape``, ``dtype`` and ``device`` are the
    one-card pool's (every plane: ``[L*P + 1, ps, 2Hk, D]``, an MLA pool's
    one plane; rank 0's device). So the KVT1 wire, the offload tiers, the
    durable store and a connector see the one-card block bytes whatever the
    engine's mesh: planes K0, V0, K1, V1, ... across the tp ranks, rank r
    holding ``[r*2Hk/tp, (r+1)*2Hk/tp)``."""

    def __init__(self, engine) -> None:
        self._engine = engine
        c, cfg = engine.cache, engine.model_cfg
        planes = c.shape[2] if cfg.is_mla else 2 * cfg.num_kv_heads
        self.shape = (c.shape[0], c.shape[1], planes, c.shape[3])
        self.dtype, self.device = c.dtype, c.device

    def gather(self, page_ids) -> torch.Tensor:
        """[n, L, ps, planes, D] on the pool's device (under a mesh the tp
        all-gather of the ranks' planes, on the engine's stream), ready for
        the caller's copy."""
        return self._engine._op("pages_out", pids=np.asarray(list(page_ids), np.int64))

    def insert(self, page_ids, blocks: torch.Tensor) -> None:
        """Write whole blocks (on the host or a device, any dtype the pool
        converts) into the pages, in place; under a mesh only the page ids
        travel in the command stream, the blocks go card to card."""
        self._engine._op("pages_in", pids=np.asarray(list(page_ids), np.int64),
                         host={"blocks": blocks})


@dataclass
class StagedExport:
    """In-flight staging of one request's KV export: the engine lock can be
    released the moment this exists; the bytes land while it keeps stepping."""

    request_id: str
    hashes: list[int]
    chunks: list[list[int]]
    parts: list[StagedPart]


def _stage(engine, pids: list[int], staging_pages: int) -> list[StagedPart]:
    with engine._on_stream():
        return stage_pages(engine.kv_pool.gather, pids, staging_pages)


def export_begin(engine, request_id: str, token_ids: list[int],
                 lora_id: Optional[str] = None, staging_pages: int = 16,
                 mm_hashes: Sequence[bytes] = (),
                 ) -> tuple[KVTransferParams, Optional[StagedExport]]:
    """Phase 1 (caller holds the engine lock, cheap): resolve the resident
    block chain of ``token_ids`` under adapter ``lora_id`` and media
    ``mm_hashes`` (keyed with the engine's generation-scoped
    ``_lora_hash_key`` and the media identities, as its own commits are) and
    stage its pages."""
    from llmd_tpu_torch.core.kv_events import block_keys_for_tokens

    ps = engine.cfg.page_size
    pids: list[int] = []
    hashes: list[int] = []
    chunks: list[list[int]] = []
    keys = block_keys_for_tokens(token_ids, ps, engine._lora_hash_key(lora_id), mm_hashes)
    for i, h in enumerate(keys):
        pid = engine.alloc.cached.get(h)
        if pid is None:
            break  # chain broken (block evicted already): export the resident prefix
        pids.append(pid)
        hashes.append(h)
        chunks.append(token_ids[i * ps : (i + 1) * ps])
    params = KVTransferParams(remote_request_id=request_id, num_blocks=len(pids))
    if not pids:
        return params, None
    return params, StagedExport(request_id, hashes, chunks, _stage(engine, pids, staging_pages))


def prefix_export_begin(engine, request_id: str, block_hashes: Sequence[int],
                        staging_pages: int = 16) -> Optional[StagedExport]:
    """Phase 1 of serving a cross-engine prefix pull (caller holds the engine
    lock): walk the requested hash chain against the local prefix cache and
    stage the resident prefix. Chunks ship empty: the puller verifies the
    chain against its own prompt and fills them from it."""
    pids: list[int] = []
    hashes: list[int] = []
    for h in block_hashes:
        pid = engine.alloc.cached.get(int(h))
        if pid is None:
            break  # chain broken locally: serve the resident prefix only
        pids.append(pid)
        hashes.append(int(h))
    if not pids:
        return None
    return StagedExport(request_id, hashes, [[] for _ in hashes],
                        _stage(engine, pids, staging_pages))


def export_finish(staged: StagedExport, source: KVTransferSource) -> int:
    """Phase 2 (engine lock NOT held): drain the staged copies into one
    contiguous block-major buffer and register the export. Returns blocks."""
    blocks = drain_staged(staged.parts)
    source.register(staged.request_id, staged.hashes, staged.chunks, blocks)
    return blocks.shape[0]


def export_from_engine(engine, source: KVTransferSource, request_id: str,
                       token_ids: list[int], lora_id: Optional[str] = None,
                       mm_hashes: Sequence[bytes] = ()) -> KVTransferParams:
    """Both phases back to back (tests and non-threaded callers)."""
    params, staged = export_begin(engine, request_id, token_ids, lora_id,
                                  mm_hashes=mm_hashes)
    if staged is not None:
        export_finish(staged, source)
    return params


def inject_into_engine(engine, pulled: PulledKV, token_ids: list[int],
                       lora_id: Optional[str] = None,
                       mm_hashes: Sequence[bytes] = ()) -> int:
    """Commit pulled blocks into the local allocator and pool as prefix-cache
    entries (caller holds the engine lock). Returns blocks injected.

    Only blocks matching the chain recomputed for THIS prompt (under adapter
    ``lora_id``'s generation-scoped key and the media ``mm_hashes``) are
    accepted:
    a stale or foreign export cannot poison the cache. The pool is written in
    place (its address is baked into the captured decode programs)."""
    from llmd_tpu_torch.core.kv_events import block_keys_for_tokens

    ps = engine.cfg.page_size
    pool = engine.kv_pool
    L, _ = _layers(pool, engine.cfg.num_pages)
    local_shape = (L,) + tuple(pool.shape[1:])
    if tuple(pulled.blocks.shape[1:]) != local_shape:
        # a peer with another pool layout or page geometry: dtypes convert,
        # shapes cannot; refuse loudly so it reads as a config error
        raise ValueError(
            f"pulled KV block shape {tuple(pulled.blocks.shape[1:])} does not match "
            f"local pool block shape {local_shape} — P/D peers must agree on "
            "kv_layout and page geometry (rolling upgrades: pin kv_layout)")
    with engine._on_stream():  # an allocation may evict: its copy-out too
        return _inject(engine, pulled, token_ids, engine._lora_hash_key(lora_id), mm_hashes)


def _inject(engine, pulled: PulledKV, token_ids: list[int], lora_key: Optional[str],
            mm_hashes: Sequence[bytes]) -> int:
    from llmd_tpu_torch.core.kv_events import block_keys_for_tokens

    ps = engine.cfg.page_size
    keys = block_keys_for_tokens(token_ids, ps, lora_key, mm_hashes)
    take: list[tuple[int, int]] = []  # (pulled index, page id)
    parent_of: dict[int, Optional[int]] = {}
    parent: Optional[int] = None
    for i, h in enumerate(pulled.block_hashes):
        if i >= len(keys) or keys[i] != h:
            break
        parent_of[h] = parent
        parent = h
        if h in engine.alloc.cached:
            continue  # already resident locally
        pid = engine.alloc.allocate()
        if pid is None:
            break  # pool pressure: keep what we have, recompute the rest
        take.append((i, pid))
    if not take:
        return 0
    blocks = pulled.blocks
    if len(take) < blocks.shape[0]:  # uint8 view: index_select takes no fp8 on the CPU
        idx = torch.tensor([i for i, _ in take], dtype=torch.int64)
        blocks = blocks.view(torch.uint8).index_select(0, idx).view(blocks.dtype)
    engine.kv_pool.insert([p for _, p in take], blocks)
    for i, pid in take:
        h = pulled.block_hashes[i]
        # prefix pulls ship empty chunks; the verified chain proves the local
        # prompt slice is the block's exact token content
        chunk = list(pulled.token_chunks[i]) or token_ids[i * ps : (i + 1) * ps]
        engine.alloc.commit_block(pid, h, chunk, parent_of[h], lora_key)
        engine.alloc.release(pid)  # refcount 0: cached and evictable, like any prefix hit
    return len(take)
