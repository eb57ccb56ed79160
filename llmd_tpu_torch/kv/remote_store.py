"""Remote KV store over the network (port of ``llmd_tpu/kv/remote_store.py``,
the same KVS1 frames, so a port engine and a JAX engine share one store).

A standalone content-addressed block store any engine reaches over TCP, behind
the out-of-tree connector seam (kv/connector_api.py) — KV computed by one pod
survives pod restarts and feeds OTHER pods' admissions, the cross-pod tier the
reference gets from InfiniStore-backed LMCache (Dockerfile.cuda:55-59,
kv-offloader.md:70-100). Design choices for this stack:

- content-addressed by chained block hash (the same keys the prefix cache and
  KV events use), so admission can ask for a consecutive chain directly;
- framed wire protocol in the house style (MAGIC + JSON header + raw payload,
  like disagg/transfer.py) — one long-lived store, many short-lived clients;
- byte-budget LRU eviction server-side (external stores manage their own
  capacity — the engine never has to care, matching the FS-backend contract).

Wire protocol (request → response):
  MAGIC ‖ u32 len ‖ JSON header ‖ payload?
  ops: put   {hashes, dtype, shape, nbytes} + payload   → {stored}
       get   {hashes}                  → {found, dtype, shape, nbytes} + payload
       probe {hashes}                  → {found}         (consecutive prefix)
       stats {}                        → counters
"""

from __future__ import annotations

import json
import math
import random
import socket
import struct
import threading
import time
import zlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional

from llmd_tpu_torch.kv import dtypes
from llmd_tpu_torch.kv.connector_api import KVConnectorBase, register_kv_connector
from llmd_tpu_torch.kv.dtypes import resolve_dtype  # the reference's name here, without ml_dtypes

MAGIC = b"KVS1"


@dataclass
class StoreFaults:
    """Fault injection for the KVS1 server, in the testing/fake_server.py
    FaultConfig idiom — chaos tests drive real wire frames, not mocks."""

    error_rate: float = 0.0          # fraction of ops answered {"error": ...}
    connect_refuse: bool = False     # accept then close before the request
    latency_s: float = 0.0           # per-op service delay
    first_byte_delay_s: float = 0.0  # delay before the get response frame
    corrupt_payload: bool = False    # flip one byte per block (after crc)
    hangup_rate: float = 0.0         # fraction of gets cut mid-payload
    seed: int = 0


def _recv_exact(conn: socket.socket, n: int) -> bytearray:
    buf = bytearray(n)
    view, got = memoryview(buf), 0
    while got < n:
        k = conn.recv_into(view[got:], min(1 << 20, n - got))
        if not k:
            raise ConnectionError("peer closed mid-frame")
        got += k
    return buf


def _send_frame(conn: socket.socket, header: dict, payload=b"") -> None:
    hdr = json.dumps(header).encode()
    conn.sendall(MAGIC + struct.pack("<I", len(hdr)) + hdr)
    if len(payload):
        conn.sendall(payload)


def _recv_frame(conn: socket.socket) -> tuple[dict, "socket.socket"]:
    if _recv_exact(conn, 4) != MAGIC:
        raise ConnectionError("bad magic")
    (hlen,) = struct.unpack("<I", _recv_exact(conn, 4))
    return json.loads(_recv_exact(conn, hlen)), conn


def verify_crc_prefix(body: bytes, n: int, crcs) -> int:
    """Longest verified consecutive block prefix of a get payload.

    Truncating at the first checksum mismatch (rather than rejecting the
    whole payload) keeps the consecutive-prefix property admission relies
    on: everything before the corrupt block is still committable. A store
    predating the crc header (no list) passes through unverified.
    """
    if not crcs or n <= 0:
        return max(0, n)
    per = len(body) // n
    for i in range(min(n, len(crcs))):
        if zlib.crc32(body[i * per : (i + 1) * per]) != int(crcs[i]):
            return i
    return n


class RemoteKVStoreServer:
    """Content-addressed block store with a byte-budget LRU."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 max_bytes: int = 1 << 30) -> None:
        self.host, self.port = host, port
        self.max_bytes = max_bytes
        # guarded-by: _lock — entries are (blob, dtype, shape, crc32)
        self._blocks: OrderedDict[int, tuple[bytes, str, tuple, int]] = (
            OrderedDict())
        self._bytes = 0  # guarded-by: _lock
        self._lock = threading.Lock()
        self._srv: Optional[socket.socket] = None
        self._stop = threading.Event()
        # guarded-by: _lock
        self.stats = {"puts": 0, "gets": 0, "probes": 0, "evictions": 0,
                      "hit_blocks": 0, "miss_blocks": 0}
        self.faults = StoreFaults()
        self._fault_rng = random.Random(self.faults.seed)
        # guarded-by: _lock
        self.fault_counts = {"refused": 0, "errors": 0, "hangups": 0,
                             "corrupted": 0}

    def set_faults(self, **kw) -> None:
        for k, v in kw.items():
            if not hasattr(self.faults, k):
                raise AttributeError(f"unknown fault knob {k!r}")
            setattr(self.faults, k, v)
        self._fault_rng = random.Random(self.faults.seed)

    def start(self) -> None:
        self._srv = socket.create_server((self.host, self.port))
        self.port = self._srv.getsockname()[1]
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="kv-store").start()

    def stop(self) -> None:
        self._stop.set()
        if self._srv is not None:
            # close() alone does NOT interrupt a thread blocked in accept()
            # on Linux — the syscall pins the kernel socket, which keeps
            # accepting (and serving) connections until accept returns. A
            # self-connection wakes it so the loop observes _stop and exits.
            wake_host = ("127.0.0.1" if self.host in ("0.0.0.0", "::")
                         else self.host)
            try:
                with socket.create_connection((wake_host, self.port),
                                              timeout=0.2):
                    pass
            except OSError:
                pass
            self._srv.close()

    # -- storage -----------------------------------------------------------
    def _put(self, hashes: list[int], dtype: str, shape: tuple,
             payload: bytes) -> int:
        # a truncated/misaligned client frame must not be stored under content
        # hashes that later read back as valid KV bytes: nbytes must be exactly
        # n blocks of the declared dtype/shape
        try:
            expect = (len(hashes) * math.prod(int(d) for d in (shape or (1,)))
                      * resolve_dtype(dtype).itemsize)
        except (TypeError, ValueError) as e:  # an unknown dtype name is a TypeError
            raise ValueError(f"bad put header dtype/shape: {e}") from e
        if len(payload) != expect:
            raise ValueError(
                f"put payload {len(payload)}B != {len(hashes)} blocks of "
                f"{dtype}{tuple(shape)} = {expect}B")
        per = len(payload) // max(1, len(hashes))
        with self._lock:
            for i, h in enumerate(hashes):
                if h in self._blocks:
                    self._blocks.move_to_end(h)
                    continue
                blob = bytes(payload[i * per : (i + 1) * per])
                # crc captured at ingest: a get response carries it so clients
                # can reject payloads corrupted on the wire (or by fault
                # injection) without trusting the transport
                self._blocks[h] = (blob, dtype, tuple(shape), zlib.crc32(blob))
                self._bytes += len(blob)
            while self._bytes > self.max_bytes and self._blocks:
                _h, (blob, _d, _s, _c) = self._blocks.popitem(last=False)
                self._bytes -= len(blob)
                self.stats["evictions"] += 1
            self.stats["puts"] += 1
        return len(hashes)

    def _prefix(self, hashes: list[int], touch: bool) -> list[int]:
        """Consecutive found prefix (the only shape admission can commit)."""
        out = []
        with self._lock:
            for h in hashes:
                if h not in self._blocks:
                    break
                if touch:
                    self._blocks.move_to_end(h)
                out.append(h)
        return out

    def _get(self, hashes: list[int]) -> tuple[
            list[int], list[tuple[bytes, str, tuple, int]]]:
        """Consecutive prefix AND its blobs under ONE critical section.

        Scanning the prefix and fetching the blobs under separate lock
        acquisitions is a poison race: a concurrent put-triggered eviction can
        remove a middle block between the two, and the client would commit a
        non-consecutive payload positionally under the consecutive hash chain.
        """
        have: list[int] = []
        blobs: list[tuple[bytes, str, tuple, int]] = []
        with self._lock:
            for h in hashes:
                entry = self._blocks.get(h)
                if entry is None:
                    break
                self._blocks.move_to_end(h)
                have.append(h)
                blobs.append(entry)
        return have, blobs

    # -- server loop -------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_one, args=(conn,),
                             daemon=True).start()

    def _serve_one(self, conn: socket.socket) -> None:
        f = self.faults
        try:
            with conn:
                if f.connect_refuse:
                    # accept-then-slam: the client's next read raises
                    # ConnectionError, same failure class as a refused connect
                    with self._lock:
                        self.fault_counts["refused"] += 1
                    return
                if f.latency_s:
                    time.sleep(f.latency_s)
                hdr, _ = _recv_frame(conn)
                op = hdr.get("op")
                if f.error_rate and self._fault_rng.random() < f.error_rate:
                    if op == "put":  # drain the payload so the socket is clean
                        _recv_exact(conn, int(hdr.get("nbytes", 0)))
                    with self._lock:
                        self.fault_counts["errors"] += 1
                    _send_frame(conn, {"error": "injected fault",
                                       "stored": 0, "found": 0})
                    return
                if op == "put":
                    payload = _recv_exact(conn, int(hdr["nbytes"]))
                    try:
                        n = self._put([int(h) for h in hdr["hashes"]],
                                      hdr["dtype"], hdr["shape"], payload)
                    except ValueError as e:
                        _send_frame(conn, {"error": str(e), "stored": 0})
                    else:
                        _send_frame(conn, {"stored": n})
                elif op == "probe":
                    hashes = [int(h) for h in hdr["hashes"]]
                    have = self._prefix(hashes, touch=False)
                    with self._lock:
                        self.stats["hit_blocks"] += len(have)
                        self.stats["miss_blocks"] += len(hashes) - len(have)
                        self.stats["probes"] += 1
                    _send_frame(conn, {"found": len(have)})
                elif op == "get":
                    hashes = [int(h) for h in hdr["hashes"]]
                    have, blobs = self._get(hashes)
                    with self._lock:
                        self.stats["hit_blocks"] += len(have)
                        self.stats["miss_blocks"] += len(hashes) - len(have)
                        self.stats["gets"] += 1
                    payload = b"".join(b for b, _d, _s, _c in blobs)
                    meta = blobs[0] if blobs else (b"", "float32", (), 0)
                    resp = {"found": len(blobs),
                            "dtype": meta[1],
                            "shape": list(meta[2]),
                            "crc": [c for _b, _d, _s, c in blobs],
                            "nbytes": len(payload)}
                    if f.first_byte_delay_s:
                        time.sleep(f.first_byte_delay_s)
                    if f.corrupt_payload and payload:
                        # flip a byte per block AFTER the crc list was built:
                        # the client's checksum verify is what must catch it
                        per = len(payload) // max(1, len(blobs))
                        buf = bytearray(payload)
                        for i in range(len(blobs)):
                            buf[i * per] ^= 0xFF
                        payload = bytes(buf)
                        with self._lock:
                            self.fault_counts["corrupted"] += 1
                    if (payload and f.hangup_rate
                            and self._fault_rng.random() < f.hangup_rate):
                        hdrb = json.dumps(resp).encode()
                        conn.sendall(MAGIC + struct.pack("<I", len(hdrb))
                                     + hdrb + payload[: len(payload) // 2])
                        with self._lock:
                            self.fault_counts["hangups"] += 1
                        return  # with-block slams the socket mid-frame
                    _send_frame(conn, resp, payload)
                elif op == "stats":
                    with self._lock:
                        _send_frame(conn, {**self.stats,
                                           "blocks": len(self._blocks),
                                           "bytes": self._bytes})
                else:
                    _send_frame(conn, {"error": f"unknown op {op!r}"})
        except (ConnectionError, OSError, json.JSONDecodeError):
            pass  # client vanished mid-op: next client gets a fresh thread


class RemoteKVConnector(KVConnectorBase):
    """Engine-side connector speaking the store protocol (registered as
    ``remote-store``; EngineConfig.kv_connector_params = {host, port})."""

    def __init__(self, params: Optional[dict] = None) -> None:
        super().__init__(params)
        p = self.params
        self.host = p.get("host", "127.0.0.1")
        self.port = int(p.get("port", 0))
        self.timeout = float(p.get("timeout_s", 5.0))
        # get_num_matched_blocks runs under the engine scheduling lock — the
        # connector API's own contract says 'must be cheap (index lookup, no
        # IO)', so the admission probe gets a far tighter deadline than the
        # bulk get/put paths: a blackholed store must not stall the step loop
        self.probe_timeout = float(p.get("probe_timeout_s", 0.25))
        # circuit breakers: after `breaker_errors` CONSECUTIVE failures the
        # path goes dark for `breaker_cooldown_s` rather than paying a timeout
        # per call forever. TWO independent breakers: the admission probe's
        # tight deadline must not conflate a slow-but-healthy store (probe
        # times out at 0.25s, bulk get/put fine within 5s) with a dead one —
        # probe failures only stop probing; bulk failures stop everything.
        self.breaker_errors = int(p.get("breaker_errors", 3))
        self.breaker_cooldown = float(p.get("breaker_cooldown_s", 30.0))
        self._consec_errors = {"probe": 0, "bulk": 0}
        self._open_until = {"probe": 0.0, "bulk": 0.0}
        self.stats = {"errors": 0, "breaker_trips": 0, "breaker_skips": 0}

    def _rpc(self, header: dict, payload=b"",
             timeout: Optional[float] = None) -> tuple[dict, bytearray]:
        with socket.create_connection((self.host, self.port),
                                      timeout=timeout or self.timeout) as conn:
            _send_frame(conn, header, payload)
            resp, _ = _recv_frame(conn)
            body = _recv_exact(conn, int(resp["nbytes"])) if resp.get("nbytes") else b""
            return resp, body

    def _breaker_open(self, path: str) -> bool:
        import time as _time

        now = _time.monotonic()
        # a bulk-path outage silences the probe too (probing a dead store from
        # under the engine lock is the stall the breaker exists to prevent)
        for key in ({"probe", "bulk"} if path == "probe" else {path}):
            if (self._consec_errors[key] >= self.breaker_errors
                    and now < self._open_until[key]):
                self.stats["breaker_skips"] += 1
                return True
        return False

    def _record(self, ok: bool, path: str = "bulk") -> None:
        import time as _time

        if ok:
            self._consec_errors[path] = 0
            if path == "bulk":
                # bulk success proves the store alive: give the probe its
                # trial back immediately instead of waiting out the cooldown
                self._open_until["probe"] = 0.0
            return
        self.stats["errors"] += 1
        self._consec_errors[path] += 1
        if self._consec_errors[path] == self.breaker_errors:
            self.stats["breaker_trips"] += 1
        if self._consec_errors[path] >= self.breaker_errors:
            self._open_until[path] = _time.monotonic() + self.breaker_cooldown

    def get_num_matched_blocks(self, block_hashes: list[int]) -> int:
        if self._breaker_open("probe"):
            return 0
        try:
            resp, _ = self._rpc({"op": "probe", "hashes": block_hashes},
                                timeout=self.probe_timeout)
            self._record(ok=True, path="probe")
            return int(resp.get("found", 0))
        except (OSError, ConnectionError, KeyError, ValueError):
            self._record(ok=False, path="probe")
            return 0  # store down/slow = no external hits; serving continues

    def load_blocks(self, cache, block_hashes, page_ids, pages_per_layer):
        want = block_hashes[: len(page_ids)]
        if self._breaker_open("bulk"):
            return cache, 0
        try:
            resp, body = self._rpc({"op": "get", "hashes": want})
            n = int(resp.get("found", 0))
            if n == 0:
                self._record(ok=True)
                return cache, 0
            n = verify_crc_prefix(body, n, resp.get("crc"))
            # a corrupt payload is a store-path failure (repeats should trip
            # the breaker), but the verified consecutive prefix is still good
            self._record(ok=n == int(resp["found"]))
            if n == 0:
                return cache, 0
            per = len(body) // int(resp["found"])
            blocks = dtypes.from_bytes(memoryview(body)[: n * per], resp["dtype"],
                                       (n, *resp["shape"]))
            cache.insert(page_ids[:n], blocks)
            return cache, n
        except (OSError, ConnectionError, KeyError, ValueError, TypeError):
            self._record(ok=False)
            return cache, 0

    def save_blocks(self, block_hashes, token_chunks, blocks) -> None:
        if self._breaker_open("bulk"):
            return
        arr = blocks.contiguous()
        try:
            self._rpc({"op": "put", "hashes": list(block_hashes),
                       "dtype": dtypes.dtype_name(arr.dtype), "shape": list(arr.shape[1:]),
                       "nbytes": dtypes.nbytes(arr)}, dtypes.to_bytes(arr))
            self._record(ok=True)
        except (OSError, ConnectionError):
            self._record(ok=False)  # best-effort tier


register_kv_connector("remote-store", RemoteKVConnector)


def main() -> None:
    """CLI: python -m llmd_tpu_torch.kv.remote_store --port 9400 --max-gb 8"""
    import argparse
    import time

    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=9400)
    ap.add_argument("--max-gb", type=float, default=8.0)
    args = ap.parse_args()
    srv = RemoteKVStoreServer(args.host, args.port,
                              max_bytes=int(args.max_gb * (1 << 30)))
    srv.start()
    print(f"llmd-tpu-torch remote KV store on {srv.host}:{srv.port} "
          f"({args.max_gb} GB budget)", flush=True)
    while True:
        time.sleep(3600)


if __name__ == "__main__":
    main()
