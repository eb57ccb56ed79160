"""Minimal Redis/Valkey-wire (RESP2) server (copy of
``llmd_tpu/testing/resp_server.py``) — the in-repo stand-in for the
external index store (kv/index_backends.ExternalKVBlockIndex), playing the
role Valkey plays for the reference's Redis index backend
(kv-indexer.md:64-101). Command subset the index layout needs: PING, HSET,
HGET, HGETALL, HDEL, DEL, SADD, SREM, SMEMBERS, DBSIZE, FLUSHALL.

Thread-per-connection over blocking sockets (RESP is simple enough not to
need an event loop).
No eviction: a real Valkey brings its own maxmemory policy.
"""

from __future__ import annotations

import socket
import threading
from typing import Optional


class RespStoreServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self.host, self.port = host, port
        self._hashes: dict[bytes, dict[bytes, bytes]] = {}
        self._sets: dict[bytes, set[bytes]] = {}
        self._lock = threading.Lock()
        self._srv: Optional[socket.socket] = None
        self._stop = threading.Event()

    def start(self) -> None:
        self._srv = socket.create_server((self.host, self.port))
        self.port = self._srv.getsockname()[1]
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="resp-store").start()

    def stop(self) -> None:
        self._stop.set()
        if self._srv is not None:
            try:  # wake a blocked accept() (see kv/remote_store.py stop())
                with socket.create_connection(
                        ("127.0.0.1" if self.host in ("0.0.0.0", "::")
                         else self.host, self.port), timeout=0.2):
                    pass
            except OSError:
                pass
            self._srv.close()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    # -- wire --------------------------------------------------------------
    def _serve(self, conn: socket.socket) -> None:
        buf = b""

        def read_line() -> Optional[bytes]:
            nonlocal buf
            while b"\r\n" not in buf:
                chunk = conn.recv(65536)
                if not chunk:
                    return None
                buf += chunk
            line, buf = buf.split(b"\r\n", 1)
            return line

        def read_exact(n: int) -> Optional[bytes]:
            nonlocal buf
            while len(buf) < n + 2:
                chunk = conn.recv(65536)
                if not chunk:
                    return None
                buf += chunk
            data, buf = buf[:n], buf[n + 2:]
            return data

        try:
            with conn:
                while not self._stop.is_set():
                    line = read_line()
                    if line is None:
                        return
                    if not line.startswith(b"*"):
                        conn.sendall(b"-ERR protocol\r\n")
                        return
                    parts = []
                    for _ in range(int(line[1:])):
                        hdr = read_line()
                        if hdr is None or not hdr.startswith(b"$"):
                            return
                        val = read_exact(int(hdr[1:]))
                        if val is None:
                            return
                        parts.append(val)
                    conn.sendall(self._dispatch(parts))
        except (OSError, ValueError):
            pass

    # -- commands ----------------------------------------------------------
    @staticmethod
    def _bulk(v: Optional[bytes]) -> bytes:
        return b"$-1\r\n" if v is None else b"$%d\r\n%s\r\n" % (len(v), v)

    def _dispatch(self, parts: list[bytes]) -> bytes:
        cmd, args = parts[0].upper(), parts[1:]
        with self._lock:
            if cmd == b"PING":
                return b"+PONG\r\n"
            if cmd == b"HSET":
                h = self._hashes.setdefault(args[0], {})
                added = 0
                for i in range(1, len(args), 2):
                    added += args[i] not in h
                    h[args[i]] = args[i + 1]
                return b":%d\r\n" % added
            if cmd == b"HGET":
                return self._bulk(self._hashes.get(args[0], {}).get(args[1]))
            if cmd == b"HGETALL":
                h = self._hashes.get(args[0], {})
                out = b"*%d\r\n" % (2 * len(h))
                for k, v in h.items():
                    out += self._bulk(k) + self._bulk(v)
                return out
            if cmd == b"HDEL":
                h = self._hashes.get(args[0], {})
                n = 0
                for f in args[1:]:
                    n += h.pop(f, None) is not None
                if not h:
                    self._hashes.pop(args[0], None)
                return b":%d\r\n" % n
            if cmd == b"DEL":
                n = 0
                for k in args:
                    n += (self._hashes.pop(k, None) is not None
                          or self._sets.pop(k, None) is not None)
                return b":%d\r\n" % n
            if cmd == b"SADD":
                s = self._sets.setdefault(args[0], set())
                n = len(args[1:]) - len(s.intersection(args[1:]))
                s.update(args[1:])
                return b":%d\r\n" % n
            if cmd == b"SREM":
                s = self._sets.get(args[0], set())
                n = len(s.intersection(args[1:]))
                s.difference_update(args[1:])
                if not s:
                    self._sets.pop(args[0], None)
                return b":%d\r\n" % n
            if cmd == b"SMEMBERS":
                s = sorted(self._sets.get(args[0], set()))
                return b"*%d\r\n" % len(s) + b"".join(self._bulk(m) for m in s)
            if cmd == b"DBSIZE":
                return b":%d\r\n" % (len(self._hashes) + len(self._sets))
            if cmd == b"FLUSHALL":
                self._hashes.clear()
                self._sets.clear()
                return b"+OK\r\n"
            return b"-ERR unknown command '%s'\r\n" % cmd


def main() -> None:
    """CLI: python -m llmd_tpu_torch.testing.resp_server --port 6379"""
    import argparse
    import time

    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=6379)
    args = ap.parse_args()
    srv = RespStoreServer(args.host, args.port)
    srv.start()
    print(f"llmd-tpu RESP store on {srv.host}:{srv.port}", flush=True)
    while True:
        time.sleep(3600)


if __name__ == "__main__":
    main()
