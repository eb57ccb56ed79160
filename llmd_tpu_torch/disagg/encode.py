"""Encode worker: the E stage of E/PD and E/P/D multimodal disaggregation
(port of ``llmd_tpu/disagg/encode.py``).

Media items of a request are encoded (bytes to ``[mm_tokens, hidden]`` rows)
by dedicated workers, concurrently across items, and the rows ride the chat
body to the P/D engines as ``mm_items``, which the engine writes over the
prompt's placeholder embeddings (``models/transformer.forward_core``):

- ``VisionRunner``: the tower (``models/vision.py``) batched over the fresh
  items of one call, on the CUDA card unless the caller asks for the CPU,
  behind a content-hash LRU so re-sent media skip the tower (the encode
  analogue of prefix caching); a lock guards the LRU and ``stats`` when
  calls overlap;
- ``EncodeServer``: a stateless worker on the standard library's HTTP server
  (as the port's engine server): ``POST /v1/encode`` ``{"items": [part,
  ...]}`` answers ``{"items": [{mm_hash, n_tokens, embedding_b64}]}`` (400
  for a part that is not an inline ``data:`` URI), ``GET /health`` and ``GET
  /metrics`` (the reference's two lines, byte for byte);
- the wire item: the canonical part identity (``core/request._mm_hash``, the
  hash the router and the engine fold into block keys) in hex, and the rows
  as little-endian float32, base64.

The tower's default weights are a test double drawn from a ``torch.Generator``
seeded by ``vision:{name}`` (the reference seeds ``jax.random`` the same way,
which torch cannot reproduce), on the CPU, so every worker for a model, on
any device, holds the same weights. ``VisionRunner(cfg, params=...)`` takes
the reference's numpy leaves instead.

    python -m llmd_tpu_torch.disagg.encode --model tiny-vl --port 8001 [--cpu]
"""

from __future__ import annotations

import base64
import binascii
import hashlib
import json
import socket
import sys
import threading
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from llmd_tpu_torch.core.request import _mm_hash, media_url_of_part, part_is_inline_media
from llmd_tpu_torch.engine.engine import resolve_device
from llmd_tpu_torch.models.config import ModelConfig
from llmd_tpu_torch.models.vision import (
    bytes_to_pixels,
    encode_images,
    init_vision_params,
    mm_content_hash,
    vision_params_from_numpy,
)

MAX_BODY_BYTES = 64 * 1024 * 1024  # the reference worker's client_max_size


def is_media_part(part) -> bool:
    """Inline ``data:`` media of a known kind, without decoding the payload;
    the one media predicate of ``core/request``, so the router's hashing and
    the engine's handling agree on what is media."""
    return part_is_inline_media(part)


def part_identity(part: dict) -> bytes:
    """The canonical media identity wherever one is compared: the router's
    block keys, the encode wire, the engine's block-key fold and P/D."""
    h = _mm_hash(part)
    return h if h is not None else hashlib.sha256(b"media").digest()


def iter_media_parts(body: dict):
    """The media parts of an OpenAI-style body, in prompt order: the one
    traversal shared by the E-stage fan-out and the server's tokenization."""
    for m in body.get("messages", []) or []:
        content = m.get("content")
        if isinstance(content, list):
            for part in content:
                if is_media_part(part):
                    yield part


def media_bytes_from_part(part: dict) -> Optional[bytes]:
    """A content part's raw media bytes (inline ``data:`` URIs only; a remote
    URL is the caller's to inline), or None."""
    _kind, url = media_url_of_part(part)
    if url is not None and url.startswith("data:"):
        try:
            return base64.b64decode(url.split(",", 1)[1], validate=False)
        except (IndexError, binascii.Error):
            return None
    return None


class VisionRunner:
    """The tower and a content-hash LRU (shared by encode workers and servers
    that encode in-process)."""

    def __init__(self, cfg: ModelConfig, cache_items: int = 256,
                 device: "torch.device | str | None" = None,
                 params: Optional[dict] = None) -> None:
        """``params``: the reference's numpy leaves (default: the seeded test
        double)."""
        if not cfg.has_vision:
            raise ValueError(f"model {cfg.name!r} has no vision tower")
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            seed = int.from_bytes(
                hashlib.sha256(f"vision:{cfg.name}".encode()).digest()[:4], "little")
            self.params = init_vision_params(cfg, torch.Generator().manual_seed(seed),
                                             self.device)
        else:
            self.params = vision_params_from_numpy(cfg, params, self.device)
        self._lock = threading.Lock()  # the LRU and stats, once calls overlap
        self._lru: OrderedDict[bytes, np.ndarray] = OrderedDict()
        self._cache_items = cache_items
        self.stats = {"encoded_items": 0, "cache_hits": 0}

    def encode_pixels(self, pixels: np.ndarray) -> torch.Tensor:
        """[N, S, S, 3] float32 pixels -> [N, mm_tokens, hidden] rows on the
        runner's device (no cache)."""
        with torch.no_grad():
            # llmd-lint: allow[lock-unguarded-read] one atomic read of the weights dict: an encode in flight keeps the dict it read until it returns; close() swaps in an empty one under the lock, and taking the lock here would serialise overlapping encodes
            return encode_images(self.cfg, self.params,
                                 torch.from_numpy(pixels).to(self.device))

    def encode(self, payloads: list[bytes]) -> list[tuple[bytes, np.ndarray]]:
        """Bytes per media item -> [(content hash, [mm_tokens, hidden] float32)]."""
        out: list[Optional[tuple[bytes, np.ndarray]]] = [None] * len(payloads)
        fresh: list[tuple[int, bytes, bytes]] = []  # (slot, hash, payload)
        with self._lock:
            for i, data in enumerate(payloads):
                h = mm_content_hash(data)
                hit = self._lru.get(h)
                if hit is not None:
                    self._lru.move_to_end(h)
                    self.stats["cache_hits"] += 1
                    out[i] = (h, hit)
                else:
                    fresh.append((i, h, data))
        if fresh:
            px = np.stack([bytes_to_pixels(self.cfg, d) for _, _, d in fresh])
            emb = self.encode_pixels(px).float().cpu().numpy()
            with self._lock:
                for (i, h, _), e in zip(fresh, emb):
                    out[i] = (h, e)
                    self._lru[h] = e
                    if len(self._lru) > self._cache_items:
                        self._lru.popitem(last=False)
                self.stats["encoded_items"] += len(fresh)
        return out  # type: ignore[return-value]

    def close(self) -> None:
        """Drop the tower's weights (its device memory) and the cached rows;
        the runner encodes nothing after."""
        with self._lock:
            self.params = {}
            self._lru.clear()


def mm_item_to_wire(h: bytes, emb: np.ndarray) -> dict:
    return {
        "mm_hash": h.hex(),
        "n_tokens": int(emb.shape[0]),
        "embedding_b64": base64.b64encode(
            np.ascontiguousarray(emb, np.float32).tobytes()).decode(),
    }


def mm_item_from_wire(d: dict, hidden_size: int) -> tuple[bytes, np.ndarray]:
    emb = np.frombuffer(base64.b64decode(d["embedding_b64"]), np.float32)
    return bytes.fromhex(d["mm_hash"]), emb.reshape(int(d["n_tokens"]), hidden_size)


class EncodeServer:
    """A standalone encode worker (the reference's encode deployment role)."""

    def __init__(self, cfg: ModelConfig, host: str = "127.0.0.1", port: int = 0,
                 device: "torch.device | str | None" = None) -> None:
        self.cfg = cfg
        self.host, self.port = host, port
        self.runner_ = VisionRunner(cfg, device=device)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._conns: set[socket.socket] = set()  # open client connections
        self._conns_lock = threading.Lock()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> None:
        """Bind (port 0 picks a free one) and serve on a thread."""
        self._httpd = ThreadingHTTPServer((self.host, self.port), _make_handler(self))
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="encode-server", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        with self._conns_lock:
            conns, self._conns = self._conns, set()
        for conn in conns:  # idle keep-alive connections end with the server
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    def metrics_text(self) -> str:
        s = self.runner_.stats
        return (f'llmd_tpu:encode_items_total {s["encoded_items"]}\n'
                f'llmd_tpu:encode_cache_hits_total {s["cache_hits"]}\n')

    def encode(self, body: dict) -> tuple[int, dict]:
        parts = body.get("items", [])
        payloads: list[bytes] = []
        for part in parts:
            data = media_bytes_from_part(part)
            if data is None:
                return 400, {"error": "unsupported media part (inline data: URIs only)"}
            payloads.append(data)
        encoded = self.runner_.encode(payloads)
        # the wire identity is the canonical part hash (what the router and
        # the engine fold into block keys); the content hash keys the LRU only
        return 200, {"items": [mm_item_to_wire(part_identity(p), e)
                               for p, (_h, e) in zip(parts, encoded)]}


def _make_handler(server: EncodeServer) -> type:
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"  # keep-alive: every response is sized

        def setup(self) -> None:
            super().setup()
            with server._conns_lock:
                server._conns.add(self.connection)

        def finish(self) -> None:
            with server._conns_lock:
                server._conns.discard(self.connection)
            super().finish()

        def _send(self, status: int, data: bytes, ctype: str = "application/json") -> None:
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self) -> None:  # noqa: N802 — http.server's spelling
            path = self.path.partition("?")[0]
            if path == "/health":
                self._send(200, json.dumps({"status": "ok", "role": "encode"}).encode())
            elif path == "/metrics":
                self._send(200, server.metrics_text().encode(), "text/plain; charset=utf-8")
            else:
                self._send(404, json.dumps({"error": f"no route {path}"}).encode())

        def do_POST(self) -> None:  # noqa: N802
            path = self.path.partition("?")[0]
            n = int(self.headers.get("Content-Length") or 0)
            if n > MAX_BODY_BYTES:
                self.close_connection = True
                self._send(413, json.dumps({"error": "request body too large"}).encode())
                return
            raw = self.rfile.read(n) if n else b""
            if path != "/v1/encode":
                self._send(404, json.dumps({"error": f"no route {path}"}).encode())
                return
            try:
                body = json.loads(raw)
                if not isinstance(body, dict):
                    raise ValueError("body must be a JSON object")
            except ValueError:
                self._send(400, json.dumps({"error": "invalid JSON"}).encode())
                return
            status, payload = server.encode(body)
            self._send(status, json.dumps(payload).encode())

        def log_message(self, format: str, *args) -> None:  # noqa: A002
            pass  # no per-request stderr lines

    return Handler


def main(argv: "list[str] | None" = None) -> None:
    """CLI: an encode worker for ``--model`` (a registry shape with a tower),
    on the CUDA card unless ``--cpu`` is given."""
    import argparse

    from llmd_tpu_torch.models import get_model_config

    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="tiny-vl",
                    help="registry shape with a vision tower (mm_tokens > 0)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8001)
    ap.add_argument("--cpu", action="store_true", help="run the tower on the CPU (dev)")
    args = ap.parse_args(argv)
    srv = EncodeServer(get_model_config(args.model), host=args.host, port=args.port,
                       device="cpu" if args.cpu else None)
    srv.start()
    print(f"llmd-tpu-torch encode worker ({args.model}) on http://{srv.address} "
          f"(device {srv.runner_.device})", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        srv.stop()


if __name__ == "__main__":
    main(sys.argv[1:])
