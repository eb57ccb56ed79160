"""OpenAI-compatible HTTP server over the port's engine, on the standard library:
the model-server surface that llm-d's router, pool controller and KV indexer
drive (reference ``llmd_tpu/engine/server.py``).

``http.server.ThreadingHTTPServer`` answers each connection in its own thread
over HTTP/1.1 keep-alive (every JSON response carries its length, every SSE
stream is chunked, so a router's pooled connections stay usable); one
engine-loop thread (``AsyncLLMEngine``) steps the engine. Routes:

- ``POST /v1/completions`` and ``POST /v1/chat/completions`` (messages
  flattened by ``core/request.flatten_messages``): the reference's
  ``text_completion`` / ``chat.completion`` objects; ``"stream": true`` gives
  SSE, one ``data:`` event per engine output (``text`` or ``delta.content``,
  ``finish_reason`` once finished, ``usage`` with ``cached_tokens`` on the
  last), then ``data: [DONE]``. A client that disconnects mid-stream aborts
  its request. ``prompt`` is encoded as its text, as the reference does (a
  list prompt as its ``str``; token ids go in ``prompt_token_ids``); ``stop``
  strings cut the text, streamed or not. The text of a stream is decoded
  incrementally, so its joined pieces equal the non-streamed text.
- ``POST /v1/completions/render`` and ``/v1/chat/completions/render``:
  ``{"prompt_token_ids": [...]}``, the tokens the router's token producer
  hashes.
- ``GET /metrics``: the engine's registry (``obs/metrics.py``, vLLM's and the
  reference's names) then the server's; the request gauges are set from
  ``engine.stats`` first.
- Admission gate on the generation routes: 503 with ``Retry-After: 1`` while
  draining; 504 when the ``x-request-timeout`` budget is already spent (a
  malformed value is ignored). A malformed structured body (``guided_choice``,
  ``guided_regex``, ``response_format``, ``logit_bias``) answers 400 before
  the request counts (``validate_structured_body``); well-formed ones ride
  the completion and chat bodies to the engine, which is given the server's
  tokenizer to lift grammars onto, and stream piece by piece like any other.
- ``GET /health`` (503 ``draining`` while draining, 503 ``unhealthy`` if the
  engine loop died), ``POST /drain[?timeout_s=30]`` (stop admitting, wait,
  bounded, for the requests in flight: 200 ``drained`` or 504 ``timeout``;
  body ``{"enable": false}`` reopens admission), ``GET /v1/models``.

With ``kv_events_port`` set, the engine's KV events are published on the
reference's topic and wire (``engine/kv_publisher.py``); port 0 picks a free
one, read back from ``kv_events_port`` after ``start()``.

Not served yet (ROADMAP Queue A): ``/debug/*``, ``/v1/embeddings``,
``/v1/responses``, ``/v1/conversations``, the LoRA routes and P/D
``kv_transfer_params``.
"""

from __future__ import annotations

import itertools
import json
import socket
import sys
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Iterator, Optional
from urllib.parse import parse_qs

from llmd_tpu_torch.core.kv_events import kv_topic
from llmd_tpu_torch.core.request import HDR_REQUEST_TIMEOUT, SamplingParams, flatten_messages
from llmd_tpu_torch.engine.async_engine import AsyncLLMEngine, EngineLoopError
from llmd_tpu_torch.engine.config import EngineConfig
from llmd_tpu_torch.engine.engine import LLMEngine
from llmd_tpu_torch.engine.kv_publisher import KVEventPublisher
from llmd_tpu_torch.engine.tokenizer import Tokenizer, load_tokenizer
from llmd_tpu_torch.models.config import ModelConfig
from llmd_tpu_torch.obs.metrics import Registry, register_engine_server_metrics
from llmd_tpu_torch.structured import validate_structured_body

GENERATE_ROUTES = {"/v1/completions": False, "/v1/chat/completions": True}  # path -> chat
RENDER_ROUTES = ("/v1/completions/render", "/v1/chat/completions/render")


def sampling_from_body(body: dict) -> SamplingParams:
    """The reference's parse (``_sampling_from_body``); ``min_p``,
    ``logprobs``, ``repetition_penalty`` are not read, as there."""
    stop = body.get("stop") or ()
    return SamplingParams(
        max_tokens=int(body.get("max_tokens", 16)),
        temperature=float(body.get("temperature", 1.0)),
        top_p=float(body.get("top_p", 1.0)),
        top_k=int(body.get("top_k", 0)),
        stop=(stop,) if isinstance(stop, str) else tuple(stop),
        stop_token_ids=tuple(body.get("stop_token_ids") or ()),
        seed=body.get("seed"),
        ignore_eos=bool(body.get("ignore_eos", False)),
        n=int(body.get("n", 1)),
        presence_penalty=float(body.get("presence_penalty", 0.0)),
        frequency_penalty=float(body.get("frequency_penalty", 0.0)),
        guided_choice=body.get("guided_choice"),
        guided_regex=body.get("guided_regex"),
        response_format=body.get("response_format"),
        logit_bias=body.get("logit_bias"),
    )


class TextStream:
    """One request's text, decoded as its tokens arrive. ``push`` returns the
    text that has become final: a trailing replacement character (a UTF-8
    sequence still incomplete) and the last ``len(stop) - 1`` characters (a
    stop string still incomplete) wait for more tokens. The joined pieces
    equal the decode of all the tokens, cut before the first stop string;
    ``stopped`` is set once one appeared."""

    def __init__(self, tokenizer: Tokenizer, stop) -> None:
        self.tokenizer = tokenizer
        self.stop = [s for s in stop if s]
        self.ids: list[int] = []
        self.sent = 0  # characters returned so far
        self.stopped = False

    def push(self, ids: list[int], final: bool) -> str:
        self.ids.extend(ids)
        text = self.tokenizer.decode(self.ids)
        cuts = [i for i in (text.find(s) for s in self.stop) if i >= 0]
        if cuts:
            end, self.stopped = min(cuts), True
        elif final:
            end = len(text)
        else:
            end = len(text) - max((len(s) - 1 for s in self.stop), default=0)
            if text.endswith("\ufffd"):
                end = min(end, len(text) - 1)
        piece = text[self.sent:end]
        self.sent = max(self.sent, end)
        return piece


class EngineServer:
    def __init__(
        self,
        model_cfg: ModelConfig,
        engine_cfg: EngineConfig,
        model_name: Optional[str] = None,
        host: str = "127.0.0.1",
        port: int = 8000,
        kv_events_port: Optional[int] = None,
        tokenizer: Optional[Tokenizer] = None,
        params=None,
        engine: Optional[LLMEngine] = None,
        device=None,
        seed: int = 0,
    ) -> None:
        self.model_name = model_name or f"llmd-tpu/{model_cfg.name}"
        self.host, self.port = host, port
        self.tokenizer = tokenizer or load_tokenizer()
        self.kv_events_port = kv_events_port
        self.publisher = (KVEventPublisher(kv_events_port)
                          if kv_events_port is not None else None)
        sink = self.publisher.sink if self.publisher is not None else None
        if engine is None:
            engine = LLMEngine(model_cfg, engine_cfg, params=params, event_sink=sink,
                               seed=seed, device=device, tokenizer=self.tokenizer)
        else:
            if engine.tokenizer is None:  # structured requests lift onto this vocabulary
                engine.tokenizer = self.tokenizer
            if sink is not None:
                engine.alloc.event_sink = sink
        self.engine = engine
        self.async_engine = AsyncLLMEngine(self.engine)
        # frontend-owned families; the engine's live in engine.registry
        self.registry = Registry()
        self.server_metrics = register_engine_server_metrics(self.registry)
        # POST /drain: admissions stop, in-flight requests finish, /health
        # says draining so the router routes around this engine
        self.draining = False
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._conns: set[socket.socket] = set()  # open client connections
        self._conns_lock = threading.Lock()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> None:
        """Bind (port 0 picks a free one), start the engine loop, the KV-event
        publisher (raising if it cannot start) and the server."""
        self._httpd = _HTTPServer((self.host, self.port), _make_handler(self))
        self.port = self._httpd.server_address[1]
        if self.publisher is not None:
            try:
                self.publisher.start(kv_topic(self.address, self.model_name))
            except BaseException:
                self._httpd.server_close()
                self._httpd = None
                raise
            self.kv_events_port = self.publisher.port
        self.async_engine.start()
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="http-server", daemon=True)
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
        self.async_engine.stop()
        if self.publisher is not None:
            self.publisher.stop()

    # -- handlers: (status, payload[, headers]) ------------------------------
    def health(self) -> tuple[int, dict]:
        if self.draining:
            return 503, {"status": "draining", "inflight": len(self.engine.seqs)}
        err = self.async_engine.error
        if err is not None:
            return 503, {"status": "unhealthy", "error": str(err)}
        return 200, {"status": "ok"}

    def models(self) -> tuple[int, dict]:
        return 200, {"object": "list",
                     "data": [{"id": self.model_name, "object": "model"}]}

    def metrics_text(self) -> str:
        """The engine's families, then the server's; the request gauges
        mirror ``engine.stats`` at scrape time (no engine lock is taken)."""
        em, st = self.engine.metrics, self.engine.stats
        em.requests_waiting.set(st.num_waiting)
        em.requests_running.set(st.num_running)
        em.kv_usage.set(st.kv_utilization)
        return self.engine.registry.expose() + self.registry.expose()

    def admission_block(self, headers) -> Optional[tuple[int, dict, dict]]:
        """Draining: 503, retryable, so the router re-schedules the request on
        another engine. A forwarded deadline already spent: 504, before any
        work. A malformed deadline header is ignored."""
        if self.draining:
            return 503, {"error": {"message": "draining"}}, {"Retry-After": "1"}
        raw = headers.get(HDR_REQUEST_TIMEOUT)
        if raw is not None:
            try:
                budget = float(raw)
            except ValueError:
                return None
            if budget <= 0:
                return 504, {"error": {"message": "deadline exceeded"}}, {}
        return None

    def drain(self, query: str, body: dict) -> tuple[int, dict]:
        """Stop admitting and wait, at most ``timeout_s`` (default 30), for
        the requests in flight to finish; ``{"enable": false}`` reopens."""
        if body.get("enable") is False:
            self.draining = False
            return 200, {"status": "ok", "draining": False}
        try:
            timeout_s = float(parse_qs(query).get("timeout_s", ["30"])[-1])
        except ValueError:
            return 400, {"error": {"message": "timeout_s must be a number"}}
        t0 = time.monotonic()
        self.draining = True
        while self.engine.seqs and time.monotonic() - t0 < timeout_s:
            time.sleep(0.02)
        drained = not self.engine.seqs
        return (200 if drained else 504), {"status": "drained" if drained else "timeout",
                                           "inflight": len(self.engine.seqs)}

    def tokenize_body(self, body: dict) -> list[int]:
        """The prompt's token ids, as the reference's ``_tokenize_body``:
        ``prompt_token_ids`` as given, ``messages`` flattened, otherwise the
        text of ``prompt`` (a list prompt is encoded as its ``str``)."""
        if body.get("prompt_token_ids"):
            return [int(t) for t in body["prompt_token_ids"]]
        if "messages" in body:
            return self.tokenizer.encode(flatten_messages(body["messages"]))
        return self.tokenizer.encode(str(body.get("prompt", "")))

    def render(self, body: dict) -> tuple[int, dict]:
        try:
            return 200, {"prompt_token_ids": self.tokenize_body(body)}
        except (ValueError, TypeError, AttributeError) as e:  # malformed body
            return 400, {"error": {"message": str(e)}}

    def generate(self, body: dict, chat: bool):
        """(status, payload) for a JSON answer, or (200, iterator of SSE
        event dicts) for a stream whose first engine output has arrived."""
        try:
            # a malformed structured spec (schema, regex, logit_bias) is a
            # 400 before the request counts or reaches the engine
            validate_structured_body(body)
        except ValueError as e:
            return 400, {"error": {"message": str(e)}}
        self.server_metrics.requests.inc()
        try:
            token_ids = self.tokenize_body(body)
            sampling = sampling_from_body(body)
        except (ValueError, TypeError, AttributeError) as e:  # malformed body
            return 400, {"error": {"message": str(e)}}
        if not sampling.ignore_eos:
            sampling.stop_token_ids = tuple(sampling.stop_token_ids) + (self.tokenizer.eos_id,)
        rid = f"cmpl-{uuid.uuid4().hex[:16]}"
        head = {"id": rid, "object": "chat.completion" if chat else "text_completion",
                "created": int(time.time()), "model": body.get("model", self.model_name)}
        text = TextStream(self.tokenizer, sampling.stop)
        outputs = self.async_engine.generate(rid, token_ids, sampling)
        try:
            first = next(outputs)  # admission errors surface here, as a 400
        except ValueError as e:
            return 400, {"error": {"message": str(e)}}
        except EngineLoopError as e:
            return 500, {"error": {"message": str(e)}}
        if body.get("stream"):
            return 200, self._sse_events(outputs, first, head, chat, text, len(token_ids))
        out_ids, out = list(first.new_token_ids), first
        try:
            while not out.finished:
                out = next(outputs)
                out_ids.extend(out.new_token_ids)
        except EngineLoopError as e:
            return 500, {"error": {"message": str(e)}}
        content = text.push(out_ids, final=True)
        reason = "stop" if text.stopped else out.finish_reason
        choice = ({"index": 0, "message": {"role": "assistant", "content": content},
                   "finish_reason": reason} if chat else
                  {"index": 0, "text": content, "finish_reason": reason})
        return 200, {**head, "usage": _usage(len(token_ids), len(out_ids),
                                              out.num_cached_prompt_tokens),
                     "choices": [choice]}

    def _sse_events(self, outputs: Iterator, out, head: dict, chat: bool, text: TextStream,
                    n_prompt: int) -> Iterator[dict]:
        """One event per engine output; closing this iterator (a client gone
        mid-stream) closes ``outputs``, which aborts the request."""
        head = {**head, "object": "chat.completion.chunk" if chat else "text_completion"}
        n_out = 0
        try:
            while True:
                n_out += len(out.new_token_ids)
                piece = text.push(out.new_token_ids, final=out.finished)
                finished = out.finished or text.stopped
                reason = "stop" if text.stopped else out.finish_reason
                choice = ({"index": 0, "delta": {"content": piece}} if chat else
                          {"index": 0, "text": piece})
                choice["finish_reason"] = reason if finished else None
                event = {**head, "choices": [choice]}
                if finished:
                    event["usage"] = _usage(n_prompt, n_out, out.num_cached_prompt_tokens)
                yield event
                if finished:
                    return
                out = next(outputs)
        finally:
            outputs.close()


def _usage(n_prompt: int, n_out: int, cached: int) -> dict:
    return {"prompt_tokens": n_prompt, "completion_tokens": n_out,
            "total_tokens": n_prompt + n_out, "cached_tokens": cached}


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True

    def handle_error(self, request, client_address) -> None:
        if isinstance(sys.exc_info()[1], ConnectionError):
            return  # a client closed its keep-alive connection: nothing to report
        super().handle_error(request, client_address)


def _make_handler(server: EngineServer) -> type:
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"  # keep-alive: every response is sized or chunked

        def setup(self) -> None:
            super().setup()
            with server._conns_lock:
                server._conns.add(self.connection)

        def finish(self) -> None:
            with server._conns_lock:
                server._conns.discard(self.connection)
            super().finish()

        def _send_bytes(self, status: int, data: bytes, ctype: str,
                        headers: Optional[dict] = None) -> None:
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def _send(self, status: int, payload: dict, headers: Optional[dict] = None) -> None:
            self._send_bytes(status, json.dumps(payload).encode(), "application/json",
                             headers)

        def _stream(self, events: Iterator[dict]) -> None:
            """SSE over chunked transfer encoding; a write that fails (the
            client went away) closes ``events``, which aborts the request."""

            def chunk(data: bytes) -> None:
                self.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))
                self.wfile.flush()

            try:
                # the first event is ready (its engine output has arrived);
                # taking it starts ``events``, so closing it always aborts
                first = next(events)
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                for event in itertools.chain([first], events):
                    chunk(f"data: {json.dumps(event)}\n\n".encode())
                chunk(b"data: [DONE]\n\n")
                self.wfile.write(b"0\r\n\r\n")
            except (BrokenPipeError, ConnectionResetError):
                self.close_connection = True
            except EngineLoopError:
                self.close_connection = True  # the stream ends unterminated
            finally:
                events.close()

        def _body(self) -> Optional[dict]:
            """The JSON object body ({} when empty); None after answering 400."""
            n = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(n) if n else b""
            try:
                body = json.loads(raw) if raw else {}
                if not isinstance(body, dict):
                    raise ValueError("body must be a JSON object")
            except ValueError:
                self._send(400, {"error": {"message": "invalid JSON"}})
                return None
            return body

        def do_GET(self) -> None:  # noqa: N802 — http.server's spelling
            path = self.path.partition("?")[0]
            if path == "/health":
                self._send(*server.health())
            elif path == "/v1/models":
                self._send(*server.models())
            elif path == "/metrics":
                self._send_bytes(200, server.metrics_text().encode(),
                                 "text/plain; charset=utf-8")
            else:
                self._send(404, {"error": {"message": f"no route {path}"}})

        def do_POST(self) -> None:  # noqa: N802
            path, _, query = self.path.partition("?")
            if path in GENERATE_ROUTES:
                blocked = server.admission_block(self.headers)
                body = self._body()  # read even when blocked: the connection stays usable
                if blocked is not None:
                    self._send(*blocked)
                elif body is not None:
                    status, result = server.generate(body, chat=GENERATE_ROUTES[path])
                    if isinstance(result, dict):
                        self._send(status, result)
                    else:
                        self._stream(result)
            elif path in RENDER_ROUTES:
                body = self._body()
                if body is not None:
                    self._send(*server.render(body))
            elif path == "/drain":
                n = int(self.headers.get("Content-Length") or 0)
                try:  # an unreadable body counts as empty, as the reference's
                    body = json.loads(self.rfile.read(n)) if n else {}
                except ValueError:
                    body = {}
                self._send(*server.drain(query, body if isinstance(body, dict) else {}))
            else:
                n = int(self.headers.get("Content-Length") or 0)
                self.rfile.read(n)
                self._send(404, {"error": {"message": f"no route {path}"}})

        def log_message(self, format: str, *args) -> None:  # noqa: A002
            pass  # no per-request stderr lines

    return Handler
