"""OpenAI-compatible HTTP server over the port's engine, on the standard library.

``http.server.ThreadingHTTPServer`` answers each connection in its own thread;
one engine-loop thread (``AsyncLLMEngine``) steps the engine. Routes:

- ``POST /v1/completions``: non-streaming; ``prompt`` as a string or a list of
  token ids (or ``prompt_token_ids``). The response has the reference
  server's top-level keys (``llmd_tpu/engine/server.py``: id, object, created,
  model, usage, choices). ``stop`` strings cut the returned text.
- ``GET /v1/models``, ``GET /health``.

Streaming, chat, embeddings, ``/metrics`` and KV-event publication are later
work (ROADMAP).
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from llmd_tpu_torch.core.request import SamplingParams
from llmd_tpu_torch.engine.async_engine import AsyncLLMEngine, EngineLoopError
from llmd_tpu_torch.engine.config import EngineConfig
from llmd_tpu_torch.engine.engine import LLMEngine
from llmd_tpu_torch.engine.tokenizer import Tokenizer, load_tokenizer
from llmd_tpu_torch.models.config import ModelConfig


def sampling_from_body(body: dict) -> SamplingParams:
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
        logprobs=body.get("logprobs"),
        guided_choice=body.get("guided_choice"),
        guided_regex=body.get("guided_regex"),
        response_format=body.get("response_format"),
        logit_bias=body.get("logit_bias"),
    )


class EngineServer:
    def __init__(
        self,
        model_cfg: ModelConfig,
        engine_cfg: EngineConfig,
        model_name: Optional[str] = None,
        host: str = "127.0.0.1",
        port: int = 8000,
        tokenizer: Optional[Tokenizer] = None,
        params=None,
        engine: Optional[LLMEngine] = None,
        device=None,
        seed: int = 0,
    ) -> None:
        self.model_name = model_name or f"llmd-tpu/{model_cfg.name}"
        self.host, self.port = host, port
        self.tokenizer = tokenizer or load_tokenizer()
        self.engine = engine or LLMEngine(model_cfg, engine_cfg, params=params,
                                          seed=seed, device=device)
        self.async_engine = AsyncLLMEngine(self.engine)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> None:
        """Bind (port 0 picks a free one), start the engine loop and the server."""
        self._httpd = ThreadingHTTPServer((self.host, self.port), _make_handler(self))
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self.async_engine.start()
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="http-server", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        self.async_engine.stop()

    # -- handlers: (status, payload) ---------------------------------------
    def health(self) -> tuple[int, dict]:
        err = self.async_engine.error
        if err is not None:
            return 503, {"status": "unhealthy", "error": str(err)}
        return 200, {"status": "ok"}

    def models(self) -> tuple[int, dict]:
        return 200, {"object": "list",
                     "data": [{"id": self.model_name, "object": "model"}]}

    def _tokenize_body(self, body: dict) -> list[int]:
        if body.get("prompt_token_ids"):
            return [int(t) for t in body["prompt_token_ids"]]
        prompt = body.get("prompt", "")
        if isinstance(prompt, list):
            if prompt and all(isinstance(t, int) for t in prompt):
                return list(prompt)
            raise ValueError("prompt must be a string or a list of token ids "
                             "(batched prompts are not served)")
        return self.tokenizer.encode(str(prompt))

    def completions(self, body: dict) -> tuple[int, dict]:
        if body.get("stream"):
            return 400, {"error": {"message": "streaming is not served by the port yet"}}
        try:
            token_ids = self._tokenize_body(body)
            sampling = sampling_from_body(body)
        except (ValueError, TypeError) as e:
            return 400, {"error": {"message": str(e)}}
        if not sampling.ignore_eos:
            sampling.stop_token_ids = tuple(sampling.stop_token_ids) + (self.tokenizer.eos_id,)
        rid = f"cmpl-{uuid.uuid4().hex[:16]}"
        created = int(time.time())
        model = body.get("model", self.model_name)
        out_ids: list[int] = []
        cached, reason = 0, None
        try:
            for out in self.async_engine.generate(rid, token_ids, sampling):
                out_ids.extend(out.new_token_ids)
                cached = out.num_cached_prompt_tokens
                reason = out.finish_reason
        except ValueError as e:
            return 400, {"error": {"message": str(e)}}
        except EngineLoopError as e:
            return 500, {"error": {"message": str(e)}}
        text = self.tokenizer.decode(out_ids)
        cut = [i for i in (text.find(s) for s in sampling.stop if s) if i >= 0]
        if cut:
            text, reason = text[: min(cut)], "stop"
        usage = {"prompt_tokens": len(token_ids), "completion_tokens": len(out_ids),
                 "total_tokens": len(token_ids) + len(out_ids), "cached_tokens": cached}
        return 200, {
            "id": rid, "object": "text_completion", "created": created,
            "model": model, "usage": usage,
            "choices": [{"index": 0, "text": text, "finish_reason": reason}],
        }


def _make_handler(server: EngineServer) -> type:
    class Handler(BaseHTTPRequestHandler):
        def _send(self, status: int, payload: dict) -> None:
            data = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self) -> None:  # noqa: N802 — http.server's spelling
            if self.path == "/health":
                self._send(*server.health())
            elif self.path == "/v1/models":
                self._send(*server.models())
            else:
                self._send(404, {"error": {"message": f"no route {self.path}"}})

        def do_POST(self) -> None:  # noqa: N802
            if self.path != "/v1/completions":
                self._send(404, {"error": {"message": f"no route {self.path}"}})
                return
            try:
                n = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(body, dict):
                    raise ValueError("body must be a JSON object")
            except ValueError:
                self._send(400, {"error": {"message": "invalid JSON"}})
                return
            self._send(*server.completions(body))

        def log_message(self, format: str, *args) -> None:  # noqa: A002
            pass  # no per-request stderr lines

    return Handler
