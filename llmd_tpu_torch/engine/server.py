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
  body ``{"enable": false}`` reopens admission), ``GET /v1/models`` (loaded
  LoRA adapters listed with their ``parent``).
- LoRA (an engine built with ``EngineConfig.lora``): a generation or
  embedding request names its adapter in ``lora_adapter``, or names a loaded
  adapter as its ``model`` (the canary of an adapter rollout); an unknown
  adapter, or any adapter while LoRA is off, is a 404. ``POST
  /v1/load_lora_adapter`` ``{"lora_name", "lora_path"?}`` answers 200 with the
  slot, 409 when the adapter is busy, 400 otherwise (``lora_path``: an npz of
  ``lora_{A,B}_{target}`` arrays; one that needs ``ml_dtypes`` to read, such
  as a bfloat16 npz, is refused with 400); ``POST /v1/unload_lora_adapter``
  answers 200, 404 for an unknown adapter and 409 when busy.
  ``vllm:lora_requests_info`` is rebuilt at every scrape.
- ``POST /v1/embeddings``: ``input`` a string, a list of strings, a token
  list or a list of token lists; one mean-pooled, L2-normalised vector each
  (``LLMEngine.embed``, under the engine lock), behind the admission gate;
  400 on an empty item or a token id outside the vocabulary, 503 when the
  engine cannot serve it (no free pages).

With ``kv_events_port`` set, the engine's KV events are published on the
reference's topic and wire (``engine/kv_publisher.py``); port 0 picks a free
one, read back from ``kv_events_port`` after ``start()``.

The KV data plane (``disagg/transfer.py``), as the reference's server: with
``kv_transfer_port`` set (0 = a free one) a ``KVTransferSource`` serves pulls
of this engine's exports, and the completion and chat bodies take
``kv_transfer_params``:

- ``do_remote_decode``: once the (non-streamed) request is done, its prompt's
  resident blocks are staged under the engine lock and registered off it;
  the answer carries ``kv_transfer_params`` (``remote_request_id``,
  ``num_blocks``, ``remote_host`` when routable, ``remote_port``);
- ``do_remote_prefill``: the blocks are pulled, injected under the engine
  lock before admission and the producer notified (``_pull_remote_kv``); any
  failure recomputes;
- ``do_prefix_pull`` (the KV plane): the peer rung, then the durable store
  (``_pull_prefix_kv``, ``_durable_get``); a failure never fails the request.
  With ``LLMD_KV_PLANE=precise`` the source also serves peers' prefix pulls.

Each path keys its blocks under the request's adapter and media.

Multimodal (a model with ``mm_tokens`` > 0), as the reference's server: a
chat body with inline ``data:`` media parts, or with E-stage ``mm_items``, is
tokenized by ``_mm_token_stream`` (each media part becomes ``mm_tokens``
placeholder ids; ``/render`` answers the same stream, so the router's
precise scorer hashes what the engine hashes). ``_tokenize_mm`` matches the
wire items to the parts by part identity and encodes the missing ones with
an in-process tower (one lazy ``VisionRunner`` on the engine's device, under
a lock); a server without a tower degrades such a request to the text-only
flattening. A bad item is a 400 ``multimodal content: ...``. The media
identities key the request's blocks in the P/D pull, the export, the prefix
pull and the durable rung.

A pull whose producer was not notified is released when the request ends
(``_release_pending_pull``). ``/drain`` flushes the engine's durable
write-back queue within its budget (``_flush_for_drain``). The transfer and
durable metric families read ``transfer_stats``, the source's counters and
the queue, as the reference's do.

The observability plane, as the reference's server:

- a generation request opens an ``engine.generate`` span, a child of its
  ``traceparent`` header when it carries one, and hands the span's context
  to the engine (the flight record's trace id, the exemplars, the
  ``engine.step`` spans); the router's ``x-llm-d-tenant`` header (clamped)
  lands on the flight record. The prefix pull records ``kv_pull``, the
  durable rung ``kv_durable_get``, the write-back queue ``kv_flush`` and
  ``/drain`` ``drain_start`` / ``drain_done`` on the engine's recorder;
- ``GET /debug/requests[?status,model,min_latency_ms,trace,limit]`` and
  ``GET /debug/requests/{rid}`` (the detail with its phase and decision
  ledgers; 404 for an unknown id, 400 for a non-numeric filter);
- ``start()`` builds and starts the engine's ``DeviceMonitor``
  (``obs/device.py``) unless the engine has one, and ``stop()`` stops the
  one it built; ``/health`` answers 503 ``{"status": "unhealthy",
  "reason": ...}`` while the monitor reports a stalled step loop or a dead
  card; ``GET /debug/profile?seconds=N`` captures one profiler window (400
  for a non-numeric ``seconds``, 409 while another capture runs, 503 without
  a monitor, 500 if the capture fails), run on the request's own thread;
  the tracer starts and stops with the step loop paused between steps.

``POST /v1/responses`` (``input`` a string or a list of role / content
items, ``max_output_tokens``, an optional ``conversation``) goes through the
chat path's tokenization, admission gate and generation; ``POST
/v1/conversations``, ``GET`` / ``DELETE /v1/conversations/{cid}`` and ``GET``
/ ``POST /v1/conversations/{cid}/items`` keep the reference's pod-local
store, LRU-capped at 4096 conversations of at most 512 items each (404 for
an unknown id).
"""

from __future__ import annotations

import itertools
import json
from collections import OrderedDict
import re
import socket
import sys
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Iterator, Optional
from urllib.parse import parse_qs, unquote

import numpy as np

from llmd_tpu_torch.core.kv_events import kv_topic
from llmd_tpu_torch.core.request import (
    HDR_REQUEST_TIMEOUT, HDR_TENANT, SamplingParams, clamp_tenant, flatten_messages)
from llmd_tpu_torch.disagg.encode import (
    VisionRunner,
    is_media_part,
    iter_media_parts,
    media_bytes_from_part,
    mm_item_from_wire,
    part_identity,
)
from llmd_tpu_torch.disagg.transfer import (
    KVTransferClient,
    KVTransferParams,
    KVTransferSource,
    PulledKV,
    drain_staged,
    export_begin,
    export_finish,
    inject_into_engine,
)
from llmd_tpu_torch.engine.async_engine import AsyncLLMEngine, EngineLoopError
from llmd_tpu_torch.engine.config import EngineConfig
from llmd_tpu_torch.engine.engine import LLMEngine
from llmd_tpu_torch.engine.kv_publisher import KVEventPublisher
from llmd_tpu_torch.engine.tokenizer import Tokenizer, load_tokenizer
from llmd_tpu_torch.kvplane import plane_mode, pull_prefix_into, serve_prefix
from llmd_tpu_torch.models.config import ModelConfig
from llmd_tpu_torch.obs.device import DeviceMonitor, ProfileBusy
from llmd_tpu_torch.obs.events import debug_detail_response, debug_list_response
from llmd_tpu_torch.obs.metrics import Registry, register_engine_server_metrics
from llmd_tpu_torch.obs.tracing import extract_traceparent, global_tracer
from llmd_tpu_torch.structured import validate_structured_body

GENERATE_ROUTES = {"/v1/completions": False, "/v1/chat/completions": True}  # path -> chat
RENDER_ROUTES = ("/v1/completions/render", "/v1/chat/completions/render")
LORA_ROUTES = {"/v1/load_lora_adapter": "load_lora", "/v1/unload_lora_adapter": "unload_lora"}


def body_has_media(body: dict) -> bool:
    return bool(body.get("mm_items")) or next(iter_media_parts(body), None) is not None


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
        kv_transfer_port: Optional[int] = None,
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
        self.kv_transfer_port = kv_transfer_port
        self.advertise_host: Optional[str] = None  # routable host for transfer handles
        self.transfer_source: Optional[KVTransferSource] = None
        self.transfer_client: Optional[KVTransferClient] = None
        self.transfer_stats = {"injected_blocks": 0, "pull_failures": 0,
                               "prefix_pulls": 0, "prefix_pull_blocks": 0,
                               "released": 0}  # guarded-by: _transfer_lock
        # pulls whose peer-side registration may still be live: local rid ->
        # (host, port, remote rid), released when the request ends
        self._pending_pulls: dict[str, tuple] = {}  # guarded-by: _transfer_lock
        self._transfer_lock = threading.Lock()
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
        # the in-process tower (combined PD), built at the first media request
        self._vision: Optional[VisionRunner] = None
        self._vision_lock = threading.Lock()
        # frontend-owned families; the engine's live in engine.registry
        self.registry = Registry()
        self.server_metrics = register_engine_server_metrics(self.registry)
        self._attach_transfer_metrics()
        # POST /drain: admissions stop, in-flight requests finish, /health
        # says draining so the router routes around this engine
        self.draining = False
        self.tracer = global_tracer()  # the engine hop joins the router's trace
        # the device plane's monitor: built and owned by start() unless the
        # engine arrived with one
        self.monitor: Optional[DeviceMonitor] = None
        self._owns_monitor = False
        # the Conversations API store: pod-local (the router keeps a
        # conversation's traffic on this pod), LRU-capped, and each
        # conversation capped too (the oldest items roll off)
        self._conversations: "OrderedDict[str, dict]" = OrderedDict()  # guarded-by: _conv_lock
        self._conv_lock = threading.Lock()
        self._max_conversations = 4096
        self._max_conv_items = 512
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._conns: set[socket.socket] = set()  # open client connections
        self._conns_lock = threading.Lock()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def _attach_transfer_metrics(self) -> None:
        """The transfer and durable families read live state at scrape time,
        at the reference's sites (``transfer_stats``, the source's counters
        and registrations, the write-back queue and breaker); the flush
        counter is moved by the queue's ``on_flush`` callback."""
        sm = self.server_metrics
        for key in self.transfer_stats:
            sm.transfer[key].set_function(lambda k=key: self.transfer_stats[k])
        for key in ("exports", "pulls", "notifies", "expired"):
            sm.transfer[key].set_function(
                lambda k=key: self.transfer_source.stats.get(k, 0)
                if self.transfer_source is not None else 0)
        sm.transfer_registrations.set_function(
            lambda: len(self.transfer_source) if self.transfer_source is not None else 0)
        sm.kv_durable_queue_depth.set_function(
            lambda: self.engine.writeback.depth() if self.engine.writeback is not None else 0)
        sm.kv_durable_breaker.set_function(
            lambda: self.engine.durable.breaker_state()
            if self.engine.durable is not None else 0.0)
        wb = self.engine.writeback
        if wb is not None and wb.on_flush is None:
            def _on_flush(outcome: str, n_blocks: int) -> None:
                sm.kv_durable_flush.labels(outcome=outcome).inc(n_blocks)
                self.engine.flight.record_system("kv_flush", outcome=outcome, n_blocks=n_blocks)

            wb.on_flush = _on_flush

    def _bump(self, key: str, n: int = 1) -> None:
        with self._transfer_lock:
            self.transfer_stats[key] += n

    def start(self) -> None:
        """Bind (port 0 picks a free one), start the KV-event publisher
        (raising if it cannot start), the KV transfer source, the device
        monitor, the engine loop and the server; a failure before the serve
        loop unbinds."""
        self._httpd = _HTTPServer((self.host, self.port), _make_handler(self))
        self.port = self._httpd.server_address[1]
        try:
            self._start_planes()
        except BaseException:
            # stop() must not wait on a serve loop that never ran
            self._httpd.server_close()
            self._httpd = None
            raise
        self.async_engine.start()
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="http-server", daemon=True)
        self._thread.start()

    def _start_planes(self) -> None:
        """The KV-event publisher, the KV transfer source and the device
        monitor, for ``start``."""
        if self.publisher is not None:
            self.publisher.start(kv_topic(self.address, self.model_name))
            self.kv_events_port = self.publisher.port
        if self.kv_transfer_port is not None:
            self.transfer_source = KVTransferSource(port=self.kv_transfer_port)
            if plane_mode() == "precise":
                # serve peers' pull_prefix from the local prefix cache (set
                # before start(): selects the python transport, which speaks it)
                self.transfer_source.prefix_provider = (
                    lambda hashes, rid: serve_prefix(self, hashes, rid))
            self.transfer_source.start()
            self.kv_transfer_port = self.transfer_source.port
            self.transfer_client = KVTransferClient()
        if self.engine.monitor is None:
            # pending_fn reads the engine's live map without its lock: the
            # watchdog never waits on the lock a hung step holds
            eng = self.engine
            monitor = DeviceMonitor(
                eng.registry, flight=eng.flight,
                devices=[eng.device] if eng.device.type == "cuda" else [],
                pending_fn=lambda: bool(eng.seqs),
                pause_fn=self.async_engine.run_locked)
            monitor.start()
            self.engine.monitor = monitor
            self._owns_monitor = True
        self.monitor = self.engine.monitor

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
        if self._owns_monitor and self.monitor is not None:
            self.monitor.stop()
            self.engine.monitor = self.monitor = None
            self._owns_monitor = False
        if self.engine.writeback is not None:
            self.engine.writeback.stop()
        if self.transfer_source is not None:
            self.transfer_source.stop()
        if self.publisher is not None:
            self.publisher.stop()

    # -- the KV data plane ---------------------------------------------------
    def _pull_remote_kv(self, ktp: KVTransferParams, token_ids: list[int],
                        rid: Optional[str] = None, lora_id: Optional[str] = None,
                        mm_hashes: list = ()) -> int:
        """Pull and inject the producer's KV; any failure recomputes locally
        (kv_load_failure_policy=recompute)."""
        if rid is not None:
            with self._transfer_lock:
                self._pending_pulls[rid] = (ktp.remote_host, ktp.remote_port,
                                            ktp.remote_request_id)
        try:
            pulled = self.transfer_client.pull(ktp.remote_host, ktp.remote_port,
                                               ktp.remote_request_id)
            if pulled is None:
                self._bump("pull_failures")
                return 0
            n = self.async_engine.run_locked(
                lambda: inject_into_engine(self.engine, pulled, token_ids, lora_id, mm_hashes))
            self._bump("injected_blocks", n)
            # free the producer's export (NIXL-notify semantics)
            if self.transfer_client.notify(ktp.remote_host, ktp.remote_port,
                                           ktp.remote_request_id) and rid is not None:
                with self._transfer_lock:
                    self._pending_pulls.pop(rid, None)
            return n
        except Exception as e:  # noqa: BLE001 — a failed pull recomputes, never fails the request
            self._bump("pull_failures")
            if isinstance(e, ValueError) and "block shape" in str(e):
                # a peer layout or geometry mismatch is a standing config
                # error: say so once a minute, not only in the counter
                now = time.monotonic()
                if now - getattr(self, "_shape_err_ts", 0.0) > 60.0:
                    self._shape_err_ts = now
                    print(f"kv-transfer: {e}", file=sys.stderr, flush=True)
            return 0

    def _pull_prefix_kv(self, rid: str, ktp: KVTransferParams, token_ids: list[int],
                        lora_id: Optional[str] = None, mm_hashes: list = ()) -> int:
        """KV-plane prefix pull ahead of prefill: the peer rung first (when the
        router stamped one), then the cluster-durable store. A failure falls
        through to the offload tiers and re-prefill; it never fails the
        request. Injected blocks become ordinary prefix hits."""
        self._bump("prefix_pulls")
        t0 = time.monotonic()
        tier = ktp.tier or "peer"
        peer = f"{ktp.remote_host}:{ktp.remote_port}"
        n, outcome = 0, "miss"
        if tier == "peer" and ktp.remote_host and self.transfer_client is not None:
            with self._transfer_lock:
                self._pending_pulls[rid] = (ktp.remote_host, ktp.remote_port,
                                            ktp.remote_request_id)
            n, outcome, released = pull_prefix_into(self, ktp, token_ids, lora_id,
                                                    mm_hashes)
            if released:
                with self._transfer_lock:
                    self._pending_pulls.pop(rid, None)
        durable = self.engine.durable
        if n == 0 and durable is not None and ktp.block_hashes:
            # the durable rung: the peer died or missed, or the router stamped
            # the durable tier directly; the cluster store outlives replicas
            dn, d_outcome = self._durable_get(ktp.block_hashes, token_ids, lora_id,
                                              mm_hashes)
            if dn or tier == "durable":
                n, outcome, tier = dn, d_outcome, "durable"
                peer = f"{durable.cfg.host}:{durable.cfg.port}"
        pull_s = time.monotonic() - t0
        self.server_metrics.prefix_pull_seconds.labels(outcome=outcome).observe(pull_s)
        if n:
            self._bump("prefix_pull_blocks", n)
        else:
            self._bump("pull_failures")
        # the pull runs before admission opens the flight record: open it here
        # (start is idempotent; add_request backfills the model); a durable
        # fetch keeps the kv_pull name, ``tier`` tells them apart
        self.engine.flight.start(rid)
        self.engine.flight.record(rid, "kv_pull", outcome=outcome, blocks=n,
                                  ms=round(pull_s * 1e3, 3), tier=tier, peer=peer)
        return n

    def _durable_get(self, block_hashes, token_ids: list[int],
                     lora_id: Optional[str] = None, mm_hashes: list = ()) -> tuple[int, str]:
        """The durable rung: fetch the verified consecutive prefix from the
        cluster store and inject it exactly like a peer pull (hash-chain
        verified against THIS prompt, shape-checked). Returns
        (blocks injected, the pull's outcome)."""
        t0 = time.monotonic()
        want = [int(h) for h in block_hashes]
        n, blocks, fetch_outcome = self.engine.durable.get(want)
        injected = 0
        if n and blocks is not None:
            pulled = PulledKV(block_hashes=want[:n], token_chunks=[[] for _ in range(n)],
                              blocks=blocks)
            try:
                injected = self.async_engine.run_locked(
                    lambda: inject_into_engine(self.engine, pulled, token_ids, lora_id,
                                               mm_hashes))
            except ValueError:
                # block shape or chain mismatch: never commit suspect bytes
                injected, fetch_outcome = 0, "corrupt"
            except Exception:  # noqa: BLE001 — any other inject failure falls down the ladder
                injected, fetch_outcome = 0, "error"
            if injected:
                self._bump("injected_blocks", injected)
        self.engine.flight.record_system("kv_durable_get", outcome=fetch_outcome,
                                         blocks=injected,
                                         ms=round((time.monotonic() - t0) * 1e3, 3))
        self.server_metrics.kv_durable_get.labels(outcome=fetch_outcome).inc()
        if injected:
            return injected, "hit"
        if fetch_outcome in ("ok", "miss", "breaker_open"):
            return 0, "miss"
        return 0, "error"

    def _flush_for_drain(self, budget_s: float) -> tuple[int, int]:
        """Final write-back before retirement: stage the resident prefix set
        under the engine lock, drain its bytes off it, enqueue, then empty
        the flush queue within the remaining budget (the rest is abandoned)."""
        from llmd_tpu_torch.kv.writeback import stage_resident_blocks

        t0 = time.monotonic()
        wb = self.engine.writeback
        try:
            hashes, parts = self.async_engine.run_locked(
                lambda: stage_resident_blocks(self.engine, wb.max_blocks))
            if hashes:
                wb.offer(hashes, drain_staged(parts))
        except Exception:  # noqa: BLE001 — best effort: drain must still retire on time
            pass
        return wb.flush_for_drain(max(0.0, budget_s - (time.monotonic() - t0)))

    def _release_pending_pull(self, rid: str) -> None:
        """Free the peer-side registration of an ended request whose pull was
        never notified, so a dead puller does not pin the peer's export until
        its TTL."""
        with self._transfer_lock:
            pending = self._pending_pulls.pop(rid, None)
        if pending is None or self.transfer_client is None:
            return
        host, port, remote_rid = pending
        if self.transfer_client.notify(host, port, remote_rid):
            self._bump("released")

    def _export(self, rid: str, token_ids: list[int], lora_id: Optional[str] = None,
                mm_hashes: list = ()) -> dict:
        """``do_remote_decode``: stage the prompt's resident blocks under the
        engine lock, drain and register them off it; the transfer handle."""
        out_params, staged = self.async_engine.run_locked(
            lambda: export_begin(self.engine, rid, token_ids, lora_id,
                                 staging_pages=self.engine.cfg.offload_staging_blocks,
                                 mm_hashes=mm_hashes))
        if staged is not None:
            export_finish(staged, self.transfer_source)
        # advertise a routable host, never the bind-any address: the sidecar
        # falls back to the prefiller's host when it is unset
        routable = self.advertise_host or self.host
        if routable not in ("0.0.0.0", "::", ""):
            out_params.remote_host = routable
        out_params.remote_port = self.transfer_source.port
        return out_params.to_dict()

    # -- handlers: (status, payload[, headers]) ------------------------------
    def health(self) -> tuple[int, dict]:
        if self.draining:
            return 503, {"status": "draining", "inflight": len(self.engine.seqs)}
        err = self.async_engine.error
        if err is not None:
            return 503, {"status": "unhealthy", "error": str(err)}
        reason = self.monitor.unhealthy_reason() if self.monitor is not None else None
        if reason is not None:
            # a stalled step loop or a dead card: the same 503, with the
            # structured reason the pool controller's sweep records
            return 503, {"status": "unhealthy", **reason}
        return 200, {"status": "ok"}

    def models(self) -> tuple[int, dict]:
        data = [{"id": self.model_name, "object": "model"}]
        reg = self.engine.lora_registry
        if reg is not None:  # adapters list as models, as vLLM's
            data += [{"id": name, "object": "model", "parent": self.model_name}
                     for name in sorted(reg.slots)]
        return 200, {"object": "list", "data": data}

    def metrics_text(self) -> str:
        """The engine's families, then the server's; the request gauges
        mirror ``engine.stats`` at scrape time (no engine lock is taken), and
        the LoRA info gauge is rebuilt from the registry (its labels are the
        data)."""
        em, st = self.engine.metrics, self.engine.stats
        em.requests_waiting.set(st.num_waiting)
        em.requests_running.set(st.num_running)
        em.kv_usage.set(st.kv_utilization)
        reg = self.engine.lora_registry
        if reg is not None:
            info = reg.metrics_info()
            em.lora_info.clear()
            em.lora_info.labels(
                max_lora=info["max_lora"],
                running_lora_adapters=info["running_lora_adapters"],
                waiting_lora_adapters=info["waiting_lora_adapters"]).set(1)
        return self.engine.registry.expose() + self.registry.expose()

    def resolve_lora(self, body: dict) -> tuple[Optional[str], Optional[tuple[int, dict]]]:
        """(adapter, None), or (None, the 404 answer): ``lora_adapter``, or a
        loaded adapter named as ``model``; an unknown adapter, or any adapter
        while LoRA serving is off, is a 404 (serving the base model under its
        name would mislead the client and poison the prefix cache)."""
        lora_id = body.get("lora_adapter")
        reg = self.engine.lora_registry
        if lora_id is None and reg is not None and reg.has(body.get("model", self.model_name)):
            lora_id = body.get("model", self.model_name)
        if lora_id is not None and (reg is None or not reg.has(lora_id)):
            return None, (404, {"error": {"message": f"unknown LoRA adapter {lora_id!r}"}})
        return lora_id, None

    def load_lora(self, body: dict) -> tuple[int, dict]:
        """``POST /v1/load_lora_adapter``: 200 with the slot, 409 when the
        adapter has requests in flight or every slot is busy, 400 otherwise."""
        if self.engine.lora_registry is None:
            return 400, {"error": "LoRA serving disabled (EngineConfig.lora unset)"}
        name = body.get("lora_name")
        if name is None:
            return 400, {"error": "lora_name required"}
        if not isinstance(name, str) or not re.fullmatch(r"[A-Za-z0-9._/\-]{1,128}", name):
            # names land in Prometheus label values and hash keys
            return 400, {"error": "invalid lora_name"}
        path = body.get("lora_path")
        try:
            weights = None
            if path:  # the filesystem resolver: an npz of lora_{A,B}_{target} arrays
                with np.load(path) as z:
                    weights = {k: z[k] for k in z.files}
            slot = self.async_engine.run_locked(
                lambda: self.engine.load_lora_adapter(name, weights))
        except RuntimeError as e:
            return 409, {"error": str(e)}
        except Exception as e:  # noqa: BLE001 — any unreadable adapter is the client's 400
            return 400, {"error": f"cannot load adapter: {e}"}
        return 200, {"status": "ok", "lora_name": name, "slot": slot}

    def unload_lora(self, body: dict) -> tuple[int, dict]:
        """``POST /v1/unload_lora_adapter``: 200, 404 for an unknown adapter,
        409 while it has requests in flight."""
        if self.engine.lora_registry is None:
            return 400, {"error": "LoRA serving disabled (EngineConfig.lora unset)"}
        name = body.get("lora_name")
        if name is None:
            return 400, {"error": "lora_name required"}
        try:
            ok = self.async_engine.run_locked(lambda: self.engine.unload_lora_adapter(name))
        except RuntimeError as e:
            return 409, {"error": str(e)}
        if not ok:
            return 404, {"error": f"unknown adapter {name!r}"}
        return 200, {"status": "ok", "lora_name": name}

    def embeddings(self, body: dict) -> tuple[int, dict]:
        """``POST /v1/embeddings`` (the reference's ``_embeddings``)."""
        inp = body.get("input")
        if inp is None:
            return 400, {"error": {"message": "input required"}}
        items = [inp] if isinstance(inp, str) else list(inp)
        if items and isinstance(items[0], int):  # one pre-tokenized prompt
            items = [items]
        model = body.get("model", self.model_name)
        lora_id, missing = self.resolve_lora(body)
        if missing is not None:
            return missing
        data, total = [], 0
        for i, item in enumerate(items):
            ids = item if isinstance(item, list) else self.tokenizer.encode(str(item))
            if not ids:
                return 400, {"error": {"message": f"empty input at index {i}"}}
            total += len(ids)
            try:
                vec = self.async_engine.run_locked(
                    lambda ids=ids: self.engine.embed(ids, lora_id))
            except (ValueError, TypeError) as e:  # token ids outside the vocabulary
                return 400, {"error": {"message": str(e)}}
            except RuntimeError as e:
                return 503, {"error": {"message": str(e)}}
            data.append({"object": "embedding", "index": i, "embedding": vec})
        self.server_metrics.requests.inc()
        return 200, {"object": "list", "model": model, "data": data,
                     "usage": {"prompt_tokens": total, "total_tokens": total}}

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
        if not self.draining:
            self.draining = True
            self.engine.flight.record_system("drain_start", inflight=len(self.engine.seqs))
        while self.engine.seqs and time.monotonic() - t0 < timeout_s:
            time.sleep(0.02)
        drained = not self.engine.seqs
        flush_info = {}
        if drained and self.engine.writeback is not None:
            # write the resident working set back before retirement, within
            # min(drain budget, the rest of the drain window)
            flushed, abandoned = self._flush_for_drain(
                min(self.engine.durable.cfg.drain_budget_s,
                    max(0.0, timeout_s - (time.monotonic() - t0))))
            flush_info = {"flushed_blocks": flushed, "abandoned_blocks": abandoned}
        self.engine.flight.record_system(
            "drain_done", drained=drained, inflight=len(self.engine.seqs),
            waited_ms=round((time.monotonic() - t0) * 1e3, 1), **flush_info)
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

    def _mm_token_stream(self, body: dict) -> tuple[list[int], list[dict]]:
        """The multimodal token stream: each media part expands to
        ``mm_tokens`` placeholder ids, the rest is encoded piece by piece as
        the reference does. ``/render`` and the generation routes share it,
        so the engine hashes the stream the router's scorer hashed. Returns
        (tokens, the media parts in order)."""
        cfg = self.engine.model_cfg
        pieces: list = []  # text pieces; None marks a media slot
        parts: list[dict] = []
        for m in body.get("messages", []) or []:
            content = m.get("content", "")
            pieces.append(f"{m.get('role', '')}: ")
            if isinstance(content, list):
                for part in content:
                    if is_media_part(part):
                        pieces.append(None)
                        parts.append(part)
                    elif isinstance(part, dict):
                        pieces.append(part.get("text", "") + " ")
                    else:
                        pieces.append(str(part) + " ")
            else:
                pieces.append(str(content))
            pieces.append("\n")
        token_ids: list[int] = []
        for p in pieces:
            if p is None:
                token_ids.extend([cfg.mm_placeholder_id] * cfg.mm_tokens)
            elif p:
                token_ids.extend(self.tokenizer.encode(p))
        return token_ids, parts

    def _tokenize_mm(self, body: dict) -> tuple[list[int], Optional[list]]:
        """(tokens, mm_items) of a media request: the E stage's wire items
        matched to the parts by part identity, the missing ones encoded by
        the in-process tower. Without a tower the request degrades to the
        text-only flattening: (its tokens, None)."""
        cfg = self.engine.model_cfg
        token_ids, parts = self._mm_token_stream(body)
        wire: dict[bytes, tuple[bytes, np.ndarray]] = {}
        for d in body.get("mm_items") or []:
            try:
                h, emb = mm_item_from_wire(d, cfg.hidden_size)
                wire[h] = (h, emb)
            except Exception:  # noqa: BLE001 — a malformed wire item counts as missing
                continue
        mm_items: list = [wire.get(part_identity(part)) for part in parts]
        missing = [i for i, item in enumerate(mm_items) if item is None]
        if missing:
            if not cfg.has_vision:
                # an E/PD worker without a tower: the media identity still
                # lands in the stream through flatten's <kind:hash> rendering
                return self.tokenize_body(body), None
            with self._vision_lock:
                if self._vision is None:
                    self._vision = VisionRunner(cfg, device=self.engine.device)
            encoded = self._vision.encode([media_bytes_from_part(parts[i]) or b""
                                           for i in missing])
            for i, (_h, emb) in zip(missing, encoded):
                mm_items[i] = (part_identity(parts[i]), emb)
        return token_ids, mm_items

    def render(self, body: dict) -> tuple[int, dict]:
        try:
            if self.engine.model_cfg.mm_tokens > 0 and body_has_media(body):
                return 200, {"prompt_token_ids": self._mm_token_stream(body)[0]}
            return 200, {"prompt_token_ids": self.tokenize_body(body)}
        except (ValueError, TypeError, AttributeError) as e:  # malformed body
            return 400, {"error": {"message": str(e)}}

    def generate(self, body: dict, chat: bool, headers=None):
        """(status, payload) for a JSON answer, or (200, iterator of SSE
        event dicts) for a stream whose first engine output has arrived.
        ``headers``: the request's (``traceparent``, the tenant)."""
        headers = headers if headers is not None else {}
        try:
            # a malformed structured spec (schema, regex, logit_bias) is a
            # 400 before the request counts or reaches the engine
            validate_structured_body(body)
        except ValueError as e:
            return 400, {"error": {"message": str(e)}}
        self.server_metrics.requests.inc()
        token_ids = mm_items = None
        try:
            if self.engine.model_cfg.mm_tokens > 0 and body_has_media(body):
                token_ids, mm_items = self._tokenize_mm(body)
        except Exception as e:  # noqa: BLE001 — any bad media item is the client's 400
            return 400, {"error": {"message": f"multimodal content: {e}"}}
        mm_hashes = [h for h, _ in mm_items] if mm_items else []
        try:
            if token_ids is None:
                token_ids = self.tokenize_body(body)
            sampling = sampling_from_body(body)
        except (ValueError, TypeError, AttributeError) as e:  # malformed body
            return 400, {"error": {"message": str(e)}}
        if not sampling.ignore_eos:
            sampling.stop_token_ids = tuple(sampling.stop_token_ids) + (self.tokenizer.eos_id,)
        rid = f"cmpl-{uuid.uuid4().hex[:16]}"
        head = {"id": rid, "object": "chat.completion" if chat else "text_completion",
                "created": int(time.time()), "model": body.get("model", self.model_name)}
        lora_id, missing = self.resolve_lora(body)
        if missing is not None:
            return missing
        try:
            ktp = KVTransferParams.from_dict(body.get("kv_transfer_params"))
        except (ValueError, TypeError, AttributeError) as e:  # malformed body
            return 400, {"error": {"message": str(e)}}
        stream = bool(body.get("stream"))
        span = self.tracer.start_span(
            "engine.generate", parent=extract_traceparent(dict(headers.items())),
            **{"llm_d.model": head["model"], "llm_d.prompt_tokens": len(token_ids),
               "llm_d.stream": stream})
        if ktp.do_remote_prefill and self.transfer_client is not None:
            span.add_event("kv_transfer.pull")
            self._pull_remote_kv(ktp, token_ids, rid, lora_id, mm_hashes)
        elif (ktp.do_prefix_pull and ktp.block_hashes
              and (self.transfer_client is not None or self.engine.durable is not None)):
            # the router found this prefix on a peer or in the durable store
            span.add_event("kv_plane.pull")
            self._pull_prefix_kv(rid, ktp, token_ids, lora_id, mm_hashes)
        # the engine's rid is minted here, so the router's tenant header is the
        # only identity link: open (or backfill) the record with it first
        self.engine.flight.start(rid, tenant=clamp_tenant(headers.get(HDR_TENANT)))
        try:
            status, result = self._generate(rid, token_ids, sampling, head, chat, stream,
                                            ktp.do_remote_decode, lora_id, mm_items,
                                            span.context)
        except BaseException as e:
            span.set_error(f"{type(e).__name__}: {e}")
            span.end()
            self._release_pending_pull(rid)
            raise
        if not isinstance(result, dict):
            return status, self._released_after(rid, result, span)
        if status != 200:
            span.set_error(str(result.get("error", {}).get("message", "")))
        else:
            usage = result["usage"]
            span.set_attribute("llm_d.completion_tokens", usage["completion_tokens"])
            span.set_attribute("llm_d.cached_tokens", usage["cached_tokens"])
        span.end()
        self._release_pending_pull(rid)
        return status, result

    def _released_after(self, rid: str, events: Iterator[dict], span) -> Iterator[dict]:
        """``events``, then (however the stream ends) the end of the request's
        span and the release of its pending pull."""
        try:
            yield from events
        finally:
            events.close()
            span.end()
            self._release_pending_pull(rid)

    def _generate(self, rid: str, token_ids: list[int], sampling: SamplingParams,
                  head: dict, chat: bool, stream: bool, export: bool,
                  lora_id: Optional[str] = None, mm_items: Optional[list] = None,
                  trace_ctx=None):
        text = TextStream(self.tokenizer, sampling.stop)
        outputs = self.async_engine.generate(rid, token_ids, sampling, lora_id, mm_items,
                                             trace_ctx)
        try:
            first = next(outputs)  # admission errors surface here, as a 400
        except ValueError as e:
            return 400, {"error": {"message": str(e)}}
        except EngineLoopError as e:
            return 500, {"error": {"message": str(e)}}
        if stream:
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
        payload = {**head, "usage": _usage(len(token_ids), len(out_ids),
                                           out.num_cached_prompt_tokens),
                   "choices": [choice]}
        if export and self.transfer_source is not None:
            payload["kv_transfer_params"] = self._export(
                rid, token_ids, lora_id, [h for h, _ in mm_items or ()])
        return 200, payload

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


    # -- the observability routes ----------------------------------------------
    def debug_requests(self, query: str) -> tuple[int, dict]:
        """``GET /debug/requests``: the recorder's newest-first summaries."""
        return debug_list_response(self.engine.flight,
                                   {k: v[-1] for k, v in parse_qs(query).items()})

    def debug_request(self, rid: str) -> tuple[int, dict]:
        """``GET /debug/requests/{rid}``: one timeline with its ledgers."""
        return debug_detail_response(self.engine.flight, rid)

    def debug_profile(self, query: str) -> tuple[int, dict]:
        """``GET /debug/profile?seconds=N`` (default 2): one profiler window,
        captured on this request's thread while the engine steps on."""
        if self.monitor is None:
            return 503, {"error": {"message": "device monitor not running"}}
        try:
            seconds = float(parse_qs(query).get("seconds", ["2"])[-1])
        except ValueError:
            return 400, {"error": {"message": "seconds must be numeric"}}
        try:
            return 200, self.monitor.capture_profile(seconds)
        except ProfileBusy as e:
            return 409, {"error": {"message": str(e)}}
        except Exception as e:  # noqa: BLE001 — the capture's failure is the answer
            return 500, {"error": {"message": f"profile capture failed: {e}"}}

    # -- the Responses and Conversations APIs -----------------------------------
    @staticmethod
    def _responses_input_to_messages(inp) -> list[dict]:
        if isinstance(inp, str):
            return [{"role": "user", "content": inp}]
        return [{"role": item.get("role", "user"), "content": item.get("content", "")}
                for item in inp or [] if isinstance(item, dict)]

    def responses(self, body: dict) -> tuple[int, dict]:
        """``POST /v1/responses`` (the reference's ``_responses``): the
        conversation's items (if one is named) then ``input`` as chat
        messages, through ``generate`` as a chat request; the exchange is
        appended to the conversation."""
        conv_id = body.get("conversation")
        with self._conv_lock:
            conv = self._conversations.get(conv_id) if conv_id else None
            history = list(conv["items"]) if conv is not None else []
        if conv_id and conv is None:
            return 404, {"error": {"message": f"unknown conversation {conv_id!r}"}}
        new_msgs = self._responses_input_to_messages(body.get("input", ""))
        try:
            max_out = int(body.get("max_output_tokens", body.get("max_tokens", 16)))
        except (TypeError, ValueError) as e:
            return 400, {"error": {"message": str(e)}}
        chat_body = {"model": body.get("model", self.model_name),
                     "messages": history + new_msgs, "max_tokens": max_out,
                     "temperature": body.get("temperature", 1.0)}
        if body.get("ignore_eos"):
            chat_body["ignore_eos"] = True
        # structured-output fields ride through to the shared sampling parse
        for key in ("response_format", "guided_choice", "guided_regex", "logit_bias"):
            if body.get(key) is not None:
                chat_body[key] = body[key]
        status, out = self.generate(chat_body, chat=True)
        if status != 200:
            return status, out
        choice = out["choices"][0]
        text, finish = choice["message"]["content"], choice["finish_reason"]
        state = "completed" if finish in (None, "stop", "eos") else "incomplete"
        resp = {
            "id": f"resp_{uuid.uuid4().hex[:12]}", "object": "response",
            "created_at": int(time.time()), "model": chat_body["model"], "status": state,
            "output": [{
                "id": f"msg_{uuid.uuid4().hex[:12]}", "type": "message",
                "role": "assistant", "status": "completed",
                "content": [{"type": "output_text", "text": text, "annotations": []}]}],
            "max_output_tokens": max_out,
            "usage": {"input_tokens": out["usage"]["prompt_tokens"],
                      "output_tokens": out["usage"]["completion_tokens"],
                      "total_tokens": out["usage"]["total_tokens"]},
        }
        if state == "incomplete":
            resp["incomplete_details"] = {"reason": "max_output_tokens"}
        if conv is not None:
            with self._conv_lock:
                conv["items"].extend(new_msgs)
                conv["items"].append({"role": "assistant", "content": text})
                self._conv_trim(conv)
        if conv_id:
            resp["conversation"] = conv_id
        return 200, resp

    def _conv_trim(self, conv: dict) -> None:
        if len(conv["items"]) > self._max_conv_items:
            del conv["items"][: len(conv["items"]) - self._max_conv_items]

    def conv_create(self, body: dict) -> tuple[int, dict]:
        """``POST /v1/conversations``: a router may pass the ``id`` (so its
        sticky routing by id is deterministic); otherwise a fresh one."""
        cid = str(body.get("id") or f"conv_{uuid.uuid4().hex[:12]}")
        conv = {"id": cid, "object": "conversation", "created_at": int(time.time()),
                "items": list(body.get("items", []) or []),
                "metadata": body.get("metadata") or {}}
        self._conv_trim(conv)
        with self._conv_lock:
            self._conversations[cid] = conv
            while len(self._conversations) > self._max_conversations:
                self._conversations.popitem(last=False)
        return 200, {k: v for k, v in conv.items() if k != "items"}

    def _conv(self, cid: str) -> Optional[dict]:
        """The conversation (touched for the LRU), or None. Call under
        ``_conv_lock``."""
        conv = self._conversations.get(cid)
        if conv is not None:
            self._conversations.move_to_end(cid)
        return conv

    def conv_get(self, cid: str) -> tuple[int, dict]:
        with self._conv_lock:
            conv = self._conv(cid)
            if conv is None:
                return 404, {"error": {"message": "not found"}}
            return 200, {k: v for k, v in conv.items() if k != "items"}

    def conv_delete(self, cid: str) -> tuple[int, dict]:
        with self._conv_lock:
            conv = self._conversations.pop(cid, None)
        if conv is None:
            return 404, {"error": {"message": "not found"}}
        return 200, {"id": conv["id"], "object": "conversation.deleted", "deleted": True}

    def conv_add_items(self, cid: str, body: dict) -> tuple[int, dict]:
        items = body.get("items", [])
        with self._conv_lock:
            conv = self._conv(cid)
            if conv is None:
                return 404, {"error": {"message": "not found"}}
            conv["items"].extend(items)
            self._conv_trim(conv)
        return 200, {"object": "list", "data": items}

    def conv_list_items(self, cid: str) -> tuple[int, dict]:
        with self._conv_lock:
            conv = self._conv(cid)
            if conv is None:
                return 404, {"error": {"message": "not found"}}
            return 200, {"object": "list", "data": list(conv["items"])}


_CONV_ITEMS = re.compile(r"^/v1/conversations/([^/]+)/items$")
_CONV = re.compile(r"^/v1/conversations/([^/]+)$")
_DEBUG_REQUEST = re.compile(r"^/debug/requests/([^/]+)$")


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
            path, _, query = self.path.partition("?")
            if path == "/health":
                self._send(*server.health())
            elif path == "/v1/models":
                self._send(*server.models())
            elif path == "/metrics":
                self._send_bytes(200, server.metrics_text().encode(),
                                 "text/plain; charset=utf-8")
            elif path == "/debug/requests":
                self._send(*server.debug_requests(query))
            elif m := _DEBUG_REQUEST.match(path):
                self._send(*server.debug_request(unquote(m.group(1))))
            elif path == "/debug/profile":
                self._send(*server.debug_profile(query))
            elif m := _CONV_ITEMS.match(path):
                self._send(*server.conv_list_items(unquote(m.group(1))))
            elif m := _CONV.match(path):
                self._send(*server.conv_get(unquote(m.group(1))))
            else:
                self._send(404, {"error": {"message": f"no route {path}"}})

        def do_DELETE(self) -> None:  # noqa: N802
            path = self.path.partition("?")[0]
            n = int(self.headers.get("Content-Length") or 0)
            if n:
                self.rfile.read(n)
            if m := _CONV.match(path):
                self._send(*server.conv_delete(unquote(m.group(1))))
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
                    status, result = server.generate(body, chat=GENERATE_ROUTES[path],
                                                     headers=self.headers)
                    if isinstance(result, dict):
                        self._send(status, result)
                    else:
                        self._stream(result)
            elif path in RENDER_ROUTES:
                body = self._body()
                if body is not None:
                    self._send(*server.render(body))
            elif path == "/v1/embeddings":
                blocked = server.admission_block(self.headers)
                body = self._body()
                if blocked is not None:
                    self._send(*blocked)
                elif body is not None:
                    self._send(*server.embeddings(body))
            elif path == "/v1/responses":
                blocked = server.admission_block(self.headers)
                body = self._body()
                if blocked is not None:
                    self._send(*blocked)
                elif body is not None:
                    self._send(*server.responses(body))
            elif path == "/v1/conversations":
                n = int(self.headers.get("Content-Length") or 0)
                try:  # an unreadable body counts as empty, as the reference's
                    body = json.loads(self.rfile.read(n)) if n else {}
                except ValueError:
                    body = {}
                self._send(*server.conv_create(body if isinstance(body, dict) else {}))
            elif m := _CONV_ITEMS.match(path):
                body = self._body()
                if body is not None:
                    self._send(*server.conv_add_items(unquote(m.group(1)), body))
            elif path in LORA_ROUTES:
                body = self._body()
                if body is not None:
                    self._send(*getattr(server, LORA_ROUTES[path])(body))
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
