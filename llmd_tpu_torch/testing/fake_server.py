"""Fake model server: the control plane's hardware-free test fixture (copy of
``llmd_tpu/testing/fake_server.py`` on ``router/http.py``'s asyncio server, where
the reference uses aiohttp; pyzmq is imported when a server publishes KV
events, never when this module is imported).

Implements the full model-server contract the router depends on (SURVEY.md §4):

- OpenAI HTTP API: ``/v1/completions``, ``/v1/chat/completions`` (+streaming)
- render/tokenize endpoints: ``/v1/completions/render`` (kv-indexer.md:104-113)
- Prometheus ``/metrics`` with the vLLM-compatible names (model-servers.md:38-52)
- ``/health`` liveness/readiness (model-servers.md:81-86)
- ZMQ KV-event publishing with a simulated paged prefix cache (kv-indexer.md:59-87)

Timing model: prefill cost ∝ uncached prompt tokens, decode cost ∝ output tokens, so
prefix-cache-aware routing measurably beats round-robin in tests — mirroring the
reference's optimized-baseline benchmark design (BASELINE.md row 7).
"""

from __future__ import annotations

import asyncio
import json
import random
import time
import uuid
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Optional

from llmd_tpu_torch.core.kv_events import (
    AllBlocksCleared,
    BlockRemoved,
    BlockStored,
    block_keys_for_tokens,
    encode_event_batch,
    kv_topic,
)
from llmd_tpu_torch.core.request import flatten_messages
from llmd_tpu_torch.router.http import (
    HTTPServer,
    Request,
    Response,
    StreamResponse,
    json_response,
)


def fake_tokenize(text: str) -> list[int]:
    """Deterministic byte-level tokenizer shared by fixture and router tests."""
    return list(text.encode("utf-8"))


@dataclass
class FakeServerConfig:
    model: str = "fake/model"
    block_size: int = 16
    num_blocks: int = 512
    prefill_us_per_token: float = 50.0  # uncached prompt tokens
    decode_us_per_token: float = 500.0
    kv_pull_us_per_block: float = 200.0  # P→D remote-prefill transfer cost
    max_running: int = 8
    kv_events_port: Optional[int] = None  # bind tcp://*:port when set (pod-discovery mode)
    role: str = "both"  # prefill | decode | both
    lora_adapters: list[str] = field(default_factory=list)


@dataclass
class FaultConfig:
    """Programmable fault injection (resilience tests, tools/chaos_check.py).

    Faults target the generation endpoints; /metrics and /health have their
    own flags. The RNG is seeded so chaos runs replay deterministically."""

    error_rate: float = 0.0  # fraction of generate requests → error_status
    error_status: int = 503
    connect_refuse: bool = False  # kill the connection instead of answering
    latency_s: float = 0.0  # added latency before each generate request
    # slow-replica injection (SLO harness): stretch the timing model instead
    # of failing outright — the router sees a healthy-but-slow endpoint
    first_byte_delay_s: float = 0.0  # added to the prefill phase (TTFT)
    decode_delay_s: float = 0.0  # added per generated token (ITL)
    jitter_s: float = 0.0  # uniform [0, jitter] extra on each injected delay
    midstream_hangup_rate: float = 0.0  # streaming: cut after the first chunk
    flap_period_s: float = 0.0  # >0: alternate up/down on this period
    flap_duty: float = 0.5  # fraction of each period the server is UP
    fail_metrics: bool = False  # /metrics answers 500 (scrape-error paths)
    fail_health: bool = False  # /health answers 503
    seed: int = 0


class FakeModelServer:
    def __init__(self, cfg: FakeServerConfig, host: str = "127.0.0.1", port: int = 0):
        self.cfg = cfg
        self.host, self.port = host, port
        self.running = 0
        self.queued = 0
        self.request_count = 0
        # Simulated paged prefix cache: block_hash → last-use (LRU).
        self.blocks: OrderedDict[int, float] = OrderedDict()
        self._zctx = None
        self._pub = None
        self._seq = 0
        self._front: Optional[HTTPServer] = None
        self._admit = asyncio.Semaphore(cfg.max_running)
        self.received: list[dict] = []  # request log for assertions
        # fault injection (resilience/chaos tests): mutate via set_faults()
        self.faults = FaultConfig()
        self._fault_rng = random.Random(self.faults.seed)
        self._flap_t0 = time.monotonic()
        self.fault_counts = {"errors": 0, "refused": 0, "midstream": 0}
        self.draining = False  # POST /drain mirrors the engine server
        # cross-engine prefix-pull simulation (docs/kv-plane.md)
        self.pulls_completed = 0
        self.pulled_blocks = 0
        # P/D disaggregation (docs/pd-disaggregation.md): count of requests
        # that adopted a remote prefiller's KV instead of prefilling locally
        self.remote_pulls = 0
        # per-request phase timelines in the flight-record to_dict() shape,
        # so gates can fold them with obs.attribution.build_ledger verbatim
        self.request_records: list[dict] = []

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> None:
        front = HTTPServer()
        front.add_route("POST", "/v1/completions", self._completions)
        front.add_route("POST", "/v1/chat/completions", self._chat)
        front.add_route("POST", "/v1/embeddings", self._embeddings)
        front.add_route("POST", "/v1/completions/render", self._render)
        front.add_route("POST", "/v1/chat/completions/render", self._render)
        front.add_route("GET", "/metrics", self._metrics)
        front.add_route("GET", "/health", self._health)
        front.add_route("POST", "/drain", self._drain)
        front.add_route("GET", "/v1/models", self._models)
        self.port = await front.start(self.host, self.port)
        self._front = front
        if self.cfg.kv_events_port is not None:
            import zmq
            import zmq.asyncio

            self._zctx = zmq.asyncio.Context()
            self._pub = self._zctx.socket(zmq.PUB)
            if self.cfg.kv_events_port == 0:
                self.cfg.kv_events_port = self._pub.bind_to_random_port("tcp://127.0.0.1")
            else:
                self._pub.bind(f"tcp://127.0.0.1:{self.cfg.kv_events_port}")

    async def stop(self) -> None:
        """Close the front; in-flight handlers are cancelled, so their
        clients see the connection go (the reference's aiohttp cleanup)."""
        if self._front is not None:
            front, self._front = self._front, None
            await front.stop()
        if self._pub is not None:
            self._pub.close(0)
            self._zctx.term()

    @property
    def serving(self) -> bool:
        """True from ``start`` until ``stop`` (the reference reads aiohttp's
        ``_runner`` for this)."""
        return self._front is not None

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    # -- KV cache simulation ----------------------------------------------
    async def _publish(self, events) -> None:
        if self._pub is None:
            return
        self._seq += 1
        topic = kv_topic(self.address, self.cfg.model).encode()
        await self._pub.send_multipart([topic, encode_event_batch(events, self._seq)])

    async def _touch_blocks(self, token_ids: list[int], lora: Optional[str]) -> int:
        """Insert/refresh blocks for tokens; publish events; return cached-prefix len."""
        keys = block_keys_for_tokens(token_ids, self.cfg.block_size, lora)
        cached = 0
        for k in keys:
            if k in self.blocks:
                cached += 1
            else:
                break
        now = time.monotonic()
        stored, removed = [], []
        parent = keys[cached - 1] if cached else None
        new_keys = keys[cached:]
        for k in keys:
            self.blocks[k] = now
            self.blocks.move_to_end(k)
        while len(self.blocks) > self.cfg.num_blocks:
            old, _ = self.blocks.popitem(last=False)
            removed.append(old)
        if new_keys:
            chunk = token_ids[cached * self.cfg.block_size : len(keys) * self.cfg.block_size]
            stored.append(BlockStored(
                block_hashes=new_keys, parent_block_hash=parent, token_ids=chunk,
                block_size=self.cfg.block_size, lora_id=lora,
            ))
        events = stored + ([BlockRemoved(block_hashes=removed)] if removed else [])
        if events:
            await self._publish(events)
        return cached * self.cfg.block_size

    async def clear_cache(self) -> None:
        self.blocks.clear()
        await self._publish([AllBlocksCleared()])

    async def _simulate_prefix_pull(self, token_ids: list[int],
                                    lora: Optional[str],
                                    hashes: list) -> int:
        """Adopt router-stamped pulled blocks ahead of admission. Only the
        stamped hashes that agree with this prompt's own chain are adopted
        (hash-chain verification, like ``inject_into_engine``); adopted
        blocks then count as cached in ``_touch_blocks`` and are published
        so the router index learns this pod now holds them."""
        keys = block_keys_for_tokens(token_ids, self.cfg.block_size, lora)
        n = 0
        for k, h in zip(keys, hashes):
            if int(h) != k:
                break
            n += 1
        if not n:
            return 0
        cached = 0
        for k in keys[:n]:
            if k in self.blocks:
                cached += 1
            else:
                break
        now = time.monotonic()
        for k in keys[:n]:
            self.blocks[k] = now
            self.blocks.move_to_end(k)
        new_keys = keys[cached:n]
        if new_keys:
            await self._publish([BlockStored(
                block_hashes=new_keys,
                parent_block_hash=keys[cached - 1] if cached else None,
                token_ids=token_ids[cached * self.cfg.block_size : n * self.cfg.block_size],
                block_size=self.cfg.block_size, lora_id=lora,
            )])
        self.pulls_completed += 1
        self.pulled_blocks += n
        return n

    # -- fault injection ---------------------------------------------------
    def set_faults(self, **kw) -> None:
        """Update fault knobs at runtime (``set_faults(error_rate=0.2)``);
        passing ``seed`` reseeds the RNG, ``flap_period_s`` restarts the
        flap schedule from 'up'."""
        for k, v in kw.items():
            if not hasattr(self.faults, k):
                raise AttributeError(f"unknown fault knob {k!r}")
            setattr(self.faults, k, v)
        if "seed" in kw:
            self._fault_rng = random.Random(kw["seed"])
        if "flap_period_s" in kw:
            self._flap_t0 = time.monotonic()

    def _injected_delay(self, base_s: float) -> float:
        """A latency-knob value plus its jitter draw (seeded RNG, so runs
        replay). Jitter only applies where a base delay is configured."""
        if base_s <= 0:
            return 0.0
        return base_s + self._fault_rng.uniform(0.0, self.faults.jitter_s)

    def _flap_down(self) -> bool:
        f = self.faults
        if f.flap_period_s <= 0:
            return False
        phase = ((time.monotonic() - self._flap_t0) % f.flap_period_s) / f.flap_period_s
        return phase >= f.flap_duty

    def _refuse(self, request: Request):
        """Kill the connection without an HTTP response: the client sees a
        reset/disconnect, i.e. a connect-class (retryable) failure. The
        server's connection loop takes the ``ConnectionResetError`` as the
        end of the connection and writes nothing more on it."""
        self.fault_counts["refused"] += 1
        request._writer.close()
        raise ConnectionResetError("fault: connection refused")

    async def _maybe_fault(self, request: Request) -> Optional[Response]:
        """Evaluate the fault schedule for one generate request. Returns an
        error response, raises (connect-refuse), or returns None (healthy)."""
        f = self.faults
        if f.latency_s > 0:
            await asyncio.sleep(f.latency_s)
        if f.connect_refuse:
            self._refuse(request)
        if self._flap_down() or (
                f.error_rate > 0 and self._fault_rng.random() < f.error_rate):
            self.fault_counts["errors"] += 1
            return json_response({"error": {"message": "fault injected"}},
                                     status=f.error_status)
        return None

    # -- handlers ----------------------------------------------------------
    def _close_record(self, rid: str, events: list[dict], t_open: float,
                      status: str = "finished") -> None:
        """Retire one request's phase timeline. ``latency_ms`` is the retired
        stamp itself, so build_ledger's intervals partition the wall exactly."""
        events.append({"event": "retired",
                       "t_ms": round((time.monotonic() - t_open) * 1e3, 3)})
        self.request_records.append({
            "request_id": rid, "model": self.cfg.model, "status": status,
            "latency_ms": events[-1]["t_ms"], "events": events})
        if len(self.request_records) > 4096:
            del self.request_records[: len(self.request_records) - 4096]

    async def _serve_generation(self, request: Request, prompt: str, body: dict, chat: bool):
        lora = body.get("model") if body.get("model") in self.cfg.lora_adapters else None
        token_ids = fake_tokenize(prompt)
        max_tokens = int(body.get("max_tokens", 16))
        stream = bool(body.get("stream", False))
        # kv_transfer_params flow for P/D (disaggregation/README.md:104-131).
        kv_params = body.get("kv_transfer_params") or {}
        self.request_count += 1
        self.received.append({"prompt": prompt, "body": body, "t": time.monotonic()})
        if self.cfg.role == "prefill" and not kv_params.get("do_remote_decode"):
            # prefill-only replica: decode-phase work must carry the P/D
            # handshake. A client error, never a 5xx — misrouted traffic
            # should bounce to the sender, not trip breakers/retries.
            return json_response(
                {"error": {"message": "prefill-only replica refuses decode "
                                      "work (missing do_remote_decode)",
                           "type": "invalid_request_error"}}, status=400)
        if self.draining:
            return json_response({"error": {"message": "draining"}},
                                     status=503, headers={"Retry-After": "1"})
        faulted = await self._maybe_fault(request)
        if faulted is not None:
            return faulted
        # decided up front so one seeded RNG draw covers the whole stream
        hangup = (stream and self.faults.midstream_hangup_rate > 0
                  and self._fault_rng.random() < self.faults.midstream_hangup_rate)

        t_open = time.monotonic()
        events: list[dict] = []

        def ev(name: str) -> None:
            events.append({"event": name,
                           "t_ms": round((time.monotonic() - t_open) * 1e3, 3)})

        rid = f"cmpl-{uuid.uuid4().hex[:12]}"
        remote_pull = bool(kv_params.get("do_remote_prefill")
                           and kv_params.get("remote_request_id"))
        if remote_pull:
            # P/D split decode side: price the P→D transfer per block, then
            # adopt the prompt's whole chain — local prefill is skipped, and
            # the phase ledger shows kv_pull where prefill would have been
            keys = block_keys_for_tokens(token_ids, self.cfg.block_size, lora)
            await asyncio.sleep(
                max(1, len(keys)) * self.cfg.kv_pull_us_per_block / 1e6)
            now = time.monotonic()
            for k in keys:
                self.blocks[k] = now
                self.blocks.move_to_end(k)
            self.remote_pulls += 1
            ev("kv_pull")
        else:
            ev("arrival")

        self.queued += 1
        async with self._admit:  # FIFO-ish admission, no busy-wait
            self.queued -= 1
            self.running += 1
            try:
                if kv_params.get("do_prefix_pull") and kv_params.get("block_hashes"):
                    await self._simulate_prefix_pull(
                        token_ids, lora, kv_params["block_hashes"])
                cached = await self._touch_blocks(token_ids, lora)
                if remote_pull:
                    cached = len(token_ids)  # full KV arrived from P
                uncached = max(0, len(token_ids) - cached)
                prefill_s = (uncached * self.cfg.prefill_us_per_token / 1e6
                             + self._injected_delay(self.faults.first_byte_delay_s))
                tpot_s = (self.cfg.decode_us_per_token / 1e6
                          + self._injected_delay(self.faults.decode_delay_s))
                ev("admitted")
                model = body.get("model", self.cfg.model)
                usage = {
                    "prompt_tokens": len(token_ids), "completion_tokens": max_tokens,
                    "total_tokens": len(token_ids) + max_tokens, "cached_tokens": cached,
                }

                if stream:
                    resp = StreamResponse(headers={"Content-Type": "text/event-stream"})
                    await resp.prepare(request)
                    if not remote_pull:
                        ev("prefill_start")
                    await asyncio.sleep(prefill_s)
                    if not remote_pull:
                        ev("prefill_end")
                    for i in range(max_tokens):
                        if hangup and i == 1:
                            # mid-stream hangup AFTER the first chunk: the
                            # client holds partial output, so the router must
                            # NOT retry — exactly the case under test
                            self.fault_counts["midstream"] += 1
                            self._refuse(request)
                        await asyncio.sleep(tpot_s)
                        if i == 0:
                            ev("first_token")
                        chunk = {
                            "id": rid, "model": model, "created": int(time.time()),
                            "object": "chat.completion.chunk" if chat else "text_completion",
                            "choices": [
                                {"index": 0, "delta": {"content": f"t{i} "}}
                                if chat else {"index": 0, "text": f"t{i} "}
                            ],
                        }
                        if i == max_tokens - 1:
                            chunk["usage"] = usage
                        await resp.write(f"data: {json.dumps(chunk)}\n\n".encode())
                    ev("decode")
                    await resp.write(b"data: [DONE]\n\n")
                    await resp.write_eof()
                    self._close_record(rid, events, t_open)
                    return resp

                if not remote_pull:
                    ev("prefill_start")
                await asyncio.sleep(prefill_s)
                if not remote_pull:
                    ev("prefill_end")
                await asyncio.sleep(tpot_s)
                ev("first_token")
                if max_tokens > 1:
                    await asyncio.sleep((max_tokens - 1) * tpot_s)
                ev("decode")
                text = f"echo({len(token_ids)}t,{max_tokens}o)"
                out: dict = {
                    "id": rid, "object": "chat.completion" if chat else "text_completion",
                    "model": model, "created": int(time.time()), "usage": usage,
                    "choices": [
                        {"index": 0, "message": {"role": "assistant", "content": text}}
                        if chat else {"index": 0, "text": text, "finish_reason": "length"}
                    ],
                }
                if kv_params.get("do_remote_decode"):
                    out["kv_transfer_params"] = {
                        "remote_host": self.host, "remote_port": self.port,
                        "remote_request_id": rid, "remote_block_ids": list(range(len(token_ids) // self.cfg.block_size)),
                    }
                self._close_record(rid, events, t_open)
                return json_response(out)
            finally:
                self.running -= 1

    async def _completions(self, request: Request):
        body = await request.json()
        return await self._serve_generation(request, str(body.get("prompt", "")), body, chat=False)

    async def _chat(self, request: Request):
        body = await request.json()
        prompt = flatten_messages(body.get("messages", []))
        return await self._serve_generation(request, prompt, body, chat=True)

    async def _embeddings(self, request: Request) -> Response:
        import hashlib

        body = await request.json()
        inp = body.get("input", "")
        items = [inp] if isinstance(inp, str) else list(inp)
        self.request_count += 1
        data = []
        for i, item in enumerate(items):
            # deterministic pseudo-embedding from the content hash
            h = hashlib.sha256(str(item).encode()).digest()
            vec = [((b / 255.0) * 2 - 1) for b in h[:16]]
            data.append({"object": "embedding", "index": i, "embedding": vec})
        ntok = sum(len(fake_tokenize(str(it))) for it in items)
        return json_response({
            "object": "list", "model": body.get("model", self.cfg.model), "data": data,
            "usage": {"prompt_tokens": ntok, "total_tokens": ntok},
        })

    async def _render(self, request: Request) -> Response:
        body = await request.json()
        if "messages" in body:
            prompt = flatten_messages(body.get("messages", []))
        else:
            prompt = str(body.get("prompt", ""))
        return json_response({"prompt_token_ids": fake_tokenize(prompt)})

    async def _metrics(self, request: Request) -> Response:
        if self.faults.fail_metrics:
            return Response(b"fault: metrics down", 500,
                            content_type="text/plain; charset=utf-8")
        util = min(1.0, len(self.blocks) / self.cfg.num_blocks)
        lines = [
            f"vllm:num_requests_waiting {self.queued}",
            f"vllm:num_requests_running {self.running}",
            f"vllm:kv_cache_usage_perc {util:.6f}",
            f'vllm:cache_config_info{{block_size="{self.cfg.block_size}",num_gpu_blocks="{self.cfg.num_blocks}"}} 1',
        ]
        if self.cfg.role == "decode":
            # decode replicas advertise the kv-transfer side channel the
            # prefiller pushes into (disaggregation/README.md:104-131)
            lines.append(
                f'vllm:kv_transfer_config_info{{kv_role="kv_consumer",'
                f'side_channel_host="{self.host}",'
                f'side_channel_port="{self.port}"}} 1')
        if self.cfg.lora_adapters:
            running = ",".join(self.cfg.lora_adapters[:1])
            lines.append(
                f'vllm:lora_requests_info{{max_lora="4",running_lora_adapters="{running}",'
                f'waiting_lora_adapters=""}} {time.time():.3f}'
            )
        return Response(("\n".join(lines) + "\n").encode(),
                        content_type="text/plain; charset=utf-8")

    async def _health(self, request: Request) -> Response:
        if self.faults.fail_health:
            return json_response({"status": "unhealthy"}, status=503)
        if self.draining:
            return json_response(
                {"status": "draining", "inflight": self.running}, status=503)
        return json_response({"status": "ok", "role": self.cfg.role})

    async def _drain(self, request: Request) -> Response:
        """Engine-server /drain contract: stop admissions, wait (bounded) for
        in-flight generations to finish. ``{"enable": false}`` re-opens."""
        try:
            body = await request.json() if request.can_read_body else {}
        except Exception:
            body = {}
        if body.get("enable") is False:
            self.draining = False
            return json_response({"status": "ok", "draining": False})
        self.draining = True
        try:
            timeout_s = float(request.query.get("timeout_s", 10.0))
        except ValueError:
            return json_response(
                {"error": {"message": "timeout_s must be a number"}}, status=400)
        t0 = time.monotonic()
        while self.running and time.monotonic() - t0 < timeout_s:
            await asyncio.sleep(0.01)
        drained = self.running == 0
        return json_response(
            {"status": "drained" if drained else "timeout",
             "inflight": self.running},
            status=200 if drained else 504)

    async def _models(self, request: Request) -> Response:
        data = [{"id": self.cfg.model, "object": "model"}]
        data += [{"id": a, "object": "model", "parent": self.cfg.model} for a in self.cfg.lora_adapters]
        return json_response({"object": "list", "data": data})


def main() -> int:
    """CLI: run one fake replica as a standalone process — the pool
    controller's ProcessReplicaLauncher target for hardware-free runs."""
    import argparse

    ap = argparse.ArgumentParser(description="standalone FakeModelServer")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--model", default="fake/model")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=512)
    ap.add_argument("--max-running", type=int, default=8)
    ap.add_argument("--prefill-us-per-token", type=float, default=50.0)
    ap.add_argument("--decode-us-per-token", type=float, default=500.0)
    ap.add_argument("--kv-pull-us-per-block", type=float, default=200.0)
    ap.add_argument("--role", default="both",
                    choices=["prefill", "decode", "both"])
    args = ap.parse_args()

    cfg = FakeServerConfig(
        model=args.model, block_size=args.block_size,
        num_blocks=args.num_blocks, max_running=args.max_running,
        prefill_us_per_token=args.prefill_us_per_token,
        decode_us_per_token=args.decode_us_per_token,
        kv_pull_us_per_block=args.kv_pull_us_per_block, role=args.role)
    server = FakeModelServer(cfg, host=args.host, port=args.port)

    async def run() -> None:
        await server.start()
        print(f"fake model server on http://{server.address}", flush=True)
        await asyncio.Event().wait()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
