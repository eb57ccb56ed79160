"""The port's fake model server (``llmd_tpu_torch/testing/fake_server.py``, on
``router/http.py`` and pyzmq) against the reference's aiohttp one: the same
script of requests gives the same statuses, bodies, SSE streams and
``/metrics`` text, the same request records and the same KV-event bytes, with
one fake clock and one id sequence patched into both modules. The script
covers completions, chat, SSE, render, embeddings, ``/v1/models``, LoRA,
drain (idle, in flight, re-open, a bad timeout), health, the P/D roles
(prefill refusal, the transfer handle, the remote pull), the prefix pull, LRU
eviction, ``clear_cache`` and each fault (error rate, connect refuse, added
latency, first-byte / decode delays with jitter, mid-stream hangup, flap,
failing ``/metrics`` and ``/health``). The client is aiohttp for both
servers, so a dropped connection reads the same on both."""

import asyncio
import itertools
import json

import aiohttp
import pytest
import zmq
import zmq.asyncio

import llmd_tpu.testing.fake_server as ref_fake
import llmd_tpu_torch.testing.fake_server as port_fake
from llmd_tpu_torch.core.kv_events import block_keys_for_tokens, decode_event_batch
from tests.conftest import run_async


class Clock:
    def __init__(self) -> None:
        self.t = 5000.0

    def monotonic(self) -> float:
        return self.t

    def time(self) -> float:
        return self.t


class _Ids:
    """``uuid.uuid4().hex`` as a counter."""

    def __init__(self) -> None:
        self._n = itertools.count(1)

    def uuid4(self):
        class _U:
            hex = f"{next(self._n):032x}"

        return _U()


@pytest.fixture
def patched(monkeypatch):
    clocks = {}
    for mod in (ref_fake, port_fake):
        clocks[mod] = Clock()
        monkeypatch.setattr(mod, "time", clocks[mod])
        monkeypatch.setattr(mod, "uuid", _Ids())
    return clocks


def _norm(obj, port: int):
    """A body with the server's own port replaced (the transfer handle)."""
    if isinstance(obj, dict):
        return {k: ("PORT" if k == "remote_port" and v == port else _norm(v, port))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_norm(v, port) for v in obj]
    return obj


async def _call(sess, server, method: str, path: str, body=None, stream=False,
                raw: bytes = None) -> tuple:
    """(status, JSON body or text, content-type family), or the client's
    exception name and what it read before it."""
    url = f"http://{server.address}{path}"
    got = b""
    try:
        kw = {"data": raw} if raw is not None else ({"json": body} if body is not None else {})
        async with sess.request(method, url, **kw) as r:
            if stream:
                async for chunk in r.content.iter_any():
                    got += chunk
                return r.status, got.decode(), "stream"
            ctype = r.content_type
            data = await r.read()
            if ctype == "application/json":
                return r.status, _norm(json.loads(data), server.port), ctype
            return r.status, data.decode().replace(str(server.port), "PORT"), ctype
    except (aiohttp.ClientError, ConnectionError) as e:
        return type(e).__name__, got.decode()


async def _script(mod, clock: Clock) -> dict:
    cfg = mod.FakeServerConfig(block_size=4, num_blocks=8, prefill_us_per_token=0.0,
                               decode_us_per_token=0.0, kv_pull_us_per_block=0.0,
                               kv_events_port=0, lora_adapters=["ad1"])
    server = mod.FakeModelServer(cfg)
    await server.start()
    zctx = zmq.asyncio.Context()
    sub = zctx.socket(zmq.SUB)
    sub.setsockopt(zmq.SUBSCRIBE, b"kv@")
    sub.connect(f"tcp://127.0.0.1:{cfg.kv_events_port}")
    await asyncio.sleep(0.2)  # the subscription reaches the publisher
    out: list = []
    timeout = aiohttp.ClientTimeout(total=10)
    try:
        async with aiohttp.ClientSession(timeout=timeout) as sess:
            async def call(*a, **k):
                out.append(await _call(sess, server, *a, **k))

            await call("GET", "/health")
            await call("GET", "/v1/models")
            for prompt in ("hello world, the first prompt", "hello world, the first prompt",
                           "hello world, another", "x" * 40):  # repeats, a prefix, eviction
                await call("POST", "/v1/completions", {"prompt": prompt, "max_tokens": 3})
            await call("POST", "/v1/completions", {"prompt": "lora prompt text",
                                                   "model": "ad1", "max_tokens": 2})
            msgs = [{"role": "system", "content": "be brief"},
                    {"role": "user", "content": [{"type": "text", "text": "hi there"}]}]
            await call("POST", "/v1/chat/completions", {"messages": msgs, "max_tokens": 2})
            await call("POST", "/v1/completions", {"prompt": "stream me please",
                                                   "max_tokens": 3, "stream": True}, stream=True)
            await call("POST", "/v1/chat/completions", {"messages": msgs, "max_tokens": 2,
                                                        "stream": True}, stream=True)
            await call("POST", "/v1/completions/render", {"prompt": "render this"})
            await call("POST", "/v1/chat/completions/render", {"messages": msgs})
            await call("POST", "/v1/embeddings", {"input": ["a", "bb", "ccc"],
                                                  "model": "emb"})
            await call("POST", "/v1/embeddings", {"input": "one"})
            await call("GET", "/metrics")
            await call("GET", "/nope")
            toks = mod.fake_tokenize("prefix pull prompt!")
            keys = block_keys_for_tokens(toks, 4, None)
            await call("POST", "/v1/completions", {
                "prompt": "prefix pull prompt!", "max_tokens": 1,
                "kv_transfer_params": {"do_prefix_pull": True,
                                       "block_hashes": keys[:3] + [7]}})
            await call("POST", "/v1/completions", {
                "prompt": "remote decode please", "max_tokens": 2,
                "kv_transfer_params": {"do_remote_decode": True}})
            await call("POST", "/v1/completions", {
                "prompt": "remote prefilled prompt", "max_tokens": 2,
                "kv_transfer_params": {"do_remote_prefill": True,
                                       "remote_request_id": "cmpl-x"}})
            await server.clear_cache()
            # faults
            server.set_faults(error_rate=1.0, error_status=429, seed=3)
            await call("POST", "/v1/completions", {"prompt": "p", "max_tokens": 1})
            server.set_faults(error_rate=0.5, error_status=503, seed=3)
            for _ in range(6):
                await call("POST", "/v1/completions", {"prompt": "q", "max_tokens": 1})
            server.set_faults(error_rate=0.0, connect_refuse=True)
            await call("POST", "/v1/completions", {"prompt": "r", "max_tokens": 1})
            server.set_faults(connect_refuse=False, latency_s=0.01, first_byte_delay_s=0.001,
                              decode_delay_s=0.001, jitter_s=0.002, seed=9)
            await call("POST", "/v1/completions", {"prompt": "slow", "max_tokens": 2})
            server.set_faults(latency_s=0.0, first_byte_delay_s=0.0, decode_delay_s=0.0,
                              midstream_hangup_rate=1.0)
            await call("POST", "/v1/completions", {"prompt": "cut", "max_tokens": 4,
                                                   "stream": True}, stream=True)
            server.set_faults(midstream_hangup_rate=0.0, flap_period_s=10.0, flap_duty=0.5)
            clock.t += 6  # the down half of the period
            await call("POST", "/v1/completions", {"prompt": "flap", "max_tokens": 1})
            clock.t += 5
            await call("POST", "/v1/completions", {"prompt": "flap", "max_tokens": 1})
            server.set_faults(flap_period_s=0.0, fail_metrics=True, fail_health=True)
            await call("GET", "/metrics")
            await call("GET", "/health")
            server.set_faults(fail_metrics=False, fail_health=False)
            try:
                server.set_faults(bogus=1)
            except AttributeError as e:
                out.append(str(e))
            # drain: one request in flight past a short drain, then idle
            server.set_faults(decode_delay_s=0.1)
            slow = asyncio.ensure_future(_call(sess, server, "POST", "/v1/completions",
                                               {"prompt": "in flight", "max_tokens": 3}))
            while server.running == 0:
                await asyncio.sleep(0.005)
            drain = asyncio.ensure_future(_call(sess, server, "POST",
                                                "/drain?timeout_s=0.5"))
            await asyncio.sleep(0.02)
            clock.t += 1  # past the drain's timeout with the request in flight
            out.append(await drain)
            await call("GET", "/health")
            await call("POST", "/v1/completions", {"prompt": "refused", "max_tokens": 1})
            out.append(await slow)
            server.set_faults(decode_delay_s=0.0)
            await call("POST", "/drain")
            await call("POST", "/drain?timeout_s=soon")
            await call("POST", "/drain", {"enable": False})
            await call("GET", "/health")
            await call("GET", "/metrics")
        events = []
        while True:
            try:
                topic, payload = await asyncio.wait_for(sub.recv_multipart(), 0.3)
            except asyncio.TimeoutError:
                break
            events.append((topic.decode().replace(server.address, "ADDR"), payload))
        state = {"counts": (server.request_count, server.pulls_completed,
                            server.pulled_blocks, server.remote_pulls),
                 "faults": dict(server.fault_counts), "blocks": list(server.blocks),
                 "records": server.request_records,
                 "received": [(r["prompt"], r["body"]) for r in server.received]}
    finally:
        sub.close(0)
        zctx.term()
        await server.stop()
    return {"out": out, "events": events, "state": state}


async def _roles(mod) -> list:
    out = []
    async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=10)) as sess:
        for role in ("prefill", "decode"):
            server = mod.FakeModelServer(mod.FakeServerConfig(
                role=role, prefill_us_per_token=0.0, decode_us_per_token=0.0,
                kv_pull_us_per_block=0.0))
            await server.start()
            try:
                for body in ({"prompt": "plain", "max_tokens": 2},
                             {"prompt": "p" * 40, "max_tokens": 1,
                              "kv_transfer_params": {"do_remote_decode": True}}):
                    out.append(await _call(sess, server, "POST", "/v1/completions", body))
                out.append(await _call(sess, server, "GET", "/metrics"))
                out.append(await _call(sess, server, "GET", "/health"))
            finally:
                await server.stop()
    return out


def test_fake_server_script_equal_to_reference(patched):
    a = run_async(_script(ref_fake, patched[ref_fake]))
    b = run_async(_script(port_fake, patched[port_fake]))
    assert len(a["out"]) == len(b["out"])
    for i, (x, y) in enumerate(zip(a["out"], b["out"])):
        assert x == y, (i, x, y)
    assert a["state"] == b["state"]
    assert [t for t, _ in a["events"]] == [t for t, _ in b["events"]]
    assert [p for _, p in a["events"]] == [p for _, p in b["events"]]
    out = b["out"]
    statuses = [o[0] for o in out if not isinstance(o, str)]
    assert {200, 400, 404, 429, 503, 504, "ServerDisconnectedError"} <= set(statuses)
    assert any(o[0] in ("ClientPayloadError", 200) and "t0" in o[1] and "[DONE]" not in o[1]
               for o in out if isinstance(o, tuple) and len(o) == 2)
    kinds = {type(ev).__name__ for _, p in b["events"] for ev in decode_event_batch(p)[1]}
    assert kinds == {"BlockStored", "BlockRemoved", "AllBlocksCleared"}
    # 429 once, 503 thrice at rate 0.5 under seed 3, 503 once while flapped down;
    # the connect refuse and the mid-stream hangup each drop a connection
    assert b["state"]["faults"] == {"errors": 5, "refused": 2, "midstream": 1}
    assert b["state"]["counts"][1:] == (1, 3, 1)  # one prefix pull of 3 blocks, one P->D


def test_fake_server_roles_equal_to_reference(patched):
    a = run_async(_roles(ref_fake))
    b = run_async(_roles(port_fake))
    assert a == b
    assert b[0][0] == 400 and b[1][0] == 200 and "kv_transfer_params" in b[1][1]
    assert "kv_transfer_config_info" in b[6][1]


def test_fake_tokenize_equal_to_reference():
    for text in ("", "hello", "héllo wörld ✓", "\x00\n\t"):
        assert port_fake.fake_tokenize(text) == ref_fake.fake_tokenize(text)


def test_serving_flag_follows_start_and_stop():
    async def scenario():
        server = port_fake.FakeModelServer(port_fake.FakeServerConfig())
        assert not server.serving
        await server.start()
        assert server.serving and server.port > 0
        await server.stop()
        assert not server.serving
        await server.stop()  # idempotent

    run_async(scenario())


# ------------------------------------------- the server under a stopping replica
def _http_server():
    from llmd_tpu_torch.router.http import HTTPServer, json_response

    srv = HTTPServer()

    async def ok(request):
        return json_response({"ok": True})

    srv.add_route("GET", "/health", ok)
    return srv


async def _get_once(reader, writer) -> bytes:
    writer.write(b"GET /health HTTP/1.1\r\nhost: x\r\n\r\n")
    await writer.drain()
    return await asyncio.wait_for(reader.read(4096), 5)


def test_stop_aborts_a_connection_its_cancel_missed():
    """A keep-alive connection whose handler ``stop`` did not cancel (one
    accepted in the same loop pass as the stop, as a killed fake replica's
    sidecar client's was) is aborted after ``STOP_GRACE_S``: ``stop`` returns
    and the client reads the end, where it waited for ever before."""
    from llmd_tpu_torch.router import http

    async def scenario():
        srv = _http_server()
        port = await srv.start("127.0.0.1", 0)
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        assert b"200 OK" in await _get_once(reader, writer)  # kept alive, idle
        srv._conns.clear()  # the stop's snapshot misses this handler
        t0 = asyncio.get_running_loop().time()
        await asyncio.wait_for(srv.stop(), http.STOP_GRACE_S + 5)
        waited = asyncio.get_running_loop().time() - t0
        tail = await asyncio.wait_for(reader.read(), 5)
        writer.close()
        return waited, tail

    waited, tail = run_async(scenario())
    assert http.STOP_GRACE_S - 0.5 <= waited < http.STOP_GRACE_S + 2 and tail == b""


def test_a_connection_accepted_while_stopping_is_not_served():
    async def scenario():
        srv = _http_server()
        port = await srv.start("127.0.0.1", 0)
        srv._closing = True  # what stop sets before it closes the listener
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        try:
            got = await _get_once(reader, writer)
        except ConnectionError:
            got = b""
        writer.close()
        await asyncio.wait_for(srv.stop(), 5)
        return got

    assert run_async(scenario()) == b""
