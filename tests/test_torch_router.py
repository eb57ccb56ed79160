"""The port's serving surface against the reference's, on the CPU at ``tiny``
in float32, and the reference router driving port engines.

- **Server parity.** The port's ``EngineServer`` and the reference's
  (``llmd_tpu/engine/server.py``), serving the same weights, answer the same
  script with the same status codes, JSON keys, greedy text (plain, chat, and
  the joined SSE text with its final ``finish_reason`` and ``usage``), render
  ids, admission, ``/drain`` and ``/health`` codes, and publish the same KV
  events (decoded batches joined, ``seq`` aside).
- **Router end to end.** A real ``llmd_tpu.router.server.RouterServer``,
  configured for precise prefix-cache routing, in front of two port engines:
  its datalayer reads their ``/metrics``, its KV index fills from their
  events, a shared prefix stays on one engine, a stream proxies through it,
  greedy text through it equals the engine's own, and after ``/drain`` on one
  engine new requests land on the other.
"""

import asyncio
import dataclasses
import functools
import json

import aiohttp
import jax
import numpy as np
import zmq
import zmq.asyncio

from llmd_tpu.core.config import FrameworkConfig
from llmd_tpu.core.endpoint import Endpoint, EndpointPool
from llmd_tpu.core.kv_events import decode_event_batch
from llmd_tpu.core.metrics_contract import StdMetric
from llmd_tpu.engine.config import EngineConfig as JaxEngineConfig
from llmd_tpu.engine.server import EngineServer as JaxEngineServer
from llmd_tpu.kv import plugins as _kv  # noqa: F401 (registers the KV plugins)
from llmd_tpu.kv.subscriber import LABEL_KV_EVENTS_ADDR
from llmd_tpu.models import get_model_config as jax_model_config
from llmd_tpu.models import transformer as jt
from llmd_tpu.router import filters_pickers as _fp  # noqa: F401
from llmd_tpu.router import scorers as _s  # noqa: F401
from llmd_tpu.router.plugins import known_plugin_types
from llmd_tpu.router.server import RouterServer
from llmd_tpu_torch.engine import EngineConfig
from llmd_tpu_torch.engine.server import EngineServer
from llmd_tpu_torch.models import get_model_config
from llmd_tpu_torch.models import transformer as tt
from tests.conftest import run_async

KW = dict(page_size=16, num_pages=64, max_model_len=512, max_batch_size=4,
          prefill_chunk=64, decode_steps=2)
MODEL = "test/tiny"
PRECISE_CFG = """
plugins:
  - {name: token-producer, type: token-producer}
  - {name: precise-producer, type: precise-prefix-cache-producer, params: {blockSize: 16}}
  - {name: prefix, type: precise-prefix-cache-scorer}
  - {name: queue, type: queue-depth-scorer}
  - {name: inflight, type: inflight-load-producer}
schedulingProfiles:
  - name: default
    plugins:
      - {pluginRef: prefix, weight: 3}
      - {pluginRef: queue, weight: 2}
"""


@functools.cache
def _weights():
    jcfg = dataclasses.replace(jax_model_config("tiny"), dtype="float32")
    tcfg = dataclasses.replace(get_model_config("tiny"), dtype="float32")
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, {k: np.asarray(v) for k, v in jp.items()}


def _port_server(**kw) -> EngineServer:
    _, tcfg, _, npp = _weights()
    return EngineServer(tcfg, EngineConfig(**KW), model_name=MODEL, host="127.0.0.1",
                        port=0, params=tt.params_from_numpy(tcfg, npp), device="cpu", **kw)


async def _call(sess, method, url, body=None, headers=None):
    """(status, parsed body, headers); a stream comes back as its events."""
    async with sess.request(method, url, json=body, headers=headers) as r:
        if r.headers.get("Content-Type", "").startswith("text/event-stream"):
            events = []
            async for line in r.content:
                line = line.decode().strip()
                if line.startswith("data: "):
                    events.append(line[6:])
            assert events[-1] == "[DONE]"
            return r.status, [json.loads(e) for e in events[:-1]], r.headers
        return r.status, json.loads(await r.read()), r.headers


def _joined(events, chat):
    return "".join(e["choices"][0]["delta"]["content"] if chat else e["choices"][0]["text"]
                   for e in events)


def _shape(payload):
    """What the comparison keeps of a JSON answer: its keys, its choices'
    keys, and everything but the id and the creation time."""
    if not isinstance(payload, dict):
        return payload
    return {k: ([_shape(c) for c in v] if k == "choices" else _shape(v))
            for k, v in payload.items() if k not in ("id", "created")}


async def _script(base: str, events_port: int) -> dict:
    """The same requests against one server; everything comparable."""
    zctx = zmq.asyncio.Context()
    sub = zctx.socket(zmq.SUB)
    sub.setsockopt(zmq.SUBSCRIBE, b"kv@")
    sub.connect(f"tcp://127.0.0.1:{events_port}")
    await asyncio.sleep(0.3)  # slow joiner
    out: dict = {}
    prompt = "hello paged attention world, this is a prompt with pages"
    chat = [{"role": "system", "content": "be brief"},
            {"role": "user", "content": [{"type": "text", "text": "stream"}, "me"]}]
    try:
        async with aiohttp.ClientSession() as s:
            for name, path, body in [
                ("cmpl", "/v1/completions", {"prompt": prompt}),
                ("cmpl_stream", "/v1/completions", {"prompt": prompt, "stream": True}),
                ("chat", "/v1/chat/completions", {"messages": chat}),
                ("chat_stream", "/v1/chat/completions", {"messages": chat, "stream": True}),
            ]:
                status, payload, _ = await _call(s, "POST", base + path, {
                    **body, "max_tokens": 12, "temperature": 0.0})
                if body.get("stream"):
                    c = "messages" in body
                    last = payload[-1]
                    # an event's own text is not compared: the port holds back
                    # an incomplete UTF-8 sequence, the reference decodes each
                    # piece alone; the joined texts are compared
                    out[name] = (status, _joined(payload, c),
                                 last["choices"][0]["finish_reason"], last["usage"],
                                 {(e["object"], e["model"], tuple(sorted(e)),
                                   tuple(sorted(e["choices"][0]))) for e in payload},
                                 all(e["choices"][0]["finish_reason"] is None
                                     for e in payload[:-1]))
                else:
                    out[name] = (status, _shape(payload))
            for path, body in [("/v1/completions/render", {"prompt": "abc"}),
                               ("/v1/chat/completions/render", {"messages": chat})]:
                out[path] = (await _call(s, "POST", base + path, body))[:2]
            async with s.post(base + "/v1/completions", data=b"garbage") as r:
                out["invalid_json"] = r.status
            async with s.post(base + "/v1/completions",
                              json={"prompt": "", "max_tokens": 4}) as r:
                out["empty_prompt"] = r.status
            for budget in ("0", "-1.5", "soon", "30"):
                status, *_ = await _call(s, "POST", base + "/v1/completions", {
                    "prompt": "abc", "max_tokens": 2, "temperature": 0.0},
                    headers={"x-request-timeout": budget})
                out[f"deadline {budget}"] = status
            out["drain bad"] = (await _call(s, "POST", base + "/drain?timeout_s=soon"))[:2]
            out["drain"] = (await _call(s, "POST", base + "/drain?timeout_s=5"))[:2]
            out["health draining"] = (await _call(s, "GET", base + "/health"))[:2]
            status, payload, headers = await _call(s, "POST", base + "/v1/completions",
                                                   {"prompt": "abc"})
            out["admission draining"] = (status, payload, headers.get("Retry-After"))
            out["reopen"] = (await _call(s, "POST", base + "/drain", {"enable": False}))[:2]
            out["health"] = (await _call(s, "GET", base + "/health"))[:2]
        events = []
        deadline = asyncio.get_running_loop().time() + 2.0
        while asyncio.get_running_loop().time() < deadline:
            try:
                topic, payload = await asyncio.wait_for(sub.recv_multipart(), 0.3)
            except asyncio.TimeoutError:
                if events:
                    break
                continue
            assert topic.decode().startswith("kv@") and topic.decode().endswith(f"@{MODEL}")
            events += decode_event_batch(payload)[1]
        out["kv events"] = events
    finally:
        sub.close(0)
        zctx.term()
    return out


def test_server_parity_with_reference():
    async def main():
        jcfg, _, jp, _ = _weights()
        ref = JaxEngineServer(jcfg, JaxEngineConfig(**KW, attn_impl="reference"),
                              model_name=MODEL, host="127.0.0.1", port=0,
                              kv_events_port=0, params=jp)
        await ref.start()
        try:
            want = await _script(f"http://{ref.address}", ref.kv_events_port)
        finally:
            await ref.stop()
        port = _port_server(kv_events_port=0)
        port.start()
        try:
            got = await _script(f"http://{port.address}", port.kv_events_port)
        finally:
            port.stop()
        return want, got

    want, got = run_async(main())
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key], key
    # the script is not vacuous
    assert want["cmpl"][0] == 200 and want["cmpl"][1]["usage"]["completion_tokens"] == 12
    assert want["cmpl_stream"][1] == want["cmpl"][1]["choices"][0]["text"]
    assert want["drain"] == (200, {"status": "drained", "inflight": 0})
    assert want["admission draining"][0] == 503 and want["health draining"][0] == 503
    assert len(want["kv events"]) > 0


LIST_PROMPTS = [[1, 2, 3], ["ab", "c"]]


async def _list_prompt_script(base: str) -> list:
    """Each list-valued prompt through the completions route and ``/render``:
    (status, prompt tokens, greedy text) for the completion, (status, ids)
    for the render."""
    out = []
    async with aiohttp.ClientSession() as s:
        for prompt in LIST_PROMPTS:
            status, payload, _ = await _call(s, "POST", base + "/v1/completions", {
                "prompt": prompt, "max_tokens": 8, "temperature": 0.0})
            out.append((status, payload["usage"]["prompt_tokens"],
                        payload["choices"][0]["text"]))
            out.append((await _call(s, "POST", base + "/v1/completions/render",
                                    {"prompt": prompt}))[:2])
    return out


def test_list_prompt_parity_with_reference():
    """A list-valued ``prompt`` is encoded as its text, as the reference's
    ``_tokenize_body`` does (``str(body["prompt"])``): ``[1, 2, 3]`` is the
    text "[1, 2, 3]" (tokens 91 49 44 32 50 44 32 51 93 with the byte
    tokenizer), ``["ab", "c"]`` answers 200. Both servers give the same
    status, prompt tokens and greedy text on the completions route and the
    same ids from ``/render``, which the router's prefix scoring reads."""
    async def main():
        jcfg, _, jp, _ = _weights()
        ref = JaxEngineServer(jcfg, JaxEngineConfig(**KW, attn_impl="reference"),
                              model_name=MODEL, host="127.0.0.1", port=0, params=jp)
        await ref.start()
        try:
            want = await _list_prompt_script(f"http://{ref.address}")
        finally:
            await ref.stop()
        port = _port_server()
        port.start()
        try:
            got = await _list_prompt_script(f"http://{port.address}")
        finally:
            port.stop()
        return want, got

    want, got = run_async(main())
    assert got == want
    assert want[1] == (200, {"prompt_token_ids": [91, 49, 44, 32, 50, 44, 32, 51, 93]})
    assert want[0][:2] == (200, 9) and want[2][0] == want[3][0] == 200


def test_router_drives_port_engines():
    async def main():
        engines = [_port_server(kv_events_port=0) for _ in range(2)]
        for e in engines:
            e.start()
        pool = EndpointPool()
        for e in engines:
            pool.upsert(Endpoint(address=e.address, labels={
                LABEL_KV_EVENTS_ADDR: f"127.0.0.1:{e.kv_events_port}"}))
        cfg = FrameworkConfig.from_yaml(PRECISE_CFG, known_types=known_plugin_types())
        router = RouterServer(cfg, pool, port=0, poll_interval_s=0.1)
        await router.start()
        try:
            await asyncio.sleep(0.4)  # a metrics poll; SUB connections (slow joiner)
            for e in engines:  # 1. the datalayer read each engine's /metrics
                attrs = pool.get(e.address).attrs
                assert attrs.get(StdMetric.BLOCK_SIZE) == KW["page_size"]
                assert attrs.get(StdMetric.NUM_BLOCKS) == KW["num_pages"]
                assert attrs.get(StdMetric.QUEUED_REQUESTS) == 0
            url = f"http://{router.address}/v1/completions"
            prefix = "shared system prompt " * 10
            chosen = []
            async with aiohttp.ClientSession() as s:
                for i in range(5):  # 2. the index fills; the prefix stays put
                    status, body, headers = await _call(s, "POST", url, {
                        "model": MODEL, "prompt": prefix + f"q{i}", "max_tokens": 4,
                        "temperature": 0.0})
                    assert status == 200, body
                    chosen.append(headers["x-llm-d-endpoint"])
                    if i == 0:
                        await asyncio.sleep(0.3)  # the engine's events land in the index
                        assert len(router.ctx["kv_index"]) > 0
                assert len(set(chosen)) == 1, chosen
                sticky = chosen[0]
                other = next(e for e in engines if e.address != sticky)
                # 3. a stream proxies through; 4. greedy text as the engine's own
                req = {"model": MODEL, "prompt": prefix + "stream", "max_tokens": 8,
                       "temperature": 0.0}
                status, events, headers = await _call(s, "POST", url, {**req, "stream": True})
                assert status == 200 and headers["Content-Type"].startswith(
                    "text/event-stream")
                via_router = _joined(events, chat=False)
                assert events[-1]["usage"]["completion_tokens"] == 8
                _, direct, _ = await _call(s, "POST", f"http://{other.address}/v1/completions",
                                           req)
                assert via_router == direct["choices"][0]["text"]
                # 5. drain the sticky engine: new requests land on the other
                status, body, _ = await _call(s, "POST", f"http://{sticky}/drain?timeout_s=5")
                assert (status, body["status"]) == (200, "drained")
                for i in range(3):
                    status, body, headers = await _call(s, "POST", url, {
                        "model": MODEL, "prompt": prefix + f"after{i}", "max_tokens": 2,
                        "temperature": 0.0})
                    assert status == 200, body
                    assert headers["x-llm-d-endpoint"] == other.address
        finally:
            await router.stop()
            for e in engines:
                e.stop()

    run_async(main())
