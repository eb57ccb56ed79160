"""The port's router server against the reference's, on the CPU, in front of
the same kind of engines: two tiny port engines (float32) publishing KV events.

- **One script, both routers.** The reference ``llmd_tpu.router.server.
  RouterServer`` and the port's ``llmd_tpu_torch.router.server.RouterServer``
  sit in turn in front of two fresh engines (built alike from one seed), with
  the README's precise-prefix config and the same scheduler seed. The script
  gives equal status codes, ``x-llm-d-endpoint`` picks (as engine indices),
  echo headers, greedy and streamed texts, retry and drain behaviour (a
  drained engine answers 503, the router re-picks; both drained: 502), and
  ``/metrics`` families with equal names, types, help and labels.
- **Streaming passes through as it arrives**: the first SSE event reaches the
  client while the upstream holds back the rest; hedging, a body cut after
  its headers and a stream cut mid-way behave as the reference's, against
  scripted upstreams.
- **The CLI** ``python -m llmd_tpu_torch.router.serve`` answers with
  ``--endpoints-file`` (one subprocess), each refused flag exits 2 naming
  its ROADMAP item, and the HA flags attach a leader elector.
"""

import asyncio
import dataclasses
import json
import os
import random
import subprocess
import sys
import time
from pathlib import Path

import aiohttp
import pytest
import torch

from llmd_tpu.core.config import FrameworkConfig as RefConfig
from llmd_tpu.core.endpoint import Endpoint as RefEndpoint
from llmd_tpu.core.endpoint import EndpointPool as RefPool
from llmd_tpu.kv import plugins as _ref_kv  # noqa: F401 (registers the KV plugins)
from llmd_tpu.router import filters_pickers as _ref_fp  # noqa: F401
from llmd_tpu.router import scorers as _ref_s  # noqa: F401
from llmd_tpu.router.plugins import known_plugin_types as ref_known
from llmd_tpu.router.server import RouterServer as RefRouter
from llmd_tpu_torch import router as _port_router  # noqa: F401 (registers the plugins)
from llmd_tpu_torch.core.config import FrameworkConfig as PortConfig
from llmd_tpu_torch.core.metrics_contract import StdMetric
from llmd_tpu_torch.core.endpoint import Endpoint as PortEndpoint
from llmd_tpu_torch.core.endpoint import EndpointPool as PortPool
from llmd_tpu_torch.engine import EngineConfig
from llmd_tpu_torch.engine.server import EngineServer
from llmd_tpu_torch.kv.subscriber import LABEL_KV_EVENTS_ADDR
from llmd_tpu_torch.models import get_model_config
from llmd_tpu_torch.models import transformer as tt
from llmd_tpu_torch.router import serve as port_serve
from llmd_tpu_torch.router.plugins import known_plugin_types as port_known
from llmd_tpu_torch.router.server import RouterServer as PortRouter
from tests.conftest import run_async

REPO = Path(__file__).resolve().parent.parent
KW = dict(page_size=16, num_pages=64, max_model_len=512, max_batch_size=4,
          prefill_chunk=64, decode_steps=2)
MODEL = "test/tiny"
# the README's precise-prefix config
PRECISE_CFG = """
plugins:
  - {name: token-producer, type: token-producer}
  - {name: precise-producer, type: precise-prefix-cache-producer, params: {blockSize: 16}}
  - {name: prefix, type: precise-prefix-cache-scorer}
  - {name: queue, type: queue-depth-scorer}
schedulingProfiles:
  - {name: default, plugins: [{pluginRef: prefix, weight: 3}, {pluginRef: queue, weight: 2}]}
"""
SEED = 7


def _engines():
    cfg = dataclasses.replace(get_model_config("tiny"), dtype="float32")
    params = tt.init_params(cfg, torch.Generator().manual_seed(0))
    out = [EngineServer(cfg, EngineConfig(**KW), model_name=MODEL, host="127.0.0.1", port=0,
                        kv_events_port=0, params=params, device="cpu") for _ in range(2)]
    for e in out:
        e.start()
    return out


async def _until(cond, what, timeout=5.0):
    """Wait (bounded) for a condition the router reaches asynchronously."""
    t_end = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < t_end, f"timed out waiting for {what}"
        await asyncio.sleep(0.02)


async def _call(s, method, url, body=None, headers=None, raw=None):
    """(status, body: parsed JSON, or the joined SSE events, headers)."""
    kw = {"data": raw} if raw is not None else {"json": body}
    async with s.request(method, url, headers=headers, **kw) as r:
        if r.headers.get("Content-Type", "").startswith("text/event-stream"):
            events = [line.decode().strip()[6:] async for line in r.content
                      if line.startswith(b"data: ")]
            return r.status, [e if e == "[DONE]" else _strip(json.loads(e))
                              for e in events], r.headers
        data = await r.read()
        try:
            return r.status, json.loads(data), r.headers
        except ValueError:
            return r.status, data.decode(), r.headers


def _strip(payload):
    """An answer without its id and creation time."""
    if not isinstance(payload, dict):
        return payload
    return {k: v for k, v in payload.items() if k not in ("id", "created")}


def _families(text: str) -> dict:
    """/metrics -> {family: (type, help, label-name sets of its samples)}."""
    fams: dict = {}
    for line in text.splitlines():
        if line.startswith("# HELP "):
            name, _, help_ = line[7:].partition(" ")
            fams.setdefault(name, {})["help"] = help_
        elif line.startswith("# TYPE "):
            name, _, typ = line[7:].partition(" ")
            fams.setdefault(name, {})["type"] = typ
    return {k: (v.get("type"), v.get("help")) for k, v in fams.items()}


async def _script(kind: str) -> dict:
    """Drive one router (``kind`` "ref" or "port") in front of two fresh
    engines; return everything comparable, endpoints as engine indices."""
    engines = _engines()
    addrs = [e.address for e in engines]
    idx = {a: i for i, a in enumerate(addrs)}
    if kind == "ref":
        pool, cfg = RefPool(), RefConfig.from_yaml(PRECISE_CFG, known_types=ref_known())
        for e in engines:
            pool.upsert(RefEndpoint(address=e.address, labels={
                LABEL_KV_EVENTS_ADDR: f"127.0.0.1:{e.kv_events_port}"}))
        random.seed(SEED)  # the reference's pickers draw from the global random
        router = RefRouter(cfg, pool, port=0, poll_interval_s=0.05)
    else:
        pool, cfg = PortPool(), PortConfig.from_yaml(PRECISE_CFG, known_types=port_known())
        for e in engines:
            pool.upsert(PortEndpoint(address=e.address, labels={
                LABEL_KV_EVENTS_ADDR: f"127.0.0.1:{e.kv_events_port}"}))
        router = PortRouter(cfg, pool, port=0, poll_interval_s=0.05, seed=SEED)
    await router.start()
    out: dict = {}
    base = f"http://{router.address}"
    index = router.ctx["kv_index"]
    try:
        await _until(lambda: all(ep.attrs.get(StdMetric.KV_UTILIZATION) is not None for ep in pool.list()),
                     "the first metrics poll")
        prefixes = ["shared system prompt " * 4, "another long preamble, " * 4]
        async with aiohttp.ClientSession() as s:
            def pick(h):
                return idx.get(h.get("x-llm-d-endpoint"))

            async def go(name, body, path="/v1/completions", **kw):
                status, payload, h = await _call(s, "POST", base + path, body, **kw)
                echo = {k.lower(): v for k, v in h.items()
                        if k.lower().startswith("x-llm-d-") and k.lower() not in (
                            "x-llm-d-endpoint", "x-llm-d-request-id")}
                if isinstance(payload, dict):
                    payload = _strip(payload)
                out[name] = (status, pick(h), echo, payload)
                return out[name]

            for g, prefix in enumerate(prefixes):
                n_before = len(index)
                await go(f"g{g} first", {"model": MODEL, "prompt": prefix + "q0",
                                         "max_tokens": 6, "temperature": 0.0})
                # the engine's BlockStored events reach the index (a speculative
                # insert already added the keys; the confirmed ones follow)
                await _until(lambda: router.kv_subscriber.batches_received > g,
                             "the engine's KV events")
                out[f"g{g} index grew"] = len(index) > n_before
                for i in (1, 2):
                    await go(f"g{g} q{i}", {"model": MODEL, "prompt": prefix + f"q{i}",
                                            "max_tokens": 6, "temperature": 0.0})
                await go(f"g{g} stream", {"model": MODEL, "prompt": prefix + "s",
                                          "max_tokens": 6, "temperature": 0.0,
                                          "stream": True})
            await go("chat", {"model": MODEL, "max_tokens": 5, "temperature": 0.0,
                              "messages": [{"role": "user", "content": prefixes[0]}]},
                     path="/v1/chat/completions")
            await go("bad json", None, raw=b"{nope")
            await go("bad regex", {"model": MODEL, "prompt": "x", "guided_regex": "(",
                                   "max_tokens": 2})
            await go("deadline spent", {"model": MODEL, "prompt": "x", "max_tokens": 2},
                     headers={"x-request-timeout": "0.000001"})
            for path in ("/health", "/v1/models", "/debug/requests?limit=x",
                         "/admin/model-rewrites", "/nope"):
                status, body, _ = await _call(s, "GET", base + path)
                out[f"GET {path}"] = status if path != "/v1/models" else (status, body)
            # drain: the sticky engine answers 503, the router re-picks the other
            sticky = out["g0 q2"][1]
            status, body, _ = await _call(s, "POST", f"http://{addrs[sticky]}/drain?timeout_s=5")
            assert status == 200, body
            for i in range(2):
                await go(f"drained {i}", {"model": MODEL, "prompt": prefixes[0] + f"d{i}",
                                          "max_tokens": 3, "temperature": 0.0})
            status, body, _ = await _call(s, "POST",
                                          f"http://{addrs[1 - sticky]}/drain?timeout_s=5")
            await go("both drained", {"model": MODEL, "prompt": "z", "max_tokens": 2})
            status, text, _ = await _call(s, "GET", base + "/metrics")
            out["metrics families"] = _families(text)
            out["metric labels"] = {n: tuple(router.registry.get(n).labelnames)
                                    for n in router.registry.families()}
            out["scheduled"] = router.scheduler.metrics["scheduled_total"]
    finally:
        await router.stop()
        for e in engines:
            e.stop()
    return out


def test_router_server_parity_with_reference(monkeypatch):
    # span ids draw from the global random in both packages; give them their
    # own stream, so the global one carries the reference pickers' draws only
    import llmd_tpu.obs.tracing as ref_tracing
    import llmd_tpu_torch.obs.tracing as port_tracing

    monkeypatch.setattr(ref_tracing, "random", random.Random(1))
    monkeypatch.setattr(port_tracing, "random", random.Random(2))
    want = run_async(_script("ref"))
    got = run_async(_script("port"))
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key], key
    # the script is not vacuous
    for g in (0, 1):
        first = want[f"g{g} first"]
        assert first[0] == 200 and want[f"g{g} index grew"]
        assert all(want[f"g{g} {k}"][1] == first[1] for k in ("q1", "q2", "stream"))
        assert want[f"g{g} q2"][3]["usage"]["cached_tokens"] >= 64
    assert want["g0 stream"][3][-1] == "[DONE]"
    assert [want[k][0] for k in ("bad json", "bad regex", "deadline spent")] == [400, 400, 504]
    assert want["drained 0"][:3] == (200, 1 - want["g0 q2"][1], {"x-llm-d-attempts": "2"})
    assert want["both drained"][0] == 502
    assert "llm_d_epp_requests_total" in want["metrics families"]
    assert len(want["metrics families"]) >= 60


def test_stream_passes_through_as_it_arrives():
    """An upstream sends one SSE event and holds the rest until the client
    has read that event through the router: a router that buffered the
    stream would never deliver it (the wait times out)."""
    async def main():
        up = _Upstream("gated")
        await up.start()
        pool = PortPool()
        pool.upsert(PortEndpoint(address=up.address))
        cfg = PortConfig.from_yaml(QUEUE_CFG, known_types=port_known())
        router = PortRouter(cfg, pool, port=0, poll_interval_s=0.05, seed=SEED)
        await router.start()
        try:
            async with aiohttp.ClientSession() as s:
                async with s.post(f"http://{router.address}/v1/completions", json={
                        "model": MODEL, "prompt": "p", "stream": True}) as r:
                    assert r.status == 200
                    first = await asyncio.wait_for(r.content.readline(), 5)
                    assert first == b"data: 0\n"
                    up.gate.set()
                    rest = await asyncio.wait_for(r.read(), 5)
            assert rest == b"\ndata: 1\n\n"
        finally:
            await router.stop()
            await up.stop()

    run_async(main())


# refused by name until the KV plane's router side and HA came; served since
HA_FLAGS = ["--ha-k8s-lease", "--ha-lease-file"]


@pytest.mark.parametrize("flag", sorted(port_serve.REFUSED_FLAGS) + HA_FLAGS)
def test_refused_flags_name_their_item(flag, capsys, monkeypatch):
    """Each refused flag exits 2 naming its ROADMAP item; the HA flags are
    served: the router is built with a leader elector on the named lease
    attached before it starts."""
    argv = [flag] if flag == "--k8s-discovery" else [flag, "1"]
    if flag in HA_FLAGS:
        import llmd_tpu_torch.router.ha as ha

        attached = []
        monkeypatch.setattr(ha, "attach_ha", lambda router, el: attached.append(el))
        monkeypatch.setattr(port_serve.asyncio, "run", lambda coro: coro.close())
        port_serve.main(argv + ["--endpoints", "127.0.0.1:9"])
        lease = attached[0].lease
        assert type(lease) is (ha.FileLease if flag == "--ha-lease-file" else ha.K8sLease)
        assert (lease.path if flag == "--ha-lease-file" else lease.name) == "1"
        return
    with pytest.raises(SystemExit) as exc:
        port_serve.main(argv)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert flag in err and port_serve.REFUSED_FLAGS[flag] in err and "ROADMAP" in err


def test_serve_cli_answers_with_an_endpoints_file(tmp_path):
    """``python -m llmd_tpu_torch.router.serve --endpoints-file`` in front of
    one engine: it prints its address, and a completion through it is 200
    with the engine's text."""
    engines = _engines()
    proc = None
    try:
        eps = tmp_path / "endpoints.txt"
        eps.write_text(f"{engines[0].address},both\n")
        cfg = tmp_path / "precise.yaml"
        cfg.write_text(PRECISE_CFG)
        proc = subprocess.Popen(
            [sys.executable, "-m", "llmd_tpu_torch.router.serve", "--config", str(cfg),
             "--endpoints-file", str(eps), "--host", "127.0.0.1", "--port", "0",
             "--poll-interval", "0.1"],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env={**os.environ, "PYTHONPATH": str(REPO)})
        line = proc.stdout.readline()
        assert line.startswith("llmd-tpu router on http://"), (line, proc.stderr.read()
                                                               if proc.poll() else "")
        address = line.split("http://", 1)[1].split()[0]
        assert "(1 endpoints)" in line

        async def main():
            body = {"model": MODEL, "prompt": "hello router", "max_tokens": 4,
                    "temperature": 0.0}
            async with aiohttp.ClientSession() as s:
                routed = await _call(s, "POST", f"http://{address}/v1/completions", body)
                direct = await _call(s, "POST", f"http://{engines[0].address}/v1/completions",
                                     body)
            return routed, direct

        routed, direct = run_async(main())
        assert routed[0] == 200 and routed[2]["x-llm-d-endpoint"] == engines[0].address
        assert routed[1]["choices"][0]["text"] == direct[1]["choices"][0]["text"]
    finally:
        if proc is not None:
            proc.kill()
            proc.wait(timeout=10)
        for e in engines:
            e.stop()


class _Upstream:
    """A scripted upstream on asyncio streams: ``/metrics`` with a queue
    depth, and ``/v1/completions`` answered by ``mode``: "ok" (JSON after
    ``delay`` s; "once": the same, then the close), "short" (headers promise 100 bytes, 10 arrive, then the
    close), "midstream" (two SSE events, then the close without the chunked
    terminator) or "gated" (one SSE event, the second once ``gate`` is set). Counts its open connections that carried a
    completion."""

    def __init__(self, mode: str = "ok", delay: float = 0.0, waiting: int = 0) -> None:
        self.mode, self.delay, self.waiting = mode, delay, waiting
        self.open = 0
        self.server = None
        self._tasks: set = set()
        self.gate = asyncio.Event()

    async def start(self) -> None:
        self.server = await asyncio.start_server(self._conn, "127.0.0.1", 0)
        self.address = f"127.0.0.1:{self.server.sockets[0].getsockname()[1]}"

    async def stop(self) -> None:
        self.server.close()
        for t in list(self._tasks):
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)

    async def _conn(self, reader, writer) -> None:
        carried = False
        self._tasks.add(asyncio.current_task())
        try:
            while True:
                line = await reader.readline()
                if not line:
                    return
                length = 0
                while (h := await reader.readline()) not in (b"\r\n", b""):
                    if h.lower().startswith(b"content-length:"):
                        length = int(h.split(b":")[1])
                body = await reader.readexactly(length) if length else b""
                path = line.split()[1].decode()
                if path == "/metrics":
                    text = f"vllm:num_requests_waiting {self.waiting}\n".encode()
                    writer.write(b"HTTP/1.1 200 OK\r\nContent-Length: %d\r\n\r\n%s"
                                 % (len(text), text))
                    await writer.drain()
                    continue
                if not carried:
                    carried = True
                    self.open += 1
                if self.mode in ("ok", "once"):
                    await asyncio.sleep(self.delay)
                    out = json.dumps({"choices": [{"text": self.address}],
                                      "usage": {"prompt_tokens": 1,
                                                "completion_tokens": 1}}).encode()
                    writer.write(b"HTTP/1.1 200 OK\r\nContent-Type: application/json\r\n"
                                 b"Content-Length: %d\r\n\r\n%s" % (len(out), out))
                    await writer.drain()
                    if self.mode == "once":  # keep-alive promised, then closed
                        return
                    continue
                if self.mode == "gated":
                    writer.write(b"HTTP/1.1 200 OK\r\nContent-Type: text/event-stream\r\n"
                                 b"Transfer-Encoding: chunked\r\n\r\n")
                    for i in range(2):
                        ev = f"data: {i}\n\n".encode()
                        writer.write(b"%x\r\n%s\r\n" % (len(ev), ev))
                        await writer.drain()
                        if i == 0:
                            await self.gate.wait()
                    writer.write(b"0\r\n\r\n")
                    await writer.drain()
                    continue
                if self.mode == "short":
                    writer.write(b"HTTP/1.1 200 OK\r\nContent-Type: application/json\r\n"
                                 b"Content-Length: 100\r\n\r\n" + b"x" * 10)
                else:
                    writer.write(b"HTTP/1.1 200 OK\r\nContent-Type: text/event-stream\r\n"
                                 b"Transfer-Encoding: chunked\r\n\r\n")
                    for i in range(2):
                        ev = f"data: {i}\n\n".encode()
                        writer.write(b"%x\r\n%s\r\n" % (len(ev), ev))
                await writer.drain()
                assert body is not None
                return
        except (ConnectionError, asyncio.CancelledError):
            return
        finally:
            self.open -= carried
            self._tasks.discard(asyncio.current_task())
            writer.close()


QUEUE_CFG = """
plugins:
  - {name: queue, type: queue-depth-scorer}
schedulingProfiles:
  - {name: default, plugins: [{pluginRef: queue}]}
"""


async def _failure_script(kind: str) -> dict:
    """Hedging (a slow primary, a fast secondary), a body cut after its
    headers, a stream cut mid-way: codes, picks, counters."""
    slow, fast = _Upstream("ok", delay=0.4, waiting=0), _Upstream("ok", waiting=5)
    short, midstream = _Upstream("short"), _Upstream("midstream")
    ups = [slow, fast, short, midstream]
    for u in ups:
        await u.start()
    out: dict = {}
    try:
        for name, members in (("hedge", [slow, fast]), ("short", [short]),
                              ("midstream", [midstream])):
            if kind == "ref":
                pool, cfg = RefPool(), RefConfig.from_yaml(QUEUE_CFG, known_types=ref_known())
                for u in members:
                    pool.upsert(RefEndpoint(address=u.address))
                router = RefRouter(cfg, pool, port=0, poll_interval_s=0.05)
            else:
                pool, cfg = PortPool(), PortConfig.from_yaml(QUEUE_CFG, known_types=port_known())
                for u in members:
                    pool.upsert(PortEndpoint(address=u.address))
                router = PortRouter(cfg, pool, port=0, poll_interval_s=0.05, seed=SEED)
            await router.start()
            try:
                await _until(lambda: all(ep.attrs.get(StdMetric.QUEUED_REQUESTS) is not None
                                         for ep in pool.list()), "the first metrics poll")
                body = {"model": MODEL, "prompt": "p", "max_tokens": 2,
                        "stream": name == "midstream"}
                async with aiohttp.ClientSession() as s:
                    status, payload, h = await _call(
                        s, "POST", f"http://{router.address}/v1/completions", body)
                    if name == "hedge":  # the loser's leg is closed, not pooled
                        await _until(lambda: slow.open == 0, "the hedge loser's close")
                m = router.metrics
                row = json.dumps([status, h.get("x-llm-d-endpoint"), h.get("x-llm-d-attempts"),
                                  payload if name != "short"
                                  else payload["error"]["message"][:20],
                                  m.hedges.value, m.hedge_wins.value, m.errors.value,
                                  router.resilience.snapshot()])
                for i, u in enumerate(ups):  # fresh upstreams a run: addresses as indices
                    row = row.replace(u.address, f"upstream {i}")
                out[name] = json.loads(row)
            finally:
                await router.stop()
    finally:
        for u in ups:
            await u.stop()
    return out


def test_hedging_and_committed_failures_match_reference(monkeypatch):
    """With hedging on, a slow primary's request is hedged to the other
    endpoint, which wins, and the loser's connection is closed. A body cut
    after committed headers is a 502 without a retry; a stream cut mid-way
    ends the client's stream without a retry. Both routers alike."""
    monkeypatch.setenv("LLMD_HEDGE_ENABLED", "1")
    monkeypatch.setenv("LLMD_HEDGE_DELAY_MS", "100")
    want = run_async(_failure_script("ref"))
    got = run_async(_failure_script("port"))
    assert got == want
    assert want["hedge"][:2] == [200, "upstream 1"] and want["hedge"][4:6] == [1, 1]
    assert want["short"][0] == 502 and want["short"][2] is None
    assert want["midstream"][0] == 200 and want["midstream"][3] == [0, 1]
    assert want["midstream"][7]["breakers"]["upstream 3"]["consecutive_failures"] == 1


def test_client_pool_reuses_and_replaces_closed_connections():
    """The router's client keeps one connection to an upstream that keeps it
    open, and sends a request again on a new connection when the pooled one
    was closed by the peer before any byte of the answer."""
    from llmd_tpu_torch.router.http import HTTPClient

    async def main():
        keep, once = _Upstream("ok"), _Upstream("once")
        await keep.start()
        await once.start()
        client = HTTPClient()
        try:
            for up in (keep, once):
                opened = client.connections_opened
                for _ in range(3):
                    r = await client.request("POST", f"http://{up.address}/v1/completions",
                                             json_body={"prompt": "p"}, timeout=5)
                    assert r.status == 200
                    assert (await r.json())["choices"][0]["text"] == up.address
                up.opened = client.connections_opened - opened
        finally:
            await client.close()
            await keep.stop()
            await once.stop()
        return keep.opened, once.opened

    assert run_async(main()) == (1, 3)

