"""The port's gateway fronts against the reference's, on the CPU:

- **ext_proc.** The reference's ``ExtProcEPP`` (grpcio) and the port's (its own
  wire), each over its own ``RouterServer`` in front of the same two fake
  model servers, one scheduler seed per stream. One grpcio client plays
  Envoy and drives the same script into both, with raw bytes: the cases of
  ``tests/test_extproc.py`` (a pick, a FULL_DUPLEX chunked body, the response
  phases feeding usage back, the rewrite's body mutation), the golden Envoy
  bytes of ``tests/test_extproc_conformance.py`` (header values in
  ``raw_value``, a pick on headers alone), the trailer phases, a bad body,
  FailClose and FailOpen on an empty pool, a deliberate rejection that
  FailOpen still enforces, the health Check and Watch, and ``max_streams``.
  The response bytes are equal stream by stream, as are the
  ``llm_d_epp_extproc_*`` lines of both routers' ``/metrics`` and their
  in-flight counts.
- **vllmgrpc.** The same for ``Generate`` (unary, token ids, streamed) and
  ``Embed`` over fake servers, and the rejection codes; then the slice end to
  end: a tiny float32 port engine behind the port's front and the JAX engine
  (same weights) behind the reference's give the same tokens.
- **crds.** ``load_yaml_all`` equals ``yaml.safe_load_all`` on the seven deploy
  manifests; their ``ManifestSet``s are equal, and ``tests/test_crds.py``'s
  error cases give the same messages.
- **The Kubernetes watch.** The port's and the reference's ``K8sWatchSource``
  against one fake API server: the pools are equal after the list, ADDED /
  MODIFIED / DELETED, a pod going not-ready, the role label, an ``ERROR``
  410 re-list and a dropped stream.
"""

import asyncio
import dataclasses
import glob
import json
import queue
import random
import threading
import urllib.request

import grpc
import pytest
import torch
import yaml
from aiohttp import web

from llmd_tpu.core import crds as ref_crds
from llmd_tpu.core.config import FrameworkConfig as RefConfig
from llmd_tpu.core.endpoint import EndpointPool as RefPool
from llmd_tpu.router import ext_proc_pb2 as pb
from llmd_tpu.router import plugins as _ref_plugins  # noqa: F401
from llmd_tpu.router import scorers as _ref_scorers  # noqa: F401
from llmd_tpu.router import vllm_grpc_pb2 as vpb
from llmd_tpu.router.datalayer import add_static_endpoints as ref_add_static
from llmd_tpu.router.discovery import K8sWatchSource as RefWatch
from llmd_tpu.router.extproc import ExtProcEPP as RefEPP
from llmd_tpu.router.plugins import known_plugin_types as ref_known
from llmd_tpu.router.server import RouterServer as RefRouter
from llmd_tpu.router.vllmgrpc import VllmGrpcFront as RefFront
from llmd_tpu.testing.fake_server import FakeModelServer, FakeServerConfig
from llmd_tpu_torch import router as _port_router  # noqa: F401 (registers the plugins)
from llmd_tpu_torch.core import crds as port_crds
from llmd_tpu_torch.core.config import FrameworkConfig as PortConfig
from llmd_tpu_torch.core.config import load_yaml_all
from llmd_tpu_torch.core.endpoint import EndpointPool as PortPool
from llmd_tpu_torch.router.datalayer import add_static_endpoints as port_add_static
from llmd_tpu_torch.router.discovery import K8sWatchSource as PortWatch
from llmd_tpu_torch.router.extproc import ENVOY_SERVICE, HDR_DESTINATION, HEALTH_SERVICE
from llmd_tpu_torch.router.extproc import ExtProcEPP as PortEPP
from llmd_tpu_torch.router.plugins import known_plugin_types as port_known
from llmd_tpu_torch.router.server import RouterServer as PortRouter
from llmd_tpu_torch.router.vllmgrpc import SERVICE as VLLM_SERVICE
from llmd_tpu_torch.router.vllmgrpc import VllmGrpcFront as PortFront
from tests.test_extproc_conformance import golden_body, golden_headers

CONFIG = """
plugins:
  - name: queue
    type: queue-depth-scorer
  - name: inflight
    type: inflight-load-producer
schedulingProfiles:
  - name: default
    plugins:
      - {pluginRef: queue, weight: 2}
"""
PROCESS = f"/{ENVOY_SERVICE}/Process"
# no simulated time on the fakes (their prefix caches are emptied before each
# router's run: both runs see the same answers)
FAKE = FakeServerConfig(prefill_us_per_token=0.0, decode_us_per_token=0.0)


class _Loop:
    def __init__(self) -> None:
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()

    def run(self, coro, timeout: float = 60):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def close(self) -> None:
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(5)


async def _until(cond, what: str, timeout: float = 10.0) -> None:
    loop = asyncio.get_running_loop()
    end = loop.time() + timeout
    while not cond():
        assert loop.time() < end, f"timed out waiting for {what}"
        await asyncio.sleep(0.02)


class _Side:
    """One package's router with its ext_proc EPP and vLLM gRPC front."""

    def __init__(self, kind: str, fakes) -> None:
        self.kind = kind
        self.fakes = fakes

    async def start(self, empty: bool = False) -> None:
        ref = self.kind == "ref"
        pool = RefPool() if ref else PortPool()
        if not empty:
            (ref_add_static if ref else port_add_static)(pool, [f.address for f in self.fakes])
        cfg = (RefConfig if ref else PortConfig).from_yaml(
            CONFIG, known_types=(ref_known if ref else port_known)())
        kw = {} if ref else {"seed": 0}
        self.pool = pool
        self.router = (RefRouter if ref else PortRouter)(cfg, pool, host="127.0.0.1", port=0,
                                                         poll_interval_s=0.05, **kw)
        await self.router.start()
        self.epp = (RefEPP if ref else PortEPP)(self.router, host="127.0.0.1", max_streams=3)
        await self.epp.start()
        self.front = (RefFront if ref else PortFront)(self.router, host="127.0.0.1")
        await self.front.start()
        await _until(lambda: all(ep.attrs.get("kv_cache_utilization") is not None
                                 for ep in pool.list()), "the first metrics poll")

    async def stop(self) -> None:
        await self.front.stop()
        await self.epp.stop()
        await self.router.stop()

    def seed(self, k: int) -> None:
        """The next draws (picks, rewrites) from seed ``k``: the reference
        draws from the global ``random``, the port from its scheduler's rng."""
        if self.kind == "ref":
            random.seed(k)
        else:
            self.router.scheduler.rng.seed(k)


@pytest.fixture(scope="module")
def sides():
    lp = _Loop()
    fakes = [FakeModelServer(FAKE, port=0) for _ in range(2)]
    out = {"loop": lp, "fakes": fakes}

    async def setup():
        for f in fakes:
            await f.start()
        for kind in ("ref", "port"):
            for label, empty in ((kind, False), (f"{kind}_empty", True)):
                out[label] = side = _Side(kind, fakes)
                await side.start(empty=empty)

    lp.run(setup())
    yield out

    async def teardown():
        for kind in ("ref", "port", "ref_empty", "port_empty"):
            await out[kind].stop()
        for f in fakes:
            await f.stop()

    lp.run(teardown())
    lp.close()


def _req(headers: dict, body=None, chunks: int = 1, end_on_headers: bool = False) -> list:
    """An Envoy request's phases as pb2 bytes (header values in ``value``)."""
    hm = pb.HeaderMap(headers=[pb.HeaderValue(key=k, value=v) for k, v in headers.items()])
    out = [pb.ProcessingRequest(request_headers=pb.HttpHeaders(
        headers=hm, end_of_stream=end_on_headers)).SerializeToString()]
    if body is None:
        return out
    raw = body if isinstance(body, bytes) else json.dumps(body).encode()
    step = max(1, len(raw) // chunks)
    offs = list(range(0, len(raw), step))
    for i, off in enumerate(offs):
        out.append(pb.ProcessingRequest(request_body=pb.HttpBody(
            body=raw[off:off + step], end_of_stream=i == len(offs) - 1)).SerializeToString())
    return out


def _response_phases(status: str, usage_tokens: int) -> list:
    return [pb.ProcessingRequest(response_headers=pb.HttpHeaders(headers=pb.HeaderMap(
                headers=[pb.HeaderValue(key=":status", value=status),
                         pb.HeaderValue(key="content-type", value="application/json")])))
            .SerializeToString(),
            pb.ProcessingRequest(response_body=pb.HttpBody(
                body=json.dumps({"usage": {"completion_tokens": usage_tokens}}).encode(),
                end_of_stream=True)).SerializeToString()]


def _hdrs(rid: str, path: str = "/v1/completions", **more) -> dict:
    return {":path": path, ":method": "POST", "x-request-id": rid, **more}


BODY = {"model": "m", "prompt": "hello", "max_tokens": 4}
SCRIPT = [  # (name, request phases)
    ("pick", _req(_hdrs("s-pick"), BODY)),
    ("chunked", _req(_hdrs("s-chunked"), {"model": "m", "prompt": "x" * 256, "max_tokens": 2},
                     chunks=4)),
    ("response phases", _req(_hdrs("s-usage"), BODY) + _response_phases("200", 2)),
    ("rewrite", _req(_hdrs("s-rewrite"), {"model": "alias", "prompt": "p", "max_tokens": 2})),
    ("golden", [golden_headers({":path": "/v1/completions", ":method": "POST",
                                "x-request-id": "golden-1"}),
                golden_body(json.dumps({"model": "m", "prompt": "conformance",
                                        "max_tokens": 2}).encode())]),
    ("golden headers only", [golden_headers({":path": "/v1/completions",
                                             "x-request-id": "golden-2"},
                                            end_of_stream=True)]),
    ("trailers", _req(_hdrs("s-trail"), BODY) + [
        pb.ProcessingRequest(request_trailers=pb.HttpTrailers()).SerializeToString(),
        pb.ProcessingRequest(response_trailers=pb.HttpTrailers()).SerializeToString()]),
    ("bad json", _req(_hdrs("s-bad"), b"{nope")),
    ("deadline spent", _req(_hdrs("s-late", **{"x-request-timeout": "0.000001"}), BODY)),
]


def _stream(address: str, msgs: list, method: str = PROCESS):
    with grpc.insecure_channel(address) as ch:
        try:
            return [bytes(r) for r in ch.stream_stream(method)(iter(msgs), timeout=30)]
        except grpc.RpcError as e:
            return ("status", e.code(), e.details())


def _extproc_lines(router) -> list:
    with urllib.request.urlopen(f"http://127.0.0.1:{router.port}/metrics", timeout=10) as r:
        text = r.read().decode()
    return [ln for ln in text.splitlines() if ln.startswith("llm_d_epp_extproc_")]


def _inflight(side) -> dict:
    return dict(side.router.ctx.get("inflight_requests", {}))


def test_extproc_script_bytes_equal_reference(sides):
    """The ext_proc script through both EPPs: equal response bytes stream by
    stream, picks among the fakes, equal ``/metrics`` lines and equal
    in-flight counts once every stream's feedback landed."""
    fakes = {f.address for f in sides["fakes"]}
    out = {}
    for kind in ("ref", "port"):
        side = sides[kind]
        side.router.model_rewrites["alias"] = [("real-model", 1.0)]
        rows = []
        for k, (name, msgs) in enumerate(SCRIPT):
            side.seed(k)
            rows.append((name, _stream(side.epp.address, msgs)))
        empty = sides[f"{kind}_empty"]
        msgs = _req(_hdrs("s-none"), BODY)
        rows.append(("fail close", _stream(empty.epp.address, msgs)))
        empty.epp.failure_mode = side.epp.failure_mode = "FailOpen"
        rows.append(("fail open", _stream(empty.epp.address, msgs)))
        side.seed(len(SCRIPT))
        rows.append(("fail open, deliberate", _stream(
            side.epp.address, _req(_hdrs("s-late2", **{"x-request-timeout": "0.000001"}),
                                   BODY))))
        empty.epp.failure_mode = side.epp.failure_mode = "FailClose"
        # every stream's end gives its pick back, but for the two spent
        # deadlines: their rejection comes after the pick and holds no
        # endpoint to post to (the reference's accounting, kept)
        sides["loop"].run(_until(lambda: sum(_inflight(side).values()) == 2, "the feedback"))
        out[kind] = {"rows": rows, "metrics": _extproc_lines(side.router),
                     "empty metrics": _extproc_lines(sides[f"{kind}_empty"].router),
                     "inflight": _inflight(side)}
    for (name, ref_row), (_, port_row) in zip(out["ref"]["rows"], out["port"]["rows"]):
        assert port_row == ref_row, name
    rows = dict(out["port"]["rows"])
    picked = pb.ProcessingResponse.FromString(rows["pick"][1]).request_body.response
    dest = {o.header.key: o.header.raw_value.decode()
            for o in picked.header_mutation.set_headers}
    assert dest[HDR_DESTINATION] in fakes and dest["x-llm-d-request-id"] == "s-pick"
    rewrite = pb.ProcessingResponse.FromString(rows["rewrite"][1]).request_body.response
    assert json.loads(rewrite.body_mutation.body)["model"] == "real-model"
    assert pb.ProcessingResponse.FromString(rows["fail close"][1]).immediate_response \
        .status.code == 503
    assert not pb.ProcessingResponse.FromString(rows["fail open"][1]).request_body \
        .response.header_mutation.set_headers
    assert pb.ProcessingResponse.FromString(rows["fail open, deliberate"][1]) \
        .immediate_response.status.code == 504
    assert len(rows["golden headers only"]) == 1
    assert out["port"]["metrics"] == out["ref"]["metrics"]
    assert out["port"]["empty metrics"] == out["ref"]["empty metrics"]
    assert "llm_d_epp_extproc_picks_total 7" in out["port"]["metrics"]
    assert "llm_d_epp_extproc_fail_open_total 1" in out["port"]["empty metrics"]
    assert out["port"]["inflight"] == out["ref"]["inflight"]


def test_extproc_health_and_max_streams(sides):
    """Health Check and Watch answer SERVING (the same bytes); with
    ``max_streams`` open, one more stream is refused RESOURCE_EXHAUSTED by
    both (a Watch counts as a stream, as under grpcio); the port's Watch
    stays open until its server stops."""
    out = {}
    for kind in ("ref", "port"):
        epp = sides[kind].epp
        with grpc.insecure_channel(epp.address) as ch:
            check = bytes(ch.unary_unary(f"/{HEALTH_SERVICE}/Check")(b"", timeout=10))
            watch = ch.unary_stream(f"/{HEALTH_SERVICE}/Watch")(b"", timeout=30)
            first = bytes(next(watch))
            held = []
            for i in range(2):  # with the Watch: max_streams (3) open
                q: queue.Queue = queue.Queue()
                for m in _req(_hdrs(f"held-{i}")):
                    q.put(m)
                call = ch.stream_stream(PROCESS)(iter(q.get, None), timeout=30)
                held.append((q, call, bytes(next(call))))
            refused = _stream(epp.address, _req(_hdrs("one-too-many"), BODY))
            for q, call, _ in held:
                q.put(None)
                list(call)
            watch.cancel()
        out[kind] = (check, first, [h[2] for h in held], refused)
    assert out["port"] == out["ref"]
    assert out["port"][0] == out["port"][1] == b"\x08\x01"
    assert out["port"][3][1] == grpc.StatusCode.RESOURCE_EXHAUSTED


def test_port_watch_stays_open_until_stop():
    """The port's Watch holds its stream until the EPP stops, then ends OK."""
    lp = _Loop()

    async def main():
        router = PortRouter(PortConfig.from_yaml(CONFIG, known_types=port_known()),
                            PortPool(), host="127.0.0.1", port=0)
        await router.start()
        epp = PortEPP(router, host="127.0.0.1")
        await epp.start()
        from llmd_tpu_torch.router.grpc_wire import Channel, StatusCode

        ch = Channel(epp.address)
        watch = ch.unary_stream(f"/{HEALTH_SERVICE}/Watch")(b"", timeout=30)
        first = await watch.read()
        pending = asyncio.ensure_future(watch.read())
        await asyncio.sleep(0)
        still_open = not pending.done()
        await epp.stop()
        end = await asyncio.wait_for(pending, 10)
        await ch.close()
        await router.stop()
        return first, still_open, end, watch.code()

    try:
        first, still_open, end, code = lp.run(main())
    finally:
        lp.close()
    assert first == b"\x08\x01" and still_open and end is None
    assert code == 0  # OK


def _vllm(address: str, kind: str, request, timeout: float = 30):
    with grpc.insecure_channel(address) as ch:
        try:
            if kind == "Embed":
                return [bytes(ch.unary_unary(f"/{VLLM_SERVICE}/Embed")(
                    request.SerializeToString(), timeout=timeout))]
            return [bytes(m) for m in ch.unary_stream(f"/{VLLM_SERVICE}/Generate")(
                request.SerializeToString(), timeout=timeout)]
        except grpc.RpcError as e:
            return ("status", e.code(), e.details())


VLLM_SCRIPT = [
    ("generate", "Generate", vpb.GenerateRequest(
        request_id="g-1", model="m", prompt="count to five",
        sampling_params=vpb.SamplingParams(max_tokens=6, temperature=0.0, ignore_eos=True))),
    ("token ids", "Generate", vpb.GenerateRequest(
        request_id="g-2", model="m", prompt_token_ids=vpb.TokenIds(values=list(range(20, 40))),
        sampling_params=vpb.SamplingParams(max_tokens=4, top_p=0.5, top_k=3, stop=["x"]))),
    ("stream", "Generate", vpb.GenerateRequest(
        request_id="g-3", model="m", prompt="stream this", stream=True,
        sampling_params=vpb.SamplingParams(max_tokens=5, temperature=0.0, ignore_eos=True))),
    ("embed", "Embed", vpb.EmbedRequest(request_id="e-1", model="m", input="embed me")),
]


def test_vllmgrpc_bytes_equal_reference(sides):
    """Generate (unary, token ids, streamed) and Embed through both fronts:
    equal response bytes; on an empty pool both refuse with UNAVAILABLE and
    the same message; the counters agree."""
    out = {}
    for kind in ("ref", "port"):
        side, empty = sides[kind], sides[f"{kind}_empty"]
        for f in sides["fakes"]:
            f.blocks.clear()
        rows = []
        for k, (name, method, request) in enumerate(VLLM_SCRIPT):
            side.seed(k)
            rows.append((name, _vllm(side.front.address, method, request)))
        rows.append(("no endpoint", _vllm(empty.front.address, "Generate", VLLM_SCRIPT[0][2])))
        rows.append(("no endpoint, embed", _vllm(empty.front.address, "Embed",
                                                 VLLM_SCRIPT[3][2])))
        out[kind] = (rows, dict(side.front.metrics), dict(empty.front.metrics))
    for (name, ref_row), (_, port_row) in zip(out["ref"][0], out["port"][0]):
        assert port_row == ref_row, name
    rows = dict(out["port"][0])
    first = vpb.GenerateResponse.FromString(rows["generate"][0])
    assert first.finished and first.usage.completion_tokens == 6
    assert first.endpoint in {f.address for f in sides["fakes"]}
    assert [vpb.GenerateResponse.FromString(m).outputs[0].text
            for m in rows["stream"]] == ["t0 ", "t1 ", "t2 ", "t3 ", "t4 "]
    assert rows["no endpoint"][1] == grpc.StatusCode.UNAVAILABLE
    assert out["port"][1:] == out["ref"][1:]


def test_vllmgrpc_tokens_equal_jax_engine_end_to_end():
    """The slice end to end: a tiny float32 port engine behind the port's
    router and vLLM gRPC front, the JAX engine with the same weights behind
    the reference's; greedy Generate, unary and streamed, gives the same
    texts and token counts."""
    import jax
    import numpy as np

    from llmd_tpu.engine import EngineConfig as JaxEngineConfig
    from llmd_tpu.engine.server import EngineServer as JaxEngineServer
    from llmd_tpu.models import get_model_config as jax_model_config
    from llmd_tpu.models import transformer as jt
    from llmd_tpu_torch.engine import EngineConfig
    from llmd_tpu_torch.engine.server import EngineServer
    from llmd_tpu_torch.models import get_model_config
    from llmd_tpu_torch.models import transformer as tt

    kw = dict(page_size=8, num_pages=64, max_model_len=256, max_batch_size=4,
              prefill_chunk=32)
    jcfg = dataclasses.replace(jax_model_config("tiny"), dtype="float32")
    tcfg = dataclasses.replace(get_model_config("tiny"), dtype="float32")
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    npp = {k: np.asarray(v) for k, v in jp.items()}
    requests = [
        vpb.GenerateRequest(request_id="e2e-1", model="m", prompt="count to five",
                            sampling_params=vpb.SamplingParams(max_tokens=6, ignore_eos=True)),
        vpb.GenerateRequest(request_id="e2e-2", model="m", stream=True,
                            prompt_token_ids=vpb.TokenIds(values=list(range(20, 40))),
                            sampling_params=vpb.SamplingParams(max_tokens=5, ignore_eos=True))]
    lp = _Loop()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)

    async def run(kind):
        if kind == "ref":
            engine = JaxEngineServer(jcfg, JaxEngineConfig(**kw, attn_impl="reference"),
                                     model_name="m", host="127.0.0.1", port=0, params=jp)
            await engine.start()
        else:
            engine = EngineServer(tcfg, EngineConfig(**kw), model_name="m", host="127.0.0.1",
                                  port=0, params=tt.params_from_numpy(tcfg, npp), device="cpu")
            engine.start()
        ref = kind == "ref"
        pool = RefPool() if ref else PortPool()
        (ref_add_static if ref else port_add_static)(pool, [engine.address])
        cfg = (RefConfig if ref else PortConfig).from_yaml(
            CONFIG, known_types=(ref_known if ref else port_known)())
        router = (RefRouter if ref else PortRouter)(cfg, pool, host="127.0.0.1", port=0)
        await router.start()
        front = (RefFront if ref else PortFront)(router, host="127.0.0.1")
        await front.start()
        try:
            loop = asyncio.get_running_loop()
            rows = []
            for r in requests:
                rows.append(await loop.run_in_executor(
                    None, _vllm, front.address, "Generate", r, 120))
            return rows, engine.address
        finally:
            await front.stop()
            await router.stop()
            if ref:
                await engine.stop()
            else:
                engine.stop()

    try:
        out = {kind: lp.run(run(kind), timeout=300) for kind in ("ref", "port")}
    finally:
        lp.close()
        torch.set_num_threads(threads)

    def texts(rows, address):
        got = []
        for msgs in rows:
            assert not isinstance(msgs, tuple), msgs
            decoded = [vpb.GenerateResponse.FromString(m) for m in msgs]
            assert all(d.endpoint == address for d in decoded)
            got.append(("".join(d.outputs[0].text for d in decoded),
                        decoded[-1].outputs[0].finish_reason, decoded[-1].finished,
                        decoded[0].usage.completion_tokens, len(decoded)))
        return got

    ref_texts, port_texts = texts(*out["ref"]), texts(*out["port"])
    assert port_texts == ref_texts
    assert port_texts[0][3] == 6 and port_texts[1][4] >= 5


# -- crds ------------------------------------------------------------------------
DEPLOY = sorted(glob.glob(str(__import__("pathlib").Path(__file__).resolve().parent.parent
                              / "deploy" / "*" / "manifests.yaml")))


def _crd_docs(docs):
    return [d for d in docs if d and d.get("kind") in ref_crds._KINDS]


def test_manifest_sets_equal_reference():
    """The seven deploy manifests: ``load_yaml_all`` = ``yaml.safe_load_all``;
    their CRD documents give equal ``ManifestSet``s, and the whole files the
    same refusal (a Deployment is no CRD kind)."""
    assert len(DEPLOY) == 7
    n_docs = 0
    for path in DEPLOY:
        text = open(path).read()
        docs = load_yaml_all(text)
        assert docs == list(yaml.safe_load_all(text)), path
        n_docs += len(docs)
        ref = ref_crds.load_manifests(_crd_docs(docs))
        port = port_crds.load_manifests(_crd_docs(docs))
        assert dataclasses.asdict(port) == dataclasses.asdict(ref), path
        assert port.objectives_map() == ref.objectives_map()
        assert port.rewrites_map() == ref.rewrites_map()
        with pytest.raises(ref_crds.ManifestError) as r:
            ref_crds.load_manifest_yaml(text)
        with pytest.raises(port_crds.ManifestError) as p:
            port_crds.load_manifest_yaml(text)
        assert str(p.value) == str(r.value)
    assert n_docs == 22


def test_crd_errors_equal_reference():
    """``tests/test_crds.py``'s manifest and its error cases: the same sets
    and the same messages."""
    from tests.test_crds import MANIFESTS

    assert dataclasses.asdict(port_crds.load_manifest_yaml(MANIFESTS)) == dataclasses.asdict(
        ref_crds.load_manifest_yaml(MANIFESTS))
    cases = [lambda m: m.load_manifest_yaml(MANIFESTS.replace("FailOpen", "Explode")),
             lambda m: m.load_manifest_yaml(MANIFESTS.replace("poolRef: {name: pool-a}",
                                                              "poolRef: {name: nope}")),
             lambda m: m.load_manifest_yaml("kind: Gadget\nmetadata: {name: g}\n"),
             lambda m: m.InferencePool(name="x", selector={"a": "b"},
                                       target_ports=list(range(8000, 8009))),
             lambda m: m.InferencePool(name="x", selector={"a": "b"}, target_ports=[8000, 8000]),
             lambda m: m.InferencePool(name="x", selector={}, target_ports=[8000]),
             lambda m: m.InferenceModelRewrite(name="r", model="m", targets=[]),
             lambda m: m.RewriteTarget(model="t", weight=-1.0)]
    for case in cases:
        with pytest.raises(ref_crds.ManifestError) as r:
            case(ref_crds)
        with pytest.raises(port_crds.ManifestError) as p:
            case(port_crds)
        assert str(p.value) == str(r.value)


# -- the Kubernetes pod watch ------------------------------------------------------
def _pod(name: str, ip: str, ready: bool = True, labels: "dict | None" = None,
         managed: int = 0) -> dict:
    """A pod; ``managed`` bytes of managedFields make its event line long, as
    a real pod's is."""
    return {"metadata": {"name": name, "uid": f"uid-{name}",
                         "labels": {"app": "ms", **(labels or {})},
                         "managedFields": [{"fieldsV1": "f" * managed}] if managed else []},
            "status": {"phase": "Running", "podIP": ip,
                       "conditions": [{"type": "Ready", "status": "True" if ready else "False"}]}}


class FakeK8s:
    """Pods list + watch (a copy of ``tests/test_discovery.py``'s, which can
    also send an ERROR event and drop its watch streams, and writes each
    event line in two chunks)."""

    def __init__(self) -> None:
        self.pods: dict[str, dict] = {}
        self.watchers: list[asyncio.Queue] = []
        self.list_calls = 0
        self.port = 0

    async def start(self) -> None:
        app = web.Application()
        app.router.add_get("/api/v1/namespaces/{ns}/pods", self._pods)
        self._runner = web.AppRunner(app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, "127.0.0.1", 0)
        await site.start()
        self.port = site._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        self.drop()
        await self._runner.cleanup()

    async def _pods(self, request: web.Request):
        assert request.headers.get("Authorization") == "Bearer t"
        assert request.query.get("labelSelector") == "app=ms"
        if request.query.get("watch"):
            resp = web.StreamResponse()
            await resp.prepare(request)
            q: asyncio.Queue = asyncio.Queue()
            self.watchers.append(q)
            try:
                while (ev := await q.get()) is not None:
                    line = (json.dumps(ev) + "\n").encode()
                    # two chunks: a reader must join a line across them
                    await resp.write(line[:len(line) // 2])
                    await resp.write(line[len(line) // 2:])
                    if ev["type"] == "ERROR":
                        break  # an API server ends the watch after its ERROR
            finally:
                self.watchers.remove(q)
            return resp
        self.list_calls += 1
        return web.json_response({"items": list(self.pods.values()),
                                  "metadata": {"resourceVersion": str(self.list_calls)}})

    def event(self, etype: str, obj: dict) -> None:
        if etype in ("ADDED", "MODIFIED"):
            self.pods[obj["metadata"]["uid"]] = obj
        elif etype == "DELETED":
            self.pods.pop(obj["metadata"]["uid"], None)
        for q in self.watchers:
            q.put_nowait({"type": etype, "object": obj})

    def drop(self) -> None:
        for q in list(self.watchers):
            q.put_nowait(None)


def _pool_view(pool) -> set:
    return {(e.address, e.name, e.role.value, tuple(sorted(e.labels.items())), e.engine_type)
            for e in pool.list()}


def test_k8s_watch_pools_equal_reference():
    """Both packages' watches against one fake API server, two target ports:
    after every step the pools are equal and hold what the step implies (a
    200 kB event line among them)."""
    lp = _Loop()

    async def main():
        api = FakeK8s()
        await api.start()
        api.pods["uid-a"] = _pod("a", "10.1.0.1")
        api.pods["uid-p"] = _pod("p", "10.1.0.9", labels={"llm-d.ai/role": "prefill",
                                                         "llm-d.ai/engine-type": "vllm"})
        pools = {"ref": RefPool(), "port": PortPool()}
        sources = {k: cls(pools[k], {"app": "ms"}, ports=[8000, 8001], namespace="ns",
                          api_base=f"http://127.0.0.1:{api.port}", token="t",
                          rebackoff_s=0.01)
                   for k, cls in (("ref", RefWatch), ("port", PortWatch))}
        views = []

        async def step(what, expect):
            await _until(lambda: all(len(api.watchers) == 2 and
                                     {e.address for e in pools[k].list()} == expect
                                     for k in pools), what)
            assert _pool_view(pools["port"]) == _pool_view(pools["ref"]), what
            views.append((what, sorted(_pool_view(pools["port"]))))

        def both(ip):
            return {f"{ip}:8000", f"{ip}:8001"}

        for s in sources.values():
            await s.start()
        await step("list", both("10.1.0.1") | both("10.1.0.9"))
        api.event("ADDED", _pod("b", "10.1.0.2", managed=200_000))
        await step("added", both("10.1.0.1") | both("10.1.0.9") | both("10.1.0.2"))
        api.event("MODIFIED", _pod("b", "10.1.0.2", ready=False))
        await step("not ready", both("10.1.0.1") | both("10.1.0.9"))
        api.event("DELETED", _pod("a", "10.1.0.1"))
        await step("deleted", both("10.1.0.9"))
        relists = {k: s.relists for k, s in sources.items()}
        api.pods["uid-c"] = _pod("c", "10.1.0.3")  # appears while no event says so
        api.event("ERROR", {"kind": "Status", "code": 410, "reason": "Expired"})
        await step("error 410 re-list", both("10.1.0.9") | both("10.1.0.3"))
        api.pods.pop("uid-p")
        api.drop()
        await step("dropped stream re-list", both("10.1.0.3"))
        counts = {k: (s.relists - relists[k], s.events_seen) for k, s in sources.items()}
        for s in sources.values():
            await s.stop()
        await api.stop()
        return views, counts

    try:
        views, counts = lp.run(main())
    finally:
        lp.close()
    assert counts["port"] == counts["ref"] == (2, 4)
    assert ("10.1.0.9:8000", "p", "prefill", (("app", "ms"), ("llm-d.ai/engine-type", "vllm"),
                                               ("llm-d.ai/role", "prefill")), "vllm") \
        in dict(views)["list"]
