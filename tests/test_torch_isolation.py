"""The PyTorch port stands alone: no jax, no llmd_tpu, card by default. Its
modules and chip_smoke.py import without ``safetensors``, ``transformers``,
``aiohttp``, ``msgpack``, ``ml_dtypes``, ``yaml``, ``grpc``, ``google`` (the
protobuf runtime) and ``sklearn`` too: the port reads safetensors itself,
imports the HF tokenizer only when a caller asks for one, serves and proxies
HTTP on the standard library, writes the KV-event wire by hand, reads its router
configs and manifests with its own YAML reader, speaks gRPC and protobuf on its
own wire and codec, and fits its latency predictor with its own histogram GBDT.
Under the same blocker the pool runs (a controller over fake replicas behind the
port's router and sidecar, and a trace replayed through it), and so do the
gateway fronts: one ext_proc stream picks an endpoint, and a pod watch re-lists
after its stream ends. So does the batch plane: one multipart upload and one
batch through the port's OpenAI Batch gateway, one item through the async
processor, and one run of the load harness. So does the tooling, with the
reference's top-level ``tools`` package blocked too: the port's lint runs
clean over the port and the manifest validator finds ``deploy/`` valid."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent

# Blocks the top-level names jax, jaxlib, llmd_tpu, safetensors, transformers,
# aiohttp, msgpack, ml_dtypes, yaml, grpc, google, sklearn and tools EXACTLY (a prefix match would
# also block llmd_tpu_torch), then imports every module of the port and
# chip_smoke.py, and fits and queries the latency model (the reference imports
# scikit-learn inside ``fit``, which an import-time check alone would miss). Then
# it runs the pool path (the reference imports aiohttp, the predictor, the
# endpoint roles, the fake server and the sidecar inside functions): one
# ``PoolController`` over a ``FakeReplicaLauncher`` with sidecars behind a
# ``RouterServer`` through floor, scale-up, drain-retire and a health sweep, and
# ``replay_trace`` of a 20-request trace through the router. Then the gateway:
# one ext_proc stream (the port's gRPC client playing Envoy) through the port's
# ``ExtProcEPP`` over a router in front of a fake replica, and a
# ``K8sWatchSource`` against a fake pods API on the port's ``HTTPServer`` that
# ends its watch once, so the source lists again. Then the batch plane: a
# multipart upload and a batch through the port's ``BatchGateway`` in front of a
# fake server, one item through the ``AsyncProcessor``, and a ``run_load`` of the
# load harness against the same fake server.
GATE_MODULES = ["ci_gate", "structured_check", "moe_check", "device_obs_check", "util_check",
                "kv_durability_check", "warm_start_probe", "dryrun", "make_checkpoint",
                "perf_regress"]

_BLOCKED_IMPORT = r"""
import importlib, importlib.abc, pkgutil, sys
GATE_MODULES = @GATE_MODULES@

BLOCKED = {"jax", "jaxlib", "llmd_tpu", "safetensors", "transformers", "aiohttp",
           "msgpack", "ml_dtypes", "yaml", "grpc", "google", "sklearn", "tools"}


class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import: {name}")
        return None


# an installed namespace package's .pth file may create an empty ``google`` at
# start-up, before anything is imported: forget it, so only an import counts
for name in [n for n in sys.modules if n.split(".")[0] in BLOCKED]:
    del sys.modules[name]
sys.meta_path.insert(0, Blocker())
try:
    import llmd_tpu  # noqa: F401
except ImportError:
    pass
else:
    raise SystemExit("the blocker let llmd_tpu through")
import llmd_tpu_torch

names = [m.name for m in pkgutil.walk_packages(llmd_tpu_torch.__path__, "llmd_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401
from llmd_tpu_torch.predictor import LatencyModel, LatencySample

samples = [LatencySample(kv_usage=i % 10 / 10, input_len=float(i), queue_depth=i % 7,
                         ttft_ms=3.0 * i + (i % 7) * 20, tpot_ms=5.0 + i % 4)
           for i in range(64)]
model = LatencyModel()
assert model.fit(samples) and model.is_fit()
assert all(t > 0 and p > 0 for t, p in model.predict(samples[:4]))

import asyncio
from llmd_tpu_torch.core.config import FrameworkConfig
from llmd_tpu_torch.core.endpoint import EndpointPool
from llmd_tpu_torch.pool import FakeReplicaLauncher, PoolConfig, PoolController
from llmd_tpu_torch.pool.harness import replay_trace
from llmd_tpu_torch.pool.traces import bursty_trace
from llmd_tpu_torch.router.plugins import known_plugin_types
from llmd_tpu_torch.router.server import RouterServer
from llmd_tpu_torch.testing.fake_server import FakeServerConfig

POOL_ROUTER_CFG = '''
plugins:
  - {name: inflight, type: inflight-load-producer}
  - {name: queue, type: queue-depth-scorer}
schedulingProfiles:
  - name: default
    plugins:
      - {pluginRef: queue, weight: 1}
'''


async def pool_path():
    pool = EndpointPool()
    router = RouterServer(FrameworkConfig.from_yaml(POOL_ROUTER_CFG,
                                                    known_types=known_plugin_types()),
                          pool, port=0, poll_interval_s=0.05)
    await router.start()
    launcher = FakeReplicaLauncher(server_config=FakeServerConfig(
        prefill_us_per_token=0.0, decode_us_per_token=0.0), with_sidecar=True)
    ctl = PoolController(PoolConfig(min_replicas=1, max_replicas=3, interval_s=3600,
                                    sfz_interval_s=3600, policy="hpa"), launcher,
                         router=router)
    await ctl.start()
    try:
        assert len(ctl.replicas) == 1 and len(pool.list()) == 1
        await ctl.scale_to(3, reason="up")
        await ctl.scale_to(2, reason="down")  # drain + retire
        assert len(ctl.replicas) == 2 and len(pool.list()) == 2
        await launcher.kill(next(iter(ctl.replicas.values())))
        await ctl._health_sweep()
        assert len(ctl.replicas) == 1 and len(pool.list()) == 1
        trace = bursty_trace(duration_s=4, base_rps=10, burst_rps=10, seed=1)[:20]
        report = await replay_trace(router.address, trace, time_scale=0.1)
        assert report.total == len(trace) == 20 and report.statuses == {"200": 20}, \
            report.summary()
    finally:
        await ctl.stop()
        await router.stop()
    return ctl.status()


status = asyncio.run(pool_path())
assert len(status["launches"]) == 3 and status["ready_replicas"] == 0, status


async def gateway_path():
    import json
    from llmd_tpu_torch.router import ext_proc_pb as pb
    from llmd_tpu_torch.router.discovery import K8sWatchSource
    from llmd_tpu_torch.router.extproc import ENVOY_SERVICE, HDR_DESTINATION, ExtProcEPP
    from llmd_tpu_torch.router.grpc_wire import Channel
    from llmd_tpu_torch.router.http import HTTPServer, StreamResponse, json_response
    from llmd_tpu_torch.testing.fake_server import FakeModelServer

    fake = FakeModelServer(FakeServerConfig(), port=0)
    await fake.start()
    pool = EndpointPool()
    from llmd_tpu_torch.router.datalayer import add_static_endpoints
    add_static_endpoints(pool, [fake.address])
    router = RouterServer(FrameworkConfig.from_yaml(POOL_ROUTER_CFG,
                                                    known_types=known_plugin_types()),
                          pool, host="127.0.0.1", port=0, poll_interval_s=0.05)
    await router.start()
    epp = ExtProcEPP(router, host="127.0.0.1")
    await epp.start()
    ch = Channel(epp.address)
    call = ch.stream_stream(f"/{ENVOY_SERVICE}/Process",
                            request_serializer=pb.ProcessingRequest.SerializeToString,
                            response_deserializer=pb.ProcessingResponse.FromString)()
    await call.write(pb.ProcessingRequest(request_headers=pb.HttpHeaders(headers=pb.HeaderMap(
        headers=[pb.HeaderValue(key=":path", raw_value=b"/v1/completions")]))))
    assert (await call.read()).WhichOneof("response") == "request_headers"
    await call.write(pb.ProcessingRequest(request_body=pb.HttpBody(
        body=json.dumps({"model": "m", "prompt": "p"}).encode(), end_of_stream=True)))
    picked = (await call.read()).request_body.response.header_mutation.set_headers
    assert {o.header.key: o.header.raw_value for o in picked}[HDR_DESTINATION] ==         fake.address.encode()
    await call.done_writing()
    assert await call.read() is None
    await ch.close()
    await epp.stop()
    await router.stop()
    await fake.stop()

    pod = {"metadata": {"name": "a", "uid": "u-a", "labels": {"app": "ms"}},
           "status": {"phase": "Running", "podIP": "10.0.0.1",
                      "conditions": [{"type": "Ready", "status": "True"}]}}
    lists = []

    async def pods(request):
        if request.query.get("watch"):
            resp = StreamResponse(headers={"content-type": "application/json"})
            await resp.prepare(request)
            await resp.write(json.dumps({"type": "BOOKMARK", "object": {}}).encode() + b"\n")
            return resp  # the watch ends: the source lists again
        lists.append(1)
        return json_response({"items": [pod], "metadata": {"resourceVersion": "1"}})

    api = HTTPServer()
    api.add_route("GET", "/api/v1/namespaces/{ns}/pods", pods)
    port = await api.start("127.0.0.1", 0)
    watched = EndpointPool()
    src = K8sWatchSource(watched, {"app": "ms"}, [8000], api_base=f"http://127.0.0.1:{port}",
                         token="t", rebackoff_s=0.01)
    await src.start()
    for _ in range(500):
        if src.relists >= 2:
            break
        await asyncio.sleep(0.01)
    await src.stop()
    await api.stop()
    assert src.relists >= 2 and src.events_seen >= 1, (src.relists, src.events_seen)
    assert [e.address for e in watched.list()] == ["10.0.0.1:8000"]


asyncio.run(gateway_path())


async def batch_path():
    import tempfile
    from llmd_tpu_torch.batch import (AsyncItem, AsyncProcessor, AsyncProcessorConfig,
                                      BatchGateway, BatchGatewayConfig, MemoryQueuePuller)
    from llmd_tpu_torch.benchmark import WorkloadSpec, build_requests, run_load
    from llmd_tpu_torch.router.http import HTTPClient
    from llmd_tpu_torch.testing.fake_server import FakeModelServer

    fake = FakeModelServer(FakeServerConfig(prefill_us_per_token=0.0,
                                            decode_us_per_token=0.0))
    await fake.start()
    root = tempfile.mkdtemp()
    gw = BatchGateway(BatchGatewayConfig(target_url=f"http://{fake.address}",
                                         files_root=root + "/files",
                                         store_path=root + "/b.db"))
    await gw.start()
    client = HTTPClient()
    try:
        lines = "\n".join('{"custom_id": "c%d", "url": "/v1/completions", "body": '
                          '{"prompt": "p%d", "max_tokens": 2}}' % (i, i) for i in range(3))
        body = (b"--b1\r\nContent-Disposition: form-data; name=file; filename=in.jsonl"
                b"\r\n\r\n" + lines.encode() + b"\r\n--b1--\r\n")
        r = await client.request("POST", f"http://{gw.address}/v1/files", body=body,
                                 headers={"content-type": "multipart/form-data; boundary=b1"})
        fid = (await r.json())["id"]
        r = await client.request("POST", f"http://{gw.address}/v1/batches",
                                 json_body={"input_file_id": fid})
        bid = (await r.json())["id"]
        for _ in range(1000):
            if gw.store.get(bid).status == "completed":
                break
            await asyncio.sleep(0.01)
        row = gw.store.get(bid)
        assert (row.status, row.completed) == ("completed", 3), row
        results = []
        q = MemoryQueuePuller()
        proc = AsyncProcessor(AsyncProcessorConfig(target_url=f"http://{fake.address}",
                                                   num_workers=1, seed=0), q,
                              on_result=lambda item, res: results.append(res))
        await proc.start()
        await q.put(AsyncItem(id="a", url="/v1/completions", body={"prompt": "x"}))
        for _ in range(1000):
            if results:
                break
            await asyncio.sleep(0.01)
        await proc.stop()
        assert results and results[0]["choices"], results
        spec = WorkloadSpec(kind="shared-prefix", num_requests=6, max_tokens=2,
                            prefix_words=6, prompt_words=10)
        res = await run_load(fake.address, build_requests(spec), concurrency=2, stream=True)
        assert res.errors == 0 and len(res.ttfts) == 6, res.summary()
    finally:
        await client.close()
        await gw.stop()
        await fake.stop()


asyncio.run(batch_path())

# the port's tooling: its lint over the port and the manifest validator over
# deploy/ (the reference's tools/ package is blocked above)
import contextlib, io
from llmd_tpu_torch.tools.llmd_lint.__main__ import main as lint_main
from llmd_tpu_torch.tools.validate_manifests import validate

with contextlib.redirect_stdout(io.StringIO()) as lint_out:
    assert lint_main([]) == 0, lint_out.getvalue()[-3000:]
assert "llmd-lint: OK" in lint_out.getvalue()
assert validate("deploy") == []

# the gate: its roster, and the comparator over the pinned files
import argparse
from llmd_tpu_torch.tools import ci_gate, perf_regress

roster = ci_gate.stages(argparse.Namespace(quick=True, cpu=True, skip_tests=True,
                                           skip_bench=False, skip_dryrun=False))
assert roster[0][0] == "lint-envvars" and roster[-1][0] == "dryrun-multichip-2"
with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
    assert perf_regress.main(["--candidate", "BENCH_CAMPAIGN_r05.json",
                              "--baseline", "BENCH_r05.json"]) == 0

leaked = sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)
assert not leaked, leaked
# the serving surface's modules are among them; pyzmq is imported only when a
# server publishes KV events
assert {"llmd_tpu_torch.obs.metrics", "llmd_tpu_torch.core.metrics_contract",
        "llmd_tpu_torch.engine.kv_publisher", "llmd_tpu_torch.engine.server"} <= set(names)
# so are the speculative and structured modules
assert {"llmd_tpu_torch.structured", "llmd_tpu_torch.structured.regex_dfa",
        "llmd_tpu_torch.structured.json_schema", "llmd_tpu_torch.structured.grammar",
        "llmd_tpu_torch.structured.cache", "llmd_tpu_torch.engine.spec",
        "llmd_tpu_torch.engine.verify_program", "llmd_tpu_torch.engine.programs"} <= set(names)
# and the fp8 pool's: both kernels' wrappers, the write path, the engine, its
# config and CLI, the bench and the profiler
assert {"llmd_tpu_torch.ops.paged_attention", "llmd_tpu_torch.ops.mla_decode",
        "llmd_tpu_torch.models.transformer", "llmd_tpu_torch.engine.config",
        "llmd_tpu_torch.engine.engine", "llmd_tpu_torch.engine.serve",
        "llmd_tpu_torch.tools.bench", "llmd_tpu_torch.tools.profile_engine"} <= set(names)
# and the KV data plane's: transfer, the offload tiers, the connector seam,
# the remote store, the durable tier, the dtype names, the engine's KV-plane pulls
assert {"llmd_tpu_torch.disagg.transfer", "llmd_tpu_torch.kv.dtypes",
        "llmd_tpu_torch.kv.fs_backend", "llmd_tpu_torch.kv.offload",
        "llmd_tpu_torch.kv.connector_api", "llmd_tpu_torch.kv.remote_store",
        "llmd_tpu_torch.kv.writeback", "llmd_tpu_torch.kvplane.pull",
        "llmd_tpu_torch.native.build"} <= set(names)
# and multi-adapter LoRA's (the embed program lives in the engine)
assert "llmd_tpu_torch.models.lora" in names
# and multimodal serving's: the vision tower and the encode worker
assert {"llmd_tpu_torch.models.vision", "llmd_tpu_torch.disagg.encode"} <= set(names)
# and the observability plane's: tracing, the flight recorder, the phase and
# decision ledgers, the device plane
assert {"llmd_tpu_torch.obs.tracing", "llmd_tpu_torch.obs.events",
        "llmd_tpu_torch.obs.attribution", "llmd_tpu_torch.obs.decisions",
        "llmd_tpu_torch.obs.device"} <= set(names)
# and the launch surface's: K1's launch-config table, the DP rank groups
assert {"llmd_tpu_torch.ops.attn_tune", "llmd_tpu_torch.engine.dp_group",
        "llmd_tpu_torch.tools.timing"} <= set(names)
# and the mesh's: the rank mesh, the world launcher and its worker, the ring,
# the rank-side checks
assert {"llmd_tpu_torch.parallel.mesh", "llmd_tpu_torch.parallel.launch",
        "llmd_tpu_torch.parallel.worker", "llmd_tpu_torch.ops.ring_attention",
        "llmd_tpu_torch.parallel.checks"} <= set(names)
# and what moves LoRA, the masked tables, media rows and KV pages over the
# mesh: the bank, the programs, the data plane's modules, the server
assert {"llmd_tpu_torch.models.lora", "llmd_tpu_torch.engine.decode_program",
        "llmd_tpu_torch.engine.verify_program", "llmd_tpu_torch.disagg.transfer",
        "llmd_tpu_torch.kv.offload", "llmd_tpu_torch.kv.writeback",
        "llmd_tpu_torch.kv.connector_api", "llmd_tpu_torch.kvplane.pull",
        "llmd_tpu_torch.engine.server", "llmd_tpu_torch.engine.serve"} <= set(names)
# and the router's: config, endpoints, plugins, scheduler, KV index and
# subscriber, data layer, discovery, flow control, resilience, the HTTP layer,
# the server and its CLI, and the router plane of obs
assert {"llmd_tpu_torch.core.config", "llmd_tpu_torch.core.endpoint",
        "llmd_tpu_torch.router", "llmd_tpu_torch.router.plugins",
        "llmd_tpu_torch.router.scorers", "llmd_tpu_torch.router.filters_pickers",
        "llmd_tpu_torch.router.scheduler", "llmd_tpu_torch.kv.indexer",
        "llmd_tpu_torch.kv.index_backends", "llmd_tpu_torch.kv.plugins",
        "llmd_tpu_torch.kv.subscriber", "llmd_tpu_torch.router.datalayer",
        "llmd_tpu_torch.router.discovery", "llmd_tpu_torch.router.flowcontrol",
        "llmd_tpu_torch.router.resilience", "llmd_tpu_torch.router.http",
        "llmd_tpu_torch.router.server", "llmd_tpu_torch.router.serve",
        "llmd_tpu_torch.obs.fleet", "llmd_tpu_torch.obs.decisions"} <= set(names)
# and the latency plane's, the sidecar's, the KV plane's router side and HA
assert {"llmd_tpu_torch.predictor", "llmd_tpu_torch.predictor.gbdt",
        "llmd_tpu_torch.predictor.model", "llmd_tpu_torch.predictor.client",
        "llmd_tpu_torch.predictor.server", "llmd_tpu_torch.obs.slo",
        "llmd_tpu_torch.router.latency_plugins", "llmd_tpu_torch.router.calibrator",
        "llmd_tpu_torch.disagg.sidecar", "llmd_tpu_torch.testing.resp_server",
        "llmd_tpu_torch.kvplane.plane", "llmd_tpu_torch.router.ha"} <= set(names)
# and the pool's: autoscaling, the controller, launchers, snapshots, traces, the
# harness, the P/D pool set, the fake server and the two gates
assert {"llmd_tpu_torch.autoscaling", "llmd_tpu_torch.autoscaling.hpa",
        "llmd_tpu_torch.autoscaling.wva", "llmd_tpu_torch.pool",
        "llmd_tpu_torch.pool.controller", "llmd_tpu_torch.pool.launcher",
        "llmd_tpu_torch.pool.snapshot", "llmd_tpu_torch.pool.traces",
        "llmd_tpu_torch.pool.harness", "llmd_tpu_torch.pool.disagg",
        "llmd_tpu_torch.testing.fake_server", "llmd_tpu_torch.tools.slo_check",
        "llmd_tpu_torch.tools.pd_check"} <= set(names)
# and the gateway's: the manifests, the gRPC wire, the protobuf codec and its two
# message subsets, the two fronts
assert {"llmd_tpu_torch.core.crds", "llmd_tpu_torch.router.grpc_wire",
        "llmd_tpu_torch.router.protobuf", "llmd_tpu_torch.router.ext_proc_pb",
        "llmd_tpu_torch.router.vllm_grpc_pb", "llmd_tpu_torch.router.extproc",
        "llmd_tpu_torch.router.vllmgrpc"} <= set(names)
# and the batch plane's, the load harness, its consumer and the last gates
assert {"llmd_tpu_torch.batch", "llmd_tpu_torch.batch.store", "llmd_tpu_torch.batch.files",
        "llmd_tpu_torch.batch.gateway", "llmd_tpu_torch.batch.async_processor",
        "llmd_tpu_torch.benchmark", "llmd_tpu_torch.benchmark.harness",
        "llmd_tpu_torch.benchmark.__main__", "llmd_tpu_torch.tools.run_sched_comparison",
        "llmd_tpu_torch.tools.chaos_check", "llmd_tpu_torch.tools.kv_plane_check",
        "llmd_tpu_torch.tools.decision_check", "llmd_tpu_torch.tools.predictor_accuracy",
        "llmd_tpu_torch.tools.perf_regress"} <= set(names)
# and the tooling's: the lint framework and its shims, the operator CLIs
assert {"llmd_tpu_torch.tools.llmd_lint", "llmd_tpu_torch.tools.llmd_lint.core",
        "llmd_tpu_torch.tools.llmd_lint.config", "llmd_tpu_torch.tools.llmd_lint.locks",
        "llmd_tpu_torch.tools.llmd_lint.hotpath", "llmd_tpu_torch.tools.llmd_lint.envcontract",
        "llmd_tpu_torch.tools.llmd_lint.metrics_contract",
        "llmd_tpu_torch.tools.llmd_lint.events_contract",
        "llmd_tpu_torch.tools.llmd_lint.__main__", "llmd_tpu_torch.tools.lint_envvars",
        "llmd_tpu_torch.tools.lint_events", "llmd_tpu_torch.tools.lint_metrics",
        "llmd_tpu_torch.tools.dump_flight", "llmd_tpu_torch.tools.rollout",
        "llmd_tpu_torch.tools.validate_manifests",
        "llmd_tpu_torch.tools.predictor_offline"} <= set(names)
# and the one-command gate's: the gates it composes, the dry run, the checkpoint CLI
assert {"llmd_tpu_torch.tools." + m for m in GATE_MODULES} <= set(names)
assert "zmq" not in sys.modules
print(len(names))
"""


def test_port_imports_without_jax_or_reference_package():
    script = _BLOCKED_IMPORT.replace("@GATE_MODULES@", repr(GATE_MODULES))
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) >= 45  # every module of the port was imported


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|jaxlib|llmd_tpu|ml_dtypes|tools|yaml|aiohttp)\b(?!_)"
    r"|from\s+(jax|jaxlib|llmd_tpu|ml_dtypes|tools|yaml|aiohttp)\b(?!_))",
    re.M)


def test_source_scan_finds_no_jax_or_reference_imports():
    files = sorted((REPO / "llmd_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) >= 48
    hits = [f"{p.relative_to(REPO)}: {m.group(0).strip()}"
            for p in files for m in _FORBIDDEN.finditer(p.read_text())]
    assert not hits, hits
    # the pattern itself tells the names apart
    assert _FORBIDDEN.search("from llmd_tpu.models import x")
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert _FORBIDDEN.search("    import ml_dtypes  # noqa")
    assert _FORBIDDEN.search("from tools.llmd_lint import core")
    assert _FORBIDDEN.search("    import yaml")
    assert not _FORBIDDEN.search("from llmd_tpu_torch.models import x")
    assert not _FORBIDDEN.search("from llmd_tpu_torch.tools.llmd_lint import core")


def test_lora_module_stands_alone():
    """``models/lora.py`` keeps its own copy of the reference's pure-Python
    registry: its source imports nothing of jax or the reference package,
    and it is importable with both blocked (the subprocess above)."""
    src = (REPO / "llmd_tpu_torch" / "models" / "lora.py").read_text()
    assert not _FORBIDDEN.search(src)
    assert "class LoRARegistry" in src


def test_engine_defaults_to_the_card(monkeypatch):
    from llmd_tpu_torch.engine import EngineConfig, LLMEngine
    from llmd_tpu_torch.models import get_model_config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLMEngine(get_model_config("tiny"), EngineConfig())
    with pytest.raises(RuntimeError):
        LLMEngine(get_model_config("tiny"), EngineConfig(), device="cuda")


@pytest.mark.parametrize("module", ["models/vision.py", "disagg/encode.py"])
def test_multimodal_modules_stand_alone(module):
    """The tower and the encode worker keep their own copies of the
    reference's helpers: their sources import nothing of jax, the reference
    package, aiohttp or msgpack (the import with all of them blocked is the
    subprocess above)."""
    src = (REPO / "llmd_tpu_torch" / module).read_text()
    assert not _FORBIDDEN.search(src)
    assert not re.search(r"^\s*(import|from)\s+(aiohttp|msgpack)\b", src, re.M)


@pytest.mark.parametrize("module", ["obs/tracing.py", "obs/events.py", "obs/attribution.py",
                                    "obs/decisions.py", "obs/device.py", "engine/server.py"])
def test_observability_modules_stand_alone(module):
    """The observability plane keeps its own copies of the reference's
    tracing, flight recorder and ledgers: no jax, no reference package, no
    aiohttp or msgpack in their sources (the blocked import is the
    subprocess above)."""
    src = (REPO / "llmd_tpu_torch" / module).read_text()
    assert not _FORBIDDEN.search(src)
    assert not re.search(r"^\s*(import|from)\s+(aiohttp|msgpack)\b", src, re.M)


def test_tower_defaults_to_the_card(monkeypatch):
    """``VisionRunner`` and the encode worker's entry point put the tower on
    the card unless the caller asks for the CPU."""
    from llmd_tpu_torch.disagg import encode
    from llmd_tpu_torch.models import get_model_config

    cfg = get_model_config("tiny-vl")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        encode.VisionRunner(cfg)
    assert encode.VisionRunner(cfg, device="cpu").device == torch.device("cpu")
    seen = []

    class Stop(Exception):
        pass

    class Recorder:
        def __init__(self, cfg, host, port, device=None):
            seen.append(device)
            raise Stop

    monkeypatch.setattr(encode, "EncodeServer", Recorder)
    for argv in ([], ["--cpu"]):
        with pytest.raises(Stop):
            encode.main(["--model", "tiny-vl", "--port", "0", *argv])
    assert seen == [None, "cpu"]


@pytest.mark.parametrize("module", ["parallel/mesh.py", "parallel/launch.py",
                                    "parallel/worker.py", "parallel/checks.py",
                                    "ops/ring_attention.py", "../tests/torch_mesh_worker.py"])
def test_mesh_modules_stand_alone(module):
    """The mesh keeps its own copies of the reference's ``MeshConfig``, rules
    and logical axes, and the world script of the mesh tests runs the port
    alone: none imports jax or the reference package (the port's modules
    import with both blocked in the subprocess above)."""
    src = (REPO / "llmd_tpu_torch" / module).resolve().read_text()
    assert not _FORBIDDEN.search(src)
    if module == "parallel/mesh.py":
        assert all(f in src for f in ("class MeshConfig", "DEFAULT_RULES = ",
                                      "def param_logical_axes"))


ROUTER_MODULES = ["core/config.py", "core/endpoint.py", "core/request.py",
                  "router/__init__.py", "router/plugins.py", "router/scorers.py",
                  "router/filters_pickers.py", "router/scheduler.py", "kv/indexer.py",
                  "kv/index_backends.py", "kv/plugins.py", "kv/subscriber.py",
                  "router/datalayer.py", "router/discovery.py", "router/flowcontrol.py",
                  "router/resilience.py", "router/http.py", "router/server.py",
                  "router/serve.py", "obs/fleet.py", "obs/decisions.py", "obs/metrics.py",
                  "predictor/__init__.py", "predictor/gbdt.py", "predictor/model.py",
                  "predictor/client.py", "predictor/server.py", "obs/slo.py",
                  "router/latency_plugins.py", "router/calibrator.py", "disagg/sidecar.py",
                  "testing/resp_server.py", "kvplane/plane.py", "router/ha.py",
                  "autoscaling/__init__.py", "autoscaling/hpa.py", "autoscaling/wva.py",
                  "pool/__init__.py", "pool/snapshot.py", "pool/traces.py", "pool/launcher.py",
                  "pool/controller.py", "pool/harness.py", "pool/disagg.py",
                  "testing/fake_server.py", "tools/slo_check.py", "tools/pd_check.py",
                  "core/crds.py", "router/grpc_wire.py", "router/protobuf.py",
                  "router/ext_proc_pb.py", "router/vllm_grpc_pb.py", "router/extproc.py",
                  "router/vllmgrpc.py", "batch/__init__.py", "batch/store.py", "batch/files.py",
                  "batch/gateway.py", "batch/async_processor.py", "benchmark/__init__.py",
                  "benchmark/__main__.py", "benchmark/harness.py",
                  "tools/run_sched_comparison.py", "tools/chaos_check.py",
                  "tools/kv_plane_check.py", "tools/decision_check.py",
                  "tools/predictor_accuracy.py", "tools/perf_regress.py"]


@pytest.mark.parametrize("module", ROUTER_MODULES)
def test_router_modules_stand_alone(module):
    """The router, the latency plane, the sidecar, the KV plane's router side,
    HA, the autoscaling plane, the pool, the fake server, the pool's gates, the
    gateway fronts, the batch plane, the load harness and the last gates keep
    their own copies of the reference's modules: no
    jax, no reference package, and none of aiohttp, msgpack, yaml, grpc, google,
    sklearn or torch in their sources (they are host code; the blocked import
    is the subprocess above)."""
    src = (REPO / "llmd_tpu_torch" / module).read_text()
    assert not _FORBIDDEN.search(src)
    assert not re.search(
        r"^\s*(import|from)\s+(aiohttp|msgpack|yaml|grpc|google|sklearn|torch)\b", src, re.M)


@pytest.mark.parametrize("module", GATE_MODULES)
def test_gate_modules_stand_alone(module):
    """The one-command gate and the gates, dry run and CLIs it composes keep
    their own copies of the reference's ``tools/`` scripts and
    ``__graft_entry__.py``: no jax, no reference package, no ``tools`` and no
    ``__graft_entry__`` in their sources (the blocked import is the subprocess
    above; ``perf_regress`` is host code, with no torch either)."""
    src = (REPO / "llmd_tpu_torch" / "tools" / f"{module}.py").read_text()
    assert not _FORBIDDEN.search(src)
    assert not re.search(r"^\s*(import|from)\s+(__graft_entry__|aiohttp|msgpack)\b", src, re.M)
    assert "__graft_entry__ import" not in src
