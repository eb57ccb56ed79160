"""The PyTorch port stands alone: no jax, no llmd_tpu, card by default. Its
modules and chip_smoke.py import without ``safetensors``, ``transformers``,
``aiohttp``, ``msgpack``, ``ml_dtypes``, ``yaml``, ``grpc`` and ``sklearn`` too: the
port reads safetensors itself, imports the HF tokenizer only when a caller asks
for one, serves and proxies HTTP on the standard library, writes the KV-event
wire by hand, reads its router configs with its own YAML reader and fits its
latency predictor with its own histogram GBDT."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent

# Blocks the top-level names jax, jaxlib, llmd_tpu, safetensors, transformers,
# aiohttp, msgpack, ml_dtypes, yaml, grpc and sklearn EXACTLY (a prefix match would
# also block llmd_tpu_torch), then imports every module of the port and
# chip_smoke.py, and fits and queries the latency model (the reference imports
# scikit-learn inside ``fit``, which an import-time check alone would miss).
_BLOCKED_IMPORT = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = {"jax", "jaxlib", "llmd_tpu", "safetensors", "transformers", "aiohttp",
           "msgpack", "ml_dtypes", "yaml", "grpc", "sklearn"}


class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import: {name}")
        return None


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
assert "zmq" not in sys.modules
print(len(names))
"""


def test_port_imports_without_jax_or_reference_package():
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=REPO,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) >= 45  # every module of the port was imported


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|jaxlib|llmd_tpu|ml_dtypes)\b(?!_)"
    r"|from\s+(jax|jaxlib|llmd_tpu|ml_dtypes)\b(?!_))",
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
    assert not _FORBIDDEN.search("from llmd_tpu_torch.models import x")


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
                  "testing/resp_server.py", "kvplane/plane.py", "router/ha.py"]


@pytest.mark.parametrize("module", ROUTER_MODULES)
def test_router_modules_stand_alone(module):
    """The router, the latency plane, the sidecar, the KV plane's router side
    and HA keep their own copies of the reference's modules: no jax, no
    reference package, and none of aiohttp, msgpack, yaml, grpc, sklearn or
    torch in their sources (they are host code; the blocked import is the
    subprocess above)."""
    src = (REPO / "llmd_tpu_torch" / module).read_text()
    assert not _FORBIDDEN.search(src)
    assert not re.search(r"^\s*(import|from)\s+(aiohttp|msgpack|yaml|grpc|sklearn|torch)\b",
                         src, re.M)
