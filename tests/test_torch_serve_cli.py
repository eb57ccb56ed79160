"""The serve CLI (``llmd_tpu_torch/engine/serve.py``) against the reference's
``llmd_tpu/engine/serve.py``, so a pool launches a port replica with the argv
it builds for a JAX one.

- Every reference flag is taken, and each maps onto the ``EngineConfig``
  field the reference's CLI maps it to (the reference's main run with its
  config captured, the port's ``engine_config`` beside it), with the same
  ``LLMD_*`` environment defaults; ``--seed`` is the port's own.
- Flags the port cannot serve yet exit non-zero naming their ROADMAP item;
  ``--data/--expert/--tensor/--sequence-parallel-size`` build the
  reference's ``MeshConfig``, and one ``--tensor-parallel-size 2 --cpu``
  world (rank 0 serving, rank 1 its own process over gloo) answers a
  completion.
- ``llmd_tpu.pool.launcher.engine_argv`` (a warm start: a snapshot's
  checkpoint and ``--compile-cache-dir``), the module swapped, parses; one
  ``--cpu`` launch of it answers ``/health`` and builds its native library
  into the cache directory.
- ``native/build.set_cache_dir`` resolves the build paths into its directory.
- A dropped engine and a stopped server free their tensors at their last
  reference, with the cycle collector off.
"""

import gc
import json
import os
import re
import signal
import subprocess
import sys
import time
import types
import urllib.request
import weakref
from pathlib import Path

import pytest
import torch

from llmd_tpu_torch.core.request import SamplingParams
from llmd_tpu_torch.engine import serve
from llmd_tpu_torch.engine.config import EngineConfig, MeshConfig
from llmd_tpu_torch.engine.engine import LLMEngine
from llmd_tpu_torch.engine.server import EngineServer
from llmd_tpu_torch.models import get_model_config
from llmd_tpu_torch.native import build
from torch_mesh_worker import TAG_VAR, reap_tag

REPO = Path(__file__).resolve().parent.parent
REF_SERVE = REPO / "llmd_tpu" / "engine" / "serve.py"


class _Captured(Exception):
    pass


def _reference_config(monkeypatch, argv: list) -> dict:
    """The EngineConfig keyword arguments the reference's CLI builds from
    ``argv`` (its main run up to the config, which is captured)."""
    import llmd_tpu.engine.config as ref_config
    from llmd_tpu.engine import serve as ref_serve

    seen = {}

    def capture(**kw):
        seen.update(kw)
        raise _Captured

    monkeypatch.setattr(ref_config, "EngineConfig", capture)
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    with pytest.raises(_Captured):
        ref_serve.main()
    return seen


def _same(ref_kw: dict, port: EngineConfig) -> None:
    """Every field the reference sets equals the port's (the mesh and LoRA
    compared by their numbers)."""
    for name, value in ref_kw.items():
        if name == "mesh":
            assert (port.mesh.dp, port.mesh.sp, port.mesh.ep, port.mesh.tp) == (
                value.dp, value.sp, value.ep, value.tp), (port.mesh, value)
            continue
        got = getattr(port, name)
        if name == "lora" and value is not None:
            assert (got.max_adapters, got.rank) == (value.max_adapters, value.rank)
            continue
        assert got == value, (name, got, value)


def test_every_reference_flag_is_taken():
    ref_flags = set(re.findall(r'ap\.add_argument\(\s*"(--[a-z0-9-]+)"', REF_SERVE.read_text()))
    port_flags = {a for act in serve.build_parser()._actions for a in act.option_strings
                  if a.startswith("--")}
    assert ref_flags and ref_flags <= port_flags
    assert port_flags - ref_flags == {"--help", "--seed"}


@pytest.mark.parametrize("argv", [
    [],
    ["--block-size", "8", "--num-pages", "64", "--max-model-len", "512",
     "--max-batch-size", "4", "--prefill-chunk", "32", "--decode-steps", "2",
     "--role", "prefill"],
    ["--spec-mode", "ngram", "--spec-tokens", "3", "--spec-ngram-max", "4",
     "--spec-ngram-min", "2", "--decode-chain-depth", "3", "--pack-overlap", "off"],
    ["--structured-mode", "off", "--structured-fused", "off", "--structured-table-elems",
     "1024", "--spec-structured", "off", "--spec-structured-crosscheck", "on"],
    ["--attn-impl", "reference", "--attn-tune-file", "/x/tune.json", "--moe-dispatch",
     "einsum", "--quantize", "int8", "--kv-cache-dtype", "fp8"],
    ["--cpu-offload-pages", "4", "--offload-fs-path", "/x/fs", "--enable-lora",
     "--max-loras", "3", "--max-lora-rank", "2", "--decode-chain-depth", "0"],
    ["--data-parallel-size", "2", "--attn-impl", "pallas"],
])
def test_flags_reach_the_reference_fields(monkeypatch, argv):
    _same(_reference_config(monkeypatch, ["--cpu", *argv]),
          serve.engine_config(serve.parse_args(argv)))


def test_environment_defaults_are_the_reference(monkeypatch):
    env = {"LLMD_SPEC_MODE": "ngram", "LLMD_SPEC_TOKENS": "2", "LLMD_SPEC_NGRAM_MAX": "5",
           "LLMD_SPEC_NGRAM_MIN": "2", "LLMD_STRUCTURED_MODE": "off",
           "LLMD_DECODE_CHAIN_DEPTH": "1", "LLMD_PACK_OVERLAP": "off",
           "LLMD_STRUCTURED_FUSED": "off", "LLMD_STRUCTURED_TABLE_ELEMS": "4096",
           "LLMD_SPEC_STRUCTURED": "off", "LLMD_SPEC_STRUCTURED_CROSSCHECK": "on",
           "LLMD_ATTN_TUNE_FILE": "/x/t.json", "LLMD_MOE_DISPATCH": "einsum"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    _same(_reference_config(monkeypatch, ["--cpu"]), serve.engine_config(serve.parse_args([])))
    monkeypatch.setenv("LLMD_TPU_PORT", "8123")
    monkeypatch.setenv("LLMD_TPU_KV_EVENTS_PORT", "5999")
    monkeypatch.setenv("LLMD_TPU_KV_TRANSFER_PORT", "9100")
    args = serve.parse_args([])
    assert (args.port, args.kv_events_port, args.kv_transfer_port) == (8123, 5999, 9100)


@pytest.mark.parametrize("argv,item", [
    (["--kv-layout", "packed"], "not ported by design"),
    (["--kv-layout", "padded"], "not ported by design"),
])
def test_unserved_flags_exit_naming_their_item(capsys, argv, item):
    with pytest.raises(SystemExit) as e:
        serve.parse_args(argv)
    assert e.value.code != 0
    err = capsys.readouterr().err
    assert "not served by the port" in err and item in err and argv[0] in err
    # auto and 1 are taken
    serve.parse_args(["--kv-layout", "auto", "--expert-parallel-size", "1"])


@pytest.mark.parametrize("argv,mesh", [
    (["--expert-parallel-size", "2"], dict(ep=2)),
    (["--tensor-parallel-size", "2"], dict(tp=2)),
    (["--sequence-parallel-size", "4", "--data-parallel-size", "2"], dict(sp=4, dp=2)),
])
def test_parallel_flags_build_the_reference_mesh(monkeypatch, capsys, argv, mesh):
    """The parallel sizes are served: the port's ``MeshConfig`` is the one
    the reference's serve builds from the same flags; 0 exits non-zero."""
    cfg = serve.engine_config(serve.parse_args(argv))
    assert cfg.mesh == MeshConfig(**mesh) and cfg.dp_ranks == mesh.get("dp", 1)
    _same(_reference_config(monkeypatch, ["--cpu", *argv]), cfg)
    with pytest.raises(SystemExit) as e:
        serve.parse_args([argv[0], "0"])
    assert e.value.code != 0 and argv[0] in capsys.readouterr().err


def _post(addr: str, body: dict) -> tuple[int, dict]:
    req = urllib.request.Request(f"http://{addr}/v1/completions",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def test_tensor_parallel_cpu_world_serves(tmp_path):
    """``serve --tensor-parallel-size 2 --cpu``: this process's serve is rank
    0 of a gloo world, rank 1 its own process; a completion comes back, and
    an interrupt stops the world (no rank process outlives it)."""
    tag = os.urandom(8).hex()
    proc = subprocess.Popen(
        [sys.executable, "-m", "llmd_tpu_torch.engine.serve", "--model", "tiny", "--cpu",
         "--host", "127.0.0.1", "--port", "0", "--num-pages", "32", "--max-model-len", "128",
         "--max-batch-size", "2", "--tensor-parallel-size", "2"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=open(tmp_path / "err", "w"), text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1", TAG_VAR: tag}, start_new_session=True)
    try:
        line = proc.stdout.readline()
        assert "serving llmd-tpu/tiny" in line and "mesh sp=1 ep=1 tp=2" in line, (
            line, (tmp_path / "err").read_text()[-3000:])
        addr = line.split("http://")[1].split()[0]
        status, body = _post(addr, {"prompt": "hello mesh", "max_tokens": 4,
                                    "temperature": 0})
        assert status == 200 and body["usage"]["completion_tokens"] == 4
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        reap_tag(tag)


def _two_free_ports() -> int:
    """A port P with P and P + 1 both free (two rank publishers)."""
    import socket

    for _ in range(50):
        with socket.socket() as a:
            a.bind(("127.0.0.1", 0))
            p = a.getsockname()[1]
            with socket.socket() as b:
                try:
                    b.bind(("127.0.0.1", p + 1))
                except OSError:
                    continue
        return p
    raise RuntimeError("no two adjacent free ports")


def test_data_parallel_ranks_publish_kv_events_on_their_ports(monkeypatch, capsys):
    """``--data-parallel-size 2 --kv-events-port P``: rank r publishes on
    P + r under its own endpoint's topic, and a completion on rank 1's port
    reaches rank 1's subscriber only."""
    import zmq

    from llmd_tpu_torch.core.kv_events import BlockStored, decode_event_batch

    torch.set_num_threads(1)
    base = _two_free_ports()
    seen: dict = {}

    class _Serving:  # serve's wait: the checks, then the Ctrl-C that stops it
        def wait(self):
            line = capsys.readouterr().out
            seen["line"] = line
            eps = re.search(r"rank engines on \[([^\]]*)\]", line).group(1)
            eps = [e.strip().strip("'") for e in eps.split(",")]
            ports = [int(p) for p in re.search(r"KV events on ports \[([^\]]*)\]",
                                               line).group(1).split(",")]
            seen["eps"], seen["ports"] = eps, ports
            ctx = zmq.Context()
            subs = [ctx.socket(zmq.SUB) for _ in ports]
            try:
                for sub, port in zip(subs, ports):
                    sub.setsockopt(zmq.SUBSCRIBE, b"kv@")
                    sub.connect(f"tcp://127.0.0.1:{port}")
                time.sleep(0.3)  # slow joiner
                body = json.dumps({"prompt": "rank one " * 4, "max_tokens": 2,
                                   "temperature": 0}).encode()
                req = urllib.request.Request(f"http://{eps[1]}/v1/completions", data=body,
                                             headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=60) as r:
                    assert r.status == 200
                assert subs[1].poll(5000)
                topic, payload = subs[1].recv_multipart()[:2]
                seen["topic"] = topic.decode()
                seen["events"] = decode_event_batch(payload)[1]
                seen["rank0_quiet"] = not subs[0].poll(300)
            finally:
                for sub in subs:
                    sub.close(0)
                ctx.term()
            raise KeyboardInterrupt

    monkeypatch.setattr(serve, "threading", types.SimpleNamespace(Event=_Serving))
    serve.main(["--model", "tiny", "--cpu", "--port", "0", "--block-size", "8",
                "--num-pages", "64", "--max-model-len", "128", "--max-batch-size", "4",
                "--data-parallel-size", "2", "--kv-events-port", str(base)])
    assert seen["ports"] == [base, base + 1], seen["line"]
    assert seen["topic"] == f"kv@{seen['eps'][1]}@llmd-tpu/tiny"
    assert any(isinstance(e, BlockStored) for e in seen["events"])
    assert seen["rank0_quiet"]


def test_set_cache_dir_resolves_the_build_paths(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    monkeypatch.setattr(build, "_LOADED", {})
    default = build.library_path("paged_attention")
    assert default.parent == build.CSRC / ".build"
    assert build.set_cache_dir(tmp_path / "cache") == (tmp_path / "cache").resolve()
    for name in ("paged_attention", "mla_decode", "grouped_gemm", "kv_transfer"):
        p = build.library_path(name)
        assert p.parent == (tmp_path / "cache").resolve() and p.name.startswith(name + "-")
    assert build.library_path("paged_attention").name == default.name  # same key
    monkeypatch.setattr(build, "_LOADED", {"kv_transfer": object()})
    with pytest.raises(RuntimeError, match="already loaded"):
        build.set_cache_dir(tmp_path / "other")


def test_pool_launcher_warm_argv_parses(tmp_path):
    """A warm-start pool's ``engine_argv`` (the snapshot's checkpoint, made
    by the pool earlier, and its ``--compile-cache-dir``), the module
    swapped, parses into the cache directory and the checkpoint."""
    from llmd_tpu.pool.launcher import engine_argv
    from llmd_tpu.pool.snapshot import PoolSnapshotStore, config_fingerprint

    store = PoolSnapshotStore(str(tmp_path / "snap"))
    ckpt = store.path(config_fingerprint({"model": "tiny"}), "checkpoint")
    Path(ckpt, "config.json").write_text("{}")  # materialized on an earlier launch
    for want_warm in (False, True):
        argv, warm = engine_argv("tiny", 8123, snapshots=store, extra=["--role", "decode"])
        assert warm == want_warm and argv[1:3] == ["-m", "llmd_tpu.engine.serve"]
        args = serve.parse_args(argv[3:])
        assert args.model == ckpt and args.port == 8123 and args.role == "decode"
        assert args.compile_cache_dir == store.path(config_fingerprint({"model": "tiny"}),
                                                    "compile_cache")


def test_pool_launcher_argv_starts_a_port_replica(tmp_path):
    """The launcher's argv for a registry model, the module swapped and the
    warm start's ``--compile-cache-dir`` appended as the launcher appends it:
    launched with ``--cpu`` (and a KV-transfer side channel, whose native
    library is the port's one CPU build) it answers ``/health``, with that
    library built into the cache directory."""
    from llmd_tpu.pool.launcher import engine_argv

    cache = tmp_path / "compile_cache"
    argv, _ = engine_argv("tiny", 0)
    assert argv[1:3] == ["-m", "llmd_tpu.engine.serve"]
    argv[2] = "llmd_tpu_torch.engine.serve"
    argv += ["--compile-cache-dir", str(cache)]
    proc = subprocess.Popen(
        [*argv, "--cpu", "--host", "127.0.0.1", "--num-pages", "32",
         "--kv-transfer-port", "0"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    try:
        line = proc.stdout.readline()
        assert "serving llmd-tpu/tiny" in line and "KV transfer on port" in line, (
            line, proc.stderr.read()[-3000:] if proc.poll() is not None else "")
        addr = line.split("http://")[1].split()[0]
        with urllib.request.urlopen(f"http://{addr}/health", timeout=30) as r:
            assert r.status == 200 and json.loads(r.read()) == {"status": "ok"}
        built = sorted(p.name for p in cache.glob("*.so"))
        assert len(built) == 1 and built[0].startswith("kv_transfer-"), built
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_dropped_engine_and_stopped_server_free_their_tensors():
    """No cycle collection: an engine dropped after serving, and a server's
    engine after ``stop()`` (the server itself sits in its handler class's
    cycle; ``stop`` closes the engine it built), hold no tensor."""
    torch.set_num_threads(1)
    cfg = get_model_config("tiny")
    kw = dict(page_size=8, num_pages=32, max_model_len=128, max_batch_size=2)
    gc.collect()
    gc.disable()
    try:
        eng = LLMEngine(cfg, EngineConfig(**kw, decode_steps=2), device="cpu")
        eng.generate([list(range(5, 30))], SamplingParams(max_tokens=4, temperature=0.0))
        refs = [weakref.ref(eng), weakref.ref(eng.cache)]
        del eng
        assert all(r() is None for r in refs)
        srv = EngineServer(cfg, EngineConfig(**kw), port=0, device="cpu")
        srv.start()
        body = json.dumps({"prompt": "hi", "max_tokens": 3, "temperature": 0}).encode()
        req = urllib.request.Request(f"http://{srv.address}/v1/completions", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200
        tensors = [weakref.ref(srv.engine.cache)] + [
            weakref.ref(t) for t in srv.engine.params.values()]
        srv.stop()
        del srv, req
        assert all(r() is None for r in tensors)
    finally:
        gc.enable()
