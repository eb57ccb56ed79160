"""The port's operator CLIs (``llmd_tpu_torch/tools``) against the reference's
(``tools/``): ``dump_flight`` renders the same saved dumps to the same bytes
in every view; ``validate_manifests`` finds ``deploy/`` valid, the same issues
in broken manifests, and every flag the guides pass on the port's CLIs;
``rollout`` makes the same calls in the same order with the same report and
exit code against one router, on success and on rollback; ``predictor_accuracy``
offline writes the reference's artifact keys from the port's engine."""

from __future__ import annotations

import ast
import asyncio
import contextlib
import hashlib
import importlib.util
import io
import json
import sys
import threading
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def _fresh(path: Path, name: str):
    """A fresh instance of the module at ``path`` (its default ``out=``
    arguments bound to the stdout current while it executes)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _main(path: Path, argv: list[str]) -> tuple:
    """(exit code, stdout, stderr) of ``main(argv)`` of a fresh module."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        mod = _fresh(path, f"cli_{path.parent.name}_{path.stem}")
        try:
            rc = mod.main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


# -- dump_flight -------------------------------------------------------------------

REF_DUMP = REPO / "tools" / "dump_flight.py"
PORT_DUMP = REPO / "llmd_tpu_torch" / "tools" / "dump_flight.py"
TRACE = "4bf92f3577b34da6a3ce929d0e0e4736"
ROUTE = {"profiles": {"default": {"candidates": 3, "tie": 1, "chosen": "10.0.0.1:8000",
                                  "filters": [["prefix-filter", 1]],
                                  "top": [["10.0.0.1:8000", 1.0], ["10.0.0.2:8000", 0.6]],
                                  "breakdown": {"10.0.0.1:8000": {"prefix": 0.7,
                                                                  "queue": 0.3}},
                                  "regret": 0.4}},
         "regret": 0.4, "excluded": 1, "kv_plane": {"mode": "pull"},
         "predicted_ttft_ms": 20.0, "predicted_e2e_ms": 90.0}


def _ev(name, t_ms, **attrs):
    return {"event": name, "t_ms": t_ms, "t_unix": 1700000000.0 + t_ms / 1e3, **attrs}


def _records() -> list[dict]:
    router = {"request_id": "rt-1", "model": "m", "tenant": "t1", "status": "finished",
              "latency_ms": 100.0, "trace_id": TRACE, "finish_reason": "stop",
              "n_events": 6, "events": [
                  _ev("arrival", 0.0), _ev("flow_enqueue", 0.5), _ev("flow_dispatch", 1.0),
                  _ev("route_decision", 1.5, **ROUTE),
                  _ev("kv_pull_stamped", 1.6, blocks=4, saved_tokens_est=64),
                  _ev("forward", 2.0, endpoint="10.0.0.1:8000"),
                  _ev("retry", 30.0, reason="502"),
                  _ev("route_decision", 31.0, **ROUTE),
                  _ev("response", 99.0, ttft_ms=25.0, status=200)]}
    engine = {"request_id": "en-1", "model": "m", "tenant": None, "status": "finished",
              "latency_ms": 80.0, "trace_id": TRACE, "finish_reason": "length",
              "events_dropped": 3, "n_events": 8, "events": [
                  _ev("arrival", 0.0), _ev("kv_pull", 1.0, outcome="hit", blocks=3, ms=2.5),
                  _ev("admitted", 4.0), _ev("prefill_start", 4.5), _ev("prefill_end", 20.0),
                  _ev("first_token", 21.0), _ev("spec_verify", 40.0, accepted=2),
                  _ev("retired", 80.0, spec_drafted=8, spec_accepted=5, spec_flips=1,
                      cached_tokens=48)]}
    plain = {"request_id": "en-2", "model": None, "status": "aborted", "latency_ms": 5.5,
             "n_events": 2, "events": [_ev("arrival", 0.0), _ev("aborted", 5.5)]}
    summary = {"request_id": "en-3", "model": "m", "status": "active", "latency_ms": 12.25,
               "n_events": 4}
    return [router, engine, plain, summary]


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    d = tmp_path_factory.mktemp("flight")
    recs = _records()
    system = [{"event": "drain", "t_unix": 1700000001.5, "reason": "sigterm"},
              {"event": "watchdog_stall", "t_unix": 1700000002.0, "stall_s": 2.5}]
    files = {"list": {"requests": recs, "system": system},
             "bare": recs[:3],
             "single": recs[1],
             "embedded": {"requests": [dict(recs[0], phase_ledger={
                 "plane": "router", "wall_ms": 100.0, "phases": {"schedule": 40.0,
                                                                 "upstream": 55.0},
                 "residual_ms": 5.0}, decision=None)], "system": []}}
    for name, payload in files.items():
        (d / f"{name}.json").write_text(json.dumps(payload))
    return d


_VIEWS = {
    "list": ["list.json"],
    "list_bare": ["bare.json"],
    "list_filters_ignored_offline": ["list.json", "--status", "finished", "--limit", "1"],
    "id": ["list.json", "--id", "en-1"],
    "id_unknown_falls_back": ["list.json", "--id", "nope"],
    "id_phases": ["list.json", "--id", "rt-1", "--phases"],
    "id_decisions": ["list.json", "--id", "rt-1", "--decisions"],
    "id_both_engine": ["list.json", "--id", "en-1", "--phases", "--decisions"],
    "no_decision": ["list.json", "--id", "en-2", "--decisions", "--phases"],
    "summary_only": ["list.json", "--id", "en-3", "--phases", "--decisions"],
    "phases_all": ["list.json", "--phases"],
    "decisions_all": ["bare.json", "--decisions"],
    "trace": ["list.json", "--trace", TRACE],
    "trace_both": ["list.json", "--trace", TRACE, "--phases", "--decisions"],
    "trace_unknown": ["list.json", "--trace", "nope", "--decisions"],
    "single": ["single.json"],
    "single_id": ["single.json", "--id", "en-1", "--phases"],
    "embedded": ["embedded.json", "--id", "rt-1", "--phases", "--decisions"],
    "missing_file": ["absent.json"],
}


@pytest.mark.parametrize("view", sorted(_VIEWS))
def test_dump_flight_renders_as_the_reference(dumps, view):
    argv = [str(dumps / a) if a.endswith(".json") else a for a in _VIEWS[view]]
    ref = _main(REF_DUMP, argv)
    port = _main(PORT_DUMP, argv)
    assert port == ref
    if view not in ("trace_unknown", "missing_file"):
        assert ref[0] == 0 and ref[1]
    else:
        assert ref[0] == 1


def test_dump_flight_save_writes_the_payload(dumps, tmp_path):
    """``--save`` of a source writes its payload; the saved file renders as
    the source (here a dump: the port's save of the reference's file)."""
    src = str(dumps / "list.json")
    rc, out, _ = _main(PORT_DUMP, [src, "--id", "rt-1", "--save", str(tmp_path / "s.json")])
    assert rc == 0 and out == f"wrote {tmp_path / 's.json'}\n"
    view = ["--id", "rt-1", "--phases", "--decisions"]
    assert _main(PORT_DUMP, [str(tmp_path / "s.json"), *view]) == _main(REF_DUMP, [src, *view])


# -- validate_manifests ----------------------------------------------------------

REF_VALIDATE = REPO / "tools" / "validate_manifests.py"


@pytest.fixture(scope="module")
def validators():
    sys.path.insert(0, str(REPO / "tools"))
    try:
        ref = _fresh(REF_VALIDATE, "ref_validate_manifests")
    finally:
        sys.path.remove(str(REPO / "tools"))
    from llmd_tpu_torch.tools import validate_manifests as port

    return ref, port


def test_deploy_is_valid_on_both(validators):
    ref, port = validators
    assert ref.validate(str(REPO / "deploy")) == []
    assert port.validate(str(REPO / "deploy")) == []
    rc, out, err = _main(REPO / "llmd_tpu_torch" / "tools" / "validate_manifests.py",
                         [str(REPO / "deploy")])
    assert (rc, err) == (None, "") and out.startswith("OK: 23 manifest files valid")


_DEPLOYMENT = """
apiVersion: apps/v1
kind: Deployment
metadata: {name: d}
spec:
  selector: {matchLabels: {app: x}}
  template:
    metadata: {labels: {app: %s}}
    spec:
      containers:
        - name: e
          image: llmd-tpu:latest
          args: [python, -m, %s]
          ports: [{containerPort: 8000}]
"""
_POOL = """---
kind: InferencePool
metadata: {name: p}
spec:
  selector: {matchLabels: {app: x}}
  targetPorts: [{number: 7000}]
"""
_BROKEN = {  # tests/test_manifests.py's three, and one of each other kind
    "unknown_flag": _DEPLOYMENT % ("x", 'llmd_tpu.engine.serve, --not-a-flag, "1"'),
    "port_drift": _DEPLOYMENT % ("x", 'llmd_tpu.engine.serve, --port, "9999"') + _POOL,
    "selector_mismatch": _DEPLOYMENT % ("DIFFERENT", "llmd_tpu.engine.serve"),
    "router_flag": _DEPLOYMENT % ("x", "llmd_tpu.router.serve, --bogus=1"),
    "sidecar_flag": _DEPLOYMENT % ("x", "llmd_tpu.disagg.sidecar, --engine, a, --nope"),
    "unknown_module": _DEPLOYMENT % ("x", "llmd_tpu.engine.absent"),
    "unknown_kind": "kind: Widget\nmetadata: {name: w}\n",
    "hpa": "kind: HorizontalPodAutoscaler\nmetadata: {name: h}\nspec: {}\n",
}


def _issues(errors: list[str]) -> list[str]:
    """An issue without the flag list it quotes (the port's engine CLI takes
    every flag of the reference's and ``--seed``) or the import error it
    quotes (each package names its own)."""
    return [e.split(" (has: ")[0].split(" not importable: ")[0] for e in errors]


@pytest.mark.parametrize("case", sorted(_BROKEN))
def test_broken_manifests_give_the_same_issues(validators, tmp_path, case):
    ref, port = validators
    (tmp_path / "m.yaml").write_text(_BROKEN[case])
    want = ref.validate(str(tmp_path))
    got = port.validate(str(tmp_path))
    assert want and _issues(got) == _issues(want)


def test_every_flag_the_guides_pass_resolves_on_the_port(validators):
    ref, port = validators
    from llmd_tpu_torch.core.config import load_yaml_all

    passed: dict[str, set] = {}
    for path in sorted((REPO / "deploy").rglob("*.yaml")):
        for doc in load_yaml_all(path.read_text()):
            for c in port._containers(doc or {}) if isinstance(doc, dict) else ():
                args = [str(a) for a in c.get("args", [])]
                if "-m" in args:
                    mod = args[args.index("-m") + 1]
                    passed.setdefault(mod, set()).update(
                        a.partition("=")[0] for a in args if a.startswith("--"))
    assert {"llmd_tpu.engine.serve", "llmd_tpu.router.serve"} <= set(passed)
    for mod, flags in passed.items():
        assert flags <= port._argparse_flags(mod), (mod, flags - port._argparse_flags(mod))
        assert ref._argparse_flags(mod) <= port._argparse_flags(mod), mod


# -- rollout ------------------------------------------------------------------------

ROUTER_CFG = """
plugins:
  - {name: queue, type: queue-depth-scorer}
schedulingProfiles:
  - name: default
    plugins:
      - {pluginRef: queue, weight: 1}
"""


class _Stack:
    """Two of the port's fake servers behind the port's router, and a front
    that logs every call a rollout tool makes (method, path, JSON body)
    before passing it to the router; the front also answers the pods' LoRA
    routes (200 for a load, 404 for an adapter it never loaded), as an
    engine does. One event loop on a thread of its own."""

    def __init__(self, rewrites=None) -> None:
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.calls: list = []
        self._call(self._start(rewrites))

    def _call(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(60)

    async def _start(self, rewrites) -> None:
        from llmd_tpu_torch.core.config import FrameworkConfig
        from llmd_tpu_torch.core.endpoint import Endpoint, EndpointPool
        from llmd_tpu_torch.router.http import HTTPClient, HTTPServer, json_response
        from llmd_tpu_torch.router.plugins import known_plugin_types
        from llmd_tpu_torch.router.server import RouterServer
        from llmd_tpu_torch.testing.fake_server import FakeModelServer, FakeServerConfig

        self.fakes = [FakeModelServer(FakeServerConfig(prefill_us_per_token=0.0,
                                                       decode_us_per_token=0.0))
                      for _ in range(2)]
        pool = EndpointPool()
        for f in self.fakes:
            await f.start()
            pool.upsert(Endpoint(address=f.address))
        self.router = RouterServer(FrameworkConfig.from_yaml(
            ROUTER_CFG, known_types=known_plugin_types()), pool, host="127.0.0.1", port=0,
            model_rewrites=rewrites, seed=0)
        await self.router.start()
        self.client = HTTPClient()
        self.loaded: set = set()

        async def forward(request):
            body = await request.json() if request.body else None
            self.calls.append((request.method, request.path, body))
            if request.path == "/v1/load_lora_adapter":
                self.loaded.add(body["lora_name"])
                return json_response({"status": "ok"})
            if request.path == "/v1/unload_lora_adapter":
                known = body["lora_name"] in self.loaded
                self.loaded.discard(body["lora_name"])
                return json_response({}, 200 if known else 404)
            r = await self.client.request(request.method,
                                          f"http://{self.router.address}{request.path}",
                                          json_body=body)
            data = await r.read()
            try:
                return json_response(json.loads(data), r.status)
            except ValueError:
                return json_response({"error": data.decode(errors="replace")}, r.status)

        self.front = HTTPServer()
        for method, path in (("GET", "/admin/model-rewrites"),
                             ("POST", "/admin/model-rewrites"),
                             ("POST", "/v1/completions"), ("POST", "/v1/load_lora_adapter"),
                             ("POST", "/v1/unload_lora_adapter")):
            self.front.add_route(method, path, forward)
        self.address = f"127.0.0.1:{await self.front.start('127.0.0.1', 0)}"

    def stop_fakes(self) -> None:
        async def stop():
            for f in self.fakes:
                await f.stop()
        self._call(stop())

    def set_rewrites(self, rewrites: dict) -> None:
        self.router.model_rewrites = dict(rewrites)

    def close(self) -> None:
        async def stop():
            await self.front.stop()
            await self.client.close()
            await self.router.stop()
            for f in self.fakes:
                with contextlib.suppress(Exception):
                    await f.stop()
        try:
            self._call(stop())
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(10)
            self.loop.close()


def _rollout(tool: Path, argv: list[str], monkeypatch) -> tuple:
    """(exit code, report) of the tool's ``main()`` with ``argv``."""
    monkeypatch.setattr(sys, "argv", [str(tool), *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod = _fresh(tool, f"rollout_{tool.parent.name}")
        try:
            mod.main()
            rc = 0
        except SystemExit as e:
            rc = e.code
    return rc, json.loads(out.getvalue())


_ROLLOUTS = {  # the cases of tests/test_rollout.py
    "canary": (None, ["--model", "base", "--new", "canary-v2", "--stages", "0.25,1.0",
                      "--probes", "8"], False),
    "adapter": (None, ["--model", "m", "--new", "adapter-v2", "--stages", "0.5,1.0",
                       "--probes", "4", "--pods", "{front}", "--adapter-path", "/a/v2.npz",
                       "--old-adapter", "adapter-v1", "--unload-old"], False),
    "rollback": ({"base": [("base", 1.0)]}, ["--model", "base", "--new", "canary-v2",
                                              "--stages", "0.5,1.0", "--probes", "4"], True),
}


@pytest.mark.parametrize("case", sorted(_ROLLOUTS))
def test_rollout_calls_as_the_reference(case, monkeypatch):
    rewrites, argv, dark = _ROLLOUTS[case]
    stack = _Stack(rewrites)
    try:
        if dark:  # the pool goes dark: every canary probe fails
            stack.stop_fakes()
        argv = ["--router", stack.address, *(a.format(front=stack.address) for a in argv)]
        runs = {}
        for name, tool in (("reference", REPO / "tools" / "rollout.py"),
                           ("port", REPO / "llmd_tpu_torch" / "tools" / "rollout.py")):
            stack.calls.clear()
            stack.set_rewrites(rewrites or {})
            rc, report = _rollout(tool, argv, monkeypatch)
            after = stack._call(_get_rewrites(stack))
            runs[name] = (rc, report, list(stack.calls), after)
    finally:
        stack.close()
    assert runs["port"] == runs["reference"]
    rc, report, calls, after = runs["port"]
    if dark:
        assert rc == 1 and report["outcome"].startswith("rolled-back at 0.5")
        assert after == {"base": [["base", 1.0]]}
    else:
        assert rc == 0 and report["outcome"] == "completed"
        assert after[argv[argv.index("--model") + 1]] == [[argv[argv.index("--new") + 1], 1.0]]
    assert calls[0][:2] == (("POST", "/v1/load_lora_adapter") if case == "adapter"
                            else ("GET", "/admin/model-rewrites"))


async def _get_rewrites(stack) -> dict:
    r = await stack.client.request("GET", f"http://{stack.router.address}/admin/model-rewrites")
    return await r.json()


# -- predictor_accuracy offline --------------------------------------------------

def _reference_artifact_keys() -> list[str]:
    """The keys of the artifact dict the reference's offline mode writes."""
    tree = ast.parse((REPO / "tools" / "predictor_accuracy.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    art = next(n.value for n in ast.walk(main) if isinstance(n, ast.Assign)
               and getattr(n.targets[0], "id", None) == "artifact")
    return [k.value for k in art.keys]


def test_predictor_accuracy_offline_writes_the_reference_keys(tmp_path):
    import torch

    from llmd_tpu_torch.tools.predictor_accuracy import main

    repo_file = REPO / "PREDICTOR_ACCURACY.json"
    before = hashlib.sha256(repo_file.read_bytes()).hexdigest()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = tmp_path / "acc.json"
        with contextlib.redirect_stdout(io.StringIO()):
            assert main(["--cpu", "--reps", "3", "--out", str(out)]) == 0
    finally:
        torch.set_num_threads(threads)
    art = json.loads(out.read_text())
    assert list(art) == _reference_artifact_keys() == list(json.loads(repo_file.read_text()))
    assert art["device"] == "cpu" and art["requests_served"] == 54
    assert art["n_train"] >= 32 and 0 < art["ttft_mape"] < art["mean_baseline_ttft_mape"]
    assert hashlib.sha256(repo_file.read_bytes()).hexdigest() == before


def test_predictor_accuracy_refuses_no_card_without_cpu(tmp_path, monkeypatch):
    import torch

    from llmd_tpu_torch.tools.predictor_accuracy import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device by default"):
        main(["--reps", "3", "--out", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()
