"""The port's one-command gate and the gates it composes
(``llmd_tpu_torch/tools``: ``util_check``, ``device_obs_check``, ``moe_check``,
``structured_check``, ``kv_durability_check``, ``warm_start_probe``, ``dryrun``,
``perf_regress``'s comparator, ``make_checkpoint``, ``ci_gate``) against the
reference's (``tools/``, ``__graft_entry__.py``), on the CPU.

- util: the reference gate runs whole; the port's gate on its weights gives the
  same goodput classes per program (the unified program's padding apart: the
  port runs that program on its real tokens, so its unified padding is 0) and
  the same steady-round window deltas; both compile counts stay flat (the
  port's compile is a CUDA-graph capture, and the CPU captures none).
- device-obs: the port's five checks print the reference's lines in order.
- moe: the port's einsum engine at the default capacity drops as many routed
  copies as the reference's on the reference's weights (seed 7).
- structured: the reference's requests on the plain engine variant: 10
  conforming 200s and 3 400s. The whole port gate takes ~29 s here (each
  variant ~14 s), past this file's budget, so the n-gram variant runs in the
  gate itself (``ci_gate``'s structured-check stage, chip_smoke.py's gate
  phase).
- kv-durability: the five rungs on float32 weights shared with a JAX engine,
  whose greedy texts equal the port's control texts.
- warm_start_probe: a failed child launch exits 1 with the reference's skip
  line (the departure kept on purpose; the reference exits 0).
- dryrun: ``factor_mesh`` = ``_factor_mesh`` for n in 1..16 and both orders;
  one ``dryrun_one`` at dp=2 over a 2-rank gloo world.
- perf_regress: the verdict JSON, the markdown and stdout byte-equal to the
  reference's on the pinned files and on two synthetic regressions.
- make_checkpoint: both packages' HF loaders read its directory to bit-equal
  params, and both engines give the same greedy tokens from it.
- ci_gate: the reference's stage names in its order (a source scan), the one
  departure ``bench-tiny-attn`` under ``--cpu``, one exit code and the
  reference's summary keys; its pytest plugin registers with pytest and fails
  a session that passed no test.
"""

from __future__ import annotations

import ast
import contextlib
import dataclasses
import importlib
import io
import json
import os
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from llmd_tpu.core.request import SamplingParams as JaxSamplingParams
from llmd_tpu.engine import EngineConfig as JaxEngineConfig
from llmd_tpu.engine import LLMEngine as JaxEngine
from llmd_tpu.engine.tokenizer import load_tokenizer
from llmd_tpu.models import get_model_config as jax_model_config
from llmd_tpu.models import hf_loader as jh
from llmd_tpu.models import transformer as jt
from llmd_tpu_torch.core.request import SamplingParams
from llmd_tpu_torch.engine import EngineConfig, LLMEngine
from llmd_tpu_torch.models import get_model_config
from llmd_tpu_torch.models import hf_loader as th
from llmd_tpu_torch.models import transformer as tt
from llmd_tpu_torch.models.config import ModelConfig
from llmd_tpu_torch.tools import (ci_gate, device_obs_check, dryrun, kv_durability_check,
                                  make_checkpoint, moe_check, perf_regress, structured_check,
                                  util_check, warm_start_probe)

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    """The tiny engines run thousands of small ops: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference(name: str):
    """Import a reference gate module with the environment restored after
    (some set process-wide variables at import)."""
    saved = dict(os.environ)
    try:
        return importlib.import_module(name)
    finally:
        os.environ.clear()
        os.environ.update(saved)


def _np(params: dict) -> dict:
    return {k: np.asarray(v) for k, v in params.items()}


def _recording(module, monkeypatch) -> list:
    """Patch ``module.LLMEngine`` to keep every engine the gate builds."""
    built = []

    class Recording(module.LLMEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)

    monkeypatch.setattr(module, "LLMEngine", Recording)
    return built


# -- util-check ----------------------------------------------------------------------


def test_util_check_numbers_match_reference(monkeypatch, capsys):
    ref = _reference("tools.util_check")
    built = _recording(ref, monkeypatch)
    assert ref.main() == 0
    ref_lines = capsys.readouterr().out.splitlines()
    je = built[0]
    got = util_check.check(CPU, params=tt.params_from_numpy(ModelConfig(), _np(je.params)))
    port_lines = capsys.readouterr().out.splitlines()

    rj, rt = je.util.totals(), got["totals"]
    assert set(rt) == set(rj) == {"unified", "decode"}
    assert rt["decode"] == rj["decode"]
    for kind in ("committed", "spec_rejected", "preempted_recompute", "prefix_saved"):
        assert rt["unified"][kind] == rj["unified"][kind], kind
    assert rt["unified"]["padding"] == 0 < rj["unified"]["padding"]

    def printed(lines, prefix):
        line = next(ln for ln in lines if ln.startswith(prefix))
        return ast.literal_eval(line[line.rindex("("):].strip("()"))

    delta = "util-check: ledger == /metrics exactly; window deltas match token for token"
    ref_delta, port_delta = printed(ref_lines, delta), printed(port_lines, delta)
    assert port_delta == got["window_delta"]
    assert {k: v for k, v in port_delta.items() if k != "padding"} == {
        k: v for k, v in ref_delta.items() if k != "padding"}
    flat = "util-check: compile counts flat across steady state"
    assert printed(ref_lines, flat) == je.util.compiles() and je.util.compiles()
    assert printed(port_lines, flat) == got["compiles"] == {}  # the CPU captures nothing
    # the other checks' lines are the reference's, word for word
    assert [ln for ln in port_lines if "(" not in ln] == [
        ln for ln in ref_lines if "(" not in ln and "ALL OK" not in ln]


# -- device-obs ----------------------------------------------------------------------


def _printed_literals(path: Path, order: list[str]) -> list[str]:
    """The string each of ``order``'s functions prints last, in that order."""
    tree = ast.parse(path.read_text())
    funcs = {f.name: f for f in tree.body if isinstance(f, ast.FunctionDef)}
    out = []
    for name in order:
        calls = [n for n in ast.walk(funcs[name]) if isinstance(n, ast.Call)
                 and getattr(n.func, "id", None) == "print"]
        out.append(ast.literal_eval(calls[-1].args[0]))
    return out


def test_device_obs_check_prints_reference_lines(capsys):
    got = device_obs_check.check(CPU)
    assert got["profile_bytes"] > 0 and got["profile_kernels"] == 0  # no card traced
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("device-obs:")]
    assert lines == _printed_literals(
        REPO / "tools" / "device_obs_check.py",
        ["check_watchdog", "check_fabric_probe", "check_hbm_synthetic",
         "check_hbm_quiet_on_cpu", "check_profile_capture"])


# -- moe-check -----------------------------------------------------------------------


def test_moe_check_drops_match_reference(monkeypatch):
    ref = _reference("tools.moe_check")
    built = _recording(ref, monkeypatch)
    eng, _ = ref._serve("einsum")
    assert built == [eng] and eng.moe_dispatch == "einsum"
    params = tt.params_from_numpy(get_model_config("tiny-moe"), _np(eng.params))
    got = moe_check.check(CPU, params=params)
    assert got["einsum_dropped"] == eng.stats.moe_dropped_tokens > 0
    assert (moe_check.PROMPTS, moe_check.BASE, moe_check.SEED) == (ref.PROMPTS, ref.BASE, 7)


# -- structured-check ----------------------------------------------------------------


def test_structured_check_plain_variant():
    ref = _reference("tools.structured_check")
    for name in ("N_SCHEMA_REQUESTS", "SCHEMA", "CHOICES", "REGEX", "ENGINE_VARIANTS"):
        assert getattr(structured_check, name) == getattr(ref, name), name
    # conformance and the 400s; the spec leg runs in the gate itself
    # (ci_gate's structured-check stage, chip_smoke.py's gate phase)
    verdict = structured_check.run(CPU, variants=ref.ENGINE_VARIANTS[:1])
    n = ref.N_SCHEMA_REQUESTS
    assert verdict | {"wall_s": 0} == {
        "structured_check": "ok", "engine_variants": ["spec-off"],
        "schema_requests": n, "statuses": {"200": n + 2, "400": 3}, "failures": [],
        "wall_s": 0}


# -- kv-durability-check -------------------------------------------------------------


def test_kv_durability_rungs_match_reference_texts():
    ref = _reference("tools.kv_durability_check")
    assert (kv_durability_check.PROMPTS, kv_durability_check.BLOCK) == (ref.PROMPTS, ref.BLOCK)
    jcfg = dataclasses.replace(jax_model_config("tiny"), dtype="float32")
    tcfg = dataclasses.replace(get_model_config("tiny"), dtype="float32")
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    saved = dict(os.environ)
    try:
        verdict = kv_durability_check.run(CPU, params=tt.params_from_numpy(tcfg, _np(jp)),
                                          identity_only=True, model=tcfg)
    finally:
        assert dict(os.environ) == saved  # the gate restores what it set
    assert verdict["kv_durability_check"] == "ok", verdict
    assert all(verdict["rung_identity"].values()) and verdict["client_5xx"] == 0
    je = JaxEngine(jcfg, JaxEngineConfig(page_size=8, num_pages=64, max_model_len=256,
                                         max_batch_size=4, prefill_chunk=32,
                                         attn_impl="reference"), params=jp)
    out = je.generate([list(p.encode()) for p in ref.PROMPTS],
                      JaxSamplingParams(max_tokens=8, temperature=0.0))
    tok = load_tokenizer()  # the reference server's byte tokenizer
    texts = [tok.decode(out[f"req-{i}"]) for i in range(len(ref.PROMPTS))]
    assert [verdict["expected"][p] for p in ref.PROMPTS] == texts


# -- warm_start_probe ----------------------------------------------------------------


@pytest.mark.parametrize("fails", ["cold", "warm"])
def test_warm_start_probe_fails_on_a_failed_launch(fails, tmp_path, monkeypatch, capsys):
    """The departure kept on purpose: a child launch that fails prints the
    reference's skip line and exits 1 (the reference exits 0)."""
    calls = []
    row = {"load_s": 0.0, "build_s": 1.0, "first_generate_s": 1.0, "ready_s": 2.0,
           "native_compiles": 0, "native_libraries": []}

    def fake_run(cmd, **kw):
        calls.append(cmd)
        label = ("cold", "warm")[len(calls) - 1]
        return warm_start_probe.subprocess.CompletedProcess(
            cmd, 1 if label == fails else 0, stdout=json.dumps(row) + "\n",
            stderr="boom\n" if label == fails else "")

    monkeypatch.setattr(warm_start_probe.subprocess, "run", fake_run)
    assert warm_start_probe.main(["--cpu", "--cache-dir", str(tmp_path / "c")]) == 1
    assert calls[0][1:5] == ["-m", "llmd_tpu_torch.tools.warm_start_probe", "--child",
                             "--model"] and "--cpu" in calls[0]
    assert len(calls) == (1 if fails == "cold" else 2)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {
        "metric": "warm_start_speedup", "value": None, "unit": "x", "vs_baseline": None,
        "skipped": f"{fails}-launch-failed", "error": "boom"}


# -- dryrun --------------------------------------------------------------------------


@pytest.mark.parametrize("order", dryrun.ORDERS)
def test_factor_mesh_matches_reference(order):
    for n in range(1, 17):
        ref = graft._factor_mesh(n, order)
        got = dryrun.factor_mesh(n, order)
        assert (got.dp, got.sp, got.ep, got.tp) == (ref.dp, ref.sp, ref.ep, ref.tp), n


def test_dryrun_one_dp2_over_a_gloo_world(capsys):
    from llmd_tpu_torch.parallel.launch import World

    mesh = dryrun.factor_mesh(2)
    assert (mesh.dp, mesh.sp, mesh.ep, mesh.tp) == (2, 1, 1, 1)
    world = World.start(2, "cpu", timeout_s=120)
    try:
        done = dryrun.dryrun_one(mesh, 2, world)
    finally:
        world.close()
    assert sorted(done) == ["rank0", "rank1"] and all(len(v) == 4 for v in done.values())
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun OK: mesh(dp=2, sp=1, ep=1, tp=1) over 2 devices, "
                           "model=tiny-moe, 2 rank engines sharing the EP all-to-all; ")
    assert "moe_dispatch=sorted" in line


# -- perf_regress's comparator --------------------------------------------------------


def _regressed(tmp_path: Path, case: str) -> tuple[str, str]:
    base = json.loads((REPO / "BENCH_r05.json").read_text())
    cand = json.loads(json.dumps(base))
    row = cand["parsed"]
    if case == "past_tolerance":
        row["decode_tok_per_s"] *= 0.8  # 20% under, tolerance 8%
        row["wall_s"] *= 0.5  # faster: an improvement, not a failure
    else:  # incomparable: another device, and a metric the candidate lost
        row["device"] = "cpu"
        del row["decode_calls"]
    c, b = tmp_path / "cand.json", tmp_path / "base.json"
    c.write_text(json.dumps(cand))
    b.write_text(json.dumps(base))
    return str(c), str(b)


def _run_main(main, argv) -> tuple:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("case", ["pinned", "past_tolerance", "incomparable"])
def test_comparator_bytes_equal_reference(case, tmp_path, monkeypatch):
    ref = _reference("tools.perf_regress")
    monkeypatch.chdir(REPO)
    if case == "pinned":
        cand, base = "BENCH_CAMPAIGN_r05.json", "BENCH_r05.json"
    else:
        cand, base = _regressed(tmp_path, case)
    runs = []
    for label, main in (("ref", ref.main), ("port", perf_regress.main)):
        js, md = tmp_path / f"{label}.json", tmp_path / f"{label}.md"
        rc, out, err = _run_main(main, ["--candidate", cand, "--baseline", base,
                                        "--json-out", str(js), "--md-out", str(md)])
        runs.append((rc, out, err, js.read_bytes(), md.read_bytes()))
    assert runs[0] == runs[1]
    verdict = json.loads(runs[0][3])
    assert runs[0][0] == (0 if case == "pinned" else 1)
    if case == "past_tolerance":
        status = {r["metric"]: r["status"] for r in verdict["rows"]}
        assert status["decode_tok_per_s"] == "fail" and status["wall_s"] == "pass"
    elif case == "incomparable":
        assert not verdict["comparable"] and "device" in verdict["provenance"]
        assert {r["status"] for r in verdict["rows"]} == {"skipped", "missing"}


# -- make_checkpoint -----------------------------------------------------------------


def test_make_checkpoint_reads_bit_equal_in_both_packages(tmp_path):
    out = str(tmp_path / "tiny-hf")
    rc, stdout, _ = _run_main(make_checkpoint.main,
                              ["--shape", "tiny", "--out", out, "--dtype", "float32"])
    assert rc == 0 and stdout == f"wrote {out}\n"
    assert not [n for n in os.listdir(out) if "token" in n]  # no tokenizer, by design
    jcfg, jp = jh.load_model(out, dtype="float32")
    tcfg, tp = th.load_model(out, dtype="float32")
    want = tt.params_from_numpy(tcfg, _np(jp))
    assert sorted(tp) == sorted(want)
    for k in tp:
        assert torch.equal(tp[k], want[k]), k
    # the port's init_params at --seed, written as it was drawn
    drawn = tt.init_params(tcfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(tp[k], drawn[k]) for k in drawn)
    prompts = [[1, 2, 3, 4, 5, 6, 7], [40, 41, 42]]
    je = JaxEngine(jcfg, JaxEngineConfig(page_size=8, num_pages=32, max_model_len=64,
                                         max_batch_size=2, attn_impl="reference"), params=jp)
    te = LLMEngine(tcfg, EngineConfig(page_size=8, num_pages=32, max_model_len=64,
                                      max_batch_size=2), params=tp, device="cpu")
    jo = je.generate(prompts, JaxSamplingParams(max_tokens=6, temperature=0.0))
    to = te.generate(prompts, SamplingParams(max_tokens=6, temperature=0.0))
    assert jo == to
    rc, stdout, _ = _run_main(make_checkpoint.main, ["--shape", "tiny", "--out", out])
    assert rc == 0 and stdout == f"exists: {out}\n"
    with pytest.raises(SystemExit, match="dense families"):
        make_checkpoint.main(["--shape", "tiny-moe", "--out", str(tmp_path / "moe")])


# -- ci_gate -------------------------------------------------------------------------


def _reference_roster() -> list[str]:
    src = (REPO / "tools" / "ci_gate.py").read_text()
    # every stage tuple: ("name", [command...], env) or ("pytest", pytest_cmd, None)
    names = re.findall(r'\(\s*"([a-z0-9-]+)",\s*(?:\[|pytest_cmd\b)', src)
    assert 'f"dryrun-multichip-{n}"' in src
    return names + ["dryrun-multichip-8"]


def test_ci_gate_roster_is_the_reference_order():
    args = ci_gate.argparse.Namespace(quick=False, cpu=True, skip_tests=False,
                                      skip_bench=False, skip_dryrun=False)
    stages = ci_gate.stages(args)
    assert [name for name, _, _ in stages] == _reference_roster()
    cmds = {name: cmd for name, cmd, _ in stages}
    # every stage a port command; the one departure under --cpu
    assert cmds.pop("bench-tiny-attn") == ci_gate.NEEDS_CARD
    for name, cmd in cmds.items():
        assert cmd[1] == "-m" and cmd[2].startswith(("llmd_tpu_torch.tools.", "pytest")), name
    assert cmds["validate-manifests"][3:] == ["deploy"]
    assert cmds["perf-regress"][3:] == ["--candidate", "BENCH_CAMPAIGN_r05.json",
                                        "--baseline", "BENCH_r05.json"]
    # the parity files on the CPU, the card's kernel tests on the card
    assert cmds["pytest"][3:6] == ["-q", "-p", "llmd_tpu_torch.tools.ci_gate"]
    assert "tests/test_torch_gates.py" in cmds["pytest"] and cmds["pytest"][-2:] == [
        "-m", "not gpu"]
    on_card = ci_gate.stages(ci_gate.argparse.Namespace(**{**vars(args), "cpu": False}))
    assert [n for n, _, _ in on_card] == _reference_roster()
    assert all("--cpu" not in cmd for _, cmd, _ in on_card)
    card = {n: c for n, c, _ in on_card}
    assert "--tune-attn" in card["bench-tiny-attn"]
    assert card["pytest"][3:] == ["-q", "--noconftest", "-p", "llmd_tpu_torch.tools.ci_gate",
                                  "-m", "gpu", "tests/test_torch_kernel_gpu.py"]


@pytest.mark.parametrize("fail", [None, "kv-durability-check"])
def test_ci_gate_main_summary(fail, monkeypatch, capsys):
    seen = []

    def fake_stage(name, cmd, env=None):
        seen.append(name)
        return {"stage": name, "ok": name != fail, "rc": int(name == fail), "seconds": 0.0}

    monkeypatch.setattr(ci_gate, "run_stage", fake_stage)
    rc = ci_gate.main(["--cpu"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == (0 if fail is None else 1)
    assert last["gate"] == ("ok" if fail is None else "failed")
    assert list(last) == ["gate", "stages"]
    assert [s["stage"] for s in last["stages"]] == _reference_roster()
    for s in last["stages"]:
        if s["stage"] == "bench-tiny-attn":
            assert s == {"stage": "bench-tiny-attn", "skipped": "needs the card"}
        else:
            assert list(s) == ["stage", "ok", "rc", "seconds"]
    assert "bench-tiny-attn" not in seen
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ci_gate.main([]) == 2  # no card and no --cpu: an error, never the CPU


def test_ci_gate_pytest_plugin_fails_a_session_without_a_pass():
    class Session:
        exitstatus = 0

        def __init__(self, stats):
            tr = type("TR", (), {"stats": stats})()
            pm = type("PM", (), {"get_plugin": lambda self, name: tr})()
            self.config = type("C", (), {"pluginmanager": pm})()

    for stats, want in (({}, 5), ({"skipped": [1]}, 5), ({"passed": [1]}, 0)):
        s = Session(stats)
        ci_gate.pytest_sessionfinish(s, 0)
        assert s.exitstatus == want, stats


def test_ci_gate_module_registers_as_a_pytest_plugin():
    """pytest takes the module as a plugin (every ``pytest_*`` name a known
    hook), as the pytest stage's ``-p llmd_tpu_torch.tools.ci_gate`` loads it."""
    from _pytest.config import get_config

    pm = get_config().pluginmanager
    pm.register(ci_gate, "ci-gate-plugin")
    assert pm.get_plugin("ci-gate-plugin") is ci_gate
    assert [n for n in vars(ci_gate) if n.startswith("pytest_")] == ["pytest_sessionfinish"]
