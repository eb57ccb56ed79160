"""The port's load harness (``llmd_tpu_torch/benchmark``), its consumer
``tools/run_sched_comparison.py`` and the pure parts of the three gates
(``tools/chaos_check.py``, ``kv_plane_check.py``, ``decision_check.py``)
against the reference's, on the CPU.

- ``build_requests``: the same bodies as the reference's for every workload
  kind over several seeds and sizes; ``LoadResult.summary`` equal on the same
  samples (hypothesis).
- ``run_load`` closed loop and streamed against the port's fake server (TTFT
  at the first chunk, below e2e), an open-loop ladder, transport errors and a
  non-JSON body counted as errors; ``compare_targets`` over two fake servers;
  the CLI's ``main`` writes and prints its report.
- ``_knee`` equal to the reference's on ``tests/test_benchmark.py``'s cases.
- ``accuracy_from_metrics`` equal to the reference's on the same scrape text;
  each gate's verdict and check keys equal the reference's.
The whole gates and ``router_overhead`` (a timing bound) run on the card's
host in ``chip_smoke.py``, not here.
"""

import ast
import asyncio
import importlib.util
import json
import sys
from pathlib import Path

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import llmd_tpu.benchmark.harness as ref_h
import llmd_tpu_torch.benchmark.harness as port_h
import llmd_tpu_torch.testing.fake_server as port_fake
from llmd_tpu_torch.router.http import HTTPServer, Response
from llmd_tpu_torch.tools import predictor_accuracy as port_pa
from llmd_tpu_torch.tools import run_sched_comparison as port_sched
from tests.conftest import run_async

REPO = Path(__file__).resolve().parent.parent


def _ref_tool(name: str):
    """A script of the reference's ``tools/`` loaded as a module."""
    spec = importlib.util.spec_from_file_location(f"ref_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kind", ["shared-prefix", "random", "long-context"])
@pytest.mark.parametrize("seed", [0, 7, 123])
def test_build_requests_equals_the_reference(kind, seed):
    for kw in ({}, dict(num_requests=24, prefix_groups=3, prefix_words=20, prompt_words=30,
                        long_prompt_words=50, max_tokens=5, model="m")):
        ref = ref_h.build_requests(ref_h.WorkloadSpec(kind=kind, seed=seed, **kw))
        port = port_h.build_requests(port_h.WorkloadSpec(kind=kind, seed=seed, **kw))
        assert port == ref
        assert (port_h.WorkloadSpec(kind=kind, seed=seed, **kw).describe()
                == ref_h.WorkloadSpec(kind=kind, seed=seed, **kw).describe())
    with pytest.raises(ValueError):
        port_h.build_requests(port_h.WorkloadSpec(kind="nope"))


_times = st.lists(st.floats(0.0, 30.0, allow_nan=False), max_size=40)


@settings(max_examples=60, deadline=None)
@given(_times, _times, st.floats(0.0, 100.0, allow_nan=False), st.integers(0, 10_000),
       st.integers(0, 5))
def test_summary_equals_the_reference(ttfts, e2es, wall, tokens, errors):
    kw = dict(wall_s=wall, ttfts=ttfts, e2es=e2es, out_tokens=tokens, errors=errors)
    assert port_h.LoadResult(**kw).summary() == ref_h.LoadResult(**kw).summary()


def test_knee_equals_the_reference():
    ref = _ref_tool("run_sched_comparison")
    rungs = [
        {"rate_qps": 4, "req_per_s": 3.4, "ttft_p90_ms": 100.0},
        {"rate_qps": 8, "req_per_s": 6.9, "ttft_p90_ms": 120.0},
        {"rate_qps": 16, "req_per_s": 9.0, "ttft_p90_ms": 900.0},  # runaway
    ]
    cases = [rungs, rungs[:2] + [{"rate_qps": 16, "req_per_s": 5.0, "ttft_p90_ms": 140.0}],
             [{"rate_qps": 2, "req_per_s": 0.1, "ttft_p90_ms": None}], [],
             [{"rate_qps": 4, "req_per_s": 3.0, "ttft_p90_ms": None},
              {"rate_qps": 8, "req_per_s": 7.0, "ttft_p90_ms": 50.0}]]
    for c in cases:
        assert port_sched._knee(c) == ref._knee(c), c
    assert port_sched._knee(rungs) == {"knee_qps": 8, "ttft_p90_ms_at_knee": 120.0}
    assert port_sched._knee(cases[1])["knee_qps"] == 8
    # the comparison's profiles are the reference's workloads
    for servers, n in ((2, 24), (4, 96)):
        assert ({k: v.describe() for k, v in port_sched._profiles(servers, n).items()}
                == {k: v.describe() for k, v in ref._profiles(servers, n).items()})
    assert port_sched._kv_prompt(3, 5) == ref._kv_prompt(3, 5)


def _fake(**kw):
    return port_fake.FakeModelServer(port_fake.FakeServerConfig(
        prefill_us_per_token=5.0, decode_us_per_token=5.0, **kw))


def test_run_load_against_the_port_fake_server():
    async def main():
        fake, other = _fake(), _fake()
        await fake.start()
        await other.start()
        junk = HTTPServer()  # answers 200 with a body that is not JSON

        async def text(request):
            return Response(b"not json", content_type="text/plain")

        junk.add_route("POST", "/v1/completions", text)
        junk_port = await junk.start("127.0.0.1", 0)
        try:
            spec = port_h.WorkloadSpec(kind="random", num_requests=12, max_tokens=4,
                                       prompt_words=10)
            res = await port_h.run_load(fake.address, port_h.build_requests(spec),
                                        concurrency=4)
            assert res.errors == 0 and len(res.e2es) == 12 and res.out_tokens == 12 * 4
            assert res.ttfts == res.e2es  # non-streamed: TTFT is e2e
            res_s = await port_h.run_load(fake.address, port_h.build_requests(spec),
                                          concurrency=4, stream=True)
            assert res_s.errors == 0 and len(res_s.ttfts) == 12
            assert all(t < e for t, e in zip(res_s.ttfts, res_s.e2es))  # first chunk first
            rep = await port_h.run_ladder(fake.address, spec, [100.0, 200.0])
            assert [r["rate_qps"] for r in rep["ladder"]] == [100.0, 200.0]
            assert all(r["errors"] == 0 and r["requests"] == 12 for r in rep["ladder"])
            assert rep["workload"] == spec.describe()
            # a dead target and a body that is not JSON count as errors
            dead = await port_h.run_load("127.0.0.1:9", port_h.build_requests(spec)[:3])
            assert dead.errors == 3 and dead.e2es == []
            bad = await port_h.run_load(f"127.0.0.1:{junk_port}",
                                        port_h.build_requests(spec)[:3])
            assert bad.errors == 3 and bad.e2es == []
            fake.set_faults(error_rate=1.0, error_status=503)
            shed = await port_h.run_load(fake.address, port_h.build_requests(spec)[:2],
                                         stream=True)
            assert shed.errors == 2
            fake.set_faults(error_rate=0.0)
            report = await port_h.compare_targets(
                {"a": fake.address, "b": other.address},
                port_h.WorkloadSpec(kind="shared-prefix", num_requests=8, max_tokens=2,
                                    prefix_words=8, prompt_words=12), concurrency=2)
            assert set(report["targets"]) == {"a", "b"} and "b_vs_a_tput" in report["delta"]
            assert all(t["errors"] == 0 and t["requests"] == 8
                       for t in report["targets"].values())
        finally:
            await junk.stop()
            await fake.stop()
            await other.stop()

    run_async(main())


def test_benchmark_cli_writes_its_report(tmp_path, monkeypatch, capsys):
    """``python -m llmd_tpu_torch.benchmark``'s ``main``, run in a thread of
    this process against a fake server on the test's loop."""
    out = tmp_path / "report.json"

    async def serve():
        fake = _fake()
        await fake.start()
        try:
            monkeypatch.setattr(sys, "argv", [
                "benchmark", "--target", fake.address, "--workload", "random",
                "--requests", "6", "--max-tokens", "2", "--concurrency", "3", "--stream",
                "--out", str(out)])
            await asyncio.get_running_loop().run_in_executor(None, port_h.main)
        finally:
            await fake.stop()

    run_async(serve())
    written = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out) == written
    summary = written["targets"]["target"]
    assert summary["requests"] == 6 and summary["errors"] == 0
    assert written["workload"]["kind"] == "random"


SCRAPE = """# HELP llmd_tpu:predictor_calibration_ape rolling APE
# TYPE llmd_tpu:predictor_calibration_ape gauge
llmd_tpu:predictor_calibration_ape{objective="ttft",model="fake/model"} 0.25
llmd_tpu:predictor_calibration_ape{objective="e2e",model="m\\"q"} 1.5e-1
llmd_tpu:predictor_calibration_error_ms_bucket{objective="ttft",model="fake/model",le="+Inf"} 4
llmd_tpu:predictor_calibration_error_ms_sum{objective="ttft",model="fake/model"} -12.5
llmd_tpu:predictor_calibration_error_ms_count{objective="ttft",model="fake/model"} 4
llmd_tpu:predictor_calibration_error_ms_sum{objective="tpot",model=""} 3
llmd_tpu:predictor_calibration_error_ms_count{objective="tpot",model=""} 0
llmd_tpu:predictor_calibration_error_ms_count{objective="e2e",model="m\\"q"} 2
llmd_tpu:predictor_calibration_error_ms_sum{objective="e2e",model="m\\"q"} 7
vllm:num_requests_waiting 3
"""


def test_accuracy_from_metrics_equals_the_reference():
    ref = _ref_tool("predictor_accuracy")
    for text in (SCRAPE, "", "vllm:num_requests_running 1\n",
                 SCRAPE.replace("error_ms_count", "error_ms_total")):
        assert port_pa.accuracy_from_metrics(text) == ref.accuracy_from_metrics(text)
    got = port_pa.accuracy_from_metrics(SCRAPE)
    assert got["ttft/fake/model"] == {"rolling_ape": 0.25, "n": 4,
                                      "mean_signed_error_ms": -3.125}


def _verdict_keys(path: Path) -> dict:
    """Every string key of the dict literals in a gate's ``main_async``."""
    tree = ast.parse(path.read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.AsyncFunctionDef) and n.name == "main_async")
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            keys |= {k.value for k in node.keys
                     if isinstance(k, ast.Constant) and isinstance(k.value, str)}
    return keys


@pytest.mark.parametrize("gate", ["chaos_check", "kv_plane_check", "decision_check"])
def test_gate_verdict_keys_equal_the_reference(gate):
    port = _verdict_keys(REPO / "llmd_tpu_torch" / "tools" / f"{gate}.py")
    assert port == _verdict_keys(REPO / "tools" / f"{gate}.py")
    assert gate in port and ("checks" in port) == (gate != "chaos_check")
