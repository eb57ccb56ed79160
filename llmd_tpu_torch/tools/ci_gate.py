"""One-command gate of the port (port of ``tools/ci_gate.py``: the same stage
names in the same order, each stage a port command, one JSON summary line and
one exit code).

Usage: python -m llmd_tpu_torch.tools.ci_gate [--quick] [--skip-tests]
           [--skip-bench] [--skip-dryrun] [--cpu]
  --quick: -x on pytest and a 2-rank dry run (PR-sized; nightly runs full)
  --cpu:   every stage on the CPU (the reference's ``CPU_ENV``); without it the
           engine stages run on the card, and a machine without one is an error:
           the gate never picks the CPU by itself

Each stage is ``python -m llmd_tpu_torch.tools.<name>`` (the bench stages
``llmd_tpu_torch.tools.bench --tiny`` with the reference's flags), run from
the repo root. The stages that build an engine take ``--cpu`` under
``--cpu``; the rest are host code. ``perf-regress`` runs the comparator over
the reference stage's two pinned files: TPU runs of the JAX package, so it
exercises the comparator only and reads no speed of the port.

The pytest stage runs what of the port's tests the machine can run: under
``--cpu`` the ``tests/test_torch_*.py`` parity files where jax imports (they
hold the port against the JAX package on the CPU; without jax the stage
fails), on the card ``-m gpu tests/test_torch_kernel_gpu.py`` (the card's
machine lacks the parity files' references: no ``transformers``). A stage
that ran no test is not ok: this module is loaded into that pytest as a
plugin (``-p``) whose ``pytest_sessionfinish`` turns a session without a
passed test into exit code 5.

Departure, kept on purpose: under ``--cpu`` the ``bench-tiny-attn`` stage is
recorded as ``{"stage": "bench-tiny-attn", "skipped": "needs the card"}``:
the port's bench times K1's launch plans on the card and refuses
``--tune-attn`` with ``--cpu``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NEEDS_CARD = "needs the card"
PINNED = ("--candidate", "BENCH_CAMPAIGN_r05.json", "--baseline", "BENCH_r05.json")


def run_stage(name: str, cmd: list[str], env=None) -> dict:
    t0 = time.monotonic()
    print(f"=== {name}: {' '.join(cmd)}", flush=True)
    p = subprocess.run(cmd, cwd=ROOT, env=env or os.environ)
    dt = time.monotonic() - t0
    ok = p.returncode == 0
    print(f"=== {name}: {'OK' if ok else f'FAILED rc={p.returncode}'} "
          f"({dt:.1f}s)", flush=True)
    return {"stage": name, "ok": ok, "rc": p.returncode, "seconds": round(dt, 1)}


def pytest_sessionfinish(session, exitstatus) -> None:
    """The pytest stage's plugin hook: a session that passed no test fails
    with pytest's "no tests" code (5), skipped tests included."""
    tr = session.config.pluginmanager.get_plugin("terminalreporter")
    if exitstatus == 0 and not (tr is not None and tr.stats.get("passed")):
        session.exitstatus = 5


def tests_command(py: str, quick: bool, cpu: bool) -> "list[str] | None":
    """The pytest stage's command: under ``--cpu`` the parity files (None
    where jax does not import: no test of the port runs then); on the card
    the card's kernel tests."""
    if cpu:
        if importlib.util.find_spec("jax") is None:
            return None
        cmd = [py, "-m", "pytest", "-q", "-p", "llmd_tpu_torch.tools.ci_gate",
               *sorted(os.path.relpath(p, ROOT) for p in _torch_tests()), "-m", "not gpu"]
    else:
        # the tests' conftest imports jax, and the card's machine lacks the
        # parity files' other references (transformers among them)
        cmd = [py, "-m", "pytest", "-q", "--noconftest", "-p", "llmd_tpu_torch.tools.ci_gate",
               "-m", "gpu", "tests/test_torch_kernel_gpu.py"]
    if quick:
        cmd.append("-x")
    return cmd


def _torch_tests() -> list[str]:
    tests = os.path.join(ROOT, "tests")
    return [os.path.join(tests, n) for n in os.listdir(tests)
            if n.startswith("test_torch_") and n.endswith(".py")]


def stages(args: argparse.Namespace) -> list[tuple]:
    """(name, command or the skip reason, env) in the reference's order."""
    py = sys.executable
    dev = ["--cpu"] if args.cpu else []

    def tool(name: str, *extra: str) -> list[str]:
        return [py, "-m", f"llmd_tpu_torch.tools.{name}", *extra]

    out = [
        ("lint-envvars", tool("lint_envvars"), None),
        ("lint-metrics", tool("lint_metrics"), None),
        ("lint-events", tool("lint_events"), None),
        # unified static analysis: lock discipline, deadlock order, hot-path
        # purity (PyTorch's syncs), env/metrics/events contracts
        ("llmd-lint", tool("llmd_lint"), None),
        ("validate-manifests", tool("validate_manifests", "deploy"), None),
        ("chaos-check", tool("chaos_check"), None),
        # structured outputs: constrained generations must conform 100% and
        # malformed schemas must 400 before admission
        ("structured-check", tool("structured_check", *dev), None),
        # closed autoscaling loop: 10x swing + replica kill/flap mid-burst,
        # SLO attainment >= 95%, zero 5xx, back to floor, warm 0->1 < cold
        ("slo-check", tool("slo_check"), None),
        # device plane: watchdog trips on synthetic stall, fabric probe
        # timeout path, HBM gauges, profiler capture
        ("device-obs", tool("device_obs_check", *dev), None),
        # global KV plane: precise routing >= 90% prefix-served, cross-engine
        # pull exercised, engine killed mid-run with zero 5xx, index bounded
        ("kv-plane-check", tool("kv_plane_check"), None),
        # decision plane: 100% of retired requests carry a ledger, regret +
        # calibration families exported, zero 5xx, router-overhead bound
        ("decision-check", tool("decision_check"), None),
        # durable prefix tier: five-rung token identity, scale-to-zero ->
        # scale-up restores the working set from the store, store killed
        # mid-run with zero 5xx
        ("kv-durability-check", tool("kv_durability_check", *dev), None),
        # P/D disaggregation: predictor-gated splitting, independent P and D
        # scaling, kv_pull phase ledgers, a mid-burst prefill-pool kill
        ("pd-check", tool("pd_check"), None),
        # the comparator over the reference stage's pinned files
        ("perf-regress", tool("perf_regress", *PINNED), None),
    ]
    if not args.skip_tests:
        # the parity tests import jax: the reference package on the CPU
        out.append(("pytest", tests_command(py, args.quick, args.cpu),
                    {**os.environ, "JAX_PLATFORMS": "cpu"}))
    if not args.skip_bench:
        bench = tool("bench", "--tiny", *dev)
        # utilization plane: goodput fractions sum to 1 per program, MFU/MBU
        # families, capture counter flat in steady state, ledger == /metrics
        out.append(("util-check", tool("util_check", *dev), None))
        out.append(("bench-tiny-cpu", bench, None))
        # spec_mode=ngram smoke: drafting, mixed-batch verify, rollback
        out.append(("bench-tiny-spec", bench + ["--spec-mode", "ngram", "--workload", "echo"],
                    None))
        # K1's launch-plan tune round trip: candidate sweep on the card ->
        # tune-file merge -> engine load
        out.append(("bench-tiny-attn", NEEDS_CARD if args.cpu else bench + ["--tune-attn"],
                    None))
        # structured json workload: the masked decode chain, zero violations
        out.append(("bench-tiny-structured", bench + ["--workload", "json"], None))
        # structured x speculative compose: grammar-masked verify lands
        # accepted drafts on constrained rows with zero violations
        out.append(("bench-tiny-spec-structured",
                    bench + ["--batch", "2", "--spec-mode", "ngram", "--spec-tokens", "63",
                             "--workload", "json-echo", "--isl", "32", "--osl", "384",
                             "--assert-spec-structured"], None))
        # warm-start probe: cold/warm child launches over one library cache
        out.append(("bench-tiny-warmstart",
                    tool("warm_start_probe", *dev, "--cache-dir",
                         "campaign_logs/ci_warm_cache"), None))
        # MoE dispatch: sorted selected, greedy parity vs einsum, zero drops
        # on sorted and provable drops on capacity-starved einsum
        out.append(("bench-tiny-moe", tool("moe_check", *dev), None))
    if not args.skip_dryrun:
        n = 2 if args.quick else 8
        out.append((f"dryrun-multichip-{n}", tool("dryrun", str(n)), None))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="PR-sized: pytest -x, 2-rank dry run")
    ap.add_argument("--skip-tests", action="store_true")
    ap.add_argument("--skip-bench", action="store_true")
    ap.add_argument("--skip-dryrun", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run every stage on the CPU; default the card")
    args = ap.parse_args(argv)

    import torch

    if not args.cpu and not torch.cuda.is_available():
        print("ci_gate: no CUDA device; the gate runs on the card unless --cpu is given",
              file=sys.stderr)
        return 2
    results = []
    for name, cmd, env in stages(args):
        if cmd == NEEDS_CARD:
            print(f"=== {name}: skipped ({cmd})", flush=True)
            results.append({"stage": name, "skipped": cmd})
        elif cmd is None:
            print(f"=== {name}: FAILED: no test of the port runs on this machine",
                  flush=True)
            results.append({"stage": name, "ok": False, "rc": None, "seconds": 0.0})
        else:
            results.append(run_stage(name, cmd, env))
    ok = all(r["ok"] for r in results if "skipped" not in r)
    print(json.dumps({"gate": "ok" if ok else "failed", "stages": results}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
