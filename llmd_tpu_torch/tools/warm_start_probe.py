"""Real-replica warm-start probe: cold vs warm engine relaunch against one
persistent native library cache (port of ``tools/warm_start_probe.py``: the
same child launches, phase rows and JSON line; ``ci_gate`` stage
``bench-tiny-warmstart``).

The pool controller's warm-start path (``pool/controller.py``,
``pool_warm_start`` flight event) points a replica relaunch at a snapshot's
compile cache: in the port that is the native library cache
(``native/build.set_cache_dir``, which the serve CLI's ``--compile-cache-dir``
sets), so a relaunch loads the kernels' ``.so`` files instead of running
nvcc. This probe measures what that buys on a real replica: it launches the
SAME engine build twice in throwaway subprocesses sharing one cache directory
— the first (cold) populates it, the second (warm) is the relaunch the
controller performs — and reports ready-time (engine build + first generate,
which builds or loads the kernels) for both. The warm launch must run no
compiler, and on the card the cold one must have run it. CUDA graphs are
captured in every process, warm or cold. A CPU engine builds no native
library, so with ``--cpu`` the round trip is the same code and the speedup
means nothing.

Prints ONE JSON line:
``{"metric": "warm_start_speedup", "value": <cold_ready/warm_ready>, ...}``
with the full cold/warm phase rows as provenance.

Departure, kept on purpose: a child that fails or times out prints the
reference's skip line (``"skipped": "<label>-launch-failed"``) and the probe
exits 1. The reference exits 0 there (a structured skip for its campaign
runner), which would hide a launch that never ran.

Usage: python -m llmd_tpu_torch.tools.warm_start_probe [--model tiny] [--cpu]
           [--cache-dir DIR] [--keep-cache] [--timeout S]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _child(args: argparse.Namespace) -> None:
    """One replica launch: point the library cache at ``--cache-dir``, build
    the engine, run the first generate, report phase walls. Runs in its own
    process so a prior launch's loaded libraries can never masquerade as the
    persistent cache's win."""
    from llmd_tpu_torch.native import build

    build.set_cache_dir(args.cache_dir)

    from llmd_tpu_torch.core.request import SamplingParams
    from llmd_tpu_torch.engine import EngineConfig, LLMEngine
    from llmd_tpu_torch.engine.engine import resolve_device
    from llmd_tpu_torch.models import resolve_model

    device = resolve_device("cpu" if args.cpu else None)
    t0 = time.monotonic()
    cfg, params = resolve_model(args.model)
    load_s = time.monotonic() - t0
    ecfg = EngineConfig(page_size=16, num_pages=256, max_model_len=512,
                        max_batch_size=4, prefill_chunk=64, decode_steps=8)
    t0 = time.monotonic()
    eng = LLMEngine(cfg, ecfg, params=params, device=device)
    build_s = time.monotonic() - t0
    prompts = [[(i * 131 + j) % (cfg.vocab_size - 2) + 1 for j in range(32)]
               for i in range(2)]
    t0 = time.monotonic()
    out = eng.generate(prompts, SamplingParams(max_tokens=16, temperature=0.0,
                                               ignore_eos=True))
    first_generate_s = time.monotonic() - t0  # build-dominated when cold on the card
    assert sum(len(v) for v in out.values()) == 2 * 16
    print(json.dumps({
        "load_s": round(load_s, 3),
        "build_s": round(build_s, 3),
        "first_generate_s": round(first_generate_s, 3),
        # the number the controller's relaunch budget cares about: engine up
        # AND serving its first tokens (weight load excluded — a snapshot
        # restore prices that separately)
        "ready_s": round(build_s + first_generate_s, 3),
        "native_compiles": build.compiles,
        "native_libraries": sorted(build._LOADED),
    }))


def _skip(label: str, why: str, error: str = "") -> int:
    row = {"metric": "warm_start_speedup", "value": None, "unit": "x",
           "vs_baseline": None, "skipped": f"{label}-{why}"}
    if error:
        row["error"] = error[:500]
    print(json.dumps(row))
    return 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="tiny",
                    help="registry name or HF checkpoint dir (the replica "
                         "being relaunched)")
    ap.add_argument("--cpu", action="store_true",
                    help="run the launches on the CPU (the cache round trip is "
                         "the same code; the speedup is only meaningful on the card)")
    ap.add_argument("--cache-dir", default=None,
                    help="shared native library cache (default: a "
                         "campaign_logs/warm_cache dir under the repo root)")
    ap.add_argument("--keep-cache", action="store_true",
                    help="reuse an existing cache instead of wiping it first "
                         "(wiping is what makes the cold launch cold)")
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="per-launch subprocess budget in seconds")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    args.cache_dir = os.path.abspath(
        args.cache_dir or os.path.join(ROOT, "campaign_logs", "warm_cache"))
    if args.child:
        _child(args)
        return 0

    if not args.keep_cache and os.path.isdir(args.cache_dir):
        shutil.rmtree(args.cache_dir)
    os.makedirs(args.cache_dir, exist_ok=True)
    cmd = [sys.executable, "-m", "llmd_tpu_torch.tools.warm_start_probe", "--child",
           "--model", args.model, "--cache-dir", args.cache_dir]
    if args.cpu:
        cmd.append("--cpu")
    env = {**os.environ,
           "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    rows: dict[str, dict] = {}
    for label in ("cold", "warm"):
        t0 = time.monotonic()
        try:
            p = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                               env=env, timeout=args.timeout)
        except subprocess.TimeoutExpired:
            return _skip(label, "launch-timeout")
        if p.returncode != 0:
            tail = (p.stderr or p.stdout or "").strip().splitlines()
            sys.stderr.write(p.stderr[-4000:])
            return _skip(label, "launch-failed", tail[-1] if tail else "")
        row = json.loads(p.stdout.strip().splitlines()[-1])
        row["wall_s"] = round(time.monotonic() - t0, 3)
        rows[label] = row
        print(f"# {label} launch: ready {row['ready_s']:.2f}s "
              f"(build {row['build_s']:.2f}s + first-generate "
              f"{row['first_generate_s']:.2f}s; {row['native_compiles']} native "
              f"builds of {row['native_libraries']})", file=sys.stderr)
    entries = sum(len(fs) for _, _, fs in os.walk(args.cache_dir))
    cold, warm = rows["cold"], rows["warm"]
    print(json.dumps({
        "metric": "warm_start_speedup",
        "value": round(cold["ready_s"] / max(1e-9, warm["ready_s"]), 2),
        "unit": "x",
        "vs_baseline": None,
        "model": args.model,
        "cold": cold,
        "warm": warm,
        "cold_ready_s": cold["ready_s"],
        "warm_ready_s": warm["ready_s"],
        "cache_entries": entries,
        "cache_dir": args.cache_dir,
        "platform": "cpu" if args.cpu else "device",
    }))
    if warm["native_compiles"] != 0:
        print(f"warm_start_probe: FAILED — the warm launch ran the compiler "
              f"{warm['native_compiles']} times over a populated cache", file=sys.stderr)
        return 1
    if not args.cpu and cold["native_compiles"] == 0:
        print("warm_start_probe: FAILED — the cold launch on the card built no "
              "kernel library: the cache was not cold", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
