"""Perf regression gate: compare a bench JSON against a pinned baseline
(port of ``tools/perf_regress.py``: the comparator's tolerances, provenance
guard, verdict JSON and markdown, and its flags; ``ci_gate`` stage
``perf-regress``), and the decision ledger's router-overhead bound
(``router_overhead``, ``--router-overhead``: the same scheduler graph,
request streams, best-of-rounds timing and bound).

Given a candidate bench payload — a bench final-JSON line, a
``BENCH_*.json`` wrapper, or a campaign file — the comparator checks every
shared numeric metric against the baseline under per-metric tolerances and
emits a machine verdict (JSON) plus a human one (markdown table). When the
candidate's ``device`` or ``point`` differs from the baseline's, throughput
metrics are reported as ``skipped``: the gate then checks plumbing (payload
shape, counter sanity) only. ``--run`` executes the port's bench
(``llmd_tpu_torch.tools.bench``) and gates its payload. The repo's pinned
``BENCH_*.json`` files are TPU runs of the JAX package: comparing two of them
exercises the comparator and says nothing of the port's speed.

Usage:
  python -m llmd_tpu_torch.tools.perf_regress --candidate BENCH_CAMPAIGN_r05.json \
      --baseline BENCH_r05.json [--point P] [--json-out F] [--md-out F]
  python -m llmd_tpu_torch.tools.perf_regress --run [--baseline F] -- --tiny --cpu
  python -m llmd_tpu_torch.tools.perf_regress --router-overhead [--json-out PATH]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import Optional

# Per-metric relative tolerances. Throughput/latency jitter run-to-run even
# on pinned hardware; counters must match exactly.
DEFAULT_REL_TOL = 0.10
TOLERANCES = {
    "value": 0.08,
    "decode_tok_per_s": 0.08,
    "wall_s": 0.15,
    "host_pack_us_per_call": 0.25,
    "device_ms_per_decode_call": 0.15,
    "host_device_rtt_ms": 0.30,
    "launch_gap_s": 0.50,
    "host_pack_s": 0.50,
    "postprocess_s": 0.50,
    "prefill_steps_s": 0.25,
    "decode_steps_s": 0.25,
    "device_s": 0.15,
    "device_decode_s": 0.15,
    "weights_bw_gbs": 0.15,
    # counters: exact
    "prefill_tokens": 0.0,
    "decode_tokens": 0.0,
    "preemptions": 0.0,
    "unified_steps": 0.0,
    "decode_calls": 0.0,
    "batch": 0.0,
    "isl": 0.0,
    "osl": 0.0,
    # utilization plane: slot-token fate counters are deterministic
    # for a fixed workload — exact; recompiles must stay at the baseline's
    # (0 in steady state). padding_efficiency is a HIGHER_BETTER ratio below.
    "goodput_committed_tokens": 0.0,
    "goodput_spec_rejected_tokens": 0.0,
    "goodput_padding_tokens": 0.0,
    "goodput_preempted_recompute_tokens": 0.0,
    "goodput_prefix_saved_tokens": 0.0,
    "recompiles": 0.0,
    "padding_efficiency": 0.05,
}
# Ratios/utilizations vs an external baseline drift when the reference moves;
# informational only.
IGNORED = {"vs_baseline", "decode_vs_baseline", "weights_bw_util",
           "decode_weights_bw_util", "decode_mfu"}
# Lower-is-better metrics (a candidate UNDER baseline is an improvement, not
# a regression — only the upward direction fails).
LOWER_BETTER = {"wall_s", "host_pack_us_per_call", "device_ms_per_decode_call",
                "host_device_rtt_ms", "launch_gap_s", "host_pack_s",
                "postprocess_s", "prefill_steps_s", "decode_steps_s",
                "device_s", "device_decode_s"}
# Higher-is-better: only the downward direction fails.
HIGHER_BETTER = {"value", "decode_tok_per_s", "weights_bw_gbs",
                 "padding_efficiency"}

PROVENANCE_KEYS = ("device", "point", "weights", "quantize")


def extract_payload(data, point: Optional[str] = None) -> dict:
    """Normalize any of the three bench JSON shapes to one flat metrics dict:
    a bare bench.py final line, a BENCH_rNN wrapper ({"parsed": {...}}), or
    a campaign file ({"results": [...]}, selected by ``point``)."""
    if isinstance(data, dict) and "parsed" in data:
        return data["parsed"] or {}
    if isinstance(data, dict) and "results" in data:
        results = data["results"] or []
        if point:
            for r in results:
                if r.get("point") == point:
                    return r
            raise SystemExit(f"point {point!r} not in campaign "
                             f"(have {[r.get('point') for r in results]})")
        return results[0] if results else {}
    if isinstance(data, dict):
        return data
    raise SystemExit(f"unrecognized bench payload shape: {type(data).__name__}")


def comparable(candidate: dict, baseline: dict) -> tuple[bool, str]:
    """Like-for-like provenance check. Differing device/point/config means
    throughput numbers measure different things."""
    for key in PROVENANCE_KEYS:
        c, b = candidate.get(key), baseline.get(key)
        if c and b and c != b:
            return False, f"{key}: candidate={c!r} baseline={b!r}"
    return True, ""


def compare(candidate: dict, baseline: dict) -> dict:
    """Per-metric verdicts. Returns {"ok", "provenance", "rows": [...]} where
    each row is {metric, candidate, baseline, rel_delta, tol, status}."""
    like, why = comparable(candidate, baseline)
    rows = []
    ok = True
    for key in sorted(baseline):
        b = baseline[key]
        if not isinstance(b, (int, float)) or isinstance(b, bool):
            continue
        if key in IGNORED:
            continue
        c = candidate.get(key)
        if not isinstance(c, (int, float)) or isinstance(c, bool):
            rows.append({"metric": key, "candidate": None, "baseline": b,
                         "rel_delta": None, "tol": None, "status": "missing"})
            # a missing metric is a payload-shape regression even across
            # provenance boundaries — bench.py stopped emitting it
            ok = False
            continue
        if not like:
            rows.append({"metric": key, "candidate": c, "baseline": b,
                         "rel_delta": None, "tol": None, "status": "skipped"})
            continue
        tol = TOLERANCES.get(key, DEFAULT_REL_TOL)
        delta = (c - b) / b if b else (0.0 if c == b else float("inf"))
        regressed = abs(delta) > tol
        if key in LOWER_BETTER and delta < 0:
            regressed = False  # faster than baseline: improvement
        if key in HIGHER_BETTER and delta > 0:
            regressed = False  # more throughput than baseline: improvement
        status = "fail" if regressed else "pass"
        if regressed:
            ok = False
        rows.append({"metric": key, "candidate": c, "baseline": b,
                     "rel_delta": round(delta, 4), "tol": tol,
                     "status": status})
    return {"ok": ok, "comparable": like,
            "provenance": why or "like-for-like", "rows": rows}


def render_markdown(verdict: dict, candidate_src: str, baseline_src: str) -> str:
    lines = [
        f"## perf-regress: {'PASS' if verdict['ok'] else 'FAIL'}",
        "",
        f"- candidate: `{candidate_src}`",
        f"- baseline: `{baseline_src}`",
        f"- provenance: {verdict['provenance']}"
        + ("" if verdict["comparable"]
           else " — throughput metrics skipped (shape-only gate)"),
        "",
        "| metric | candidate | baseline | Δ rel | tol | status |",
        "|---|---:|---:|---:|---:|---|",
    ]
    for r in verdict["rows"]:
        delta = "" if r["rel_delta"] is None else f"{r['rel_delta']:+.2%}"
        tol = "" if r["tol"] is None else f"{r['tol']:.0%}"
        cand = "—" if r["candidate"] is None else r["candidate"]
        lines.append(f"| {r['metric']} | {cand} | {r['baseline']} "
                     f"| {delta} | {tol} | {r['status']} |")
    return "\n".join(lines)


def run_bench(bench_args: list[str]) -> dict:
    """--run mode: execute the port's bench (``python -m
    llmd_tpu_torch.tools.bench``), parse its final stdout JSON line (the
    bench prints #-commentary to stderr and one JSON object to stdout)."""
    cmd = [sys.executable, "-m", "llmd_tpu_torch.tools.bench"] + bench_args
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-4000:])
        raise SystemExit(f"bench failed rc={proc.returncode}: {' '.join(cmd)}")
    payload = None
    for line in reversed(proc.stdout.strip().splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                payload = json.loads(line)
                break
            except json.JSONDecodeError:
                continue
    if payload is None:
        raise SystemExit("bench produced no JSON line on stdout")
    return payload


ROUTER_OVERHEAD_REL = 0.02   # decision ledger must stay under +2% schedule cost
ROUTER_OVERHEAD_ABS_S = 25e-6  # OR under 25µs/call absolute (timer-noise floor
                               # for a schedule call measured in tens of µs)


def router_overhead(n_endpoints: int = 6, n_requests: int = 400,
                    rounds: int = 3) -> dict:
    """CPU bench smoke for the decision-ledger overhead bound: build the same
    scheduler twice (the knob is cached at construction), drive identical
    request streams with LLMD_DECISION_LEDGER off then on, and compare
    best-of-``rounds`` mean schedule latency. Passes when the ledger adds
    <2% relative OR <25µs/call absolute — 2% of a ~50µs schedule call is
    below timer noise, so the absolute epsilon is the honest floor."""
    import os
    import time

    from llmd_tpu_torch.core.config import FrameworkConfig
    from llmd_tpu_torch.core.endpoint import Endpoint, EndpointPool
    from llmd_tpu_torch.core.metrics_contract import StdMetric
    from llmd_tpu_torch.core.request import InferenceRequest
    from llmd_tpu_torch.router import filters_pickers as _fp  # noqa: F401
    from llmd_tpu_torch.router import scorers as _s  # noqa: F401
    from llmd_tpu_torch.router.plugins import known_plugin_types
    from llmd_tpu_torch.router.scheduler import Scheduler

    cfg_yaml = """
plugins:
  - {name: queue, type: queue-depth-scorer}
  - {name: kv-util, type: kv-cache-utilization-scorer}
schedulingProfiles:
  - name: default
    plugins:
      - {pluginRef: queue, weight: 2}
      - {pluginRef: kv-util, weight: 1}
"""
    pool = EndpointPool()
    for i in range(n_endpoints):
        ep = Endpoint(address=f"10.0.0.{i}:8000")
        ep.attrs.put(StdMetric.QUEUED_REQUESTS, float(i))
        ep.attrs.put(StdMetric.KV_UTILIZATION, 0.1 * i)
        pool.upsert(ep)

    def bench(enabled: bool) -> float:
        os.environ["LLMD_DECISION_LEDGER"] = "1" if enabled else "0"
        sched = Scheduler(
            FrameworkConfig.from_yaml(cfg_yaml,
                                      known_types=known_plugin_types()),
            pool)
        best = float("inf")
        for _ in range(rounds):
            reqs = [InferenceRequest(prompt=f"bench-{i}")
                    for i in range(n_requests)]
            t0 = time.perf_counter()
            for req in reqs:
                sched.schedule(req)
            best = min(best, (time.perf_counter() - t0) / n_requests)
        return best

    bench(False)  # warm imports/allocators outside the measured rounds
    off_s = bench(False)
    on_s = bench(True)
    delta_s = on_s - off_s
    rel = delta_s / off_s if off_s > 0 else 0.0
    ok = rel <= ROUTER_OVERHEAD_REL or delta_s <= ROUTER_OVERHEAD_ABS_S
    return {
        "router_overhead": "ok" if ok else "failed",
        "schedule_us_off": round(off_s * 1e6, 2),
        "schedule_us_on": round(on_s * 1e6, 2),
        "delta_us": round(delta_s * 1e6, 2),
        "rel_delta": round(rel, 4),
        "rel_bound": ROUTER_OVERHEAD_REL,
        "abs_bound_us": ROUTER_OVERHEAD_ABS_S * 1e6,
        "n_endpoints": n_endpoints,
        "n_requests": n_requests,
        "ok": ok,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Compare bench JSON against a pinned baseline")
    ap.add_argument("--candidate",
                    help="bench/campaign JSON file (omit with --run)")
    ap.add_argument("--baseline", default="BENCH_r05.json",
                    help="pinned baseline JSON (default BENCH_r05.json)")
    ap.add_argument("--point", default=None,
                    help="campaign point to select (default: the baseline's "
                         "own point when set, else the first result)")
    ap.add_argument("--run", action="store_true",
                    help="run the port's bench (args after --) and gate its output")
    ap.add_argument("--router-overhead", action="store_true",
                    help="in-process CPU smoke: assert the decision ledger "
                         "adds <2%% (or <25µs/call) to schedule latency")
    ap.add_argument("--json-out", metavar="PATH",
                    help="write the JSON verdict to PATH")
    ap.add_argument("--md-out", metavar="PATH",
                    help="write the markdown verdict to PATH")
    ap.add_argument("bench_args", nargs="*",
                    help="with --run: arguments passed through to the bench")
    args = ap.parse_args(argv)

    if args.router_overhead:
        verdict = router_overhead()
        if args.json_out:
            with open(args.json_out, "w") as f:
                json.dump(verdict, f, indent=2)
        print(json.dumps(verdict, indent=2))
        if not verdict["ok"]:
            print(f"perf-regress: FAIL (decision ledger adds "
                  f"{verdict['delta_us']}µs = {verdict['rel_delta']:+.2%} "
                  f"per schedule call)", file=sys.stderr)
            return 1
        print("perf-regress: PASS (router overhead)", file=sys.stderr)
        return 0

    with open(args.baseline) as f:
        baseline = extract_payload(json.load(f))

    if args.run:
        candidate_src = f"llmd_tpu_torch.tools.bench {' '.join(args.bench_args)}"
        candidate = run_bench(args.bench_args)
    elif args.candidate:
        candidate_src = args.candidate
        with open(args.candidate) as f:
            data = json.load(f)
        # default campaign point: mirror the baseline so the always-on CI
        # stage compares identical provenance
        point = args.point or (baseline.get("point")
                               if isinstance(data, dict) and "results" in data
                               else None)
        candidate = extract_payload(data, point=point)
    else:
        ap.error("need --candidate FILE or --run")
        return 2

    verdict = compare(candidate, baseline)
    verdict["candidate_src"] = candidate_src
    verdict["baseline_src"] = args.baseline
    md = render_markdown(verdict, candidate_src, args.baseline)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(verdict, f, indent=2)
    if args.md_out:
        with open(args.md_out, "w") as f:
            f.write(md + "\n")
    print(md)
    failed = [r["metric"] for r in verdict["rows"] if r["status"] in
              ("fail", "missing")]
    if failed:
        print(f"\nperf-regress: FAIL ({len(failed)} metric(s): "
              f"{', '.join(failed[:8])})", file=sys.stderr)
        return 1
    print("\nperf-regress: PASS", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
