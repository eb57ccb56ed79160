"""The decision ledger's router-overhead bound (port of ``router_overhead``
and ``--router-overhead`` of ``tools/perf_regress.py``: the same scheduler
graph, request streams, best-of-rounds timing and bound).

The rest of the reference's tool compares a ``bench.py`` JSON against a
pinned TPU baseline (``BENCH_r05.json``); the port's bench has no pinned
baseline of its own yet.

Usage: python -m llmd_tpu_torch.tools.perf_regress --router-overhead
           [--json-out PATH]
"""

from __future__ import annotations

import argparse
import json
import sys


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
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--router-overhead", action="store_true", required=True,
                    help="in-process CPU smoke: assert the decision ledger "
                         "adds <2%% (or <25µs/call) to schedule latency")
    ap.add_argument("--json-out", metavar="PATH",
                    help="write the JSON verdict to PATH")
    args = ap.parse_args(argv)
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


if __name__ == "__main__":
    sys.exit(main())
