"""Chaos gate: the real router against fault-injected fake endpoints (copy
of ``tools/chaos_check.py`` over the port's router and fake servers; no jax,
no aiohttp).

Spins four FakeModelServers — two answering 503 to ~20% of requests, one
flapping up/down on a schedule, one healthy — puts the real RouterServer in
front, and drives a closed-loop workload through it. The resilience layer
(deadlines, retries-on-alternate-endpoint, per-endpoint breakers) must turn
that mess into a clean client experience:

- goodput (2xx) ≥ 99% of requests,
- ZERO client-visible 5xx for retryable faults.

Retry attempts are raised to the pool size so every request can reach the
healthy endpoint in the worst case — the gate then measures the router's
resilience machinery, not the luck of the scheduler draw.

Run: python -m llmd_tpu_torch.tools.chaos_check  (exit 0 when every check holds)
"""

from __future__ import annotations

import asyncio
import json
import os
import sys
import time

from llmd_tpu_torch.router.http import HTTPClient


def gate_env() -> None:
    """All four endpoints may need a try before the healthy one answers;
    short backoff + cooldown keep the whole gate inside a few seconds. Set
    before the router is built (it reads them then), never at import."""
    os.environ.setdefault("LLMD_RETRY_MAX_ATTEMPTS", "4")
    os.environ.setdefault("LLMD_RETRY_BACKOFF_MS", "5")
    os.environ.setdefault("LLMD_RETRY_BACKOFF_MAX_MS", "50")
    os.environ.setdefault("LLMD_BREAKER_COOLDOWN_S", "1.0")


N_REQUESTS = 200
CONCURRENCY = 16
GOODPUT_FLOOR = 0.99

CFG = """
plugins:
  - {name: inflight, type: inflight-load-producer}
  - {name: queue, type: queue-depth-scorer}
  - {name: kv-util, type: kv-cache-utilization-scorer}
schedulingProfiles:
  - name: default
    plugins:
      - {pluginRef: queue, weight: 2}
      - {pluginRef: kv-util, weight: 1}
"""


async def main_async() -> int:
    from llmd_tpu_torch.core.config import FrameworkConfig
    from llmd_tpu_torch.core.endpoint import Endpoint, EndpointPool
    from llmd_tpu_torch.router import filters_pickers as _fp  # noqa: F401
    from llmd_tpu_torch.router import scorers as _s  # noqa: F401
    from llmd_tpu_torch.router.plugins import known_plugin_types
    from llmd_tpu_torch.router.server import RouterServer
    from llmd_tpu_torch.testing.fake_server import FakeModelServer, FakeServerConfig

    gate_env()

    servers = [FakeModelServer(FakeServerConfig(
        prefill_us_per_token=10.0, decode_us_per_token=50.0, max_running=16,
    )) for _ in range(4)]
    for s in servers:
        await s.start()
    # the fault schedule under test: 20% retryable errors on two endpoints,
    # one endpoint flapping down half of every second, one healthy
    servers[0].set_faults(error_rate=0.2, error_status=503, seed=11)
    servers[1].set_faults(error_rate=0.2, error_status=503, seed=22)
    servers[2].set_faults(flap_period_s=1.0, flap_duty=0.5)

    pool = EndpointPool()
    for s in servers:
        pool.upsert(Endpoint(address=s.address))
    cfg = FrameworkConfig.from_yaml(CFG, known_types=known_plugin_types())
    router = RouterServer(cfg, pool, port=0, poll_interval_s=0.1)
    await router.start()

    statuses: dict[int, int] = {}
    t0 = time.monotonic()
    try:
        await asyncio.sleep(0.3)  # first metrics poll
        sem = asyncio.Semaphore(CONCURRENCY)
        sess = HTTPClient()
        try:
            async def one(i: int) -> None:
                async with sem:
                    try:
                        r = await sess.request(
                            "POST", f"http://{router.address}/v1/completions",
                            json_body={"prompt": f"chaos probe {i} " * 4,
                                       "max_tokens": 4, "model": "fake/model"},
                            timeout=30)
                        await r.read()
                        statuses[r.status] = statuses.get(r.status, 0) + 1
                    except Exception:
                        statuses[-1] = statuses.get(-1, 0) + 1

            await asyncio.gather(*(one(i) for i in range(N_REQUESTS)))
        finally:
            await sess.close()
        # decision-ledger coverage: retried/hedged chaos traffic must still
        # carry a complete routing ledger on every retirement
        from llmd_tpu_torch.tools.slo_check import decision_ledger_coverage

        n_finished, n_ledgered = await decision_ledger_coverage(
            router.address)
        snapshot = router.resilience.snapshot()
        retries = {",".join(k): c.value
                   for k, c in router.metrics.retries._children.items()}
    finally:
        await router.stop()
        for s in servers:
            await s.stop()

    wall = time.monotonic() - t0
    good = sum(n for code, n in statuses.items() if 200 <= code < 300)
    server_5xx = sum(n for code, n in statuses.items()
                     if code >= 500 or code == -1)
    goodput = good / N_REQUESTS
    injected = {f"server{i}": s.fault_counts for i, s in enumerate(servers)}
    ledgers_ok = n_finished > 0 and n_ledgered == n_finished
    verdict = goodput >= GOODPUT_FLOOR and server_5xx == 0 and ledgers_ok
    print(json.dumps({
        "chaos_check": "ok" if verdict else "failed",
        "requests": N_REQUESTS,
        "goodput": round(goodput, 4),
        "decision_ledgers": {"finished": n_finished,
                             "with_ledger": n_ledgered},
        "statuses": {str(k): v for k, v in sorted(statuses.items())},
        "injected_faults": injected,
        "breakers": snapshot["breakers"],
        "retries_by_reason": retries,
        "wall_s": round(wall, 2),
    }, indent=2), flush=True)
    if not verdict:
        print(f"chaos_check: FAILED — goodput {goodput:.4f} "
              f"(floor {GOODPUT_FLOOR}), client-visible 5xx/errors: "
              f"{server_5xx}, decision ledgers {n_ledgered}/{n_finished}",
              file=sys.stderr)
        return 1
    return 0


def main() -> int:
    return asyncio.run(main_async())


if __name__ == "__main__":
    sys.exit(main())
