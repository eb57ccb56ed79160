"""SLO gate: the closed autoscaling loop under a 10x swing with replica chaos
(copy of ``tools/slo_check.py`` over the port's pool, router and fake
replicas; no jax, no aiohttp).

End-to-end over the real stack, no hardware: the pool controller
(``llmd_tpu_torch/pool/``) owns replica lifecycle against in-process fake engines, the
real RouterServer fronts them (discovery, flow control, breakers, retries),
and a bursty trace (pool/traces.py) swings traffic 10x while the gate

- KILLS one replica mid-burst (no drain — the controller's health sweep and
  the router's breakers must both notice), and
- FLAPS another (up/down on a schedule) for the burst's duration.

Asserts:

1. SLO attainment ≥ 95% (success within the e2e SLO, failures count against),
2. ZERO client-visible 5xx / transport errors,
3. the pool scales up under the burst and returns to the floor after it,
4. a 0→1 warm start (snapshot restore) beats the cold engine build in the
   reported warm-start metric,
5. the warm start restores repeat-prefix TTFT too (the durable tier): the
   graceful scale-to-zero drained — write-back — so the woken replica serves
   a pre-drain prefix without recomputing it (cached-token parity; the fake's
   prefill cost ∝ uncached tokens, so cached parity is TTFT parity).

Run: python -m llmd_tpu_torch.tools.slo_check  (``--full`` runs a longer
trace for local investigation.) Exit 0 when every check holds.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import tempfile
import time

from llmd_tpu_torch.router.http import HTTPClient


def gate_env() -> None:
    """Retries sized to the max pool so every request can reach a live
    replica; short backoff/cooldown keep the gate inside seconds. Set before
    the router is built (it reads them then), never at import."""
    os.environ.setdefault("LLMD_RETRY_MAX_ATTEMPTS", "4")
    os.environ.setdefault("LLMD_RETRY_BACKOFF_MS", "5")
    os.environ.setdefault("LLMD_RETRY_BACKOFF_MAX_MS", "50")
    os.environ.setdefault("LLMD_BREAKER_COOLDOWN_S", "0.5")


async def _get_json(client: HTTPClient, url: str, timeout: float = 10.0):
    r = await client.request("GET", url, timeout=timeout)
    return await r.json()


async def _post(client: HTTPClient, url: str, body: dict,
                timeout: float = 20.0) -> tuple[int, bytes, dict]:
    """(status, body bytes, headers) of one JSON POST."""
    r = await client.request("POST", url, json_body=body, timeout=timeout)
    return r.status, await r.read(), r.headers


SLO_E2E_S = 2.5
ATTAINMENT_FLOOR = 0.95


async def decision_ledger_coverage(base: str) -> tuple[int, int]:
    """(finished, with_decision_ledger) over the router's flight ring: with
    the ledger on (default), 100% of retired requests must carry a
    ``decision`` in ``/debug/requests/<id>``."""
    finished = with_ledger = 0
    client = HTTPClient()
    try:
        rows = (await _get_json(client, f"http://{base}/debug/requests"
                                f"?status=finished&limit=500")).get("requests", [])
        for row in rows:
            rid = row.get("request_id", "")
            detail = await _get_json(client, f"http://{base}/debug/requests/{rid}")
            finished += 1
            d = detail.get("decision")
            if d and d.get("profiles"):
                with_ledger += 1
    finally:
        await client.close()
    return finished, with_ledger

CFG = """
flowControl:
  enabled: true
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


async def chaos(controller, burst_start_s: float, burst_len_s: float,
                t0: float, injected: dict) -> None:
    """Mid-burst: kill one replica outright, flap another."""
    await asyncio.sleep(max(0.0, t0 + burst_start_s + 0.6 - time.monotonic()))
    flapped = None
    replicas = sorted(controller.replicas)
    if len(replicas) >= 2:
        victim = controller.replicas[replicas[0]]
        await controller.launcher.kill(victim)
        injected["killed"] = victim.address
    replicas = [a for a in sorted(controller.replicas)
                if a != injected.get("killed")]
    if replicas:
        flapped = controller.replicas[replicas[-1]]
        if flapped.server is not None:
            flapped.server.set_faults(flap_period_s=0.6, flap_duty=0.5)
            injected["flapped"] = flapped.address
    await asyncio.sleep(max(0.0, t0 + burst_start_s + burst_len_s
                            - time.monotonic()))
    if flapped is not None and flapped.server is not None:
        flapped.server.set_faults(flap_period_s=0.0)


async def main_async(full: bool) -> int:
    from llmd_tpu_torch.core.config import FrameworkConfig
    from llmd_tpu_torch.core.endpoint import EndpointPool
    from llmd_tpu_torch.pool.controller import PoolConfig, PoolController
    from llmd_tpu_torch.pool.harness import replay_trace
    from llmd_tpu_torch.pool.launcher import FakeReplicaLauncher
    from llmd_tpu_torch.pool.snapshot import PoolSnapshotStore
    from llmd_tpu_torch.pool.traces import bursty_trace
    from llmd_tpu_torch.router import filters_pickers as _fp  # noqa: F401
    from llmd_tpu_torch.router import scorers as _s  # noqa: F401
    from llmd_tpu_torch.router.plugins import known_plugin_types
    from llmd_tpu_torch.router.server import RouterServer
    from llmd_tpu_torch.testing.fake_server import FakeServerConfig

    gate_env()

    # trace shape: 10x rectangular swing
    if full:
        duration_s, base_rps, burst_rps = 24.0, 5.0, 50.0
        burst_start_s, burst_end_s = 8.0, 14.0
    else:
        duration_s, base_rps, burst_rps = 7.0, 5.0, 50.0
        burst_start_s, burst_end_s = 2.0, 4.0
    trace = bursty_trace(duration_s=duration_s, base_rps=base_rps,
                         burst_rps=burst_rps, burst_start_s=burst_start_s,
                         burst_end_s=burst_end_s, seed=42,
                         prompt_tokens=32, max_tokens=8)

    snapshot_dir = tempfile.mkdtemp(prefix="llmd-pool-snap-")
    store = PoolSnapshotStore(snapshot_dir)
    # one fake replica ≈ 20 rps (max_running 4 × ~200ms/request): the burst
    # needs 3+, the base needs 1 — the swing forces real scaling both ways
    launcher = FakeReplicaLauncher(
        server_config=FakeServerConfig(
            prefill_us_per_token=20.0, decode_us_per_token=25_000.0,
            max_running=4),
        snapshots=store,
        engine_build_s=0.7,  # simulated cold engine build the snapshot skips
        durable_store=True,  # drain write-back + warm restore (durable tier)
    )

    pool = EndpointPool()
    cfg = FrameworkConfig.from_yaml(CFG, known_types=known_plugin_types())
    router = RouterServer(cfg, pool, port=0, poll_interval_s=0.1)
    await router.start()

    controller = PoolController(
        PoolConfig(min_replicas=1, max_replicas=4, interval_s=0.25,
                   sfz_interval_s=0.05, drain_timeout_s=3.0, policy="max",
                   retention_s=30.0),
        launcher, router=router)
    t_start = time.monotonic()
    await controller.start()  # cold 0→1 launch happens here
    cold_0_to_1_s = time.monotonic() - t_start

    injected: dict = {}
    verdict = {"slo_check": "failed"}
    try:
        await asyncio.sleep(0.3)  # first metrics poll
        t0 = time.monotonic()
        chaos_task = asyncio.create_task(chaos(
            controller, burst_start_s, burst_end_s - burst_start_s, t0,
            injected))
        report = await replay_trace(router.address, trace,
                                    slo_e2e_s=SLO_E2E_S)
        await chaos_task
        n_finished, n_ledgered = await decision_ledger_coverage(
            router.address)
        # distinct launched addresses is the high-water mark: churned replicas
        # (killed + replaced) still prove the pool scaled past the floor
        peak_replicas = max(len(controller.replicas),
                            len({r.address for r in
                                 controller.launch_records}))

        # scale-down-to-floor after the burst
        floor = controller.cfg.min_replicas
        settle_deadline = time.monotonic() + (20.0 if full else 12.0)
        while (len(controller.replicas) > floor
               and time.monotonic() < settle_deadline):
            await asyncio.sleep(0.2)
        at_floor = len(controller.replicas) == floor

        # repeat-prefix probe: warm a distinctive prefix on the floor pool so
        # the durable tier has something to carry across scale-to-zero
        client = HTTPClient()
        url = f"http://{router.address}/v1/completions"
        try:
            prefix_prompt = "durable repeat prefix probe " * 8
            for _ in range(2):
                _, raw, _ = await _post(client, url, {
                    "prompt": prefix_prompt, "max_tokens": 4,
                    "model": "fake/model"})
                pre_drain = json.loads(raw)
            pre_drain_cached = int(pre_drain["usage"]["cached_tokens"])

            # 0→1 warm start: drop to zero, then one request wakes the pool
            controller.variant.min_replicas = 0
            controller.cfg.scale_to_zero = True
            controller.hpa.min_replicas = 0
            controller.wva.enforcer.scale_to_zero = True
            await controller.scale_to(0, reason="scale_to_zero")
            assert len(controller.replicas) == 0

            n_before = len(controller.launch_records)
            t_wake = time.monotonic()
            wake_status, _, _ = await _post(client, url, {
                "prompt": "wake up " * 4, "max_tokens": 4,
                "model": "fake/model"})
            warm_0_to_1_s = time.monotonic() - t_wake
            warm_records = [rec for rec in controller.launch_records[n_before:]
                            if rec.kind == "warm"]
            warm_launch_s = warm_records[0].seconds if warm_records else None

            # the warm start must restore repeat-prefix TTFT, not just
            # compile time: the graceful scale-to-zero drained (write-back),
            # so the woken replica serves the probe prefix from the durable
            # tier. In the fake's timing model prefill ∝ uncached tokens —
            # cached parity IS TTFT parity with the pre-drain repeat.
            status, raw, _ = await _post(client, url, {
                "prompt": prefix_prompt, "max_tokens": 4,
                "model": "fake/model"})
            post_wake = json.loads(raw) if status == 200 else {}
        finally:
            await client.close()
        post_wake_cached = int((post_wake.get("usage") or {})
                               .get("cached_tokens", 0))
        prefix_restored = (pre_drain_cached > 0
                          and post_wake_cached >= pre_drain_cached)

        scale_events = [e for e in router.flight.system_events()
                        if e["event"].startswith("pool_")]
        attainment_ok = report.slo_attainment >= ATTAINMENT_FLOOR
        zero_5xx = report.client_5xx == 0
        scaled_up = peak_replicas > floor
        warm_beats_cold = (warm_launch_s is not None
                           and warm_launch_s < launcher.engine_build_s
                           and warm_0_to_1_s < cold_0_to_1_s)
        ledgers_ok = n_finished > 0 and n_ledgered == n_finished
        ok = (attainment_ok and zero_5xx and scaled_up and at_floor
              and wake_status == 200 and warm_beats_cold and ledgers_ok
              and prefix_restored)
        verdict = {
            "slo_check": "ok" if ok else "failed",
            "trace": {"duration_s": duration_s, "base_rps": base_rps,
                      "burst_rps": burst_rps, "swing": burst_rps / base_rps,
                      "requests": len(trace)},
            "report": report.summary(),
            "slo_attainment_floor": ATTAINMENT_FLOOR,
            "chaos": injected,
            "replicas_peak": peak_replicas,
            "replicas_floor": floor,
            "returned_to_floor": at_floor,
            "cold_0_to_1_s": round(cold_0_to_1_s, 3),
            "warm_0_to_1_s": round(warm_0_to_1_s, 3),
            "warm_launch_s": (round(warm_launch_s, 3)
                              if warm_launch_s is not None else None),
            "engine_build_s": launcher.engine_build_s,
            "warm_beats_cold": warm_beats_cold,
            "wake_status": wake_status,
            "repeat_prefix_cached": {"pre_drain": pre_drain_cached,
                                     "post_wake": post_wake_cached},
            "launches": controller.status()["launches"],
            "pool_events": len(scale_events),
            "decision_ledgers": {"finished": n_finished,
                                 "with_ledger": n_ledgered},
            "checks": {
                "attainment": attainment_ok, "zero_5xx": zero_5xx,
                "scaled_up": scaled_up, "returned_to_floor": at_floor,
                "warm_beats_cold": warm_beats_cold,
                "decision_ledgers": ledgers_ok,
                "warm_prefix_restored": prefix_restored,
            },
        }
    finally:
        await controller.stop()
        await router.stop()

    # disagg leg: the same autoscaling contract must hold when the deployment
    # splits into role-labeled P/D pools (pd_check has the details)
    from llmd_tpu_torch.tools.pd_check import run_gate as run_pd_gate

    pd_verdict = await run_pd_gate(full)
    verdict["disagg"] = {"pd_check": pd_verdict["pd_check"],
                         "checks": pd_verdict.get("checks")}
    if pd_verdict["pd_check"] != "ok" and verdict["slo_check"] == "ok":
        verdict["slo_check"] = "failed"

    print(json.dumps(verdict, indent=2), flush=True)
    if verdict["slo_check"] != "ok":
        print(f"slo_check: FAILED — checks: {verdict.get('checks')} "
              f"disagg: {verdict.get('disagg')}", file=sys.stderr)
        return 1
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="longer trace (local investigation; CI runs tiny)")
    args = ap.parse_args()
    return asyncio.run(main_async(args.full))


if __name__ == "__main__":
    sys.exit(main())
