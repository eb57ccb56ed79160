"""P/D disaggregation gate: heterogeneous pools, predictor-gated splitting,
and a mid-burst prefill-pool kill (copy of ``tools/pd_check.py`` over the
port's pools, router, sidecar and fake replicas; no jax, no aiohttp).

End-to-end over the real stack, no hardware: a :class:`DisaggPoolSet`
(``llmd_tpu_torch/pool/disagg.py``) runs a prefill pool (queue-depth-driven HPA) and a
sidecar-fronted decode pool (KV-residency-driven WVA) against the real
RouterServer with the disagg profile handler, while a bursty trace of
distinct long prompts replays open-loop and the gate KILLS every prefill
replica mid-burst (no drain).

Asserts:

1. SLO attainment ≥ 95% and ZERO client-visible 5xx — the sidecar's
   aggregated fallback plus the decider's ``no_prefill_endpoint`` degrade
   path must absorb the prefill-pool kill;
2. P and D scale independently: the prefill pool scales up on queue depth
   (``hpa`` scale events) and the decode pool on KV pressure
   (``wva_saturated`` scale events) within the same run;
3. every disaggregated request's decode-replica phase ledger shows
   ``kv_pull`` — not ``prefill`` — and still sums to the wall clock;
4. short/cached prompts provably skip the hop: probe requests land
   aggregated with reason ``short_uncached_suffix`` and predictor deltas in
   the decision ledger, while split rows carry ``delta_ms`` stamps.

Run: python -m llmd_tpu_torch.tools.pd_check  (``--full`` runs a longer
trace for local investigation.) Exit 0 when every check holds.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import time

from llmd_tpu_torch.router.http import HTTPClient


def gate_env() -> None:
    """Retries sized to the decode pool; short backoff keeps the gate in
    seconds. Fake replicas admit ~2-4 concurrent requests, so TTFT pressure
    on the prefill pool shows up at gate scale as a handful of outstanding
    prefills. Set before the router and the pools are built (they read them
    then), never at import."""
    os.environ.setdefault("LLMD_RETRY_MAX_ATTEMPTS", "4")
    os.environ.setdefault("LLMD_RETRY_BACKOFF_MS", "5")
    os.environ.setdefault("LLMD_RETRY_BACKOFF_MAX_MS", "50")
    os.environ.setdefault("LLMD_BREAKER_COOLDOWN_S", "0.5")
    os.environ.setdefault("LLMD_POOL_PREFILL_QUEUE_TARGET", "2.0")


async def _completion(client: HTTPClient, base: str, prompt: str,
                      max_tokens: int) -> tuple[int, str]:
    """(status, x-llm-d-request-id) of one routed completion."""
    r = await client.request("POST", f"http://{base}/v1/completions",
                             json_body={"prompt": prompt, "max_tokens": max_tokens,
                                        "model": "fake/model"}, timeout=10)
    await r.read()
    return r.status, r.headers.get("x-llm-d-request-id", "")


async def _detail(client: HTTPClient, base: str, rid: str) -> dict:
    r = await client.request("GET", f"http://{base}/debug/requests/{rid}",
                             timeout=10)
    return await r.json()

SLO_E2E_S = 2.5
ATTAINMENT_FLOOR = 0.95

CFG = """
plugins:
  - {name: prefix-producer, type: approx-prefix-cache-producer, params: {blockSize: 16}}
  - {name: inflight, type: inflight-load-producer}
  - {name: predicted, type: predicted-latency-producer}
  - {name: prefix, type: prefix-cache-scorer}
  - {name: queue, type: queue-depth-scorer}
  - {name: kv-util, type: kv-cache-utilization-scorer}
  - {name: pre-filter, type: prefill-endpoints-filter}
  - {name: dec-filter, type: decode-endpoints-filter}
profileHandler: disagg-profile-handler
disaggregation: {uncachedSuffixThreshold: 64}
schedulingProfiles:
  - name: decode
    plugins:
      - {pluginRef: dec-filter}
      - {pluginRef: prefix, weight: 3}
      - {pluginRef: queue, weight: 2}
      - {pluginRef: kv-util, weight: 1}
  - name: prefill
    plugins:
      - {pluginRef: pre-filter}
      - {pluginRef: queue, weight: 2}
"""


async def kill_prefill_pool(pools, router, burst_start_s: float,
                            burst_end_s: float, t0: float,
                            injected: dict) -> None:
    """Mid-burst: kill EVERY prefill replica outright (no drain). The
    health sweep must deregister them, the sidecars must fall back to
    aggregated decode, and the reconcile loop relaunches the floor.

    The kill waits for splits to actually be flowing so the degrade path is
    exercised, not dodged; right after it, long-prompt probes land inside
    the no-prefill window (past the health sweep, before the relaunch) and
    must come back 200 with an aggregated ``no_prefill_endpoint`` pick."""
    await asyncio.sleep(max(0.0, t0 + burst_start_s - time.monotonic()))
    deadline = t0 + burst_end_s - 1.0
    while (router.scheduler.metrics["pd_splits_total"] < 3
           and time.monotonic() < deadline):
        await asyncio.sleep(0.05)
    injected["splits_at_kill"] = router.scheduler.metrics["pd_splits_total"]
    killed = []
    for address in sorted(pools.prefill.replicas):
        handle = pools.prefill.replicas[address]
        await pools.prefill.launcher.kill(handle)
        killed.append(address)
    injected["killed_prefill"] = killed

    await asyncio.sleep(0.35)  # let the health sweep deregister the dead
    probes = []
    client = HTTPClient()
    try:
        for i in range(3):
            prompt = f"degrade probe {i} " * 12  # well past the threshold
            try:
                status, rid = await _completion(client, router.address,
                                                prompt, 2)
                detail = await _detail(client, router.address, rid)
                pd = (detail.get("decision") or {}).get("pd") or {}
                probes.append({"status": status,
                               "decision": pd.get("decision"),
                               "reason": pd.get("reason")})
            except Exception as e:
                probes.append({"status": -1, "error": str(e)})
    finally:
        await client.close()
    injected["degrade_probes"] = probes


async def run_gate(full: bool) -> dict:
    """Run the P/D gate; returns the verdict dict (``pd_check: ok|failed``).

    Importable as the disagg leg of ``slo_check``."""
    from llmd_tpu_torch.core.config import FrameworkConfig
    from llmd_tpu_torch.core.endpoint import EndpointPool
    from llmd_tpu_torch.obs.attribution import build_ledger
    from llmd_tpu_torch.pool.controller import PoolConfig
    from llmd_tpu_torch.pool.disagg import DisaggPoolSet
    from llmd_tpu_torch.pool.harness import replay_trace
    from llmd_tpu_torch.pool.launcher import FakeReplicaLauncher
    from llmd_tpu_torch.pool.traces import bursty_trace
    from llmd_tpu_torch.router import filters_pickers as _fp  # noqa: F401
    from llmd_tpu_torch.router import latency_plugins as _lp  # noqa: F401
    from llmd_tpu_torch.router import scorers as _s  # noqa: F401
    from llmd_tpu_torch.router.plugins import known_plugin_types
    from llmd_tpu_torch.router.server import RouterServer
    from llmd_tpu_torch.testing.fake_server import FakeServerConfig

    gate_env()

    if full:
        duration_s, base_rps, burst_rps = 16.0, 4.0, 30.0
        burst_start_s, burst_end_s = 5.0, 10.0
    else:
        duration_s, base_rps, burst_rps = 7.0, 4.0, 30.0
        burst_start_s, burst_end_s = 2.0, 4.5
    trace = bursty_trace(duration_s=duration_s, base_rps=base_rps,
                         burst_rps=burst_rps, burst_start_s=burst_start_s,
                         burst_end_s=burst_end_s, seed=20,
                         prompt_tokens=256, max_tokens=8)
    # distinct prompts (the harness derives the prompt from the tenant):
    # every prompt's uncached suffix (~128 byte-tokens) clears the
    # 64-token split threshold AND builds real KV pressure on the small
    # decode pool; repeats would hit the approx prefix cache and go
    # aggregated by design
    for i, req in enumerate(trace):
        req.tenant = f"w{i}"

    # prefill pool: few admission slots + real per-token prefill cost, so a
    # burst of remote prefills builds a visible queue (the HPA signal)
    prefill_launcher = FakeReplicaLauncher(
        server_config=FakeServerConfig(
            role="prefill", num_blocks=4096, max_running=2,
            prefill_us_per_token=1500.0, decode_us_per_token=500.0),
        engine_build_s=0.8,  # relaunch-after-kill window stays observable
        role="prefill")
    # decode pool: tiny KV (util → 1.0 under distinct prompts = the WVA
    # signal) and slow decode with few slots, so the burst queues on D —
    # which is exactly what makes paying the kv_pull hop worth it
    decode_launcher = FakeReplicaLauncher(
        server_config=FakeServerConfig(
            role="decode", num_blocks=96, max_running=4,
            prefill_us_per_token=400.0, decode_us_per_token=20000.0,
            kv_pull_us_per_block=100.0),
        engine_build_s=0.2, role="decode", with_sidecar=True)

    pool = EndpointPool()
    cfg = FrameworkConfig.from_yaml(CFG, known_types=known_plugin_types())
    router = RouterServer(cfg, pool, port=0, poll_interval_s=0.1)
    await router.start()

    pools = DisaggPoolSet(
        prefill_launcher, decode_launcher, router=router,
        prefill_cfg=PoolConfig(min_replicas=1, max_replicas=3,
                               interval_s=0.3, sfz_interval_s=0.05,
                               drain_timeout_s=2.0, policy="hpa"),
        decode_cfg=PoolConfig(min_replicas=1, max_replicas=3,
                              interval_s=0.3, sfz_interval_s=0.05,
                              drain_timeout_s=2.0, policy="wva"))
    await pools.start()

    injected: dict = {}
    verdict = {"pd_check": "failed"}
    try:
        await asyncio.sleep(0.3)  # first metrics poll
        t0 = time.monotonic()
        kill_task = asyncio.create_task(kill_prefill_pool(
            pools, router, burst_start_s, burst_end_s, t0, injected))
        report = await replay_trace(router.address, trace,
                                    slo_e2e_s=SLO_E2E_S)
        await kill_task

        # ---- independent scaling: P on queue depth (hpa), D on KV (wva).
        # Both controllers log into the shared flight recorder, so attribute
        # each pool_scale_up event to its pool by launched address; the
        # event's `replicas` field is that controller's post-launch count.
        p_floor = pools.prefill.cfg.min_replicas
        d_floor = pools.decode.cfg.min_replicas
        p_addrs = {r.address for r in pools.prefill.launch_records}
        d_addrs = {r.address for r in pools.decode.launch_records}
        scale_ups = [e for e in router.flight.system_events()
                     if e["event"] == "pool_scale_up"]
        p_ups = [e for e in scale_ups if e.get("endpoint") in p_addrs]
        d_ups = [e for e in scale_ups if e.get("endpoint") in d_addrs]
        p_peak = max([e.get("replicas", 0) for e in p_ups], default=0)
        d_peak = max([e.get("replicas", 0) for e in d_ups], default=0)
        p_scaled = (p_peak > p_floor
                    and any(e.get("reason") == "hpa" for e in p_ups))
        d_scaled = (d_peak > d_floor
                    and any(e.get("reason") == "wva_saturated"
                            for e in d_ups))

        # ---- disagg phase ledgers on the decode replicas: kv_pull, never
        # prefill, summing to the wall clock by construction
        split_records = []
        bad_ledgers = []
        for handle in pools.decode.replicas.values():
            if handle.server is None:
                continue
            for rec in handle.server.request_records:
                if not any(e["event"] == "kv_pull" for e in rec["events"]):
                    continue
                led = build_ledger(rec)
                split_records.append(led)
                gap = abs(sum(led["phases"].values()) + led["residual_ms"]
                          - led["wall_ms"])
                if ("prefill" in led["phases"]
                        or led["phases"].get("kv_pull", 0.0) <= 0.0
                        or gap > 0.05):
                    bad_ledgers.append(led)
        splits_total = router.scheduler.metrics["pd_splits_total"]
        aggregated_total = router.scheduler.metrics["pd_aggregated_total"]
        ledgers_ok = (splits_total > 0 and len(split_records) > 0
                      and not bad_ledgers)

        # ---- degraded-to-aggregated contract after the prefill-pool kill:
        # in-flight splits fall back at the sidecar, later picks degrade at
        # the decider (no_prefill_endpoint) until the relaunch lands
        fallbacks = sum(h.sidecar.stats["prefill_fallbacks"]
                        for h in pools.decode.replicas.values()
                        if h.sidecar is not None)

        # ---- decision-ledger sweep: pd stamps on every routed request,
        # split rows carrying predicted deltas, degrade rows after the kill
        pd_rows = split_rows_with_delta = no_prefill_rows = 0
        client = HTTPClient()
        try:
            r = await client.request(
                "GET", f"http://{router.address}/debug/requests"
                f"?status=finished&limit=500", timeout=10)
            rows = (await r.json()).get("requests", [])
            for row in rows:
                detail = await _detail(client, router.address,
                                       row.get("request_id", ""))
                pd = (detail.get("decision") or {}).get("pd")
                if not pd:
                    continue
                pd_rows += 1
                if pd.get("decision") == "split" and "delta_ms" in pd:
                    split_rows_with_delta += 1
                if pd.get("reason") == "no_prefill_endpoint":
                    no_prefill_rows += 1
        finally:
            await client.close()
        degrade_probes = injected.get("degrade_probes") or []
        degrade_probes_ok = (len(degrade_probes) == 3 and all(
            p.get("status") == 200 for p in degrade_probes))
        degraded_ok = degrade_probes_ok and (
            fallbacks > 0 or no_prefill_rows > 0
            or any(p.get("reason") == "no_prefill_endpoint"
                   for p in degrade_probes))

        # ---- short-prompt probes: the hop is provably skipped — aggregated
        # pick, reason short_uncached_suffix, predictor delta stamped
        probe_rows = []
        client = HTTPClient()
        try:
            for i in range(3):
                probe_status, rid = await _completion(
                    client, router.address, f"short probe {i}", 2)
                detail = await _detail(client, router.address, rid)
                probe_rows.append((detail.get("decision") or {}).get("pd")
                                  or {})
        finally:
            await client.close()
        probes_ok = all(
            p.get("decision") == "aggregated"
            and p.get("reason") == "short_uncached_suffix"
            and "ttft_agg_ms" in p
            for p in probe_rows) and probe_status == 200

        attainment_ok = report.slo_attainment >= ATTAINMENT_FLOOR
        zero_5xx = report.client_5xx == 0
        ok = (attainment_ok and zero_5xx and p_scaled and d_scaled
              and ledgers_ok and degraded_ok and probes_ok
              and split_rows_with_delta > 0 and pd_rows > 0)
        verdict = {
            "pd_check": "ok" if ok else "failed",
            "trace": {"duration_s": duration_s, "base_rps": base_rps,
                      "burst_rps": burst_rps, "requests": len(trace)},
            "report": report.summary(),
            "slo_attainment_floor": ATTAINMENT_FLOOR,
            "chaos": injected,
            "prefill_pool": {"floor": p_floor, "peak": p_peak},
            "decode_pool": {"floor": d_floor, "peak": d_peak},
            "scale_up_reasons": {
                "prefill": sorted({e.get("reason") for e in p_ups} - {None}),
                "decode": sorted({e.get("reason") for e in d_ups} - {None})},
            "decider": {"splits": splits_total,
                        "aggregated": aggregated_total},
            "split_ledgers": {"count": len(split_records),
                              "bad": len(bad_ledgers)},
            "sidecar_prefill_fallbacks": fallbacks,
            "decision_ledger": {"pd_rows": pd_rows,
                                "split_rows_with_delta":
                                    split_rows_with_delta,
                                "no_prefill_endpoint_rows": no_prefill_rows},
            "short_probes": probe_rows,
            "checks": {
                "attainment": attainment_ok, "zero_5xx": zero_5xx,
                "prefill_scaled_on_queue": p_scaled,
                "decode_scaled_on_kv": d_scaled,
                "split_ledgers_kv_pull_not_prefill": ledgers_ok,
                "degraded_to_aggregated_on_kill": degraded_ok,
                "short_prompts_skip_hop": probes_ok,
                "split_rows_carry_deltas": split_rows_with_delta > 0,
            },
        }
    finally:
        await pools.stop()
        await router.stop()
    return verdict


async def main_async(full: bool) -> int:
    verdict = await run_gate(full)
    print(json.dumps(verdict, indent=2), flush=True)
    if verdict["pd_check"] != "ok":
        print(f"pd_check: FAILED — checks: {verdict.get('checks')}",
              file=sys.stderr)
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
