"""Decision-plane gate: every retired request explains itself (copy of
``tools/decision_check.py`` over the port's router, latency plugins and fake
servers; no jax, no aiohttp).

End-to-end over the real router, no hardware: three in-process fake engines
behind the real RouterServer running the predicted-latency pipeline, a
replayed mixed trace (streamed + non-streamed), and the decision ledger
(obs/decisions.py) on. Asserts:

1. 100% of retired requests carry a complete decision ledger — the
   ``route_decision`` routing breakdown (filters, top-k scores, per-scorer
   breakdown for chosen + runner-up), a predictor calibration join, and the
   ledger embedded under ``decision`` in ``/debug/requests/<id>``,
2. the ``llmd_tpu:predictor_calibration_*`` families are non-empty and
   ``llmd_tpu_torch.tools.predictor_accuracy --from-metrics`` can consume the scrape,
3. regret is present on multi-endpoint schedules and exported bucketed by
   SLO breach,
4. ZERO client-visible 5xx,
5. the ledger's schedule-latency overhead stays inside the perf_regress
   router-overhead bound (<2% relative or <25µs/call absolute).

Run: python -m llmd_tpu_torch.tools.decision_check  (exit 0 when every check
holds)
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys

from llmd_tpu_torch.router.http import HTTPClient


def gate_env() -> None:
    """The gate IS the decision plane; keep retries tight so it runs in
    seconds. Set before the router is built (it reads them then), never at
    import."""
    os.environ["LLMD_DECISION_LEDGER"] = "1"
    os.environ.setdefault("LLMD_RETRY_MAX_ATTEMPTS", "3")
    os.environ.setdefault("LLMD_RETRY_BACKOFF_MS", "5")
    os.environ.setdefault("LLMD_RETRY_BACKOFF_MAX_MS", "50")


N_PLAIN = 14
N_STREAM = 6

# the latency-predictor pipeline: producer stamps per-endpoint predictions,
# the scorer ranks by them, queue depth breaks the symmetry between fakes
CFG = """
plugins:
  - {name: pred, type: predicted-latency-producer}
  - {name: lat, type: latency-scorer}
  - {name: queue, type: queue-depth-scorer}
schedulingProfiles:
  - name: default
    plugins:
      - {pluginRef: lat, weight: 2}
      - {pluginRef: queue, weight: 1}
"""


async def _fake():
    from llmd_tpu_torch.testing.fake_server import FakeModelServer, FakeServerConfig

    srv = FakeModelServer(FakeServerConfig(
        prefill_us_per_token=20.0, decode_us_per_token=200.0))
    await srv.start()
    return srv


async def _post(sess: HTTPClient, router_addr: str, prompt: str, stream: bool):
    body = {"model": "fake/model", "prompt": prompt, "max_tokens": 6,
            "stream": stream}
    try:
        r = await sess.request("POST", f"http://{router_addr}/v1/completions",
                               json_body=body, timeout=15)
        await r.read()
        return r.status
    except Exception:
        return 599


async def _get_json(sess: HTTPClient, url: str):
    r = await sess.request("GET", url, timeout=10)
    return await r.json()


async def main_async() -> int:
    from llmd_tpu_torch.core.config import FrameworkConfig
    from llmd_tpu_torch.core.endpoint import Endpoint, EndpointPool
    from llmd_tpu_torch.router import filters_pickers as _fp  # noqa: F401
    from llmd_tpu_torch.router import latency_plugins as _lp  # noqa: F401
    from llmd_tpu_torch.router import scorers as _s  # noqa: F401
    from llmd_tpu_torch.router.plugins import known_plugin_types
    from llmd_tpu_torch.router.server import RouterServer

    gate_env()

    fakes = [await _fake() for _ in range(3)]
    pool = EndpointPool()
    cfg = FrameworkConfig.from_yaml(CFG, known_types=known_plugin_types())
    router = RouterServer(cfg, pool, port=0, poll_interval_s=0.2)
    await router.start()
    verdict = {"decision_check": "failed"}
    try:
        assert router.scheduler.record_decisions, \
            "LLMD_DECISION_LEDGER=1 did not enable the scheduler's ledger"
        for i, srv in enumerate(fakes):
            srv.queued = i  # distinct queue depths: no score ties
            pool.upsert(Endpoint(address=srv.address))
        await asyncio.sleep(0.5)  # first metrics poll

        statuses: list[int] = []
        sess = HTTPClient()
        try:
            for r in range(N_PLAIN):
                statuses.append(await _post(
                    sess, router.address, f"plain request {r} " * 4, False))
            results = await asyncio.gather(*[
                _post(sess, router.address, f"streamed request {r} " * 4, True)
                for r in range(N_STREAM)])
            statuses.extend(results)

            # ---- per-request ledgers via /debug/requests/<id> -------------
            listing = await _get_json(
                sess, f"http://{router.address}/debug/requests"
                      f"?status=finished&limit=100")
            finished = listing.get("requests", [])
            with_ledger = 0
            with_regret = 0
            with_calibration = 0
            with_breakdown = 0
            for row in finished:
                rid = row.get("request_id", "")
                detail = await _get_json(
                    sess, f"http://{router.address}/debug/requests/{rid}")
                d = detail.get("decision")
                if not d or d.get("plane") != "router" \
                        or not d.get("profiles"):
                    continue
                with_ledger += 1
                if d.get("regret") is not None:
                    with_regret += 1
                if d.get("calibration"):
                    with_calibration += 1
                profs = d["profiles"]
                if any(p.get("breakdown") for p in profs.values()):
                    with_breakdown += 1

            metrics_text = await (await sess.request(
                "GET", f"http://{router.address}/metrics", timeout=10)).text()
        finally:
            await sess.close()

        n_finished = len(finished)
        ledger_coverage = with_ledger / max(1, n_finished)
        n_5xx = sum(1 for s in statuses if s >= 500)

        # ---- exported families ------------------------------------------
        def _family_count(name: str) -> float:
            total = 0.0
            for line in metrics_text.splitlines():
                if line.startswith(name + "_count") \
                        or (line.startswith(name + "{") and "_bucket" not in name):
                    try:
                        total += float(line.rsplit(" ", 1)[1])
                    except ValueError:
                        pass
            return total

        calib_exported = _family_count(
            "llmd_tpu:predictor_calibration_error_ms")
        regret_exported = _family_count("llmd_tpu:decision_regret")
        ledgers_exported = _family_count("llmd_tpu:decision_ledgers_total")

        # ---- live-metrics consumption (predictor_accuracy) ---------------
        from llmd_tpu_torch.tools.predictor_accuracy import accuracy_from_metrics

        calibration = accuracy_from_metrics(metrics_text)

        # ---- ledger overhead bound (perf_regress) -------------------------
        from llmd_tpu_torch.tools.perf_regress import router_overhead

        # best-of-3 so one scheduler hiccup on a loaded box can't fail the
        # bound: only a consistent slowdown across rounds survives best-of
        overhead = router_overhead(n_requests=200, rounds=3)

        checks = {
            "ledger_coverage_100pct": (n_finished > 0
                                       and with_ledger == n_finished),
            "routing_breakdown": with_breakdown == n_finished,
            "regret_on_multi_endpoint": with_regret == n_finished,
            "calibration_joined": with_calibration > 0,
            "calibration_exported": calib_exported > 0,
            "regret_exported": regret_exported > 0,
            "ledgers_exported": ledgers_exported > 0,
            "accuracy_from_metrics": bool(calibration),
            "zero_5xx": n_5xx == 0,
            "overhead_bound": bool(overhead["ok"]),
        }
        verdict = {
            "decision_check": "ok" if all(checks.values()) else "failed",
            "requests": len(statuses),
            "finished": n_finished,
            "with_ledger": with_ledger,
            "ledger_coverage": round(ledger_coverage, 4),
            "with_regret": with_regret,
            "with_calibration": with_calibration,
            "with_breakdown": with_breakdown,
            "client_5xx": n_5xx,
            "calibration_error_samples": calib_exported,
            "regret_samples": regret_exported,
            "ledgers_total": ledgers_exported,
            "live_calibration": calibration,
            "router_overhead": overhead,
            "checks": checks,
        }
    finally:
        await router.stop()
        for f in fakes:
            try:
                await f.stop()
            except Exception:
                pass

    print(json.dumps(verdict, indent=2), flush=True)
    if verdict["decision_check"] != "ok":
        print(f"decision_check: FAILED — checks: {verdict.get('checks')}",
              file=sys.stderr)
        return 1
    return 0


def main() -> int:
    argparse.ArgumentParser(description=__doc__).parse_args()
    return asyncio.run(main_async())


if __name__ == "__main__":
    sys.exit(main())
