"""Rollout driver: weighted canary shifts + LoRA adapter rollouts (the port's
copy of ``tools/rollout.py``: the same flags, report and exit codes, on the
port's asyncio HTTP client, ``router/http.HTTPClient``, instead of aiohttp).

Drives a staged traffic shift from a serving model/adapter to its successor
through the router's runtime rewrite control (``/admin/model-rewrites``),
verifying health at every stage and rolling the weights back on failure:

1. (adapter mode) load the new adapter on every pod via the runtime-LoRA API
   (``/v1/load_lora_adapter`` — the vLLM lora_filesystem_resolver flow);
2. for each stage weight w in ``--stages``: set the rewrite
   ``old -> [(old, 1-w), (new, w)]``, send ``--probes`` canary requests
   through the router, and require success rate >= ``--min-success``;
3. on a failed stage: restore the pre-rollout weights and exit non-zero;
4. at w=1.0 the rewrite pins all traffic to the successor; with
   ``--unload-old`` the superseded adapter is then removed from every pod.

Usage:
  python -m llmd_tpu_torch.tools.rollout --router HOST:PORT --model base --new canary-v2 \
      [--stages 0.1,0.5,1.0] [--probes 8] [--min-success 1.0] \
      [--pods HOST:PORT,...] [--adapter-path /path/adapter.npz] \
      [--old-adapter name --unload-old]
"""

from __future__ import annotations

import argparse
import asyncio
import json

from llmd_tpu_torch.router.http import HTTPClient, HTTPProtocolError

# what aiohttp.ClientError covers for the probes: the peer refused, reset or
# broke the exchange
CLIENT_ERRORS = (OSError, HTTPProtocolError)


async def _post_json(session: HTTPClient, url: str, body: dict,
                     timeout_s: float = 30.0) -> tuple[int, dict]:
    r = await session.request("POST", url, json_body=body, timeout=timeout_s)
    try:
        return r.status, await r.json()
    except Exception:
        r.close()
        return r.status, {}


async def _get_json(session: HTTPClient, url: str) -> dict:
    r = await session.request("GET", url)
    return await r.json()


async def load_adapter_on_pods(session, pods: list[str], name: str,
                               path: str | None) -> None:
    for pod in pods:
        status, body = await _post_json(
            session, f"http://{pod}/v1/load_lora_adapter",
            {"lora_name": name, **({"lora_path": path} if path else {})})
        if status != 200:
            raise RuntimeError(f"load {name!r} on {pod}: HTTP {status} {body}")


async def unload_adapter_on_pods(session, pods: list[str], name: str) -> None:
    for pod in pods:
        status, body = await _post_json(
            session, f"http://{pod}/v1/unload_lora_adapter", {"lora_name": name})
        if status not in (200, 404):  # 404: pod never had it — fine
            raise RuntimeError(f"unload {name!r} on {pod}: HTTP {status} {body}")


async def probe(session, router: str, model: str, n: int,
                max_tokens: int = 4) -> float:
    """Canary probes through the router; returns the success rate."""
    ok = 0
    for i in range(n):
        try:
            status, _ = await _post_json(
                session, f"http://{router}/v1/completions",
                {"model": model, "prompt": f"rollout probe {i}",
                 "max_tokens": max_tokens, "temperature": 0})
            ok += status == 200
        except (*CLIENT_ERRORS, asyncio.TimeoutError):
            pass
    return ok / max(1, n)


async def run_rollout(router: str, model: str, new: str, stages: list[float],
                      probes: int, min_success: float,
                      pods: list[str] | None = None,
                      adapter_path: str | None = None,
                      old_adapter: str | None = None,
                      unload_old: bool = False) -> dict:
    report: dict = {"model": model, "new": new, "stages": []}
    session = HTTPClient()
    try:
        if pods:
            await load_adapter_on_pods(session, pods, new, adapter_path)
            report["loaded_on"] = list(pods)
        before = (await _get_json(
            session, f"http://{router}/admin/model-rewrites")).get(model, [])
        report["previous"] = before

        async def rollback(reason: str) -> None:
            # restore the pre-rollout targets (empty = delete); best-effort —
            # an unreachable router can't be rolled back, only reported
            try:
                await _post_json(session,
                                 f"http://{router}/admin/model-rewrites",
                                 {model: before})
                report["outcome"] = f"rolled-back at {reason}"
            except Exception as e:  # noqa: BLE001
                report["outcome"] = (f"FAILED at {reason}; rollback also "
                                     f"failed ({e}) — weights may be partial")

        for w in stages:
            targets = ([[new, 1.0]] if w >= 1.0
                       else [[model, round(1.0 - w, 6)], [new, w]])
            try:
                status, _ = await _post_json(
                    session, f"http://{router}/admin/model-rewrites",
                    {model: targets})
                if status != 200:
                    raise RuntimeError(f"weight update rejected (HTTP {status})")
                rate = await probe(session, router, model, probes)
            except Exception as e:  # mid-rollout error must not strand a
                await rollback(f"{w} ({e})")  # partial canary split in prod
                return report
            report["stages"].append({"weight": w, "success_rate": rate})
            if rate < min_success:
                await rollback(f"{w} (success {rate:.2f})")
                return report
        if unload_old and pods and old_adapter:
            await unload_adapter_on_pods(session, pods, old_adapter)
            report["unloaded"] = old_adapter
        report["outcome"] = "completed"
    finally:
        await session.close()
    return report


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--router", required=True, help="router host:port")
    ap.add_argument("--model", required=True,
                    help="client-facing model name being shifted")
    ap.add_argument("--new", required=True, help="successor model/adapter name")
    ap.add_argument("--stages", default="0.1,0.5,1.0")
    ap.add_argument("--probes", type=int, default=8)
    ap.add_argument("--min-success", type=float, default=1.0)
    ap.add_argument("--pods", default=None,
                    help="comma-separated engine pods for adapter load/unload")
    ap.add_argument("--adapter-path", default=None,
                    help="npz adapter weights for /v1/load_lora_adapter")
    ap.add_argument("--old-adapter", default=None)
    ap.add_argument("--unload-old", action="store_true")
    args = ap.parse_args(argv)
    report = asyncio.run(run_rollout(
        args.router, args.model, args.new,
        [float(s) for s in args.stages.split(",")],
        args.probes, args.min_success,
        pods=args.pods.split(",") if args.pods else None,
        adapter_path=args.adapter_path,
        old_adapter=args.old_adapter, unload_old=args.unload_old))
    print(json.dumps(report, indent=2))
    if report.get("outcome") != "completed":
        raise SystemExit(1)


if __name__ == "__main__":
    main()
