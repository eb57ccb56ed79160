"""Open-loop trace replay against the router, with SLO accounting (copy of
``llmd_tpu/pool/harness.py`` on ``router/http.py``'s pooled client, where the
reference uses aiohttp).

The harness fires each :class:`~llmd_tpu_torch.pool.traces.TraceRequest` at its
trace offset regardless of how the previous ones are doing (open loop — a
closed loop would self-throttle exactly when the pool is saturated and hide
the overload the autoscaler must react to). Thousands of concurrent streams
are just thousands of pending asyncio tasks on one client, which caps no
connection count.

Per-request records capture status, e2e latency, and TTFT (streaming), and
:class:`ReplayReport` folds them into the gate verdict inputs: SLO
attainment, client-visible 5xx count, status histogram.
"""

from __future__ import annotations

import asyncio
import json
import time
from dataclasses import dataclass, field
from typing import Optional

from llmd_tpu_torch.pool.traces import TraceRequest
from llmd_tpu_torch.router.http import HTTPClient


@dataclass
class RequestResult:
    tenant: str
    t_offset: float  # scheduled trace offset
    status: int  # HTTP status; -1 = transport error
    e2e_s: float
    ttft_s: Optional[float] = None  # streaming only
    error: str = ""

    @property
    def ok(self) -> bool:
        return 200 <= self.status < 300


@dataclass
class ReplayReport:
    """Everything tools/slo_check.py asserts on."""

    results: list[RequestResult] = field(default_factory=list)
    wall_s: float = 0.0
    slo_e2e_s: float = 0.0
    slo_ttft_s: Optional[float] = None

    @property
    def total(self) -> int:
        return len(self.results)

    @property
    def statuses(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for r in self.results:
            key = str(r.status)
            out[key] = out.get(key, 0) + 1
        return out

    @property
    def client_5xx(self) -> int:
        """Client-visible failures: 5xx responses AND transport errors."""
        return sum(1 for r in self.results if r.status >= 500 or r.status < 0)

    def _meets_slo(self, r: RequestResult) -> bool:
        if not r.ok or r.e2e_s > self.slo_e2e_s:
            return False
        if (self.slo_ttft_s is not None and r.ttft_s is not None
                and r.ttft_s > self.slo_ttft_s):
            return False
        return True

    @property
    def slo_attainment(self) -> float:
        """Fraction of ALL requests that succeeded within SLO — failures
        count against attainment, not just against goodput."""
        if not self.results:
            return 1.0
        return sum(1 for r in self.results if self._meets_slo(r)) / self.total

    def summary(self) -> dict:
        lat = sorted(r.e2e_s for r in self.results if r.ok)

        def pct(p: float) -> Optional[float]:
            if not lat:
                return None
            return round(lat[min(len(lat) - 1, int(len(lat) * p))], 4)

        return {
            "requests": self.total,
            "statuses": dict(sorted(self.statuses.items())),
            "client_5xx": self.client_5xx,
            "slo_e2e_s": self.slo_e2e_s,
            "slo_attainment": round(self.slo_attainment, 4),
            "p50_e2e_s": pct(0.50),
            "p99_e2e_s": pct(0.99),
            "wall_s": round(self.wall_s, 2),
        }


async def replay_trace(router_address: str, trace: list[TraceRequest],
                       model: str = "fake/model", slo_e2e_s: float = 3.0,
                       slo_ttft_s: Optional[float] = None,
                       time_scale: float = 1.0,
                       request_timeout_s: float = 30.0) -> ReplayReport:
    """Replay ``trace`` open-loop against ``http://<router_address>``.

    ``time_scale`` compresses/stretches offsets (0.5 = twice as fast).
    """
    report = ReplayReport(slo_e2e_s=slo_e2e_s, slo_ttft_s=slo_ttft_s)
    t0 = time.monotonic()

    async def one(req: TraceRequest, client: HTTPClient) -> None:
        delay = req.t * time_scale - (time.monotonic() - t0)
        if delay > 0:
            await asyncio.sleep(delay)
        body = {
            "model": model,
            "prompt": f"{req.tenant} " * max(1, req.prompt_tokens // 8),
            "max_tokens": req.max_tokens,
            "stream": req.stream,
        }
        sent = time.monotonic()
        ttft: Optional[float] = None
        try:
            resp = await client.request(
                "POST", f"http://{router_address}/v1/completions",
                json_body=body, headers={"x-fairness-id": req.tenant},
                timeout=request_timeout_s)
            try:
                if req.stream and resp.status == 200:
                    async for _chunk in resp.iter_chunks():
                        if ttft is None:
                            ttft = time.monotonic() - sent
                else:
                    await resp.read()
            finally:
                resp.close()
            report.results.append(RequestResult(
                tenant=req.tenant, t_offset=req.t, status=resp.status,
                e2e_s=time.monotonic() - sent, ttft_s=ttft))
        except Exception as e:
            report.results.append(RequestResult(
                tenant=req.tenant, t_offset=req.t, status=-1,
                e2e_s=time.monotonic() - sent,
                error=type(e).__name__))

    # one client for thousands of concurrent streams: no connection cap
    client = HTTPClient()
    try:
        await asyncio.gather(*(one(r, client) for r in trace))
    finally:
        await client.close()
    report.wall_s = time.monotonic() - t0
    return report


def main() -> int:
    """CLI replay: ``python -m llmd_tpu_torch.pool.harness --router host:port
    --trace trace.jsonl`` (or a built-in generator via ``--generate``)."""
    import argparse

    from llmd_tpu_torch.pool import traces

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--router", required=True, help="router host:port")
    ap.add_argument("--trace", help="JSONL trace file (pool/traces.py format)")
    ap.add_argument("--generate", choices=["bursty", "diurnal", "ramp"],
                    help="generate a trace instead of loading one")
    ap.add_argument("--duration-s", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model", default="fake/model")
    ap.add_argument("--slo-e2e-s", type=float, default=3.0)
    ap.add_argument("--time-scale", type=float, default=1.0)
    args = ap.parse_args()

    if args.trace:
        trace = traces.load_jsonl(args.trace)
    elif args.generate == "diurnal":
        trace = traces.diurnal_trace(duration_s=args.duration_s,
                                     seed=args.seed)
    elif args.generate == "ramp":
        trace = traces.multi_tenant_ramp(duration_s=args.duration_s,
                                         seed=args.seed)
    else:
        trace = traces.bursty_trace(duration_s=args.duration_s,
                                    seed=args.seed)
    report = asyncio.run(replay_trace(
        args.router, trace, model=args.model, slo_e2e_s=args.slo_e2e_s,
        time_scale=args.time_scale))
    print(json.dumps(report.summary(), indent=2))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
