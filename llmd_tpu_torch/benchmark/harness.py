"""Benchmark harness: workload profiles → load generation → JSON reports
(copy of ``llmd_tpu/benchmark/harness.py``: the same workloads from the same
seed, summaries, CLI and reports; the load goes over the port's pooled
``router/http.HTTPClient`` where the reference uses an aiohttp session, and
its transport errors — ``HTTPProtocolError``, ``OSError``, a timeout, a body
that is not JSON — count as the reference's errors).

The reference treats benchmarks as reviewed artifacts: the `llmdbenchmark` CLI
deploys an inference-perf harness with per-guide workload profiles, runs rate
ladders, and checks in the analyzed results
(the reference's helpers/benchmark.md, guides/pd-disaggregation/
README.md:229-310, guides/optimized-baseline/README.md — whose first headline
is the scheduler beating round-robin +130% on a shared-prefix workload). This
module is that harness for the serving stack:

- **workload profiles**: ``shared-prefix`` (N prefix groups × M requests — the
  prefix-cache-aware-routing workload), ``random`` (sanity_random analogue),
  ``long-context`` (few long prompts, chunked-prefill stressor).
- **arrival models**: closed-loop concurrency or open-loop Poisson rates, and
  rate ladders sweeping QPS (the reference's 3→60 QPS sweeps).
- **metrics**: output tok/s, TTFT (streaming first-chunk) mean/p50/p90, e2e
  mean/p90, error counts — the inference-perf summary fields.
- **comparison mode**: the same workload against multiple targets (e.g. a
  round-robin proxy vs the EPP router) in one report —
  ``tools/run_sched_comparison.py`` produces the RR-vs-scheduler artifact.

CLI: python -m llmd_tpu_torch.benchmark --target host:port --workload shared-prefix
         [--requests 64] [--concurrency 8] [--rate-ladder 2,4,8] [--stream]
         [--out report.json]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import random
import time
from dataclasses import dataclass, field
from typing import Optional

from llmd_tpu_torch.router.http import HTTPClient, HTTPProtocolError

REQUEST_TIMEOUT_S = 600.0  # the reference session's total timeout, per request


@dataclass
class WorkloadSpec:
    kind: str = "shared-prefix"  # shared-prefix | random | long-context
    num_requests: int = 64
    max_tokens: int = 32
    prompt_words: int = 120  # ~input length in words
    prefix_groups: int = 4  # shared-prefix: distinct prefix groups
    prefix_words: int = 100  # shared-prefix: words shared within a group
    long_prompt_words: int = 2000  # long-context profile
    model: str = "fake/model"
    seed: int = 0

    def describe(self) -> dict:
        return {k: v for k, v in self.__dict__.items()}


_WORDS = ("the of to and in that for with as on at by from up out if about "
          "into over after tokens routing prefill decode cache expert shard "
          "mesh page block batch stream latency throughput schedule").split()


def _words(rng: random.Random, n: int) -> str:
    return " ".join(rng.choice(_WORDS) for _ in range(n))


def build_requests(spec: WorkloadSpec) -> list[dict]:
    """Materialise the workload as OpenAI /v1/completions bodies."""
    rng = random.Random(spec.seed)
    out: list[dict] = []
    if spec.kind == "shared-prefix":
        prefixes = [_words(rng, spec.prefix_words) for _ in range(spec.prefix_groups)]
        for i in range(spec.num_requests):
            p = prefixes[i % spec.prefix_groups]
            suffix = _words(rng, max(1, spec.prompt_words - spec.prefix_words))
            out.append({"model": spec.model, "prompt": f"{p} {suffix}",
                        "max_tokens": spec.max_tokens})
        # realistic arrival order: groups interleave arbitrarily (a strict
        # rotation would alias with a round-robin balancer's rotation and make
        # RR accidentally sticky)
        rng.shuffle(out)
    elif spec.kind == "random":
        for _ in range(spec.num_requests):
            out.append({"model": spec.model,
                        "prompt": _words(rng, spec.prompt_words),
                        "max_tokens": spec.max_tokens})
    elif spec.kind == "long-context":
        for _ in range(spec.num_requests):
            out.append({"model": spec.model,
                        "prompt": _words(rng, spec.long_prompt_words),
                        "max_tokens": spec.max_tokens})
    else:
        raise ValueError(f"unknown workload kind {spec.kind!r}")
    return out


@dataclass
class LoadResult:
    wall_s: float = 0.0
    ttfts: list[float] = field(default_factory=list)
    e2es: list[float] = field(default_factory=list)
    out_tokens: int = 0
    errors: int = 0

    @staticmethod
    def _pct(xs: list[float], q: float) -> Optional[float]:
        if not xs:
            return None
        ys = sorted(xs)
        return ys[min(len(ys) - 1, int(q * len(ys)))]

    def summary(self) -> dict:
        n = len(self.e2es)
        return {
            "requests": n,
            "errors": self.errors,
            "wall_s": round(self.wall_s, 3),
            "out_tok_per_s": round(self.out_tokens / self.wall_s, 1) if self.wall_s else 0,
            "req_per_s": round(n / self.wall_s, 2) if self.wall_s else 0,
            "ttft_mean_ms": round(sum(self.ttfts) / len(self.ttfts) * 1e3, 1) if self.ttfts else None,
            "ttft_p50_ms": round(self._pct(self.ttfts, 0.5) * 1e3, 1) if self.ttfts else None,
            "ttft_p90_ms": round(self._pct(self.ttfts, 0.9) * 1e3, 1) if self.ttfts else None,
            "e2e_mean_ms": round(sum(self.e2es) / n * 1e3, 1) if n else None,
            "e2e_p90_ms": round(self._pct(self.e2es, 0.9) * 1e3, 1) if n else None,
        }


async def _one(client: HTTPClient, target: str, body: dict,
               stream: bool, result: LoadResult) -> None:
    t0 = time.monotonic()
    try:
        if stream:
            resp = await client.request("POST", f"http://{target}/v1/completions",
                                        json_body={**body, "stream": True},
                                        timeout=REQUEST_TIMEOUT_S)
            try:
                if resp.status != 200:
                    result.errors += 1
                    return
                first = None
                n_chunks = 0
                async for _chunk in resp.iter_chunks():
                    if first is None:
                        first = time.monotonic()
                    n_chunks += 1
            finally:
                resp.close()
            t1 = time.monotonic()
            if first is not None:
                result.ttfts.append(first - t0)
            result.e2es.append(t1 - t0)
            result.out_tokens += body.get("max_tokens", 0)
        else:
            resp = await client.request("POST", f"http://{target}/v1/completions",
                                        json_body=body, timeout=REQUEST_TIMEOUT_S)
            payload = await resp.json()
            t1 = time.monotonic()
            if resp.status != 200:
                result.errors += 1
                return
            result.e2es.append(t1 - t0)
            result.ttfts.append(t1 - t0)  # non-stream: TTFT == e2e
            result.out_tokens += payload.get("usage", {}).get(
                "completion_tokens", body.get("max_tokens", 0))
    except (HTTPProtocolError, asyncio.TimeoutError, ValueError, OSError):
        # aiohttp's ClientError / TimeoutError / JSONDecodeError / OSError:
        # a broken exchange, a timeout, a body that is not JSON
        result.errors += 1


async def run_load(target: str, requests: list[dict], *,
                   concurrency: int = 8, rate_qps: Optional[float] = None,
                   stream: bool = False, seed: int = 0) -> LoadResult:
    """Closed-loop (``concurrency`` workers) or open-loop (Poisson ``rate_qps``)."""
    result = LoadResult()
    t0 = time.monotonic()
    session = HTTPClient()
    try:
        if rate_qps is None:
            queue: asyncio.Queue = asyncio.Queue()
            for body in requests:
                queue.put_nowait(body)

            async def worker() -> None:
                while True:
                    try:
                        body = queue.get_nowait()
                    except asyncio.QueueEmpty:
                        return
                    await _one(session, target, body, stream, result)

            await asyncio.gather(*(worker() for _ in range(concurrency)))
        else:
            rng = random.Random(seed)
            tasks = []
            for body in requests:
                tasks.append(asyncio.get_running_loop().create_task(
                    _one(session, target, body, stream, result)))
                await asyncio.sleep(rng.expovariate(rate_qps))
            await asyncio.gather(*tasks)
    finally:
        await session.close()
    result.wall_s = time.monotonic() - t0
    return result


async def compare_targets(targets: dict[str, str], spec: WorkloadSpec, *,
                          concurrency: int = 8,
                          rate_qps: Optional[float] = None,
                          stream: bool = False) -> dict:
    """Same workload against each named target, sequentially (isolation)."""
    report: dict = {"workload": spec.describe(), "targets": {}}
    for name, addr in targets.items():
        res = await run_load(addr, build_requests(spec), concurrency=concurrency,
                             rate_qps=rate_qps, stream=stream)
        report["targets"][name] = res.summary()
    names = list(targets)
    if len(names) == 2:
        a, b = (report["targets"][n] for n in names)
        if a["out_tok_per_s"] and b["out_tok_per_s"]:
            report["delta"] = {
                f"{names[1]}_vs_{names[0]}_tput":
                    round(b["out_tok_per_s"] / a["out_tok_per_s"], 3),
            }
    return report


async def run_ladder(target: str, spec: WorkloadSpec, rates: list[float], *,
                     stream: bool = False) -> dict:
    """Open-loop rate ladder (the reference's QPS sweeps); one summary per rung."""
    rungs = []
    for rate in rates:
        res = await run_load(target, build_requests(spec), rate_qps=rate,
                             stream=stream)
        rungs.append({"rate_qps": rate, **res.summary()})
    return {"workload": spec.describe(), "ladder": rungs}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--target", required=True, help="host:port of router/engine")
    ap.add_argument("--workload", default="shared-prefix",
                    choices=["shared-prefix", "random", "long-context"])
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--max-tokens", type=int, default=32)
    ap.add_argument("--concurrency", type=int, default=8)
    ap.add_argument("--rate-ladder", default=None,
                    help="comma-separated QPS rungs (open loop); default closed loop")
    ap.add_argument("--stream", action="store_true", help="measure streaming TTFT")
    ap.add_argument("--model", default="fake/model")
    ap.add_argument("--out", default=None, help="write the JSON report here")
    args = ap.parse_args()

    spec = WorkloadSpec(kind=args.workload, num_requests=args.requests,
                        max_tokens=args.max_tokens, model=args.model)
    if args.rate_ladder:
        rates = [float(r) for r in args.rate_ladder.split(",")]
        report = asyncio.run(run_ladder(args.target, spec, rates,
                                        stream=args.stream))
    else:
        report = asyncio.run(compare_targets({"target": args.target}, spec,
                                             concurrency=args.concurrency,
                                             stream=args.stream))
    text = json.dumps(report, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
