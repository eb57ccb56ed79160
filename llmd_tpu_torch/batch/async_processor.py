"""Async Processor — queue-driven dispatch into the router (copy of
``llmd_tpu/batch/async_processor.py``: the same pullers, gates and retry
policy; the dispatch and the metric polls go over the port's pooled
``router/http.HTTPClient`` where the reference uses aiohttp sessions, and the
polls parse with the port's ``core/metrics_contract.parse_prometheus``).

Where it departs from the reference: the backoff's jitter is drawn from the
processor's own ``random.Random``, seeded by ``AsyncProcessorConfig.seed``
(the reference draws from the global ``random``), as the router's
``Scheduler(seed=)`` owns its draws.

Parity: reference `llm-d-incubation/llm-d-async` as specified in
`docs/architecture/advanced/batch/async-processor.md:5-40` (SURVEY §2.6 A4):
- **Queue pullers** feed an internal work channel. The reference ships Redis
  sorted-set/pubsub and GCP Pub/Sub pullers; here the same `QueuePuller` seam has
  an in-memory priority puller and a file-spool puller (JSONL drop directory —
  the no-external-deps equivalent; Redis/PubSub implementations slot in behind
  the same interface).
- **Dispatch gates** decide when the next item may go out: `constant`
  (fixed concurrency), `budget` (token bucket — the `redis` budget gate's
  semantics), `prometheus-saturation` (poll a metrics endpoint, close the gate
  while a saturation metric is above threshold), `prometheus-budget` (spend a
  budget metric).
- **Workers** (default 8) POST to the router with deadline propagation and
  exponential backoff 2s -> 60s plus jitter on retryable failures
  (`async-processor.md:5-40`; values guides/asynchronous-processing/*).
"""

from __future__ import annotations

import asyncio
import heapq
import json
import os
import random
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from llmd_tpu_torch.core.metrics_contract import parse_prometheus
from llmd_tpu_torch.router.http import HTTPClient

DEADLINE_HEADER = "x-llm-d-deadline"  # absolute epoch seconds, propagated downstream


@dataclass
class AsyncItem:
    id: str
    url: str              # e.g. /v1/completions
    body: dict
    priority: int = 0
    deadline: Optional[float] = None   # epoch seconds
    attempts: int = 0


# ---------------------------------------------------------------- queue pullers


class QueuePuller:
    """Interface: await get() -> AsyncItem; ack/nack for redelivery semantics."""

    async def get(self) -> AsyncItem:  # pragma: no cover - interface
        raise NotImplementedError

    def nack(self, item: AsyncItem) -> None:
        raise NotImplementedError


class MemoryQueuePuller(QueuePuller):
    """In-process priority queue (the Redis sorted-set stand-in)."""

    def __init__(self) -> None:
        self._heap: list[tuple[int, float, int, AsyncItem]] = []
        self._cond = asyncio.Condition()
        self._seq = 0

    async def put(self, item: AsyncItem) -> None:
        async with self._cond:
            self._seq += 1
            heapq.heappush(self._heap, (-item.priority, time.monotonic(), self._seq, item))
            self._cond.notify()

    async def get(self) -> AsyncItem:
        async with self._cond:
            while not self._heap:
                await self._cond.wait()
            return heapq.heappop(self._heap)[3]

    def nack(self, item: AsyncItem) -> None:
        # nack is sync; on the event-loop thread the locked re-push rides the
        # wake-up task (heap mutation and notify both under the condition).
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            # No running loop (sync caller): no task can be inside a critical
            # section, and the next put() will wake any waiters.
            # llmd-lint: allow[lock-unguarded-write] no running event loop in this branch, so nothing can hold the condition
            self._seq += 1
            # llmd-lint: allow[lock-unguarded-read] same single-threaded fallback path as the write above
            heapq.heappush(self._heap,
                           (-item.priority, time.monotonic(), self._seq, item))
            return
        loop.create_task(self._requeue(item))

    async def _requeue(self, item: AsyncItem) -> None:
        async with self._cond:
            self._seq += 1
            heapq.heappush(self._heap,
                           (-item.priority, time.monotonic(), self._seq, item))
            self._cond.notify()


class FileSpoolPuller(QueuePuller):
    """JSONL drop-directory puller: each *.json file is one queued item; claimed
    by rename (crash-safe: unclaimed files survive restarts)."""

    def __init__(self, spool_dir: str, poll_interval_s: float = 0.1) -> None:
        self.dir = spool_dir
        self.poll = poll_interval_s
        os.makedirs(spool_dir, exist_ok=True)

    async def get(self) -> AsyncItem:
        while True:
            for name in sorted(os.listdir(self.dir)):
                if not name.endswith(".json"):
                    continue
                path = os.path.join(self.dir, name)
                claimed = path + ".claimed"
                try:
                    os.rename(path, claimed)
                except OSError:
                    continue  # another worker got it
                try:
                    with open(claimed) as f:
                        d = json.load(f)
                    os.remove(claimed)
                    return AsyncItem(
                        id=d.get("id", name), url=d.get("url", "/v1/completions"),
                        body=d.get("body", {}), priority=int(d.get("priority", 0)),
                        deadline=d.get("deadline"),
                    )
                except (json.JSONDecodeError, OSError):
                    try:
                        os.remove(claimed)
                    except OSError:
                        pass
            await asyncio.sleep(self.poll)

    def nack(self, item: AsyncItem) -> None:
        path = os.path.join(self.dir, f"{item.id}.json")
        with open(path, "w") as f:
            json.dump({"id": item.id, "url": item.url, "body": item.body,
                       "priority": item.priority, "deadline": item.deadline}, f)


# ---------------------------------------------------------------- dispatch gates


class DispatchGate:
    """await acquire() blocks until one dispatch may proceed; release() on done."""

    async def acquire(self) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def release(self) -> None:
        pass


class ConstantGate(DispatchGate):
    """Fixed max in-flight dispatches."""

    def __init__(self, max_inflight: int = 8) -> None:
        self._sem = asyncio.Semaphore(max_inflight)

    async def acquire(self) -> None:
        await self._sem.acquire()

    def release(self) -> None:
        self._sem.release()


class BudgetGate(DispatchGate):
    """Token bucket: `rate` dispatches/second with burst `burst` (redis-budget
    gate semantics without the Redis)."""

    def __init__(self, rate: float, burst: float = 1.0) -> None:
        self.rate, self.burst = rate, max(1.0, burst)
        self._tokens = self.burst
        self._last = time.monotonic()
        self._lock = asyncio.Lock()

    async def acquire(self) -> None:
        while True:
            async with self._lock:
                now = time.monotonic()
                self._tokens = min(self.burst, self._tokens + (now - self._last) * self.rate)
                self._last = now
                if self._tokens >= 1.0:
                    self._tokens -= 1.0
                    return
                wait = (1.0 - self._tokens) / self.rate
            await asyncio.sleep(wait)


class PrometheusSaturationGate(DispatchGate):
    """Polls a Prometheus text endpoint; the gate closes while `metric` exceeds
    `threshold` (async-processor.md prometheus-saturation gate)."""

    def __init__(self, metrics_url: str, metric: str, threshold: float,
                 poll_interval_s: float = 1.0, fail_open: bool = True) -> None:
        self.metrics_url = metrics_url
        self.metric = metric
        self.threshold = threshold
        self.poll = poll_interval_s
        self.fail_open = fail_open
        self.saturated = False
        self.last_value: Optional[float] = None
        self._client: Optional[HTTPClient] = None

    def _get_client(self) -> HTTPClient:
        # one shared connection pool for the metric polls — acquire() runs per
        # dispatched item, so a per-call client would mean TCP setup per request
        if self._client is None:
            self._client = HTTPClient()
        return self._client

    async def close(self) -> None:
        if self._client is not None:
            client, self._client = self._client, None
            await client.close()

    async def _poll_once(self) -> None:
        try:
            resp = await self._get_client().request("GET", self.metrics_url, timeout=2)
            text = await resp.text()
            val = next((v for name, _labels, v in parse_prometheus(text)
                        if name == self.metric), None)
            if val is not None:
                self.last_value = float(val)
                self.saturated = self.last_value > self.threshold
        except Exception:
            self.saturated = not self.fail_open

    async def acquire(self) -> None:
        await self._poll_once()
        while self.saturated:
            await asyncio.sleep(self.poll)
            await self._poll_once()


class PrometheusBudgetGate(PrometheusSaturationGate):
    """Like saturation, but spends a budget metric: dispatch allowed while the
    metric (e.g. spare capacity) is ABOVE threshold. With ``fail_open=False`` an
    unreachable metrics endpoint keeps the gate closed (a stale last_value from
    an earlier successful poll still counts as a reading)."""

    async def acquire(self) -> None:
        while True:
            await self._poll_once()
            if self.last_value is None:  # no reading ever obtained
                if self.fail_open:
                    return
            elif self.last_value > self.threshold:
                return
            await asyncio.sleep(self.poll)


GATE_REGISTRY: dict[str, Callable[..., DispatchGate]] = {
    "constant": ConstantGate,
    "budget": BudgetGate,
    "prometheus-saturation": PrometheusSaturationGate,
    "prometheus-budget": PrometheusBudgetGate,
}


# ---------------------------------------------------------------- the processor


@dataclass
class AsyncProcessorConfig:
    target_url: str = "http://127.0.0.1:8000"
    num_workers: int = 8
    max_attempts: int = 5
    backoff_base_s: float = 2.0    # reference: exp backoff 2s -> 60s + jitter
    backoff_max_s: float = 60.0
    request_timeout_s: float = 120.0
    seed: Optional[int] = None     # the backoff jitter's generator (None: OS entropy)


class AsyncProcessor:
    def __init__(self, cfg: AsyncProcessorConfig, puller: QueuePuller,
                 gate: Optional[DispatchGate] = None,
                 on_result: Optional[Callable[[AsyncItem, Optional[dict]], None]] = None,
                 ) -> None:
        self.cfg = cfg
        self.puller = puller
        self.gate = gate or ConstantGate(cfg.num_workers)
        self.on_result = on_result
        self._tasks: list[asyncio.Task] = []
        self._client: Optional[HTTPClient] = None
        self.rng = random.Random(cfg.seed)
        self.stats = {"dispatched": 0, "succeeded": 0, "failed": 0,
                      "retried": 0, "expired": 0}

    async def start(self) -> None:
        self._client = HTTPClient()
        loop = asyncio.get_running_loop()
        self._tasks = [loop.create_task(self._worker(i))
                       for i in range(self.cfg.num_workers)]

    async def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except asyncio.CancelledError:
                pass
        if self._client:
            await self._client.close()
        if hasattr(self.gate, "close"):
            await self.gate.close()

    def _backoff(self, attempt: int) -> float:
        base = min(self.cfg.backoff_max_s, self.cfg.backoff_base_s * (2 ** (attempt - 1)))
        return base + self.rng.uniform(0, base * 0.25)  # jitter

    async def _worker(self, idx: int) -> None:
        while True:
            item = await self.puller.get()
            if item.deadline is not None and time.time() > item.deadline:
                self.stats["expired"] += 1
                self._finish(item, None)
                continue
            await self.gate.acquire()
            try:
                verdict, body = await self._dispatch(item)
            finally:
                self.gate.release()
            if verdict == "ok":
                self.stats["succeeded"] += 1
                self._finish(item, body)
                continue
            if verdict == "fatal":
                self.stats["failed"] += 1
                self._finish(item, None)
                continue
            item.attempts += 1
            if item.attempts >= self.cfg.max_attempts:
                self.stats["failed"] += 1
                self._finish(item, None)
                continue
            self.stats["retried"] += 1
            await asyncio.sleep(self._backoff(item.attempts))
            self.puller.nack(item)

    async def _dispatch(self, item: AsyncItem) -> tuple[str, Optional[dict]]:
        """Returns ("ok", body) | ("fatal", None) non-retryable | ("retry", None)."""
        headers = {}
        timeout = self.cfg.request_timeout_s
        if item.deadline is not None:
            headers[DEADLINE_HEADER] = str(item.deadline)  # deadline propagation
            timeout = max(0.1, min(timeout, item.deadline - time.time()))
        self.stats["dispatched"] += 1
        try:
            resp = await self._client.request(
                "POST", f"{self.cfg.target_url}{item.url}", json_body=item.body,
                headers=headers, timeout=timeout)
            try:
                if resp.status == 200:
                    text = (await resp.read()).decode("utf-8")
                    # aiohttp's json(content_type=None): None for a blank body
                    return "ok", json.loads(text) if text.strip() else None
            finally:
                resp.close()
            if resp.status in (400, 404, 413, 422):  # client errors: don't retry
                return "fatal", None
            return "retry", None
        except asyncio.CancelledError:
            raise
        except Exception:
            return "retry", None

    def _finish(self, item: AsyncItem, result: Optional[dict]) -> None:
        if self.on_result is not None:
            try:
                self.on_result(item, result)
            except Exception:
                pass
