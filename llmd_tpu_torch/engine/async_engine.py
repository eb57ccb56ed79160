"""Thread-safe facade over LLMEngine: one engine-loop thread (as
``llmd_tpu/engine/async_engine.py``), callers in other threads.

Request submission and token delivery cross the thread boundary through a lock
and per-request ``queue.Queue``s. If a step raises (a kernel failure, say), the
loop records the error, fails every open request with it and stops stepping:
callers see the exception and ``error`` stays set for health checks. DP rank
frontends share one instance (``start`` is idempotent) and pass their rank
to ``generate``; ``engine/dp_group.DPAsyncEngine`` replaces the loop with one
that steps on the group's waves.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterator, Optional

from llmd_tpu_torch.core.request import SamplingParams
from llmd_tpu_torch.engine.engine import EngineOutput, LLMEngine


class EngineLoopError(RuntimeError):
    """The engine loop died; carries the step's exception as __cause__."""


class AsyncLLMEngine:
    def __init__(self, engine: LLMEngine, idle_sleep_s: float = 0.002) -> None:
        self.engine = engine
        self._idle_sleep = idle_sleep_s
        self._lock = threading.Lock()
        # request_id -> stream of EngineOutput (or an exception); guarded-by: _lock
        self._streams: dict[str, queue.Queue] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return  # shared by rank frontends: one step loop
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name="engine-loop", daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 30.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.is_set():
            # the heartbeat BEFORE the lock: a step wedged on the card holds
            # the lock, and stamping inside it would hide the stall the
            # watchdog (obs/device.py) exists to catch
            mon = self.engine.monitor
            if mon is not None:
                mon.heartbeat()
            try:
                with self._lock:
                    has_work = self.engine.has_work()
                    outputs = self.engine.step() if has_work else []
            except Exception as e:  # noqa: BLE001 — the loop boundary: report, fail requests
                self._fail(e)
                return
            self._deliver(outputs)
            if not has_work:
                time.sleep(self._idle_sleep)

    def _fail(self, e: Exception) -> None:
        """Record a step's failure and fail every open request with it."""
        err = EngineLoopError(f"engine step failed: {type(e).__name__}: {e}")
        err.__cause__ = e
        with self._lock:
            self.error = err
            streams, self._streams = self._streams, {}
        for q in streams.values():
            q.put(err)

    def _deliver(self, outputs: list[EngineOutput]) -> None:
        """Hand each output to its request's stream."""
        for out in outputs:
            with self._lock:
                q = self._streams.get(out.request_id)
                if out.finished:
                    self._streams.pop(out.request_id, None)
            if q is not None:
                q.put(out)

    def stats(self):
        return self.engine.stats

    def run_locked(self, fn):
        """Run fn() while the step loop is paused: for callers that must touch
        engine state (KV injection and export) without racing a step."""
        with self._lock:
            return fn()

    def generate(self, request_id: str, token_ids: list[int], sampling: SamplingParams,
                 lora_id: Optional[str] = None, mm_items=None,
                 trace_ctx=None, rank: int = 0) -> Iterator[EngineOutput]:
        """Submit a request (under adapter ``lora_id``, with media rows
        ``mm_items``, in the trace of ``trace_ctx``, on DP rank ``rank``'s
        queue) and yield its outputs until it finishes (blocking)."""
        q: queue.Queue = queue.Queue()
        with self._lock:  # stream registration + admission are atomic
            if self.error is not None:
                raise self.error
            self._streams[request_id] = q
            try:
                self.engine.add_request(request_id, token_ids, sampling, lora_id,
                                        mm_items=mm_items, trace_ctx=trace_ctx, rank=rank)
            except ValueError:
                self._streams.pop(request_id, None)
                raise
        try:
            while True:
                out = q.get()
                if isinstance(out, BaseException):
                    raise out
                yield out
                if out.finished:
                    return
        finally:
            with self._lock:
                self._streams.pop(request_id, None)
                if request_id in self.engine.seqs:
                    self.engine.abort(request_id)
