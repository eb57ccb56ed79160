"""A program captured once into a ``torch.cuda.CUDAGraph`` and replayed once per
call: the port's counterpart of the reference's one jitted decode program.

:class:`CapturedProgram` wraps a function of no arguments that reads and
writes only static tensors (the engine's :class:`~llmd_tpu_torch.engine.
decode_program.DecodeBuffers`, the KV pool and the params) and returns a
tensor. The first :meth:`~CapturedProgram.__call__` captures it:

1. warm-up runs on a side stream: cuBLAS workspaces, the kernels' libraries
   (built and loaded, ``cudaFuncSetAttribute``, the tensor-map encoder's
   entry point) and every lazily made host object exist before capture;
2. the capture itself, with the caller's generator registered so that each
   replay draws fresh random numbers;
3. the kernel wrappers' launch counters: what the capture counted, per
   instance, is taken back and added again on every replay, so the counters
   keep counting device launches (set-up launches are not counted).

A capture holds :data:`CAPTURE_LOCK` from its warm-up to its end: other
threads that issue device-wide CUDA calls (the device monitor's liveness
probe) take it too. The capture is thread-local
(``capture_error_mode="thread_local"``): only the capturing thread may not
make the calls a capture forbids. In the default global mode a
synchronize, a read-back or an allocation by another thread (a second
engine in the same process, as a router's engines or a pool's are when they
share one) invalidated the capture and failed both engines' steps.

A capture or replay failure raises; nothing falls back to running eagerly.
The function must leave the device as it found it apart from its outputs
(the engine's idles every slot first, so the warm-up writes only the pool's
dump row). The engine counts captures, replays and capture seconds in its
``EngineStats``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

import torch


def launch_counters() -> list:
    """The kernel wrappers whose ``.launches`` / ``.launches_by_instance``
    count launches: K1, K3, K2, K4."""
    from llmd_tpu_torch.ops import grouped_gemm as gg
    from llmd_tpu_torch.ops import mla_decode as md
    from llmd_tpu_torch.ops import paged_attention as pa

    return [pa.paged_attention, md.mla_decode, gg.ragged_grouped_gemm, gg.grouped_gemm]


def _read() -> list[tuple[int, dict]]:
    return [(fn.launches, dict(fn.launches_by_instance)) for fn in launch_counters()]


def _write(counts: list[tuple[int, dict]]) -> None:
    for fn, (n, by) in zip(launch_counters(), counts):
        fn.launches = n
        fn.launches_by_instance = dict(by)


WARMUP_RUNS = 2  # eager runs on a side stream before the capture

# held by every capture; device-wide calls from other threads take it
CAPTURE_LOCK = threading.Lock()


class CapturedProgram:
    """``fn`` captured at its first call on ``device``, replayed after."""

    def __init__(self, fn: Callable[[], torch.Tensor], device: torch.device,
                 generator: torch.Generator) -> None:
        if device.type != "cuda":
            raise ValueError(f"CapturedProgram: a CUDA graph needs a CUDA device, got {device}")
        self.fn, self.device, self.generator = fn, device, generator
        self.graph: "torch.cuda.CUDAGraph | None" = None
        self.output: "torch.Tensor | None" = None
        self.per_replay: list[tuple[int, dict]] = []  # launches per wrapper and instance
        self.seconds = 0.0

    def capture(self) -> None:
        with CAPTURE_LOCK:
            self._capture()

    def _capture(self) -> None:
        t0 = time.perf_counter()
        before = _read()
        stream = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            for _ in range(WARMUP_RUNS):
                self.fn()
        stream.wait_stream(side)
        warm = _read()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            output = self.fn()
        after = _read()
        self.per_replay = [(n - n0, {k: v - by0[k] for k, v in by.items()})
                           for (n, by), (n0, by0) in zip(after, warm)]
        _write(before)
        torch.cuda.synchronize(self.device)
        self.graph, self.output = graph, output
        self.seconds = time.perf_counter() - t0

    def __call__(self) -> torch.Tensor:
        """Replay on the current stream (capturing first if need be); the
        returned tensor is the graph's static output, rewritten by the next
        replay."""
        if self.graph is None:
            self.capture()
        self.graph.replay()
        for fn, (n, by) in zip(launch_counters(), self.per_replay):
            fn.launches += n
            for k, v in by.items():
                fn.launches_by_instance[k] += v
        return self.output
