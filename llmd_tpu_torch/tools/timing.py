"""Device time of a call on the card by CUDA events, held by a spin kernel
(:func:`cuda_ms`): the one yardstick of ``tools/bench.py``'s tuner and of
``chip_smoke.py``'s kernel times. It times; it is not a path to optimise."""

import statistics

import torch

# cycles of the spin kernel queued before each timed run (~1 ms on an H100):
# longer than the host takes to enqueue the run, so the events time the card
HOLD_CYCLES = 2_000_000


def cuda_ms(fn, reps: int = 25, inner: int = 10) -> float:
    """Median per-call device time over ``reps`` runs of ``inner`` calls. A
    spin kernel queued before each run holds the card while the host
    enqueues the run, so a call whose host side is slower than its kernel is
    timed by its kernels, not by the host."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)
