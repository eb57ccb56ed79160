"""Benchmark harness: workload profiles, load generation, RR-vs-scheduler
comparison (the reference's `llmdbenchmark` / inference-perf role; port of
``llmd_tpu/benchmark``)."""

from llmd_tpu_torch.benchmark.harness import (  # noqa: F401
    LoadResult,
    WorkloadSpec,
    build_requests,
    compare_targets,
    run_load,
)
