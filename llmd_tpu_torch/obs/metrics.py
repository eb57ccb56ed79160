"""Dependency-free Prometheus text-format registry and the engine's metric
families (copy of the parts of ``llmd_tpu/obs/metrics.py`` that an engine
uses).

The text-exposition contract (``# HELP`` / ``# TYPE`` headers, cumulative
``_bucket``/``_sum``/``_count`` histogram series, label-value escaping per the
Prometheus text format) and every engine and engine-server family carry the
reference's names, types, help strings and label names, so a router or a
dashboard reads a port engine's ``/metrics`` as it reads a JAX engine's.
``vllm:lora_requests_info`` is rebuilt by the server at every scrape from
the engine's LoRA registry (its labels are the data). The device plane's
families (``DeviceMetrics``) are registered on the engine's registry by the
server's ``DeviceMonitor`` (``obs/device.py``). The router's families
(``RouterMetrics``) are the reference's, registered by ``router/server.py``;
the pool controller's are not copied yet.

* Thread-safe: the engine loop mutates families while HTTP threads scrape;
  every mutation and the exposition walk take the registry lock.
* Families are idempotent: registering the same (name, type) twice returns
  the existing family; a type mismatch raises.
* ``set_labels_function`` attaches a scrape-time callback to a labeled
  family (the utilization and HBM gauges).
* OpenMetrics exemplars: ``Histogram.observe(v, exemplar={"trace_id": ...})``
  keeps the latest exemplar of the bucket ``v`` lands in, and the exposition
  appends `` # {trace_id="..."} <value> <unix ts>`` to that bucket's line, as
  the reference's does, so a dashboard jumps from a slow bucket to a trace.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Summary",
    "Registry",
    "escape_label_value",
    "escape_help",
    "EngineMetrics",
    "EngineServerMetrics",
    "DeviceMetrics",
    "register_engine_metrics",
    "register_engine_server_metrics",
    "register_device_metrics",
]

# Default latency buckets (seconds), the reference's: engine steps land in
# the 1-500 ms range.
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0)


def escape_label_value(value: object) -> str:
    """Escape a label value per the Prometheus text exposition format:
    backslash, double-quote, and newline must be escaped inside the
    double-quoted label value."""
    return (str(value)
            .replace("\\", "\\\\")
            .replace('"', '\\"')
            .replace("\n", "\\n"))


def escape_help(text: str) -> str:
    """HELP lines escape backslash and newline (but not quotes)."""
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _render_labels(names: Sequence[str], values: Sequence[object],
                   extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    pairs = [f'{n}="{escape_label_value(v)}"' for n, v in zip(names, values)]
    pairs += [f'{n}="{escape_label_value(v)}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def _fmt(v: float) -> str:
    # Integers render without a trailing .0 (matches prometheus_client and
    # keeps byte-for-byte parity with the previous hand-rolled exposition).
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Family:
    """Base class: holds per-label-set children keyed by label values."""

    typ = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str],
                 lock: threading.RLock):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = lock
        self._children: Dict[Tuple[str, ...], object] = {}
        self._fn: Optional[Callable[[], float]] = None
        self._labels_fn: Optional[
            Callable[[], Iterable[Tuple[Dict[str, object], float]]]] = None

    # -- child management -------------------------------------------------
    def labels(self, **kv):
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(kv)} != declared "
                f"{sorted(self.labelnames)}")
        key = tuple(str(kv[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._new_child()
                self._children[key] = child
            return child

    def clear(self) -> None:
        """Drop all children (scrape-time-refreshed info gauges)."""
        with self._lock:
            self._children.clear()

    def set_function(self, fn: Callable[[], float]) -> None:
        """Attach a scrape-time value callback (unlabeled families only)."""
        if self.labelnames:
            raise ValueError(f"{self.name}: set_function on labeled family")
        self._fn = fn

    def set_labels_function(
            self,
            fn: Callable[[], Iterable[Tuple[Dict[str, object], float]]],
    ) -> None:
        """Attach a scrape-time callback yielding (labels-dict, value) pairs
        for a *labeled* counter/gauge family, so the exposed label sets
        track the caller's state (the utilization gauges' programs) without
        pre-registering a child per label set."""
        if not self.labelnames:
            raise ValueError(f"{self.name}: set_labels_function on unlabeled family")
        self._labels_fn = fn

    def _default(self):
        """The implicit child for unlabeled families."""
        if self.labelnames:
            raise ValueError(f"{self.name}: family has labels; use .labels()")
        key = ()
        # double-checked fast path: a dict get is atomic under the GIL and
        # the miss path re-checks via setdefault under the lock
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, self._new_child())
        return child

    def _new_child(self):  # pragma: no cover - overridden
        raise NotImplementedError

    # -- exposition -------------------------------------------------------
    def samples(self) -> Iterable[Tuple[str, str, float, Optional[tuple]]]:
        """Yield (suffix, rendered-labels, value, exemplar) quads; the
        exemplar is None except on histogram buckets that captured one (a
        (labels-dict, value, unix-ts) triple)."""
        if self._fn is not None:
            yield "", "", float(self._fn()), None
            return
        if self._labels_fn is not None:
            for labels, value in self._labels_fn():
                if set(labels) != set(self.labelnames):
                    continue  # malformed pair: skip rather than corrupt scrape
                key = tuple(str(labels[n]) for n in self.labelnames)
                yield "", _render_labels(self.labelnames, key), float(value), None
            return
        with self._lock:  # snapshot: .labels() can insert mid-scrape
            children = list(self._children.items())
        for key, child in children:
            for s in self._child_samples(key, child):
                yield s if len(s) == 4 else (*s, None)

    def _child_samples(self, key, child):  # pragma: no cover - overridden
        raise NotImplementedError


class _Value:
    __slots__ = ("v",)

    def __init__(self):
        self.v = 0.0


class Counter(_Family):
    typ = "counter"

    def _new_child(self):
        return _CounterChild(self._lock)

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    @property
    def value(self) -> float:
        if self._fn is not None:
            return float(self._fn())
        return self._default().value

    def _child_samples(self, key, child):
        yield "", _render_labels(self.labelnames, key), child.value


class _CounterChild:
    def __init__(self, lock):
        self._lock = lock
        self._v = _Value()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._v.v += amount

    @property
    def value(self) -> float:
        return self._v.v


class Gauge(_Family):
    typ = "gauge"

    def _new_child(self):
        return _GaugeChild(self._lock)

    def set(self, value: float) -> None:
        self._default().set(value)

    @property
    def value(self) -> float:
        if self._fn is not None:
            return float(self._fn())
        return self._default().value

    def _child_samples(self, key, child):
        yield "", _render_labels(self.labelnames, key), child.value


class _GaugeChild:
    def __init__(self, lock):
        self._lock = lock
        self._v = _Value()

    def set(self, value: float) -> None:
        with self._lock:
            self._v.v = float(value)

    @property
    def value(self) -> float:
        return self._v.v


class Histogram(_Family):
    """Cumulative-bucket histogram: `_bucket{le=...}` series are cumulative
    counts, closed by `le="+Inf"`, plus `_sum` and `_count`, each bucket
    with its latest exemplar (if one was given)."""

    typ = "histogram"

    def __init__(self, name, help, labelnames, lock,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames, lock)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError(f"{name}: histogram needs at least one bucket")

    def _new_child(self):
        return _HistogramChild(self.buckets, self._lock)

    def observe(self, value: float, exemplar: Optional[Dict[str, str]] = None) -> None:
        self._default().observe(value, exemplar=exemplar)

    def _child_samples(self, key, child):
        cum = 0
        for i, (b, c) in enumerate(zip(self.buckets, child.counts)):
            cum += c
            yield ("_bucket",
                   _render_labels(self.labelnames, key, (("le", _fmt(b)),)), cum,
                   child.exemplars[i])
        yield ("_bucket",
               _render_labels(self.labelnames, key, (("le", "+Inf"),)), child.count,
               child.exemplars[len(self.buckets)])
        yield "_sum", _render_labels(self.labelnames, key), child.sum
        yield "_count", _render_labels(self.labelnames, key), child.count


class _HistogramChild:
    def __init__(self, buckets, lock):
        self._buckets = buckets
        self._lock = lock
        self.counts = [0] * len(buckets)
        # latest (labels, value, unix-ts) per bucket, +Inf included
        self.exemplars: List[Optional[tuple]] = [None] * (len(buckets) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float, exemplar: Optional[Dict[str, str]] = None) -> None:
        v = float(value)
        with self._lock:
            self.sum += v
            self.count += 1
            idx = len(self._buckets)  # +Inf unless a finite bucket catches it
            for i, b in enumerate(self._buckets):
                if v <= b:
                    self.counts[i] += 1
                    idx = i
                    break
            if exemplar:
                self.exemplars[idx] = (dict(exemplar), v, time.time())


class Summary(_Family):
    """sum + count only (no quantiles) — enough for rate()-based means."""

    typ = "summary"

    def _new_child(self):
        return _SummaryChild(self._lock)

    def observe(self, value: float) -> None:
        self._default().observe(value)

    def _child_samples(self, key, child):
        yield "_sum", _render_labels(self.labelnames, key), child.sum
        yield "_count", _render_labels(self.labelnames, key), child.count


class _SummaryChild:
    def __init__(self, lock):
        self._lock = lock
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        with self._lock:
            self.sum += float(value)
            self.count += 1


class Registry:
    """A named set of metric families with a single text formatter."""

    def __init__(self):
        self._lock = threading.RLock()
        self._families: Dict[str, _Family] = {}

    def _register(self, cls, name, help, labelnames, **kw) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls):
                    raise ValueError(
                        f"{name}: already registered as {fam.typ}")
                return fam
            fam = cls(name, help, labelnames, self._lock, **kw)
            if not fam.labelnames:
                fam._default()  # expose 0 immediately (contract presence)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help, labelnames,
                              buckets=buckets)

    def summary(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Summary:
        return self._register(Summary, name, help, labelnames)

    def families(self) -> List[str]:
        """Registered family base names."""
        with self._lock:
            return sorted(self._families)

    def get(self, name: str) -> Optional[_Family]:
        with self._lock:
            return self._families.get(name)

    def collect(self) -> List[Tuple[str, str, float]]:
        """Flat (full_name, rendered_labels, value) sample list."""
        with self._lock:
            return [(name + suffix, labels, value)
                    for name, fam in self._families.items()
                    for suffix, labels, value, _ex in fam.samples()]

    def expose(self) -> str:
        """Render the Prometheus text exposition format (with OpenMetrics
        exemplar annotations on histogram buckets that captured one)."""
        lines: List[str] = []
        with self._lock:
            for name, fam in self._families.items():
                if fam.help:
                    lines.append(f"# HELP {name} {escape_help(fam.help)}")
                lines.append(f"# TYPE {name} {fam.typ}")
                for suffix, labels, value, ex in fam.samples():
                    line = f"{name}{suffix}{labels} {_fmt(value)}"
                    if ex is not None:
                        ex_labels, ex_value, ex_ts = ex
                        rendered = ",".join(f'{k}="{escape_label_value(v)}"'
                                            for k, v in ex_labels.items())
                        line += f" # {{{rendered}}} {_fmt(ex_value)} {ex_ts:.3f}"
                    lines.append(line)
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Family declarations, as the reference declares them (the comments name the
# reference's subsystems); scrape-time callbacks are attached later by the
# owning component.
# ---------------------------------------------------------------------------


class EngineMetrics:
    """Families owned by LLMEngine (incremented inside the step loop)."""

    def __init__(self, reg: Registry):
        self.registry = reg
        self.step_duration = reg.histogram(
            "llmd_tpu:engine_step_duration_seconds",
            "Engine step wall time by phase "
            "(unified, decode_dispatch, decode_process, spec_verify; pack = "
            "serialized host pack at a chain boundary, pack_overlap = chained "
            "fast-path pack hidden behind the in-flight device call, "
            "chain_stage = dense grammar/bias table staging per chain; attn = "
            "sampled attention-only probe scaled to the fused call: "
            "wall x layers x k; moe_dispatch / moe_experts / moe_combine = "
            "sampled MoE stage probes scaled the same way — the measured DBO "
            "overlap evidence)",
            labelnames=("phase",))
        self.attn_backend_info = reg.gauge(
            "llmd_tpu:engine_attn_backend",
            "Resolved attention backend + active block-size tune-table hash "
            "(info-style: value 1 on the selected label set)",
            labelnames=("backend", "tune"))
        self.batch_occupancy = reg.histogram(
            "llmd_tpu:engine_batch_occupancy",
            "Running/waiting sequence counts sampled once per engine step",
            labelnames=("kind",),
            buckets=(0, 1, 2, 4, 8, 16, 32, 64, 128, 256))
        self.prefill_tokens = reg.counter(
            "llmd_tpu:prefill_tokens_total",
            "Prompt tokens computed by the engine")
        self.decode_tokens = reg.counter(
            "llmd_tpu:decode_tokens_total",
            "Decode tokens generated by the engine")
        self.preemptions = reg.counter(
            "llmd_tpu:preemptions_total",
            "Sequences preempted (recompute-on-readmit)")
        self.kv_exhaustion = reg.counter(
            "llmd_tpu:kv_block_exhaustion_total",
            "KV page allocations that failed because the pool was exhausted")
        self.requests_waiting = reg.gauge(
            "vllm:num_requests_waiting",
            "Sequences in the engine waiting queue")
        self.requests_running = reg.gauge(
            "vllm:num_requests_running",
            "Sequences actively running in the engine batch")
        self.kv_usage = reg.gauge(
            "vllm:kv_cache_usage_perc",
            "KV cache page utilization (0..1)")
        self.cache_config = reg.gauge(
            "vllm:cache_config_info",
            "Static KV cache configuration",
            labelnames=("block_size", "num_gpu_blocks"))
        self.lora_info = reg.gauge(
            "vllm:lora_requests_info",
            "Running/waiting LoRA adapters (refreshed at scrape time)",
            labelnames=("max_lora", "running_lora_adapters",
                        "waiting_lora_adapters"))
        # KV offload tier: hit/miss/evict incremented inside CPUOffloadStore;
        # saves/loads/demotions/cpu_blocks attach callbacks onto the legacy
        # store counters when offload is enabled.
        self.offload_hits = reg.counter(
            "llmd_tpu:offload_hits_total",
            "CPU offload store lookups that found the block")
        self.offload_misses = reg.counter(
            "llmd_tpu:offload_misses_total",
            "CPU offload store lookups that missed")
        self.offload_evictions = reg.counter(
            "llmd_tpu:offload_evictions_total",
            "Blocks evicted from the CPU offload store (LRU)")
        self.offload_transfer_bytes = reg.histogram(
            "llmd_tpu:offload_transfer_bytes",
            "Bytes moved per offload transfer, by direction (save|load)",
            labelnames=("direction",),
            buckets=(1024, 16384, 65536, 262144, 1048576, 4194304,
                     16777216, 67108864))
        self.offload_saves = reg.counter(
            "llmd_tpu:offload_saves_total",
            "Blocks saved into the CPU offload store")
        self.offload_loads = reg.counter(
            "llmd_tpu:offload_loads_total",
            "Blocks loaded back from the CPU offload store")
        self.offload_demotions = reg.counter(
            "llmd_tpu:offload_demotions_total",
            "Blocks demoted from the CPU store to the filesystem tier")
        self.offload_cpu_blocks = reg.gauge(
            "llmd_tpu:offload_cpu_blocks",
            "Blocks currently resident in the CPU offload store")
        # Prefix-cache effectiveness: fed at admission from
        # seq.num_cached_prompt (engine._try_admit_rank) — the hit data always
        # existed host-side but never reached /metrics.
        self.prefix_cached_tokens = reg.counter(
            "llmd_tpu:engine_prefix_cached_tokens_total",
            "Prompt tokens served from the prefix cache at admission")
        self.prefix_prompt_tokens = reg.counter(
            "llmd_tpu:engine_prefix_prompt_tokens_total",
            "Prompt tokens of admitted sequences (prefix hit-ratio denominator)")
        self.prefix_hit_ratio = reg.gauge(
            "llmd_tpu:engine_prefix_cache_hit_ratio",
            "Cumulative prefix-cache hit ratio (cached / prompt tokens)")
        # Speculative decoding (engine/spec.py prompt-lookup drafts verified
        # through the flat mixed-batch program).
        self.spec_drafted = reg.counter(
            "llmd_tpu:spec_drafted_tokens_total",
            "Draft tokens proposed by the prompt-lookup drafter")
        self.spec_accepted = reg.counter(
            "llmd_tpu:spec_accepted_tokens_total",
            "Draft tokens accepted by greedy verification")
        self.spec_rejected = reg.counter(
            "llmd_tpu:spec_rejected_tokens_total",
            "Draft tokens rejected (rolled back) by greedy verification")
        self.spec_acceptance = reg.summary(
            "llmd_tpu:spec_acceptance_rate",
            "Per-request draft acceptance rate, observed at retirement "
            "(constrained=yes for grammar/logit_bias rows — the spec x "
            "structured compose path)",
            labelnames=("constrained",))
        # Step-program registry (engine/programs.py): per-program dispatch
        # counts; paired with the registry's completion counters they carry
        # the generalized quiesce invariant into /metrics.
        self.program_dispatches = reg.counter(
            "llmd_tpu:engine_program_dispatches_total",
            "Compiled-program dispatches, by step-program registry entry",
            labelnames=("program",))
        # Structured outputs (llmd_tpu/structured): grammar-constrained
        # decoding with on-device logit masks.
        self.structured_requests = reg.counter(
            "llmd_tpu:structured_requests_total",
            "Grammar-constrained requests admitted, by constraint kind",
            labelnames=("kind",))
        self.structured_compile_seconds = reg.histogram(
            "llmd_tpu:structured_compile_seconds",
            "Grammar compile time at admission (cache hits observe ~0)",
            buckets=(0.0005, 0.002, 0.01, 0.05, 0.25, 1.0, 5.0))
        self.structured_mask_seconds = reg.histogram(
            "llmd_tpu:structured_mask_build_seconds",
            "Host-side per-step bias build for constrained sample batches",
            buckets=(0.0001, 0.0005, 0.002, 0.01, 0.05, 0.25))
        self.structured_cache_hits = reg.counter(
            "llmd_tpu:structured_cache_hits_total",
            "Compiled-grammar LRU cache hits at admission")
        self.structured_cache_misses = reg.counter(
            "llmd_tpu:structured_cache_misses_total",
            "Compiled-grammar LRU cache misses (fresh compiles) at admission")
        self.structured_violations = reg.counter(
            "llmd_tpu:structured_violations_total",
            "Tokens observed outside the active grammar (incl. truncated "
            "constrained generations counted at retirement)")
        # Latency attribution (obs/attribution.py): each retired request's
        # flight timeline folds into a phase ledger; phases + the
        # unattributed residual sum to wall clock by construction. The same
        # family name is declared by RouterMetrics — registration is
        # idempotent, each plane feeds its own registry.
        self.request_phase = reg.histogram(
            "llmd_tpu:request_phase_seconds",
            "Per-request wall time attributed to a lifecycle phase at "
            "retirement (phase=unattributed is the ledger residual — the "
            "unknown-unknown detector)",
            labelnames=("phase", "tenant", "model"),
            buckets=(0.001, 0.005, 0.025, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                     10.0, 30.0))
        # Decision plane, engine view (obs/decisions.py): spec-decode
        # economics folded per request at retirement. The global
        # spec_drafted/spec_accepted counters above tally tokens fleet-wide;
        # these attribute the waste per retired request ledger.
        self.decision_ledgers = reg.counter(
            "llmd_tpu:decision_ledgers_total",
            "Retired requests folded into a decision ledger, by plane "
            "(router | engine; same family declared on both registries)",
            labelnames=("plane",))
        self.decision_spec_wasted = reg.counter(
            "llmd_tpu:decision_spec_wasted_tokens_total",
            "Draft positions packed through verify but rejected, summed per "
            "request at retirement (the speculation lever's wasted compute)")
        self.decision_spec_flips = reg.counter(
            "llmd_tpu:decision_spec_flips_total",
            "Per-sequence drafter arm/disarm transitions summed at "
            "retirement (a high flip rate means the acceptance controller "
            "is thrashing)")
        # Utilization attribution plane (obs/costmodel.py, LLMD_UTIL_LEDGER):
        # analytic per-dispatch FLOPs/bytes joined with measured step walls.
        # The MFU/MBU gauges attach scrape-time callbacks against the device-
        # generation peak table; on CPU (null peaks) the families stay
        # declared but export no samples.
        self.program_mfu = reg.gauge(
            "llmd_tpu:program_mfu",
            "Model FLOPs utilization per step program over the rolling "
            "LLMD_UTIL_WINDOW_S window: analytic dispatched FLOPs / "
            "(window x device peak FLOP/s). Absent when the device "
            "generation has no peak-table entry (e.g. CPU)",
            labelnames=("program",))
        self.program_mbu = reg.gauge(
            "llmd_tpu:program_mbu",
            "HBM bandwidth utilization per step program over the rolling "
            "window: analytic bytes (weight passes + KV page traffic) / "
            "(window x device peak bytes/s). Absent off-device",
            labelnames=("program",))
        self.program_flops = reg.gauge(
            "llmd_tpu:program_flops_per_second",
            "Achieved FLOP/s per step program over the rolling window "
            "(analytic numerator; exported even where peaks are unknown)",
            labelnames=("program",))
        self.program_bytes = reg.gauge(
            "llmd_tpu:program_bytes_per_second",
            "Achieved HBM bytes/s per step program over the rolling window "
            "(analytic numerator; exported even where peaks are unknown)",
            labelnames=("program",))
        self.goodput_tokens = reg.counter(
            "llmd_tpu:goodput_tokens_total",
            "Slot-tokens of every step-program dispatch classified by fate: "
            "committed | spec_rejected | padding | preempted_recompute | "
            "prefix_saved. Per program the kinds partition capacity + saved "
            "tokens, so fractions sum to 1 by construction",
            labelnames=("program", "kind"))
        self.padding_efficiency = reg.gauge(
            "llmd_tpu:program_padding_efficiency",
            "Real packed positions / slot capacity per step program, "
            "cumulative ((0,1]; the standing series for verify's NT "
            "overprovisioning waste)",
            labelnames=("program",))
        self.program_compiles = reg.counter(
            "llmd_tpu:program_compiles_total",
            "XLA compile-cache entries created per step program "
            "(compile_counts() deltas observed at dispatch completion; "
            "growth after warmup = recompile storm)",
            labelnames=("program",))
        self.program_compile_seconds = reg.histogram(
            "llmd_tpu:program_compile_seconds",
            "Step wall observed when a dispatch completion coincided with a "
            "compile-cache miss for its program (compile dominates that "
            "step, so the step wall approximates compile time)",
            labelnames=("program",),
            buckets=(0.1, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0))
        # MoE dispatch health (ops/moe_dispatch): the legacy einsum path
        # silently drops tokens past moe_capacity_factor — this counter
        # surfaces the quality bug the sorted path eliminates (sorted is
        # drop-free by construction, so path="sorted" staying 0 is the
        # standing invariant; path="einsum" counts routed - kept).
        self.moe_dropped_tokens = reg.counter(
            "llmd_tpu:moe_dropped_tokens_total",
            "Routed MoE tokens dropped at expert capacity, by dispatch path "
            "(sorted is drop-free by construction — a non-zero sorted series "
            "is a dispatch bug; einsum counts routed - kept per step)",
            labelnames=("path",))
        self.moe_ep_imbalance = reg.gauge(
            "llmd_tpu:moe_ep_load_imbalance",
            "Per-EP-rank expert-load imbalance (max/mean routed tokens per "
            "rank over the EPLB window), stamped before and after each "
            "rebalance (when=before|after; 1.0 = perfectly balanced)",
            labelnames=("when",))


class EngineServerMetrics:
    """Families owned by EngineServer (per-frontend in wide-EP mode)."""

    def __init__(self, reg: Registry):
        self.registry = reg
        self.requests = reg.counter(
            "llmd_tpu:requests_total",
            "Generation requests accepted by this frontend")
        self.transfer = {
            key: reg.counter(
                f"llmd_tpu:kv_transfer_{key}_total",
                f"Disaggregated KV transfer: {key}")
            for key in ("exports", "pulls", "notifies", "expired",
                        "injected_blocks", "pull_failures",
                        "prefix_pulls", "prefix_pull_blocks", "released")
        }
        # leak canary for the satellite fix: registrations a dead puller
        # abandoned are released on retire (or reaped on TTL) — a standing
        # non-zero value here under no traffic is a leak
        self.transfer_registrations = reg.gauge(
            "llmd_tpu:kv_transfer_registrations",
            "Live KV export registrations held by the transfer source")
        self.prefix_pull_seconds = reg.histogram(
            "llmd_tpu:kv_transfer_prefix_pull_seconds",
            "Wall time of router-stamped cross-engine prefix pulls, by "
            "outcome (hit|empty|miss|peer_dead|error)",
            labelnames=("outcome",),
            buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                     1.0, 2.5))
        # durable prefix tier (kv/writeback.py): flush counter is in BLOCKS
        # (abandoned = queued blocks dropped at the drain-flush deadline);
        # the get counter is in fetch OPS
        self.kv_durable_flush = reg.counter(
            "llmd_tpu:kv_durable_flush_total",
            "Prefix blocks written back to the durable store, by outcome "
            "(ok|error|dropped|abandoned)",
            labelnames=("outcome",))
        self.kv_durable_get = reg.counter(
            "llmd_tpu:kv_durable_get_total",
            "Durable-tier prefix fetches, by outcome "
            "(ok|miss|corrupt|error|breaker_open)",
            labelnames=("outcome",))
        self.kv_durable_queue_depth = reg.gauge(
            "llmd_tpu:kv_durable_queue_depth",
            "Blocks waiting in the write-back flush queue")
        self.kv_durable_breaker = reg.gauge(
            "llmd_tpu:kv_durable_breaker_state",
            "Durable-store circuit breaker (0 closed, 0.5 half-open, 1 open)")


class RouterMetrics:
    """Families owned by RouterServer (EPP-side contract)."""

    def __init__(self, reg: Registry):
        self.registry = reg
        self.requests = reg.counter(
            "llm_d_epp_requests_total", "Requests received by the router")
        self.responses = reg.counter(
            "llm_d_epp_responses_total", "Successful responses")
        self.errors = reg.counter(
            "llm_d_epp_errors_total", "Errored requests")
        self.scheduled = reg.counter(
            "llm_d_epp_scheduled_total", "Scheduling decisions made")
        self.rejected = reg.counter(
            "llm_d_epp_rejected_total", "Requests the scheduler rejected")
        self.pd_splits = reg.counter(
            "llm_d_epp_pd_splits_total", "Prefill/decode disaggregated splits")
        self.pd_aggregated = reg.counter(
            "llm_d_epp_pd_aggregated_total",
            "Disagg decider picks that stayed aggregated (hop skipped)")
        self.flow_enqueued = reg.counter(
            "llm_d_epp_flow_enqueued_total", "Requests admitted to flow queues")
        self.flow_dispatched = reg.counter(
            "llm_d_epp_flow_dispatched_total",
            "Requests dispatched from flow queues")
        self.flow_rejected_capacity = reg.counter(
            "llm_d_epp_flow_rejected_capacity_total",
            "Requests rejected for queue capacity")
        self.flow_evicted_ttl = reg.counter(
            "llm_d_epp_flow_evicted_ttl_total",
            "Queued requests evicted on TTL expiry")
        self.flow_evicted_deadline = reg.counter(
            "llm_d_epp_flow_evicted_deadline_total",
            "Queued requests whose client deadline expired before dispatch")
        self.flow_queue_depth = reg.gauge(
            "llm_d_epp_flow_queue_depth",
            "Requests currently waiting in flow-control queues")
        self.flow_queue_wait = reg.histogram(
            "llm_d_epp_flow_queue_wait_seconds",
            "Enqueue-to-dispatch wait in the flow-control queue",
            buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0,
                     2.5, 5.0, 10.0, 30.0))
        self.igw_queue_depth = reg.gauge(
            "igw_queue_depth",
            "External autoscaling signal: queued requests")
        self.igw_running = reg.gauge(
            "igw_running_requests",
            "External autoscaling signal: in-flight requests")
        # histogram (was summary) so the buckets can carry trace exemplars —
        # _sum/_count series are unchanged, rate()-mean queries still work
        self.ttft = reg.histogram(
            "llm_d_epp_ttft_seconds", "Time to first token",
            buckets=(0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                     10.0, 30.0))
        self.e2e = reg.histogram(
            "llm_d_epp_e2e_seconds", "End-to-end request latency",
            buckets=(0.1, 0.5, 1.0, 2.0, 5.0, 10.0, 30.0))
        # Resilience layer (router/resilience.py, observability/resilience.md)
        self.retries = reg.counter(
            "llm_d_epp_retries_total",
            "Forward attempts retried on an alternate endpoint, by reason",
            labelnames=("reason",))
        self.retries_exhausted = reg.counter(
            "llm_d_epp_retries_exhausted_total",
            "Requests that failed after exhausting every retry attempt")
        self.breaker_opens = reg.counter(
            "llm_d_epp_breaker_opens_total",
            "Per-endpoint circuit breakers tripped open")
        self.breaker_closes = reg.counter(
            "llm_d_epp_breaker_closes_total",
            "Circuit breakers closed after successful half-open probes")
        self.breaker_open_endpoints = reg.gauge(
            "llm_d_epp_breaker_open_endpoints",
            "Endpoints currently ejected by an open circuit breaker")
        self.deadline_exceeded = reg.counter(
            "llm_d_epp_deadline_exceeded_total",
            "Requests rejected 504 because the client budget ran out in the router")
        self.hedges = reg.counter(
            "llm_d_epp_hedges_total",
            "Hedged second attempts fired for short non-streaming requests")
        self.hedge_wins = reg.counter(
            "llm_d_epp_hedge_wins_total",
            "Hedged attempts that answered before the primary")
        self.scrape_errors = reg.counter(
            "llm_d_epp_scrape_errors_total",
            "Endpoint metrics scrapes that failed (passive-health signal)")
        # Global KV plane (llmd_tpu/kvplane, docs/kv-plane.md)
        self.kvplane_precise = reg.counter(
            "llm_d_epp_kv_plane_precise_total",
            "Requests routed on precise event-fed index lookups")
        self.kvplane_degraded = reg.counter(
            "llm_d_epp_kv_plane_degraded_total",
            "Requests degraded to the approx LRU (index cold or feed stale)")
        self.kvplane_lookups = reg.counter(
            "llm_d_epp_kv_plane_lookups_total",
            "Precise index lookups performed by the KV plane")
        self.kvplane_lookup_hits = reg.counter(
            "llm_d_epp_kv_plane_lookup_hits_total",
            "Precise lookups that found at least one indexed block")
        self.kvplane_pulls_stamped = reg.counter(
            "llm_d_epp_kv_plane_pulls_stamped_total",
            "Cross-engine prefix pulls stamped onto forwarded requests")
        self.kvplane_durable_pulls_stamped = reg.counter(
            "llm_d_epp_kv_plane_durable_pulls_stamped_total",
            "Durable-store prefix pulls stamped when no live peer qualified")
        self.kvplane_index_blocks = reg.gauge(
            "llm_d_epp_kv_plane_index_blocks",
            "Block-hash keys resident in the router's KV index")
        self.kvplane_feed_age = reg.gauge(
            "llm_d_epp_kv_plane_feed_age_seconds",
            "Seconds since the KV plane last applied an event batch "
            "(scrape-time; index-staleness alert input)")
        # Latency attribution: router-plane ledger for the same family the
        # engine declares (registration is idempotent; separate registries).
        self.request_phase = reg.histogram(
            "llmd_tpu:request_phase_seconds",
            "Per-request wall time attributed to a lifecycle phase at "
            "retirement (phase=unattributed is the ledger residual — the "
            "unknown-unknown detector)",
            labelnames=("phase", "tenant", "model"),
            buckets=(0.001, 0.005, 0.025, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                     10.0, 30.0))
        # Decision plane (obs/decisions.py): why routing chose what it chose
        # and whether the decision paid off, folded at retirement.
        self.decision_ledgers = reg.counter(
            "llmd_tpu:decision_ledgers_total",
            "Retired requests folded into a decision ledger, by plane "
            "(router | engine; same family declared on both registries)",
            labelnames=("plane",))
        self.decision_regret = reg.histogram(
            "llmd_tpu:decision_regret",
            "Chosen-endpoint weighted score minus the best alternative's on "
            "multi-endpoint schedules (<=0; further below zero = the picker "
            "overrode the score order harder), bucketed by whether the "
            "request went on to breach an SLO objective",
            labelnames=("slo_breached",),
            buckets=(-2.0, -1.0, -0.5, -0.2, -0.1, -0.05, -0.02, -0.005,
                     0.0, 0.5))
        self.decision_reschedules = reg.counter(
            "llmd_tpu:decision_reschedules_total",
            "Retry/hedge re-schedules observed on retired request ledgers, "
            "by kind",
            labelnames=("kind",))
        self.predictor_calibration_error = reg.histogram(
            "llmd_tpu:predictor_calibration_error_ms",
            "Signed latency-predictor calibration error (observed minus "
            "predicted, ms) joined at retirement, per objective (ttft|e2e) "
            "and model — a skewed sign means systematic bias, wide spread "
            "means the predictor is noise",
            labelnames=("objective", "model"),
            buckets=(-5000.0, -1000.0, -250.0, -50.0, -10.0, 0.0, 10.0,
                     50.0, 250.0, 1000.0, 5000.0))
        self.predictor_calibration_ape = reg.gauge(
            "llmd_tpu:predictor_calibration_ape",
            "Rolling mean absolute percentage error of the latency "
            "predictor over the last LLMD_DECISION_CALIB_WINDOW retired "
            "requests, per objective and model",
            labelnames=("objective", "model"))
        self.decision_kv_pull_blocks = reg.counter(
            "llmd_tpu:decision_kv_pull_blocks_total",
            "KV blocks covered by router-stamped cross-engine pulls, summed "
            "over retired request ledgers")
        self.decision_kv_tokens_saved = reg.counter(
            "llmd_tpu:decision_kv_tokens_saved_total",
            "Estimated re-prefill tokens saved by stamped pulls (plan-time "
            "estimate: peer prefix beyond the chosen target's), summed over "
            "retired request ledgers — weigh against "
            "llmd_tpu:kv_transfer_prefix_pull_seconds actually spent")
        # Per-tenant accounting (x-llm-d-tenant, default "anon"): the
        # fairness foundation — token spend and request volume by tenant.
        self.tenant_requests = reg.counter(
            "llm_d_epp_tenant_requests_total",
            "Requests received, by tenant and model",
            labelnames=("tenant", "model"))
        self.tenant_prompt_tokens = reg.counter(
            "llm_d_epp_tenant_prompt_tokens_total",
            "Prompt tokens consumed, by tenant and model (from upstream "
            "usage accounting)",
            labelnames=("tenant", "model"))
        self.tenant_completion_tokens = reg.counter(
            "llm_d_epp_tenant_completion_tokens_total",
            "Completion tokens generated, by tenant and model",
            labelnames=("tenant", "model"))
        # SLO objectives + burn rate (obs/slo.py, LLMD_SLO_*): attainment and
        # burn gauges are scrape-time callbacks over the rolling windows.
        self.slo_attainment = reg.gauge(
            "llm_d_epp_slo_attainment",
            "Rolling fraction of requests meeting the objective, per tenant "
            "x objective (ttft|e2e) x window (5m|1h)",
            labelnames=("tenant", "objective", "window"))
        self.slo_burn_rate = reg.gauge(
            "llm_d_epp_slo_burn_rate",
            "Error-budget burn rate: (1 - attainment) / (1 - target); 1.0 "
            "burns the budget exactly at the objective rate",
            labelnames=("tenant", "objective", "window"))
        self.slo_breaches = reg.counter(
            "llm_d_epp_slo_breaches_total",
            "Individual requests that missed their objective",
            labelnames=("tenant", "objective"))
        # Fleet rollup plane (obs/fleet.py): aggregated over MetricsPoller
        # scrapes so ONE router scrape answers fleet health — the pool
        # controller and dashboards consume these instead of re-deriving
        # fleet state from per-replica series.
        self.fleet_replicas = reg.gauge(
            "llmd_tpu:fleet_replicas",
            "Replicas currently contributing to the fleet rollup")
        self.fleet_tokens_per_second = reg.gauge(
            "llmd_tpu:fleet_tokens_per_second",
            "Fleet-wide generation throughput from scrape-to-scrape decode "
            "token-counter deltas")
        self.fleet_running = reg.gauge(
            "llmd_tpu:fleet_running_requests",
            "Sum of running sequences across the fleet")
        self.fleet_waiting = reg.gauge(
            "llmd_tpu:fleet_waiting_requests",
            "Sum of queued sequences across the fleet")
        self.fleet_hbm_headroom_min = reg.gauge(
            "llmd_tpu:fleet_hbm_headroom_bytes_min",
            "Smallest per-replica HBM headroom (limit - in-use, summed over "
            "the replica's devices) — the next-OOM candidate")
        self.fleet_hbm_headroom_total = reg.gauge(
            "llmd_tpu:fleet_hbm_headroom_bytes_total",
            "Total HBM headroom across the fleet")
        self.fleet_kv_utilization = reg.gauge(
            "llmd_tpu:fleet_kv_utilization_mean",
            "Mean KV cache utilization across replicas (0..1)")
        self.fleet_fabric_alive = reg.gauge(
            "llmd_tpu:fleet_fabric_alive_replicas",
            "Replicas whose device fabric liveness probe is passing")
        self.fleet_stalled = reg.gauge(
            "llmd_tpu:fleet_stalled_replicas",
            "Replicas whose step watchdog currently reports a stall")
        self.fleet_goodput_ratio = reg.gauge(
            "llmd_tpu:fleet_goodput_committed_ratio",
            "Fleet-wide committed fraction of classified slot-tokens from "
            "scrape-to-scrape goodput-counter deltas (weighted by tokens; "
            "the one-number answer to how much dispatched compute became "
            "output)")
        self.fleet_mfu = reg.gauge(
            "llmd_tpu:fleet_mfu_mean",
            "Mean of per-program MFU samples across replicas exporting them "
            "(absent while no replica runs on a peak-table device)")


class PoolMetricsFamilies:
    """Families owned by the pool controller (``pool/controller.py``)."""

    def __init__(self, reg: Registry):
        self.registry = reg
        self.desired_replicas = reg.gauge(
            "llmd_tpu:pool_desired_replicas",
            "Replica count the autoscaling policy currently wants")
        self.ready_replicas = reg.gauge(
            "llmd_tpu:pool_ready_replicas",
            "Replicas launched, ready, and registered with router discovery")
        self.scale_decisions = reg.counter(
            "llmd_tpu:pool_scale_decisions_total",
            "Reconcile decisions that changed the replica count, by reason",
            labelnames=("reason",))
        self.warm_start = reg.histogram(
            "llmd_tpu:pool_warm_start_seconds",
            "Replica launch-to-ready duration by kind (cold = full engine "
            "build, warm = snapshot restore)",
            labelnames=("kind",),
            buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                     60.0, 120.0))


class DeviceMetrics:
    """Families owned by DeviceMonitor (``obs/device.py``): HBM telemetry,
    liveness, the step watchdog and profiler captures, with the reference's
    names and help strings (``fabric`` names the card's liveness here)."""

    def __init__(self, reg: Registry):
        self.registry = reg
        self.hbm_bytes_in_use = reg.gauge(
            "llmd_tpu:device_hbm_bytes_in_use",
            "HBM bytes currently allocated, per device "
            "(absent on backends without memory_stats, e.g. CPU)",
            labelnames=("device",))
        self.hbm_peak_bytes = reg.gauge(
            "llmd_tpu:device_hbm_peak_bytes",
            "Peak HBM bytes allocated since process start, per device",
            labelnames=("device",))
        self.hbm_limit_bytes = reg.gauge(
            "llmd_tpu:device_hbm_limit_bytes",
            "HBM allocation limit, per device",
            labelnames=("device",))
        self.fabric_alive = reg.gauge(
            "llmd_tpu:device_fabric_alive",
            "1 while the fabric liveness probe completes within its timeout, "
            "0 once a probe wedges or fails")
        self.fabric_probe_failures = reg.counter(
            "llmd_tpu:device_fabric_probe_failures_total",
            "Fabric liveness probes that timed out or raised")
        self.fabric_probe_seconds = reg.histogram(
            "llmd_tpu:device_fabric_probe_seconds",
            "Wall time of successful fabric liveness probes",
            buckets=(0.001, 0.005, 0.025, 0.1, 0.5, 2.0, 10.0, 30.0))
        self.engine_stalled = reg.gauge(
            "llmd_tpu:engine_stalled",
            "1 while the step watchdog sees pending work with no dispatch-"
            "loop heartbeat for LLMD_WATCHDOG_STALL_S, else 0")
        self.engine_stalls = reg.counter(
            "llmd_tpu:engine_stalls_total",
            "Stall episodes detected by the step watchdog")
        self.heartbeat_age = reg.gauge(
            "llmd_tpu:engine_heartbeat_age_seconds",
            "Seconds since the engine dispatch loop last stamped its "
            "heartbeat (scrape-time)")
        self.profile_captures = reg.counter(
            "llmd_tpu:profile_captures_total",
            "On-demand jax.profiler windows captured via /debug/profile")


def register_engine_metrics(reg: Registry) -> EngineMetrics:
    return EngineMetrics(reg)


def register_engine_server_metrics(reg: Registry) -> EngineServerMetrics:
    return EngineServerMetrics(reg)


def register_router_metrics(reg: Registry) -> RouterMetrics:
    return RouterMetrics(reg)


def register_pool_metrics(reg: Registry) -> PoolMetricsFamilies:
    return PoolMetricsFamilies(reg)


def register_device_metrics(reg: Registry) -> DeviceMetrics:
    return DeviceMetrics(reg)
