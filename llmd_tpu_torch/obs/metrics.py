"""Dependency-free Prometheus text-format registry and the engine's metric
families (copy of the parts of ``llmd_tpu/obs/metrics.py`` that an engine
uses).

The text-exposition contract (``# HELP`` / ``# TYPE`` headers, cumulative
``_bucket``/``_sum``/``_count`` histogram series, label-value escaping per the
Prometheus text format) and every engine and engine-server family carry the
reference's names, types, help strings and label names, so a router or a
dashboard reads a port engine's ``/metrics`` as it reads a JAX engine's.
``vllm:lora_requests_info`` is rebuilt by the server at every scrape from
the engine's LoRA registry (its labels are the data). Families of features
the port does not serve yet (the decision plane) are registered all the same
and stay at zero, as they do in a reference engine with the feature off. The
router, pool and device families are not copied: no engine registers them.

* Thread-safe: the engine loop mutates families while HTTP threads scrape;
  every mutation and the exposition walk take the registry lock.
* Families are idempotent: registering the same (name, type) twice returns
  the existing family; a type mismatch raises.
* ``set_labels_function`` attaches a scrape-time callback to a labeled
  family (the utilization gauges).
"""

from __future__ import annotations

import threading
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
    "register_engine_metrics",
    "register_engine_server_metrics",
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
    def samples(self) -> Iterable[Tuple[str, str, float]]:
        """Yield (suffix, rendered-labels, value) triples."""
        if self._fn is not None:
            yield "", "", float(self._fn())
            return
        if self._labels_fn is not None:
            for labels, value in self._labels_fn():
                if set(labels) != set(self.labelnames):
                    continue  # malformed pair: skip rather than corrupt scrape
                key = tuple(str(labels[n]) for n in self.labelnames)
                yield "", _render_labels(self.labelnames, key), float(value)
            return
        with self._lock:  # snapshot: .labels() can insert mid-scrape
            children = list(self._children.items())
        for key, child in children:
            yield from self._child_samples(key, child)

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
    counts, closed by `le="+Inf"`, plus `_sum` and `_count`. (The
    reference's OpenMetrics exemplars come with tracing.)"""

    typ = "histogram"

    def __init__(self, name, help, labelnames, lock,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames, lock)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError(f"{name}: histogram needs at least one bucket")

    def _new_child(self):
        return _HistogramChild(self.buckets, self._lock)

    def observe(self, value: float) -> None:
        self._default().observe(value)

    def _child_samples(self, key, child):
        cum = 0
        for b, c in zip(self.buckets, child.counts):
            cum += c
            yield ("_bucket",
                   _render_labels(self.labelnames, key, (("le", _fmt(b)),)), cum)
        yield ("_bucket",
               _render_labels(self.labelnames, key, (("le", "+Inf"),)), child.count)
        yield "_sum", _render_labels(self.labelnames, key), child.sum
        yield "_count", _render_labels(self.labelnames, key), child.count


class _HistogramChild:
    def __init__(self, buckets, lock):
        self._buckets = buckets
        self._lock = lock
        self.counts = [0] * len(buckets)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self.sum += v
            self.count += 1
            for i, b in enumerate(self._buckets):
                if v <= b:
                    self.counts[i] += 1
                    break


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
                    for suffix, labels, value in fam.samples()]

    def expose(self) -> str:
        """Render the Prometheus text exposition format."""
        lines: List[str] = []
        with self._lock:
            for name, fam in self._families.items():
                if fam.help:
                    lines.append(f"# HELP {name} {escape_help(fam.help)}")
                lines.append(f"# TYPE {name} {fam.typ}")
                for suffix, labels, value in fam.samples():
                    lines.append(f"{name}{suffix}{labels} {_fmt(value)}")
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


def register_engine_metrics(reg: Registry) -> EngineMetrics:
    return EngineMetrics(reg)


def register_engine_server_metrics(reg: Registry) -> EngineServerMetrics:
    return EngineServerMetrics(reg)
