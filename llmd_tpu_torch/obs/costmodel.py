"""Analytic roofline cost model and the utilization / goodput ledger (copy of
``llmd_tpu/obs/costmodel.py`` for the port).

- **Cost model**: per-dispatch FLOPs and HBM bytes from the model config and
  the dispatch's packed shape. The matmul term is ``2 * active_params`` per
  slot position (the same ``flops_per_token`` that the bench's
  ``decode_mfu`` uses); bytes are weight passes plus KV page traffic (read
  and write) plus the MoE dispatch/combine traffic. Attention score/value
  FLOPs are left out, as in the reference.
- **UtilLedger**: joins each dispatch's analytic cost with its measured wall
  into per-program achieved FLOP/s and bytes/s over a rolling window, and
  classifies every slot-token of every dispatch as one of
  :data:`GOODPUT_KINDS`. The reference's compile count is its jit cache; the
  port's counterpart is a CUDA-graph capture, so :meth:`UtilLedger.compiles`
  counts captures per program and :meth:`UtilLedger.recompiles` the captures
  beyond the first.
- **Peak table**: keyed by ``torch.cuda.get_device_name()``; holds the card
  this port runs on. ``LLMD_UTIL_PEAKS_FILE`` overlays a JSON map
  ``{device name: [bf16 TFLOP/s, HBM GB/s]}``. An unknown device gives
  ``(None, None)``, never a guessed peak.

``LLMD_UTIL_LEDGER=0`` (or ``off``/``false``/empty), read once at engine
construction, turns the ledger off. :func:`attach_util_exporter` binds a
ledger to the engine's metric families: the goodput and capture counters
move at :meth:`UtilLedger.record`, and the rate gauges are read at scrape time.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time
from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Tuple


def util_ledger_enabled() -> bool:
    """Master switch, read once at engine construction (default on)."""
    return os.environ.get("LLMD_UTIL_LEDGER", "1") not in ("0", "false", "off", "")


def util_window_s() -> float:
    """Rolling window of the achieved-rate readings (seconds)."""
    try:
        return max(1.0, float(os.environ.get("LLMD_UTIL_WINDOW_S", "60")))
    except ValueError:
        return 60.0


# (bf16 dense TFLOP/s, HBM GB/s) by device name, matched by substring against
# torch.cuda.get_device_name(): the H100 SXM data sheet.
CHIP_PEAKS: Dict[str, Tuple[float, float]] = {
    "NVIDIA H100 80GB HBM3": (989.0, 3350.0),
}


def _peaks_overlay() -> Dict[str, Tuple[float, float]]:
    """CHIP_PEAKS overlaid with LLMD_UTIL_PEAKS_FILE (a malformed file keeps
    the builtin table, with a note on stderr)."""
    table = dict(CHIP_PEAKS)
    path = os.environ.get("LLMD_UTIL_PEAKS_FILE")
    if not path:
        return table
    try:
        with open(path) as f:
            raw = json.load(f)
        for kind, peaks in raw.items():
            table[str(kind)] = (float(peaks[0]), float(peaks[1]))
    except (OSError, ValueError, TypeError, IndexError, KeyError, AttributeError) as e:
        print(f"# costmodel: ignoring LLMD_UTIL_PEAKS_FILE {path!r}: {e}", file=sys.stderr)
    return table


def chip_peaks(device_kind: str, default: Optional[Tuple[float, float]] = None
               ) -> Tuple[Optional[float], Optional[float]]:
    """(bf16 TFLOP/s, HBM GB/s) for a device name, or ``default`` ((None,
    None) unless given) when the device is not in the table."""
    table = _peaks_overlay()
    for k in sorted(table, key=len, reverse=True):  # longest match first
        if k.lower() in (device_kind or "").lower():
            return table[k]
    return default if default is not None else (None, None)


def param_count(cfg) -> int:
    """Total weight parameters: qkvo + SwiGLU per layer (expert banks, shared
    experts and the router for MoE) plus the (un)tied embeddings."""
    D, L = cfg.hidden_size, cfg.num_layers
    H, Hk, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    attn = D * (H + 2 * Hk) * Dh + H * Dh * D
    if cfg.is_moe:
        Fm = cfg.moe_intermediate_size
        banks = cfg.moe_num_experts + cfg.moe_num_shared_experts
        ffn = 3 * D * Fm * banks + D * cfg.moe_num_experts
    else:
        ffn = 3 * D * cfg.intermediate_size
    emb = cfg.vocab_size * D * (1 if cfg.tie_embeddings else 2)
    return (attn + ffn) * L + emb


def active_param_count(cfg) -> int:
    """Parameters touched per token: all of a dense model; attention, top-k
    and shared experts, router and embeddings of a MoE model."""
    if not cfg.is_moe:
        return param_count(cfg)
    D, L = cfg.hidden_size, cfg.num_layers
    H, Hk, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    attn = D * (H + 2 * Hk) * Dh + H * Dh * D
    Fm = cfg.moe_intermediate_size
    active = cfg.moe_top_k + cfg.moe_num_shared_experts
    ffn = 3 * D * Fm * active + D * cfg.moe_num_experts
    emb = cfg.vocab_size * D * (1 if cfg.tie_embeddings else 2)
    return (attn + ffn) * L + emb


def bytes_per_param(cfg, quantize_weights: Optional[str]) -> int:
    """Weight-stream bytes per parameter: 1 for int8 weight-only (the
    per-channel scales are negligible), else the config's dtype width."""
    if quantize_weights == "int8":
        return 1
    return 2 if cfg.dtype == "bfloat16" else 4


def weight_bytes(cfg, quantize_weights: Optional[str] = None) -> int:
    """Bytes one full weight pass streams from HBM."""
    return param_count(cfg) * bytes_per_param(cfg, quantize_weights)


def flops_per_token(cfg) -> float:
    """Matmul FLOPs per slot position: 2 * active params."""
    return 2.0 * active_param_count(cfg)


def kv_bytes_per_token(cfg, kv_cache_dtype: Optional[str] = None) -> int:
    """Pool bytes per cached token: planes x heads x width x dtype (GQA: k
    and v planes; MLA: one latent plane; fp8 halves the width)."""
    dtype_bytes = 1 if kv_cache_dtype == "fp8" else (2 if cfg.dtype == "bfloat16" else 4)
    planes = 1 if cfg.is_mla else 2
    return planes * cfg.kv_cache_heads * cfg.kv_cache_head_dim * dtype_bytes


def moe_comm_bytes_per_token(cfg) -> int:
    """MoE dispatch + combine traffic per slot token: each of the top-k
    routed copies of the D-wide activation goes to its expert and back, in
    every layer; 0 for a dense model."""
    if not cfg.is_moe:
        return 0
    act_bytes = 2 if cfg.dtype == "bfloat16" else 4
    return cfg.num_layers * cfg.moe_top_k * cfg.hidden_size * act_bytes * 2


@dataclass(frozen=True)
class DispatchCost:
    """Analytic cost of one dispatch, from its packed shape. ``slot_tokens``
    is the capacity the program computes (the goodput denominator and the
    FLOPs multiplier); ``moe_comm_bytes`` is already in ``hbm_bytes``."""

    flops: float
    hbm_bytes: float
    slot_tokens: int
    moe_comm_bytes: float = 0.0


def dispatch_cost(cfg, *, slot_tokens: int, weight_passes: int = 1,
                  kv_read_tokens: int = 0, kv_write_tokens: int = 0,
                  quantize_weights: Optional[str] = None,
                  kv_cache_dtype: Optional[str] = None) -> DispatchCost:
    """``2 * active_params`` FLOPs per slot token; bytes = weight passes + KV
    page reads and writes + MoE dispatch/combine traffic."""
    kvb = kv_bytes_per_token(cfg, kv_cache_dtype)
    moe_comm = float(moe_comm_bytes_per_token(cfg)) * max(0, slot_tokens)
    return DispatchCost(
        flops=flops_per_token(cfg) * max(0, slot_tokens),
        hbm_bytes=(float(weight_bytes(cfg, quantize_weights)) * weight_passes
                   + float(kvb) * (max(0, kv_read_tokens) + max(0, kv_write_tokens))
                   + moe_comm),
        slot_tokens=max(0, slot_tokens),
        moe_comm_bytes=moe_comm)


GOODPUT_KINDS = ("committed", "spec_rejected", "padding", "preempted_recompute",
                 "prefix_saved")


class UtilLedger:
    """Per-program utilization, goodput and capture accounting. The engine
    calls :meth:`record` once per completed dispatch with host integers it
    already has (no device read); readers may run on another thread, so
    state changes under a lock."""

    def __init__(self, model_cfg, *, device_kind: str = "",
                 quantize_weights: Optional[str] = None,
                 kv_cache_dtype: Optional[str] = None,
                 window_s: Optional[float] = None,
                 peaks: Optional[Tuple[Optional[float], Optional[float]]] = None,
                 now=time.monotonic):
        self.cfg = model_cfg
        self.quantize_weights = quantize_weights
        self.kv_cache_dtype = kv_cache_dtype
        self.window_s = util_window_s() if window_s is None else window_s
        tf, gb = chip_peaks(device_kind) if peaks is None else peaks
        self.peak_flops = tf * 1e12 if tf else None
        self.peak_bytes = gb * 1e9 if gb else None
        self._now = now
        self._lock = threading.RLock()
        self._tokens: Dict[str, Dict[str, int]] = {}  # program -> kind -> tokens
        # program -> [flops, bytes, busy_s, dispatches, moe comm bytes]
        self._cost: Dict[str, list] = {}
        self._events: Dict[str, collections.deque] = {}  # (t, flops, bytes)
        self._compiles_seen: Dict[str, int] = {}
        self._compiles: Dict[str, int] = collections.defaultdict(int)
        self._metrics = None  # bound by attach_util_exporter

    def cost(self, program: str, *, slot_tokens: int, weight_passes: int = 1,
             kv_read_tokens: int = 0, kv_write_tokens: int = 0) -> DispatchCost:
        """The analytic cost with this engine's weight and KV widths."""
        del program  # shape-only; kept for the call sites' readability
        return dispatch_cost(
            self.cfg, slot_tokens=slot_tokens, weight_passes=weight_passes,
            kv_read_tokens=kv_read_tokens, kv_write_tokens=kv_write_tokens,
            quantize_weights=self.quantize_weights, kv_cache_dtype=self.kv_cache_dtype)

    def record(self, program: str, cost: DispatchCost, duration_s: float, *,
               committed: int = 0, spec_rejected: int = 0,
               preempted_recompute: int = 0, prefix_saved: int = 0,
               compile_counts: Optional[Dict[str, int]] = None) -> None:
        """Join one completed dispatch's cost with its wall and classify its
        slot-tokens; ``padding`` is the residual ``slot_tokens - (committed +
        spec_rejected + preempted_recompute)``, clamped at 0."""
        padding = max(0, cost.slot_tokens - (committed + spec_rejected + preempted_recompute))
        t = self._now()
        with self._lock:
            tk = self._tokens.setdefault(program, {k: 0 for k in GOODPUT_KINDS})
            tk["committed"] += committed
            tk["spec_rejected"] += spec_rejected
            tk["padding"] += padding
            tk["preempted_recompute"] += preempted_recompute
            tk["prefix_saved"] += prefix_saved
            c = self._cost.setdefault(program, [0.0, 0.0, 0.0, 0, 0.0])
            c[0] += cost.flops
            c[1] += cost.hbm_bytes
            c[2] += max(0.0, duration_s)
            c[3] += 1
            c[4] += cost.moe_comm_bytes
            ev = self._events.setdefault(program, collections.deque())
            ev.append((t, cost.flops, cost.hbm_bytes))
            self._trim(ev, t)
        m = self._metrics
        if m is not None:
            for kind, n in (("committed", committed), ("spec_rejected", spec_rejected),
                            ("padding", padding),
                            ("preempted_recompute", preempted_recompute),
                            ("prefix_saved", prefix_saved)):
                if n:
                    m.goodput_tokens.labels(program=program, kind=kind).inc(n)
        if compile_counts is not None:
            self._note_compiles(program, compile_counts, duration_s)

    def _note_compiles(self, program: str, counts: Dict[str, int],
                       duration_s: float) -> None:
        """Fold a capture-count snapshot: a program whose count grew gets the
        delta; the program whose dispatch just completed also observes its
        wall into the compile-time histogram (the capture dominated it)."""
        m = self._metrics
        with self._lock:
            for prog, n in counts.items():
                prev = self._compiles_seen.get(prog, 0)
                if n > prev:
                    self._compiles[prog] += n - prev
                    if m is not None:
                        m.program_compiles.labels(program=prog).inc(n - prev)
                        if prog == program:
                            m.program_compile_seconds.labels(program=prog).observe(
                                max(0.0, duration_s))
                self._compiles_seen[prog] = max(prev, n)

    def _trim(self, ev: collections.deque, t: float) -> None:
        horizon = t - self.window_s
        while ev and ev[0][0] < horizon:
            ev.popleft()

    def programs(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._tokens))

    def totals(self) -> Dict[str, Dict[str, int]]:
        """program -> kind -> cumulative tokens (a copy)."""
        with self._lock:
            return {p: dict(t) for p, t in self._tokens.items()}

    def fractions(self, program: str) -> Dict[str, float]:
        """Goodput fractions of one program, summing to 1 (empty before its
        first dispatch)."""
        with self._lock:
            tk = self._tokens.get(program)
            total = sum(tk.values()) if tk else 0
            return {k: v / total for k, v in tk.items()} if total > 0 else {}

    def padding_efficiency(self, program: str) -> Optional[float]:
        """Real packed positions over slot capacity, cumulative; None before
        any real token."""
        with self._lock:
            tk = self._tokens.get(program)
            if not tk:
                return None
            real = tk["committed"] + tk["spec_rejected"] + tk["preempted_recompute"]
            cap = real + tk["padding"]
            return real / cap if cap > 0 else None

    def achieved(self, program: str) -> Tuple[Optional[float], Optional[float]]:
        """(FLOP/s, bytes/s) over the rolling window; None before data."""
        t = self._now()
        with self._lock:
            ev = self._events.get(program)
            if ev:
                self._trim(ev, t)
            if not ev:
                return (None, None)
            flops = sum(e[1] for e in ev)
            byts = sum(e[2] for e in ev)
            span = max(t - ev[0][0], 1e-3)
        return (flops / span, byts / span)

    def mfu(self, program: str) -> Optional[float]:
        if self.peak_flops is None:
            return None
        f, _ = self.achieved(program)
        return None if f is None else f / self.peak_flops

    def mbu(self, program: str) -> Optional[float]:
        if self.peak_bytes is None:
            return None
        _, b = self.achieved(program)
        return None if b is None else b / self.peak_bytes

    def moe_comm_total(self) -> float:
        """Cumulative MoE dispatch + combine bytes over every program."""
        with self._lock:
            return sum(c[4] for c in self._cost.values())

    def compiles(self) -> Dict[str, int]:
        """Captures seen per program."""
        with self._lock:
            return dict(self._compiles)

    def recompiles(self) -> int:
        """Captures beyond the first per program (0 in steady state)."""
        with self._lock:
            return sum(max(0, n - 1) for n in self._compiles.values())

    # -- scrape-time callbacks ----------------------------------------------

    def _gauge_samples(self, fn) -> Iterable[Tuple[Dict[str, str], float]]:
        for p in self.programs():
            v = fn(p)
            if v is not None:
                yield ({"program": p}, v)

    def mfu_samples(self):
        return self._gauge_samples(self.mfu)

    def mbu_samples(self):
        return self._gauge_samples(self.mbu)

    def flops_samples(self):
        return self._gauge_samples(lambda p: self.achieved(p)[0])

    def bytes_samples(self):
        return self._gauge_samples(lambda p: self.achieved(p)[1])

    def padding_samples(self):
        return self._gauge_samples(self.padding_efficiency)


def attach_util_exporter(ledger: UtilLedger, metrics) -> None:
    """Bind ``ledger`` to an ``EngineMetrics``: the goodput and capture
    counters increment at ``record()``; the rate and ratio gauges attach
    scrape-time callbacks, so their label sets follow the programs as they
    run."""
    ledger._metrics = metrics
    metrics.program_mfu.set_labels_function(ledger.mfu_samples)
    metrics.program_mbu.set_labels_function(ledger.mbu_samples)
    metrics.program_flops.set_labels_function(ledger.flops_samples)
    metrics.program_bytes.set_labels_function(ledger.bytes_samples)
    metrics.padding_efficiency.set_labels_function(ledger.padding_samples)
