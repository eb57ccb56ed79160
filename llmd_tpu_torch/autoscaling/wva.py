"""Workload Variant Autoscaler: Analyzer → Optimizer → Enforcer pipeline
(copy of ``llmd_tpu/autoscaling/wva.py``; numpy and the standard library).

Parity map into reference wva.md:
- variants & VA object (modelID group, cost, min/max replicas)      :5-11, :205-237
- pipeline stages                                                    :38-56
- saturation-percentage analyzer (kv≥0.80, queue≥5, spare 0.10/3,
  N/(N-1) scale-down simulation, transition blocking)                :58-76
- saturation-token analyzer (k1 memory / k2 compute chain
  observed→historical→derived→fallback, median across replicas,
  demand incl. EPP queue, thresholds up 0.85 / down 0.70)            :78-106
- SLO analyzer (Kalman-learned α/β/γ, explicit/inferred/fallback
  targets, M/M/1-style capacity, replicas = ⌈arrival/capacity⌉)      :108-125
- scale-to-zero (retention window) and 100ms scale-from-zero engine  :128-155

Kubernetes objects are abstracted: a ``Variant.scale`` callback plays the
Deployment/LWS reconcile role, so the same engine drives k8s or process groups
(no-Kubernetes mode).
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np


# ---------------------------------------------------------------------------
# Data model
# ---------------------------------------------------------------------------


@dataclass
class ReplicaMetrics:
    """Per-replica signals (wva.md 'Registered Queries': 1-minute windows)."""

    kv_usage: float = 0.0  # [0, 1]
    queue_len: float = 0.0
    num_blocks: int = 0  # KV capacity (blocks)
    block_size: int = 16
    tokens_in_use: float = 0.0  # resident KV tokens
    avg_in_tokens: float = 256.0
    avg_out_tokens: float = 128.0
    arrival_rate: float = 0.0  # req/s dispatched to this replica
    avg_ttft_s: float = 0.0
    avg_itl_s: float = 0.0


@dataclass
class PoolMetrics:
    """One InferencePool's snapshot: per-variant replica metrics + EPP queue."""

    replicas: dict[str, list[ReplicaMetrics]]  # variant name → ready replicas
    epp_queue_size: float = 0.0  # inference_extension_flow_control_queue_size
    requests_in_retention: float = 0.0  # scale-to-zero query


@dataclass
class Variant:
    """A VariantAutoscaling object (llmd.ai/v1alpha1, wva.md:205-237)."""

    name: str
    model_id: str
    cost: float = 10.0
    min_replicas: int = 1
    max_replicas: int = 2
    current_replicas: int = 1
    desired_replicas: int = 1
    pending_replicas: int = 0  # desired ahead of current (transitioning)
    scale: Optional[Callable[[int], None]] = None  # reconcile callback

    @property
    def transitioning(self) -> bool:
        return self.desired_replicas != self.current_replicas


@dataclass
class ScalingSignal:
    """Analyzer output: capacity needed / freeable, not a decision (wva.md:44-46)."""

    scale_up: int = 0  # replicas of capacity needed
    scale_down: int = 0  # replicas safely freeable
    priority: float = 0.0
    reason: str = ""


# ---------------------------------------------------------------------------
# Analyzers
# ---------------------------------------------------------------------------


class SaturationAnalyzer:
    """saturation-percentage-based (default, wva.md:60-76)."""

    def __init__(self, kv_threshold: float = 0.80, queue_threshold: float = 5.0,
                 kv_spare_trigger: float = 0.10, queue_spare_trigger: float = 3.0) -> None:
        self.kv_threshold = kv_threshold
        self.queue_threshold = queue_threshold
        self.kv_spare_trigger = kv_spare_trigger
        self.queue_spare_trigger = queue_spare_trigger

    def _saturated(self, r: ReplicaMetrics) -> bool:
        return r.kv_usage >= self.kv_threshold or r.queue_len >= self.queue_threshold

    def analyze(self, pool: PoolMetrics, variants: Sequence[Variant]) -> ScalingSignal:
        if any(v.transitioning for v in variants):
            return ScalingSignal(reason="blocked: variant transitioning")
        reps = [r for rs in pool.replicas.values() for r in rs]
        if not reps:
            return ScalingSignal(reason="no ready replicas")
        spare_kv = float(np.mean([max(0.0, self.kv_threshold - r.kv_usage) for r in reps]))
        spare_q = float(np.mean([max(0.0, self.queue_threshold - r.queue_len) for r in reps]))
        if spare_kv < self.kv_spare_trigger or spare_q < self.queue_spare_trigger:
            return ScalingSignal(scale_up=1, priority=1.0,
                                 reason=f"saturated (spare kv {spare_kv:.2f}, q {spare_q:.1f})")
        # scale-down: ≥2 non-saturated AND simulated N→N-1 redistribution keeps headroom
        healthy = [r for r in reps if not self._saturated(r)]
        n = len(reps)
        if len(healthy) >= 2 and n >= 2:
            factor = n / (n - 1)
            kv_after = [min(1.0, r.kv_usage * factor) for r in reps]
            q_after = [r.queue_len * factor for r in reps]
            spare_kv2 = float(np.mean([max(0.0, self.kv_threshold - u) for u in kv_after]))
            spare_q2 = float(np.mean([max(0.0, self.queue_threshold - q) for q in q_after]))
            if spare_kv2 >= self.kv_spare_trigger and spare_q2 >= self.queue_spare_trigger:
                return ScalingSignal(scale_down=1, reason="spare capacity after N/(N-1) sim")
        return ScalingSignal(reason="steady")


class TokenSaturationAnalyzer:
    """saturation-token-based (experimental, wva.md:78-106): absolute token
    capacity vs demand with the k1/k2 dual-bound model."""

    HISTORY_WINDOW = 10

    def __init__(self, kv_threshold: float = 0.80, queue_threshold: float = 5.0,
                 scale_up_threshold: float = 0.85, scale_down_boundary: float = 0.70,
                 max_batched_tokens: Optional[int] = None) -> None:
        self.kv_threshold = kv_threshold
        self.queue_threshold = queue_threshold
        self.up = scale_up_threshold
        self.down = scale_down_boundary
        self.max_batched_tokens = max_batched_tokens
        self._k2_history: dict[str, deque[float]] = {}  # bucket → observations
        self.capacity_cache: dict[str, float] = {}  # variant → tokens (zero-replica est.)

    @staticmethod
    def _bucket(r: ReplicaMetrics) -> str:
        """Output-length workload bucketing for compute-bound history (wva.md:104)."""
        if r.avg_out_tokens < 100:
            return "short"
        if r.avg_out_tokens < 500:
            return "medium"
        return "long"

    def _k2(self, r: ReplicaMetrics, k1: float) -> float:
        """compute-bound chain: observed → historical → derived → fallback=k1."""
        hist = self._k2_history.setdefault(self._bucket(r), deque(maxlen=self.HISTORY_WINDOW))
        if r.queue_len >= self.queue_threshold and r.tokens_in_use > 0:
            hist.append(r.tokens_in_use)  # observed at saturation
            return r.tokens_in_use
        if hist:
            return float(np.mean(hist))
        if self.max_batched_tokens:  # derived from deployment args (steady-state model)
            total = r.avg_in_tokens + r.avg_out_tokens
            return self.max_batched_tokens * (total / max(1.0, r.avg_out_tokens))
        return k1

    def replica_capacity(self, r: ReplicaMetrics) -> float:
        k1 = r.num_blocks * r.block_size * self.kv_threshold
        return min(k1, self._k2(r, k1))

    def analyze(self, pool: PoolMetrics, variants: Sequence[Variant]) -> ScalingSignal:
        reps = [r for rs in pool.replicas.values() for r in rs]
        if not reps:
            return ScalingSignal(scale_up=1 if pool.epp_queue_size > 0 else 0,
                                 reason="no ready replicas")
        per_variant_cap: dict[str, float] = {}
        for vname, rs in pool.replicas.items():
            if rs:
                per_variant_cap[vname] = float(np.median([self.replica_capacity(r) for r in rs]))
                self.capacity_cache[vname] = per_variant_cap[vname]
        supply = sum(per_variant_cap.get(v, 0.0) * len(rs)
                     for v, rs in pool.replicas.items())
        demand = sum(r.tokens_in_use + r.queue_len * r.avg_in_tokens for r in reps)
        avg_in = float(np.mean([r.avg_in_tokens for r in reps]))
        demand += pool.epp_queue_size * avg_in  # EPP queue rides on pool demand
        required = demand / self.up - supply
        spare = supply - demand / self.down
        med_cap = float(np.median(list(per_variant_cap.values()))) if per_variant_cap else 1.0
        if required > 0:
            return ScalingSignal(scale_up=max(1, math.ceil(required / max(1.0, med_cap))),
                                 priority=required, reason=f"demand {demand:.0f} > supply {supply:.0f}")
        if spare > med_cap:  # a whole replica's worth of slack
            return ScalingSignal(scale_down=1, reason=f"spare {spare:.0f} tokens")
        return ScalingSignal(reason="steady")


class KalmanTuner:
    """Online learning of (α, β, γ) — baseline overhead, per-token compute,
    per-token KV access (wva.md:110-117) — via a linear Kalman filter.

    Observation model (documented simplification of the reference's):
      TTFT ≈ α + β·in_tokens                (prefill pass over the prompt)
      ITL  ≈ α + β + γ·(in_tokens + out/2)  (one decode step + KV read of context)
    """

    def __init__(self, q: float = 1e-7, r: float = 1e-3) -> None:
        self.x = np.array([0.01, 1e-4, 1e-5])  # [alpha_s, beta_s/token, gamma_s/token]
        self.P = np.eye(3) * 1.0
        self.Q = np.eye(3) * q
        self.R = r
        self.updates = 0

    def update(self, m: ReplicaMetrics) -> None:
        obs = []
        if m.avg_ttft_s > 0:
            obs.append((np.array([1.0, m.avg_in_tokens, 0.0]), m.avg_ttft_s))
        if m.avg_itl_s > 0:
            ctx = m.avg_in_tokens + m.avg_out_tokens / 2.0
            obs.append((np.array([1.0, 1.0, ctx]), m.avg_itl_s))
        for H, z in obs:
            self.P = self.P + self.Q
            S = float(H @ self.P @ H) + self.R
            K = (self.P @ H) / S
            self.x = self.x + K * (z - float(H @ self.x))
            self.x = np.maximum(self.x, 0.0)  # physical parameters are nonnegative
            self.P = (np.eye(3) - np.outer(K, H)) @ self.P
            self.updates += 1

    @property
    def alpha(self) -> float:
        return float(self.x[0])

    @property
    def beta(self) -> float:
        return float(self.x[1])

    @property
    def gamma(self) -> float:
        return float(self.x[2])

    def idle_ttft(self, in_tokens: float) -> float:
        return self.alpha + self.beta * in_tokens

    def idle_itl(self, in_tokens: float, out_tokens: float) -> float:
        return self.alpha + self.beta + self.gamma * (in_tokens + out_tokens / 2.0)


class SLOAnalyzer:
    """Queueing-model analyzer (wva.md:108-125): replicas = ⌈arrival rate /
    max sustainable rate within SLO⌉, with M/M/1-style waiting."""

    def __init__(self, target_ttft_s: Optional[float] = None,
                 target_itl_s: Optional[float] = None, slo_multiplier: float = 3.0) -> None:
        self.tuner = KalmanTuner()
        self.target_ttft = target_ttft_s  # explicit targets (ConfigMap path)
        self.target_itl = target_itl_s
        self.k = slo_multiplier  # inferred mode: target = idle latency × k

    def _targets(self, m: ReplicaMetrics) -> tuple[float, float]:
        if self.target_ttft is not None and self.target_itl is not None:
            return self.target_ttft, self.target_itl
        if self.tuner.updates >= 8:  # inferred (default): idle-latency multiplier
            return (self.k * max(1e-4, self.tuner.idle_ttft(m.avg_in_tokens)),
                    self.k * max(1e-5, self.tuner.idle_itl(m.avg_in_tokens, m.avg_out_tokens)))
        # fallback: observed × 1.5 headroom (capped)
        return (min(30.0, 1.5 * max(m.avg_ttft_s, 1e-3)),
                min(1.0, 1.5 * max(m.avg_itl_s, 1e-4)))

    def max_rate_per_replica(self, m: ReplicaMetrics) -> float:
        """Largest arrival rate (req/s) for which M/M/1 response time ≤ target.

        Service time s = idle e2e (TTFT + out·ITL); response time 1/(μ−λ) ≤ T
        ⇒ λ_max = μ − 1/T.
        """
        t_ttft, t_itl = self._targets(m)
        s = max(1e-3, self.tuner.idle_ttft(m.avg_in_tokens)
                + m.avg_out_tokens * self.tuner.idle_itl(m.avg_in_tokens, m.avg_out_tokens))
        target = max(s * 1.01, t_ttft + m.avg_out_tokens * t_itl)
        mu = 1.0 / s
        return max(0.01, mu - 1.0 / target)

    def analyze(self, pool: PoolMetrics, variants: Sequence[Variant]) -> ScalingSignal:
        reps = [r for rs in pool.replicas.values() for r in rs]
        if not reps:
            return ScalingSignal(scale_up=1 if pool.epp_queue_size > 0 else 0,
                                 reason="no ready replicas")
        for r in reps:
            self.tuner.update(r)
        total_rate = sum(r.arrival_rate for r in reps)
        cap = float(np.mean([self.max_rate_per_replica(r) for r in reps]))
        desired = max(1, math.ceil(total_rate / max(1e-6, cap)))
        current = len(reps)
        if desired > current:
            return ScalingSignal(scale_up=desired - current, priority=desired - current,
                                 reason=f"rate {total_rate:.2f}/s needs {desired} replicas")
        if desired < current - 0:  # hysteresis: only free whole surplus replicas
            return ScalingSignal(scale_down=current - desired,
                                 reason=f"rate {total_rate:.2f}/s needs only {desired}")
        return ScalingSignal(reason="steady")


# ---------------------------------------------------------------------------
# Optimizers + Enforcer
# ---------------------------------------------------------------------------


class CostAwareOptimizer:
    """Default unlimited mode (wva.md:48-50): scale up the cheapest variant with
    headroom, scale down the most expensive with replicas."""

    def decide(self, signal: ScalingSignal, variants: list[Variant]) -> None:
        if signal.scale_up > 0:
            remaining = signal.scale_up
            for v in sorted(variants, key=lambda v: v.cost):
                if remaining <= 0:
                    break
                if v.pending_replicas > 0:  # skip variants with pending replicas
                    continue
                room = v.max_replicas - v.desired_replicas
                add = min(room, remaining)
                if add > 0:
                    v.desired_replicas += add
                    remaining -= add
        elif signal.scale_down > 0:
            remaining = signal.scale_down
            for v in sorted(variants, key=lambda v: -v.cost):
                if remaining <= 0:
                    break
                drop = min(v.desired_replicas - v.min_replicas, remaining)
                if drop > 0:
                    v.desired_replicas -= drop
                    remaining -= drop


class GreedyByScoreOptimizer:
    """Limited mode (enableLimiter, wva.md:50): fair-share a global accelerator
    budget across pools by priority score."""

    def __init__(self, total_accelerators: int) -> None:
        self.total = total_accelerators

    def decide_all(self, signals: dict[str, ScalingSignal],
                   pools: dict[str, list[Variant]]) -> None:
        budget = self.total - sum(
            v.desired_replicas for vs in pools.values() for v in vs
        )
        # grant scale-ups in priority order while budget lasts
        for model_id in sorted(signals, key=lambda m: -signals[m].priority):
            sig = signals[model_id]
            if sig.scale_up <= 0:
                continue
            grant = min(sig.scale_up, max(0, budget))
            if grant > 0:
                CostAwareOptimizer().decide(
                    ScalingSignal(scale_up=grant), pools[model_id]
                )
                budget -= grant
        for model_id, sig in signals.items():
            if sig.scale_down > 0:
                CostAwareOptimizer().decide(sig, pools[model_id])


class Enforcer:
    """Post-optimization policies (wva.md:52-56, 128-141): scale-to-zero after an
    idle retention window, else ensure ≥1 replica on the cheapest variant."""

    def __init__(self, scale_to_zero: bool = False, retention_s: float = 600.0) -> None:
        self.scale_to_zero = scale_to_zero
        self.retention_s = retention_s

    def enforce(self, pool: PoolMetrics, variants: list[Variant]) -> None:
        if self.scale_to_zero and all(v.min_replicas == 0 for v in variants):
            if pool.requests_in_retention == 0:
                for v in variants:
                    v.desired_replicas = 0
                return
        if all(v.desired_replicas == 0 for v in variants) and not self.scale_to_zero:
            cheapest = min(variants, key=lambda v: v.cost)
            cheapest.desired_replicas = 1
        for v in variants:
            v.desired_replicas = min(max(v.desired_replicas, v.min_replicas
                                         if not self.scale_to_zero else 0),
                                     v.max_replicas)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


class WVAEngine:
    """The background scaling engine: slow analyze loop + 100ms scale-from-zero.

    ``metrics_fn(model_id) -> PoolMetrics`` abstracts Prometheus/pod scraping;
    ``Variant.scale`` abstracts the controller reconcile.
    """

    def __init__(
        self,
        pools: dict[str, list[Variant]],
        metrics_fn: Callable[[str], PoolMetrics],
        analyzer=None,
        optimizer=None,
        enforcer: Optional[Enforcer] = None,
        interval_s: float = 30.0,
        scale_from_zero_interval_s: float = 0.1,
    ) -> None:
        self.pools = pools
        self.metrics_fn = metrics_fn
        self.analyzer = analyzer or SaturationAnalyzer()
        self.optimizer = optimizer or CostAwareOptimizer()
        self.enforcer = enforcer or Enforcer()
        self.interval = interval_s
        self.sfz_interval = scale_from_zero_interval_s
        self.decisions: list[tuple[str, str, int]] = []  # (model, variant, replicas)
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    # one full pipeline pass over every pool (the 30s loop body)
    def step(self) -> dict[str, ScalingSignal]:
        signals: dict[str, ScalingSignal] = {}
        for model_id, variants in self.pools.items():
            pool = self.metrics_fn(model_id)
            sig = self.analyzer.analyze(pool, variants)
            signals[model_id] = sig
            if isinstance(self.optimizer, GreedyByScoreOptimizer):
                continue  # decided globally below
            self.optimizer.decide(sig, variants)
            self.enforcer.enforce(pool, variants)
            self._reconcile(model_id, variants)
        if isinstance(self.optimizer, GreedyByScoreOptimizer):
            self.optimizer.decide_all(signals, self.pools)
            for model_id, variants in self.pools.items():
                self.enforcer.enforce(self.metrics_fn(model_id), variants)
                self._reconcile(model_id, variants)
        return signals

    def scale_from_zero_step(self) -> None:
        """Fast path (wva.md:143-155): idle pool + queued EPP requests → 1 replica."""
        for model_id, variants in self.pools.items():
            if any(v.current_replicas > 0 or v.desired_replicas > 0 for v in variants):
                continue
            pool = self.metrics_fn(model_id)
            if pool.epp_queue_size > 0:
                cheapest = min(variants, key=lambda v: v.cost)
                cheapest.desired_replicas = 1
                self._reconcile(model_id, variants)

    def _reconcile(self, model_id: str, variants: list[Variant]) -> None:
        for v in variants:
            if v.desired_replicas != v.current_replicas:
                self.decisions.append((model_id, v.name, v.desired_replicas))
                if v.scale is not None:
                    v.scale(v.desired_replicas)
                v.pending_replicas = max(0, v.desired_replicas - v.current_replicas)

    # -- background loops --------------------------------------------------
    def start(self) -> None:
        t1 = threading.Thread(target=self._loop, daemon=True, name="wva-engine")
        t2 = threading.Thread(target=self._sfz_loop, daemon=True, name="wva-sfz")
        t1.start()
        t2.start()
        self._threads = [t1, t2]

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.step()
            except Exception:
                pass

    def _sfz_loop(self) -> None:
        while not self._stop.wait(self.sfz_interval):
            try:
                self.scale_from_zero_step()
            except Exception:
                pass
