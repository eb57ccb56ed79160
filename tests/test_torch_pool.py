"""The port's autoscaling plane and pool (``llmd_tpu_torch/autoscaling``,
``llmd_tpu_torch/pool``, ``register_pool_metrics``) held against the
reference's on the CPU, under one seed and one fake clock:

- HPA desired counts over a hypothesis grid; the WVA analyzers' signals, the
  Kalman tuner's state, the optimizers' and the enforcer's decisions and the
  engine's steps on seeded inputs (rtol 1e-12);
- fingerprints, and each side reading a store the other wrote; trace lists
  and JSONL bytes;
- ``fake_argv`` / ``engine_argv`` (the module swapped; the port passes a
  registry name through where the reference writes a checkpoint); the fake
  launcher's cold-then-warm records and durable blocks;
- both controllers over fake replicas through one script of pool states
  (floor, HPA up, WVA spare, a health-sweep replacement, scale to zero,
  scale from zero on the queue): launches, retirements, reasons,
  ``status()``, flight events and the pool families' ``/metrics`` text; the
  predictor-enriched replica metrics; ``DisaggPoolSet`` decisions;
- ``replay_trace`` and ``ReplayReport`` against one fake replica, the CLI;
- the reference's ``tests/test_pool.py`` and ``tests/test_autoscaling.py``
  cases on the port.
"""

import asyncio
import io
import json
import os
import sys
import threading
from contextlib import redirect_stdout
from dataclasses import asdict
from pathlib import Path
from types import SimpleNamespace

import aiohttp
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import llmd_tpu.autoscaling.hpa as ref_hpa
import llmd_tpu.autoscaling.wva as ref_wva
import llmd_tpu.pool.controller as ref_controller
import llmd_tpu.pool.disagg as ref_disagg
import llmd_tpu.pool.harness as ref_harness
import llmd_tpu.pool.launcher as ref_launcher
import llmd_tpu.pool.snapshot as ref_snapshot
import llmd_tpu.pool.traces as ref_traces
import llmd_tpu.testing.fake_server as ref_fake
import llmd_tpu_torch.autoscaling.hpa as port_hpa
import llmd_tpu_torch.autoscaling.wva as port_wva
import llmd_tpu_torch.pool.controller as port_controller
import llmd_tpu_torch.pool.disagg as port_disagg
import llmd_tpu_torch.pool.harness as port_harness
import llmd_tpu_torch.pool.launcher as port_launcher
import llmd_tpu_torch.pool.snapshot as port_snapshot
import llmd_tpu_torch.pool.traces as port_traces
import llmd_tpu_torch.testing.fake_server as port_fake
from llmd_tpu.core import endpoint as ref_endpoint
from llmd_tpu.core import metrics_contract as ref_contract
from llmd_tpu.obs import events as ref_events
from llmd_tpu.obs import metrics as ref_metrics
from llmd_tpu_torch.core import endpoint as port_endpoint
from llmd_tpu_torch.core import metrics_contract as port_contract
from llmd_tpu_torch.obs import events as port_events
from llmd_tpu_torch.obs import metrics as port_metrics
from tests.conftest import run_async

REF = SimpleNamespace(hpa=ref_hpa, wva=ref_wva, controller=ref_controller, disagg=ref_disagg,
                      harness=ref_harness, launcher=ref_launcher, snapshot=ref_snapshot,
                      traces=ref_traces, fake=ref_fake, endpoint=ref_endpoint,
                      contract=ref_contract, events=ref_events, metrics=ref_metrics)
PORT = SimpleNamespace(hpa=port_hpa, wva=port_wva, controller=port_controller,
                       disagg=port_disagg, harness=port_harness, launcher=port_launcher,
                       snapshot=port_snapshot, traces=port_traces, fake=port_fake,
                       endpoint=port_endpoint, contract=port_contract, events=port_events,
                       metrics=port_metrics)
BOTH = pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])
RTOL = 1e-12


class Clock:
    """One fake clock for both packages' pool modules."""

    def __init__(self) -> None:
        self.t = 1000.0

    def monotonic(self) -> float:
        return self.t

    def time(self) -> float:
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    for P in (REF, PORT):
        for mod in (P.controller, P.launcher, P.events):
            monkeypatch.setattr(mod, "time", c)
    return c


@pytest.fixture(autouse=True)
def no_pool_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith("LLMD_POOL_"):
            monkeypatch.delenv(k)


# ----------------------------------------------------------------------- HPA
@settings(max_examples=200, deadline=None)
@given(current=st.integers(0, 12), queue=st.one_of(st.none(), st.floats(0, 400)),
       running=st.one_of(st.none(), st.floats(0, 800)), q_target=st.floats(0.5, 32),
       r_target=st.floats(0.5, 64), tol=st.floats(0, 0.5), lo=st.integers(0, 3),
       span=st.integers(0, 12))
def test_hpa_desired_equal_to_reference(current, queue, running, q_target, r_target, tol,
                                        lo, span):
    values = {k: v for k, v in (("igw_queue_depth", queue), ("igw_running_requests", running))
              if v is not None}
    got = []
    for P in (REF, PORT):
        metrics = [P.hpa.ExternalMetric("igw_queue_depth", q_target, "Value"),
                   P.hpa.ExternalMetric("igw_running_requests", r_target, "AverageValue")]
        hpa = P.hpa.HPAEvaluator(metrics, min_replicas=lo, max_replicas=lo + span,
                                 tolerance=tol)
        got.append(hpa.desired_replicas(current, values))
    assert got[0] == got[1]


def test_hpa_defaults_equal_to_reference():
    a, b = ref_hpa.HPAEvaluator(), port_hpa.HPAEvaluator()
    assert [asdict(m) for m in a.metrics] == [asdict(m) for m in b.metrics]
    assert (a.min_replicas, a.max_replicas, a.tolerance) == \
        (b.min_replicas, b.max_replicas, b.tolerance)


# ----------------------------------------------------------------------- WVA
def _replica(P, rng) -> object:
    return P.wva.ReplicaMetrics(
        kv_usage=float(rng.uniform(0, 1)), queue_len=float(rng.integers(0, 10)),
        num_blocks=int(rng.integers(16, 2048)), block_size=int(rng.choice([8, 16, 32])),
        tokens_in_use=float(rng.uniform(0, 20000)), avg_in_tokens=float(rng.uniform(16, 2048)),
        avg_out_tokens=float(rng.uniform(8, 900)), arrival_rate=float(rng.uniform(0, 30)),
        avg_ttft_s=float(rng.choice([0.0, rng.uniform(0.01, 2)])),
        avg_itl_s=float(rng.choice([0.0, rng.uniform(0.001, 0.1)])))


def _pool(P, seed: int, n_variants: int = 2):
    rng = np.random.default_rng(seed)
    reps = {f"v{i}": [_replica(P, rng) for _ in range(int(rng.integers(0, 4)))]
            for i in range(n_variants)}
    return P.wva.PoolMetrics(replicas=reps, epp_queue_size=float(rng.integers(0, 6)),
                             requests_in_retention=float(rng.integers(0, 2)))


def _variants(P, seed: int, n: int = 2):
    rng = np.random.default_rng(seed + 1000)
    out = []
    for i in range(n):
        lo = int(rng.integers(0, 2))
        hi = lo + int(rng.integers(1, 6))
        cur = int(rng.integers(lo, hi + 1))
        out.append(P.wva.Variant(name=f"v{i}", model_id="m", cost=float(rng.uniform(1, 20)),
                                 min_replicas=lo, max_replicas=hi, current_replicas=cur,
                                 desired_replicas=cur if rng.random() < 0.8 else hi,
                                 pending_replicas=int(rng.integers(0, 2))))
    return out


def _sig(s) -> tuple:
    return (s.scale_up, s.scale_down, s.priority, s.reason)


def _vstate(vs) -> list:
    return [(v.name, v.desired_replicas, v.current_replicas, v.pending_replicas) for v in vs]


def _close(a, b) -> None:
    np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float), rtol=RTOL, atol=0)


@pytest.mark.parametrize("seed", range(12))
def test_wva_analyzers_equal_to_reference(seed):
    out = []
    for P in (REF, PORT):
        sat, tok = P.wva.SaturationAnalyzer(), P.wva.TokenSaturationAnalyzer(max_batched_tokens=
                                                                             2048)
        slo = P.wva.SLOAnalyzer() if seed % 2 else P.wva.SLOAnalyzer(0.5, 0.05)
        rows = []
        for k in range(6):  # history accumulates across calls (k2 buckets, the tuner)
            pool, vs = _pool(P, seed * 10 + k), _variants(P, seed * 10 + k)
            rows.append((_sig(sat.analyze(pool, vs)), _sig(tok.analyze(pool, vs)),
                         _sig(slo.analyze(pool, vs))))
        out.append((rows, dict(tok.capacity_cache),
                    {b: list(h) for b, h in tok._k2_history.items()},
                    slo.tuner.x.copy(), slo.tuner.P.copy(), slo.tuner.updates))
    (ra, ca, ha, xa, pa, ua), (rb, cb, hb, xb, pb, ub) = out
    for a, b in zip(ra, rb):
        for sa, sb in zip(a, b):
            assert sa[0:2] == sb[0:2] and sa[3] == sb[3]
            _close(sa[2], sb[2])
    assert ca.keys() == cb.keys() and ha.keys() == hb.keys() and ua == ub
    _close(list(ca.values()), list(cb.values()))
    for k in ha:
        _close(ha[k], hb[k])
    _close(xa, xb)
    _close(pa, pb)


@pytest.mark.parametrize("seed", range(4))
def test_kalman_tuner_equal_to_reference(seed):
    tuners = []
    for P in (REF, PORT):
        rng = np.random.default_rng(seed)
        t = P.wva.KalmanTuner()
        for _ in range(300):
            inp, out = float(rng.integers(64, 1024)), float(rng.integers(16, 256))
            t.update(P.wva.ReplicaMetrics(
                avg_in_tokens=inp, avg_out_tokens=out,
                avg_ttft_s=0.02 + 2e-4 * inp + float(rng.normal(0, 1e-4)),
                avg_itl_s=0.02 + 2e-4 + 1e-5 * (inp + out / 2) + float(rng.normal(0, 1e-5))))
        tuners.append(t)
    a, b = tuners
    _close(a.x, b.x)
    _close(a.P, b.P)
    assert a.updates == b.updates
    _close([a.idle_ttft(300), a.idle_itl(300, 64)], [b.idle_ttft(300), b.idle_itl(300, 64)])


@pytest.mark.parametrize("seed", range(10))
def test_optimizers_and_enforcer_equal_to_reference(seed):
    out = []
    for P in (REF, PORT):
        rng = np.random.default_rng(seed)
        rows = []
        for _ in range(8):
            vs = _variants(P, int(rng.integers(0, 1 << 30)), n=3)
            sig = P.wva.ScalingSignal(scale_up=int(rng.integers(0, 4)),
                                      scale_down=int(rng.integers(0, 4)))
            P.wva.CostAwareOptimizer().decide(sig, vs)
            rows.append(_vstate(vs))
            pool = _pool(P, int(rng.integers(0, 1 << 30)))
            P.wva.Enforcer(scale_to_zero=bool(rng.integers(0, 2))).enforce(pool, vs)
            rows.append(_vstate(vs))
        pools = {m: _variants(P, seed * 7 + i) for i, m in enumerate("abc")}
        signals = {m: P.wva.ScalingSignal(scale_up=int(rng.integers(0, 4)),
                                          scale_down=int(rng.integers(0, 2)),
                                          priority=float(rng.uniform(0, 10))) for m in pools}
        P.wva.GreedyByScoreOptimizer(total_accelerators=int(rng.integers(2, 16))).decide_all(
            signals, pools)
        rows.append({m: _vstate(vs) for m, vs in pools.items()})
        out.append(rows)
    assert out[0] == out[1]


@pytest.mark.parametrize("greedy", [False, True])
def test_wva_engine_steps_equal_to_reference(greedy):
    out = []
    for P in (REF, PORT):
        scaled = []
        pools = {m: [P.wva.Variant(name=f"{m}-{i}", model_id=m, cost=5.0 + 3 * i,
                                   min_replicas=0, max_replicas=4, current_replicas=0,
                                   desired_replicas=0, scale=scaled.append)
                     for i in range(2)] for m in ("a", "b")}
        state = {"k": 0}

        def metrics(mid, P=P, state=state, pools=pools):
            state["k"] += 1
            n = sum(v.current_replicas for v in pools[mid])
            rng = np.random.default_rng(state["k"])
            reps = {v.name: [_replica(P, rng) for _ in range(v.current_replicas)]
                    for v in pools[mid]}
            return P.wva.PoolMetrics(replicas=reps, epp_queue_size=float(n == 0) * 3,
                                     requests_in_retention=float(state["k"] % 5 != 0))

        eng = P.wva.WVAEngine(
            pools, metrics, analyzer=P.wva.TokenSaturationAnalyzer(),
            optimizer=P.wva.GreedyByScoreOptimizer(6) if greedy else None,
            enforcer=P.wva.Enforcer(scale_to_zero=True, retention_s=60))
        rows = []
        for _ in range(10):
            eng.scale_from_zero_step()
            rows.append([_sig(s) for s in eng.step().values()])
            for vs in pools.values():
                for v in vs:
                    v.current_replicas = v.desired_replicas
            rows.append({m: _vstate(vs) for m, vs in pools.items()})
        out.append((rows, list(eng.decisions), scaled))
    assert out[0] == out[1]


# ------------------------------------------------------ autoscaling, mirrored
def _mirror_variants():
    return [
        port_wva.Variant(name="cheap", model_id="m", cost=5.0, min_replicas=1, max_replicas=10,
                         current_replicas=1, desired_replicas=1),
        port_wva.Variant(name="fancy", model_id="m", cost=15.0, min_replicas=0, max_replicas=5,
                         current_replicas=1, desired_replicas=1),
    ]


def test_saturation_analyzer_up_down_steady():
    W = port_wva
    a = W.SaturationAnalyzer()
    vs = _mirror_variants()
    pool = W.PoolMetrics(replicas={"cheap": [W.ReplicaMetrics(kv_usage=0.95, queue_len=0)]})
    assert a.analyze(pool, vs).scale_up == 1
    pool = W.PoolMetrics(replicas={"cheap": [W.ReplicaMetrics(kv_usage=0.1, queue_len=9)]})
    assert a.analyze(pool, vs).scale_up == 1
    pool = W.PoolMetrics(replicas={"cheap": [W.ReplicaMetrics(kv_usage=0.05)] * 4})
    assert a.analyze(pool, vs).scale_down == 1
    pool = W.PoolMetrics(replicas={"cheap": [W.ReplicaMetrics(kv_usage=0.55, queue_len=1)] * 2})
    sig = a.analyze(pool, vs)
    assert sig.scale_up == 0 and sig.scale_down == 0
    vs[0].desired_replicas = 3
    pool = W.PoolMetrics(replicas={"cheap": [W.ReplicaMetrics(kv_usage=0.99)]})
    sig = a.analyze(pool, vs)
    assert sig.scale_up == 0 and "transitioning" in sig.reason


def test_token_analyzer_k1_k2_chain():
    W = port_wva
    a = W.TokenSaturationAnalyzer(max_batched_tokens=2048)
    r = W.ReplicaMetrics(num_blocks=1024, block_size=16, queue_len=0, avg_in_tokens=256,
                         avg_out_tokens=64)
    assert a.replica_capacity(r) <= 1024 * 16 * 0.8
    r2 = W.ReplicaMetrics(num_blocks=1024, block_size=16, queue_len=8, tokens_in_use=5000,
                          avg_out_tokens=64)
    assert a.replica_capacity(r2) == 5000
    r3 = W.ReplicaMetrics(num_blocks=1024, block_size=16, queue_len=0, avg_out_tokens=64)
    assert a.replica_capacity(r3) == 5000
    pool = W.PoolMetrics(replicas={"cheap": [W.ReplicaMetrics(
        num_blocks=64, block_size=16, tokens_in_use=900, queue_len=6, avg_in_tokens=200,
        avg_out_tokens=64)]}, epp_queue_size=10)
    assert W.TokenSaturationAnalyzer().analyze(pool, _mirror_variants()).scale_up >= 1
    pool = W.PoolMetrics(replicas={"cheap": [W.ReplicaMetrics(
        num_blocks=1024, block_size=16, tokens_in_use=100, avg_out_tokens=64)] * 3})
    assert W.TokenSaturationAnalyzer().analyze(pool, _mirror_variants()).scale_down == 1


def test_kalman_tuner_learns_parameters():
    alpha, beta, gamma = 0.02, 2e-4, 1e-5
    tuner = port_wva.KalmanTuner()
    rng = np.random.default_rng(0)
    for _ in range(400):
        inp, out = float(rng.integers(64, 1024)), float(rng.integers(16, 256))
        tuner.update(port_wva.ReplicaMetrics(
            avg_in_tokens=inp, avg_out_tokens=out,
            avg_ttft_s=alpha + beta * inp + float(rng.normal(0, 1e-4)),
            avg_itl_s=alpha + beta + gamma * (inp + out / 2) + float(rng.normal(0, 1e-5))))
    assert abs(tuner.alpha - alpha) / alpha < 0.3
    assert abs(tuner.beta - beta) / beta < 0.3
    assert abs(tuner.gamma - gamma) / gamma < 0.5


def test_slo_analyzer_scales_with_rate():
    W = port_wva
    a = W.SLOAnalyzer(target_ttft_s=0.5, target_itl_s=0.05)

    def mk(rate):
        return W.ReplicaMetrics(avg_in_tokens=256, avg_out_tokens=64, avg_ttft_s=0.08,
                                avg_itl_s=0.01, arrival_rate=rate)

    vs = _mirror_variants()
    for _ in range(10):
        a.analyze(W.PoolMetrics(replicas={"cheap": [mk(0.05)]}), vs)
    assert a.analyze(W.PoolMetrics(replicas={"cheap": [mk(50.0)]}), vs).scale_up >= 1
    assert a.analyze(W.PoolMetrics(replicas={"cheap": [mk(0.05)]}), vs).scale_up == 0


def test_cost_aware_optimizer_and_enforcer():
    W = port_wva
    vs = _mirror_variants()
    W.CostAwareOptimizer().decide(W.ScalingSignal(scale_up=2), vs)
    assert vs[0].desired_replicas == 3
    W.CostAwareOptimizer().decide(W.ScalingSignal(scale_down=1), vs)
    assert vs[1].desired_replicas == 0
    vs = [W.Variant(name="v", model_id="m", cost=1, min_replicas=0, max_replicas=4,
                    desired_replicas=2, current_replicas=2)]
    W.Enforcer(scale_to_zero=True).enforce(W.PoolMetrics(replicas={}, requests_in_retention=0),
                                           vs)
    assert vs[0].desired_replicas == 0
    vs[0].desired_replicas = 2
    W.Enforcer(scale_to_zero=True).enforce(W.PoolMetrics(replicas={}, requests_in_retention=5),
                                           vs)
    assert vs[0].desired_replicas == 2
    vs[0].desired_replicas = 0
    W.Enforcer(scale_to_zero=False).enforce(W.PoolMetrics(replicas={}), vs)
    assert vs[0].desired_replicas == 1


def test_greedy_by_score_respects_budget():
    W = port_wva
    pools = {"hot": [W.Variant(name="h", model_id="hot", cost=5, max_replicas=10,
                               current_replicas=1, desired_replicas=1)],
             "cold": [W.Variant(name="c", model_id="cold", cost=5, max_replicas=10,
                                current_replicas=1, desired_replicas=1)]}
    signals = {"hot": W.ScalingSignal(scale_up=3, priority=10.0),
               "cold": W.ScalingSignal(scale_up=3, priority=1.0)}
    W.GreedyByScoreOptimizer(total_accelerators=4).decide_all(signals, pools)
    assert pools["hot"][0].desired_replicas == 3
    assert pools["cold"][0].desired_replicas == 1


def test_engine_scale_from_zero_and_reconcile():
    W = port_wva
    scaled = []
    v = W.Variant(name="v", model_id="m", cost=1, min_replicas=0, max_replicas=4,
                  current_replicas=0, desired_replicas=0, scale=scaled.append)
    state = {"queue": 0.0}
    eng = W.WVAEngine(pools={"m": [v]}, metrics_fn=lambda mid: W.PoolMetrics(
        replicas={}, epp_queue_size=state["queue"]))
    eng.scale_from_zero_step()
    assert scaled == []
    state["queue"] = 3.0
    eng.scale_from_zero_step()
    assert scaled == [1] and eng.decisions[-1] == ("m", "v", 1)


def test_hpa_tolerance_band_edges():
    hpa = port_hpa.HPAEvaluator(min_replicas=1, max_replicas=20, tolerance=0.1)
    assert hpa.desired_replicas(4, {"igw_queue_depth": 8.75}) == 4
    assert hpa.desired_replicas(4, {"igw_queue_depth": 8.81}) == 5
    assert hpa.desired_replicas(4, {"igw_queue_depth": 7.25}) == 4
    assert hpa.desired_replicas(4, {"igw_queue_depth": 7.19}) == 4
    assert hpa.desired_replicas(4, {"igw_queue_depth": 6.0}) == 3
    edge = port_hpa.HPAEvaluator(min_replicas=1, max_replicas=20, tolerance=0.125)
    assert edge.desired_replicas(4, {"igw_queue_depth": 9.0}) == 4
    assert edge.desired_replicas(4, {"igw_queue_depth": 9.01}) == 5
    assert hpa.desired_replicas(4, {"igw_running_requests": 70.0}) == 4
    assert hpa.desired_replicas(4, {"igw_running_requests": 70.5}) == 5
    assert hpa.desired_replicas(1, {"igw_queue_depth": 0.0}) == 1
    assert hpa.desired_replicas(20, {"igw_queue_depth": 8.0 * 21}) == 20


def test_hpa_dual_metric_max():
    hpa = port_hpa.HPAEvaluator(min_replicas=1, max_replicas=20)
    assert hpa.desired_replicas(2, {"igw_queue_depth": 32.0, "igw_running_requests": 10.0}) == 8
    assert hpa.desired_replicas(4, {"igw_queue_depth": 1.0, "igw_running_requests": 100.0}) == 7
    assert hpa.desired_replicas(4, {"igw_queue_depth": 0.0, "igw_running_requests": 66.0}) == 4
    assert hpa.desired_replicas(2, {"igw_queue_depth": 1000.0}) == 20


RECORDED_IDLE = """\
vllm:num_requests_waiting 0.0
vllm:num_requests_running 0.0
vllm:kv_cache_usage_perc 0.0117
vllm:cache_config_info{block_size="16",num_gpu_blocks="512"} 1.0
"""
RECORDED_SATURATED = """\
vllm:num_requests_waiting 9.0
vllm:num_requests_running 4.0
vllm:kv_cache_usage_perc 0.9613
vllm:cache_config_info{block_size="16",num_gpu_blocks="512"} 1.0
"""


def _recorded_pool(P, text: str, n: int, epp_queue: float, in_retention: float):
    """Recorded scrape -> Endpoint attrs -> ReplicaMetrics, through the
    datalayer mapping the live controller uses."""
    reps = []
    for i in range(n):
        ep = P.endpoint.Endpoint(address=f"10.0.0.{i}:8000")
        for k, v in P.contract.map_engine_metrics("vllm",
                                                  P.contract.parse_prometheus(text)).items():
            ep.attrs.put(k, v)
        reps.append(P.controller.replica_metrics_from_endpoint(ep))
    return P.wva.PoolMetrics(replicas={"v": reps}, epp_queue_size=epp_queue,
                             requests_in_retention=in_retention)


@BOTH
def test_wva_scale_to_zero_from_recorded_metrics(P):
    """The reference's recorded-scrape case on both packages, the same
    desired counts at every step."""
    v = P.wva.Variant(name="v", model_id="m", cost=1, min_replicas=0, max_replicas=4,
                      current_replicas=2, desired_replicas=2)
    state = {"text": RECORDED_SATURATED, "retention": 1.0}
    eng = P.wva.WVAEngine(pools={"m": [v]}, metrics_fn=lambda mid: _recorded_pool(
        P, state["text"], v.current_replicas, 0.0, state["retention"]),
        enforcer=P.wva.Enforcer(scale_to_zero=True, retention_s=60))
    seen = []
    eng.step()
    seen.append(v.desired_replicas)
    v.current_replicas = v.desired_replicas
    state["text"] = RECORDED_IDLE
    eng.step()
    seen.append(v.desired_replicas)
    state["retention"] = 0.0
    v.current_replicas = v.desired_replicas
    for _ in range(4):
        eng.step()
        v.current_replicas = v.desired_replicas
        seen.append(v.desired_replicas)
    assert seen == [3, 2, 0, 0, 0, 0]


@BOTH
def test_wva_scale_from_zero_from_recorded_metrics(P):
    scaled = []
    v = P.wva.Variant(name="v", model_id="m", cost=1, min_replicas=0, max_replicas=4,
                      current_replicas=0, desired_replicas=0, scale=scaled.append)
    state = {"queue": 0.0}
    eng = P.wva.WVAEngine(pools={"m": [v]}, metrics_fn=lambda mid: _recorded_pool(
        P, RECORDED_IDLE, 0, state["queue"], in_retention=1.0))
    eng.scale_from_zero_step()
    assert scaled == []
    state["queue"] = 3.0
    eng.scale_from_zero_step()
    assert scaled == [1] and v.desired_replicas == 1


# ----------------------------------------------------------------- snapshots
_JSON = st.recursive(st.one_of(st.none(), st.booleans(), st.integers(-10**6, 10**6),
                               st.floats(allow_nan=False, allow_infinity=False),
                               st.text(max_size=8)),
                     lambda kids: st.one_of(st.lists(kids, max_size=3),
                                            st.dictionaries(st.text(max_size=6), kids,
                                                            max_size=3)), max_leaves=12)


@settings(max_examples=150, deadline=None)
@given(cfg=st.dictionaries(st.text(max_size=10), _JSON, max_size=6))
def test_config_fingerprint_equal_to_reference(cfg):
    assert port_snapshot.config_fingerprint(cfg) == ref_snapshot.config_fingerprint(cfg)


def test_config_fingerprint_canonical():
    fp = port_snapshot.config_fingerprint
    a, b = fp({"model": "m", "block_size": 16}), fp({"block_size": 16, "model": "m"})
    assert a == b != fp({"model": "m", "block_size": 32})
    assert len(a) == 16 and all(ch in "0123456789abcdef" for ch in a)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_snapshot_store_read_across_packages(tmp_path, writer):
    """One side writes a store (artifact dirs first, then the meta commit);
    the other reads it: has / load / fingerprints / path agree."""
    w, r = (ref_snapshot, port_snapshot) if writer == "ref" else (port_snapshot, ref_snapshot)
    ws, rs = w.PoolSnapshotStore(str(tmp_path)), r.PoolSnapshotStore(str(tmp_path))
    fp = w.config_fingerprint({"model": "llama-1b", "role": writer})
    assert r.config_fingerprint({"model": "llama-1b", "role": writer}) == fp
    cache = ws.path(fp, "compile_cache")
    assert os.path.isdir(cache) and not rs.has(fp)  # half-built never reads warm
    ws.save(fp, {"kind": "engine", "engine_config": {"model": "llama-1b"}})
    assert rs.has(fp) and rs.fingerprints() == ws.fingerprints() == [fp]
    assert rs.load(fp) == ws.load(fp)
    assert rs.load(fp)["kind"] == "engine" and rs.load(fp)["fingerprint"] == fp
    assert rs.path(fp, "compile_cache") == cache


def test_snapshot_store_roundtrip(tmp_path):
    store = port_snapshot.PoolSnapshotStore(str(tmp_path))
    fp = port_snapshot.config_fingerprint({"model": "m"})
    assert not store.has(fp) and store.load(fp) is None
    assert os.path.isdir(store.path(fp, "compile_cache")) and not store.has(fp)
    store.save(fp, {"kind": "fake"})
    assert store.has(fp) and store.load(fp)["kind"] == "fake"
    assert store.fingerprints() == [fp]


# -------------------------------------------------------------------- traces
TRACES = [
    ("bursty_trace", dict(duration_s=6, base_rps=5, burst_rps=50, burst_start_s=2,
                          burst_end_s=4, seed=7)),
    ("bursty_trace", dict(duration_s=60, base_rps=2, burst_rps=32, burst_start_s=5,
                          burst_end_s=45, seed=0, prompt_tokens=256, max_tokens=64)),
    ("diurnal_trace", dict(duration_s=8, min_rps=2, peak_rps=30, period_s=8, seed=3)),
    ("diurnal_trace", dict(seed=11, stream=True)),
    ("multi_tenant_ramp", dict(duration_s=6, tenants=["a", "b", "c"], start_rps=1,
                               end_rps=10, stagger_s=1.0, seed=3)),
    ("multi_tenant_ramp", dict(seed=5)),
]


@pytest.mark.parametrize("gen,kw", TRACES, ids=[f"{g}-{i}" for i, (g, _) in enumerate(TRACES)])
def test_traces_and_jsonl_equal_to_reference(tmp_path, gen, kw):
    a = getattr(ref_traces, gen)(**kw)
    b = getattr(port_traces, gen)(**kw)
    assert [asdict(r) for r in a] == [asdict(r) for r in b] and len(b) > 0
    ref_traces.dump_jsonl(a, str(tmp_path / "ref.jsonl"))
    port_traces.dump_jsonl(b, str(tmp_path / "port.jsonl"))
    assert (tmp_path / "ref.jsonl").read_bytes() == (tmp_path / "port.jsonl").read_bytes()
    back = port_traces.load_jsonl(str(tmp_path / "ref.jsonl"))
    assert [asdict(r) for r in back] == [asdict(r) for r in ref_traces.load_jsonl(
        str(tmp_path / "port.jsonl"))]


def test_traces_deterministic_and_bursty():
    t1 = port_traces.bursty_trace(duration_s=6, base_rps=5, burst_rps=50, burst_start_s=2,
                                  burst_end_s=4, seed=7)
    base = sum(1 for r in t1 if r.t < 2.0) / 2.0
    burst = sum(1 for r in t1 if 2.0 <= r.t < 4.0) / 2.0
    assert burst > 5 * base
    assert all(t1[i].t <= t1[i + 1].t for i in range(len(t1) - 1))
    ramp = port_traces.multi_tenant_ramp(duration_s=6, tenants=["a", "b", "c"], start_rps=1,
                                         end_rps=10, stagger_s=1.0, seed=3)
    firsts = sorted(min(r.t for r in ramp if r.tenant == n) for n in "abc")
    assert firsts[0] < firsts[-1]


# ----------------------------------------------------------------- launchers
@pytest.mark.parametrize("kw", [{}, dict(model="m/x", block_size=32, num_blocks=64,
                                         max_running=2, decode_us_per_token=0.0,
                                         role="decode")])
def test_fake_argv_equal_to_reference_but_the_module(kw):
    a, b = ref_launcher.fake_argv(8123, **kw), port_launcher.fake_argv(8123, **kw)
    assert a[2] == "llmd_tpu.testing.fake_server"
    assert b[2] == "llmd_tpu_torch.testing.fake_server"
    assert a[:2] + a[3:] == b[:2] + b[3:]


def test_engine_argv_equal_to_reference_but_module_and_checkpoint(tmp_path, monkeypatch):
    """With a store and a registry name the reference writes a checkpoint and
    serves it; the port passes ``--model <name>``. Everything else (the
    fingerprint's ``compile_cache``, the warm flag, the meta it commits, the
    extra flags) is the reference's; an HF directory passes through on both."""
    import llmd_tpu.testing.checkpoints as ref_ckpt

    made = []

    def fake_checkpoint(d, *a, **k):  # the reference's materialization, stubbed
        made.append(d)
        Path(d, "config.json").write_text("{}")

    monkeypatch.setattr(ref_ckpt, "make_hf_checkpoint", fake_checkpoint)
    extra = ["--host", "127.0.0.1", "--num-pages", "1024", "--role", "decode"]
    for engine_config in (None, {"model": "llama-1b", "dtype": "bfloat16"}):
        sa = ref_snapshot.PoolSnapshotStore(str(tmp_path / "ref"))
        sb = port_snapshot.PoolSnapshotStore(str(tmp_path / "port"))
        for _ in range(2):  # cold, then warm
            a, wa = ref_launcher.engine_argv("llama-1b", 9000, snapshots=sa,
                                             engine_config=engine_config, extra=extra)
            b, wb = port_launcher.engine_argv("llama-1b", 9000, snapshots=sb,
                                              engine_config=engine_config, extra=extra)
            assert wa == wb
            assert (a[2], b[2]) == ("llmd_tpu.engine.serve", "llmd_tpu_torch.engine.serve")
            ia, ib = a.index("--model") + 1, b.index("--model") + 1
            assert a[ia] == made[-1] and b[ib] == "llama-1b"
            rel = [x.replace(str(tmp_path / "ref"), "S") for x in a[:2] + a[3:ia] + a[ia + 1:]]
            assert rel == [x.replace(str(tmp_path / "port"), "S")
                           for x in b[:2] + b[3:ib] + b[ib + 1:]]
            assert sa.fingerprints() == sb.fingerprints()
            fp = sb.fingerprints()[0]
            assert {k: v for k, v in sa.load(fp).items() if k != "created_unix"} == \
                {k: v for k, v in sb.load(fp).items() if k != "created_unix"}
        (tmp_path / "ref").rename(tmp_path / f"ref-{len(made)}")
        (tmp_path / "port").rename(tmp_path / f"port-{len(made)}")
    hf = tmp_path / "hf"
    hf.mkdir()
    for store in (None, tmp_path / "hfstore"):
        a, wa = ref_launcher.engine_argv(str(hf), 9001, snapshots=store and
                                         ref_snapshot.PoolSnapshotStore(str(store) + "r"))
        b, wb = port_launcher.engine_argv(str(hf), 9001, snapshots=store and
                                          port_snapshot.PoolSnapshotStore(str(store) + "p"))
        assert wa == wb and a[3:5] == b[3:5] == ["--model", str(hf)]
        assert [x.replace(str(store) + "r", "S") for x in a[:2] + a[3:]] == \
            [x.replace(str(store) + "p", "S") for x in b[:2] + b[3:]]
    assert len(made) == 2  # the reference materialized once per fingerprint


async def _post_json(address: str, body: dict) -> tuple[int, dict]:
    async with aiohttp.ClientSession() as sess:
        async with sess.post(f"http://{address}/v1/completions", json=body) as r:
            return r.status, await r.json()


def _fake_cfg(P, **kw):
    kw.setdefault("prefill_us_per_token", 0.0)
    kw.setdefault("decode_us_per_token", 0.0)
    kw.setdefault("kv_pull_us_per_block", 0.0)
    return P.fake.FakeServerConfig(**kw)


async def _launcher_script(P, root: str) -> dict:
    store = P.snapshot.PoolSnapshotStore(root)
    launcher = P.launcher.FakeReplicaLauncher(server_config=_fake_cfg(P), snapshots=store,
                                              durable_store=True)
    h1 = await launcher.launch()
    h2 = await launcher.launch()
    for prompt in ("alpha " * 20, "beta " * 9, "alpha " * 20 + "tail"):
        status, body = await _post_json(h1.address, {"prompt": prompt, "max_tokens": 2})
        assert status == 200
    alive = [launcher.alive(h1), launcher.alive(h2)]
    await launcher.stop(h1)  # graceful: the durable write-back
    blocks = sorted(launcher.durable_blocks)
    await launcher.kill(h2)  # abrupt: nothing written back
    h3 = await launcher.launch()
    restored = sorted(h3.server.blocks)
    status, body = await _post_json(h3.address, {"prompt": "alpha " * 20, "max_tokens": 2})
    await launcher.stop(h3)
    return {"warm": [h1.warm, h2.warm, h3.warm], "names": [h1.name, h2.name, h3.name],
            "alive": alive + [launcher.alive(h1), launcher.alive(h2), launcher.alive(h3)],
            "blocks": blocks, "restored": restored, "cached": body["usage"]["cached_tokens"],
            "store": [store.load(fp)["kind"] for fp in store.fingerprints()]}


def test_fake_launcher_records_and_durable_blocks_equal_to_reference(tmp_path):
    a = run_async(_launcher_script(REF, str(tmp_path / "ref")))
    b = run_async(_launcher_script(PORT, str(tmp_path / "port")))
    assert a == b
    assert b["warm"] == [False, True, True] and b["blocks"] == b["restored"] != []
    assert b["alive"] == [True, True, False, False, False] and b["cached"] > 0


def test_fake_launcher_sidecar_fronts_decode(tmp_path):
    async def scenario():
        launcher = port_launcher.FakeReplicaLauncher(server_config=_fake_cfg(PORT),
                                                     role="decode", with_sidecar=True)
        h = await launcher.launch()
        try:
            assert h.role == "decode" and h.sidecar is not None
            assert h.address == h.sidecar.address != h.server.address
            async with aiohttp.ClientSession() as sess:
                async with sess.get(f"http://{h.address}/health") as r:
                    assert r.status == 200 and (await r.json())["role"] == "decode"
            status, body = await _post_json(h.address, {"prompt": "x" * 40, "max_tokens": 3})
            assert status == 200 and h.sidecar.stats["aggregated_requests"] == 1
        finally:
            await launcher.kill(h)
        assert h.sidecar is None and not launcher.alive(h)

    run_async(scenario())


def test_process_launcher_runs_a_port_fake_replica(tmp_path):
    """One subprocess: ``fake_argv`` under ``ProcessReplicaLauncher`` becomes
    ready on ``/health``, serves, and stops on terminate; its log lands in
    ``log_dir``. A replica that exits before ready raises."""

    async def scenario():
        launcher = port_launcher.ProcessReplicaLauncher(
            lambda port: port_launcher.fake_argv(port, decode_us_per_token=0.0),
            ready_timeout_s=60.0, log_dir=str(tmp_path / "logs"))
        h = await launcher.launch()
        try:
            assert h.name == "proc-1" and not h.warm and launcher.alive(h)
            status, body = await _post_json(h.address, {"prompt": "hi", "max_tokens": 2})
            assert status == 200 and body["choices"][0]["text"] == "echo(2t,2o)"
        finally:
            proc = h.proc
            await launcher.stop(h)
        assert not launcher.alive(h) and proc.returncode is not None
        assert "fake model server on http://" in (tmp_path / "logs" / "replica-1.log").read_text()
        dead = port_launcher.ProcessReplicaLauncher(
            lambda port: [sys.executable, "-c", "raise SystemExit(3)"], ready_timeout_s=30.0)
        with pytest.raises(RuntimeError, match="rc=3"):
            await dead.launch()

    run_async(scenario())


def test_process_launcher_kills_a_replica_whose_launch_is_cancelled(tmp_path):
    """A controller stopped mid-launch cancels the readiness wait: the
    process it started is killed and reaped, not left behind."""
    pid_file = tmp_path / "pid"
    script = (f"import os, time; open({str(pid_file)!r}, 'w').write(str(os.getpid())); "
              "time.sleep(120)")

    async def scenario():
        launcher = port_launcher.ProcessReplicaLauncher(
            lambda port: [sys.executable, "-c", script], ready_timeout_s=60.0)
        task = asyncio.ensure_future(launcher.launch())
        for _ in range(400):
            await asyncio.sleep(0.025)
            if pid_file.exists() and pid_file.read_text():
                break
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task
        return int(pid_file.read_text())

    pid = run_async(scenario())
    with pytest.raises(ProcessLookupError):
        os.kill(pid, 0)


# ---------------------------------------------------------------- controller
def _system(P, flight, names: dict) -> list:
    out = []
    for e in flight.system_events():
        e = {k: v for k, v in e.items() if k not in ("t_unix", "t", "ts")}
        if "endpoint" in e:
            e["endpoint"] = names.get(e["endpoint"], e["endpoint"])
        out.append(e)
    return out


def _families(reg) -> list:
    return [ln for ln in reg.expose().splitlines() if "llmd_tpu:pool_" in ln]


def _set_load(P, ctl, **metric):
    keys = {"kv": P.contract.StdMetric.KV_UTILIZATION,
            "queue": P.contract.StdMetric.QUEUED_REQUESTS,
            "running": P.contract.StdMetric.RUNNING_REQUESTS}
    for address in ctl.replicas:
        ep = ctl.pool.get(address)
        for k, v in metric.items():
            ep.attrs.put(keys[k], v)


async def _controller_script(P, clock: Clock, root: str) -> list:
    store = P.snapshot.PoolSnapshotStore(root)
    launcher = P.launcher.FakeReplicaLauncher(server_config=_fake_cfg(P), snapshots=store)
    pool, reg, flight = P.endpoint.EndpointPool(), P.metrics.Registry(), \
        P.events.FlightRecorder()
    depth = {"v": 0.0}
    ctl = P.controller.PoolController(
        P.controller.PoolConfig(min_replicas=1, max_replicas=4, interval_s=3600,
                                sfz_interval_s=3600, drain_timeout_s=2.0, policy="max",
                                retention_s=30.0),
        launcher, pool=pool, registry=reg, flight=flight, flow_depth_fn=lambda: depth["v"])
    names: dict = {}
    out = []

    def snap(tag: str) -> None:
        for i, rec in enumerate(ctl.launch_records):
            names.setdefault(rec.address, f"r{i}")
        st = ctl.status()
        st["replicas"] = sorted(names[a] for a in st["replicas"])
        for rec in st["launches"]:
            rec["address"] = names[rec["address"]]
        out.append({"tag": tag, "status": st, "discovery": sorted(
            (names[e.address], e.role.value, e.labels.get("llmd.ai/role")) for e in pool.list()),
            "variant": (ctl.variant.desired_replicas, ctl.variant.current_replicas),
            "events": _system(P, flight, names), "families": _families(reg)})

    await ctl.start()
    try:
        snap("floor")
        _set_load(P, ctl, running=70.0)  # HPA: ceil(70 / 16) -> 5, clamped to 4
        clock.t += 5
        await ctl.step()
        snap("hpa_up")
        _set_load(P, ctl, running=0.0, kv=0.05)  # idle: WVA frees one
        clock.t += 5
        await ctl.step()
        snap("wva_spare")
        victim = ctl.replicas[next(iter(ctl.replicas))]
        await launcher.kill(victim)  # dies without draining
        _set_load(P, ctl, running=24.0)  # the survivors ask HPA for 3 again
        clock.t += 5
        await ctl.step()
        snap("replaced")
        _set_load(P, ctl, running=0.0, kv=0.0)
        ctl.variant.min_replicas = 0
        ctl.cfg.scale_to_zero = True
        ctl.hpa.min_replicas = 0
        ctl.wva.enforcer.scale_to_zero = True
        clock.t += 31  # past the retention window
        await ctl.step()
        snap("to_zero")
        await ctl._fast_tick()  # idle, empty queue: nothing
        depth["v"] = 3.0  # requests piling up at the empty pool
        await ctl._fast_tick()
        snap("from_zero")
        await ctl.scale_to(2, reason="manual")
        snap("manual")
    finally:
        await ctl.stop()
    snap("stopped")
    return out


def test_controller_script_equal_to_reference(tmp_path, clock):
    a = run_async(_controller_script(REF, clock, str(tmp_path / "ref")))
    clock.t = 1000.0
    b = run_async(_controller_script(PORT, clock, str(tmp_path / "port")))
    assert [s["tag"] for s in b] == ["floor", "hpa_up", "wva_spare", "replaced", "to_zero",
                                     "from_zero", "manual", "stopped"]
    for sa, sb in zip(a, b):
        assert sa == sb, sa["tag"]
    reasons = [e.get("reason") for e in b[-1]["events"]]
    assert {"floor", "hpa", "wva_spare", "replica_dead", "scale_to_zero", "scale_from_zero",
            "manual"} <= set(reasons)
    assert [s["status"]["ready_replicas"] for s in b] == [1, 4, 3, 3, 0, 1, 2, 0]
    kinds = [r["kind"] for r in b[-1]["status"]["launches"]]
    assert kinds[0] == "cold" and set(kinds[1:]) == {"warm"}
    text = "\n".join(b[-1]["families"])
    assert 'llmd_tpu:pool_warm_start_seconds_count{kind="cold"} 1' in text
    assert 'llmd_tpu:pool_scale_decisions_total{reason="replica_dead"} 1' in text


class _StubPredictor:
    def __init__(self, preds):
        self.preds, self.seen = preds, []

    def predict(self, samples):
        self.seen.append([asdict(s) for s in samples])
        if self.preds == "raise":
            raise RuntimeError("down")
        return self.preds


@pytest.mark.parametrize("preds", [[(120.0, 15.0)], [(None, None)], "raise", None],
                         ids=["model", "heuristic", "raises", "none"])
def test_predictor_enriched_metrics_equal_to_reference(preds):
    rows = []
    for P in (REF, PORT):
        pool = P.endpoint.EndpointPool()
        stub = _StubPredictor(preds)
        ctx = {} if preds is None else {"latency_predictor": stub}
        ctl = P.controller.PoolController(
            P.controller.PoolConfig(), P.launcher.FakeReplicaLauncher(
                server_config=P.fake.FakeServerConfig()),
            pool=pool, router=SimpleNamespace(ctx=ctx), flow_depth_fn=lambda: 0.0)
        ep = P.endpoint.Endpoint(address="10.0.0.1:8000")
        S = P.contract.StdMetric
        for k, v in ((S.QUEUED_REQUESTS, 2.0), (S.KV_UTILIZATION, 0.5),
                     (S.RUNNING_REQUESTS, 3.0), (S.WAITING_TOKENS, 700.0),
                     (S.NUM_BLOCKS, 512.0), (S.BLOCK_SIZE, 16.0)):
            ep.attrs.put(k, v)
        pool.upsert(ep)
        ctl.replicas[ep.address] = P.launcher.ReplicaHandle(address=ep.address)
        (rm,) = ctl._live_metrics()
        rows.append((asdict(rm), stub.seen))
    assert rows[0] == rows[1]
    if preds == [(120.0, 15.0)]:
        assert rows[1][0]["avg_ttft_s"] == 0.12 and rows[1][0]["avg_itl_s"] == 0.015


def test_pool_config_from_env_equal_to_reference(monkeypatch):
    monkeypatch.setenv("LLMD_POOL_MIN_REPLICAS", "2")
    monkeypatch.setenv("LLMD_POOL_MAX_REPLICAS", "junk")
    monkeypatch.setenv("LLMD_POOL_SCALE_TO_ZERO", "true")
    monkeypatch.setenv("LLMD_POOL_INTERVAL_S", "0.5")
    monkeypatch.setenv("LLMD_POOL_POLICY", "wva")
    monkeypatch.setenv("LLMD_POOL_PREFILL_MAX_REPLICAS", "7")
    monkeypatch.setenv("LLMD_POOL_DECODE_POLICY", "hpa")
    assert asdict(port_controller.PoolConfig()) == asdict(ref_controller.PoolConfig())
    for fn in ("prefill_pool_config", "decode_pool_config"):
        a = getattr(ref_disagg, fn)(drain_timeout_s=1.5)
        b = getattr(port_disagg, fn)(drain_timeout_s=1.5)
        assert asdict(a) == asdict(b)
    a = ref_controller.PoolConfig.from_env(model="m")
    b = port_controller.PoolConfig.from_env(model="m")
    assert asdict(a) == asdict(b) and b.min_replicas == 2 and b.max_replicas == 4


async def _disagg_script(P, clock: Clock) -> list:
    S = P.contract.StdMetric
    pool = P.endpoint.EndpointPool()
    queued = {"v": 0.0}
    router = SimpleNamespace(pool=pool, flow=SimpleNamespace(_total_queued=lambda: queued["v"]))
    pre = P.launcher.FakeReplicaLauncher(server_config=_fake_cfg(P, role="prefill"),
                                         role="prefill")
    dec = P.launcher.FakeReplicaLauncher(server_config=_fake_cfg(P, role="decode"),
                                         role="decode", with_sidecar=True)
    cfg = dict(min_replicas=1, max_replicas=3, interval_s=3600, sfz_interval_s=3600,
               drain_timeout_s=1.0)
    pools = P.disagg.DisaggPoolSet(pre, dec, router=router,
                                   prefill_cfg=P.controller.PoolConfig(policy="hpa", **cfg),
                                   decode_cfg=P.controller.PoolConfig(policy="wva", **cfg))
    names: dict = {}
    out = []

    def snap(tag):
        for side in (pools.prefill, pools.decode):
            for i, rec in enumerate(side.launch_records):
                names.setdefault(rec.address, f"{side.cfg.role}{i}")
        st = pools.status()
        for role in st.values():
            role["replicas"] = sorted(names[a] for a in role["replicas"])
            for rec in role["launches"]:
                rec["address"] = names[rec["address"]]
        out.append((tag, st, sorted((names[e.address], e.role.value, dict(e.labels))
                                    for e in pool.list()),
                    pools.prefill._flow_depth(), pools.decode._flow_depth()))

    def load(ctl, **m):
        for a in ctl.replicas:
            for k, v in m.items():
                pool.get(a).attrs.put(getattr(S, k), v)

    await pools.start()
    try:
        snap("floor")
        queued["v"] = 9.0  # prompt backlog: the prefill pool's HPA signal
        load(pools.prefill, QUEUED_REQUESTS=4.0, RUNNING_REQUESTS=3.0)
        load(pools.decode, KV_UTILIZATION=0.95)  # KV pressure: the decode pool's WVA
        clock.t += 1
        await pools.step()
        snap("up")
        queued["v"] = 0.0
        load(pools.prefill, QUEUED_REQUESTS=0.0, RUNNING_REQUESTS=0.0)
        load(pools.decode, KV_UTILIZATION=0.05)
        clock.t += 1
        await pools.step()
        snap("down")
    finally:
        await pools.stop()
    return out


def test_disagg_pool_set_decisions_equal_to_reference(clock):
    a = run_async(_disagg_script(REF, clock))
    b = run_async(_disagg_script(PORT, clock))
    assert a == b
    (_, floor, *_), (_, up, *_), (_, down, *_) = b
    assert [up[r]["ready_replicas"] for r in ("prefill", "decode")] == [2, 2]
    assert [down[r]["ready_replicas"] for r in ("prefill", "decode")] == [1, 1]
    assert {role for _, role, _ in b[1][2]} == {"prefill", "decode"}


def test_prefill_hpa_target_from_env_equal_to_reference(monkeypatch):
    monkeypatch.setenv("LLMD_POOL_PREFILL_QUEUE_TARGET", "2.5")
    got = []
    for P in (REF, PORT):
        launcher = P.launcher.FakeReplicaLauncher(server_config=P.fake.FakeServerConfig())
        pools = P.disagg.DisaggPoolSet(launcher, launcher)
        got.append(([asdict(m) for m in pools.prefill.hpa.metrics],
                     asdict(pools.prefill.cfg), asdict(pools.decode.cfg),
                     pools.prefill.fleet, pools.decode.fleet, pools.decode._flow_depth()))
    assert got[0] == got[1] and got[1][0][0]["target"] == 2.5


# --------------------------------------------------------- mirrored pool cases
def _port_controller(tmp_path, **cfg_kw):
    cfg_kw.setdefault("min_replicas", 1)
    cfg_kw.setdefault("max_replicas", 4)
    cfg_kw.setdefault("interval_s", 3600)
    cfg_kw.setdefault("sfz_interval_s", 0.02)
    cfg_kw.setdefault("drain_timeout_s", 2.0)
    launcher = port_launcher.FakeReplicaLauncher(
        server_config=port_fake.FakeServerConfig(),
        snapshots=port_snapshot.PoolSnapshotStore(str(tmp_path)))
    pool = port_endpoint.EndpointPool()
    depth = {"v": 0.0}
    ctl = port_controller.PoolController(port_controller.PoolConfig(**cfg_kw), launcher,
                                         pool=pool, flow_depth_fn=lambda: depth["v"])
    return ctl, pool, depth


def test_controller_launch_retire_and_discovery(tmp_path):
    async def scenario():
        ctl, pool, _ = _port_controller(tmp_path)
        await ctl.start()
        try:
            assert len(ctl.replicas) == 1
            assert [e.address for e in pool.list()] == sorted(ctl.replicas)
            await ctl.scale_to(3)
            assert len(ctl.replicas) == 3 and len(pool.list()) == 3
            await ctl.scale_to(1)
            assert len(ctl.replicas) == 1 and len(pool.list()) == 1
            kinds = [r.kind for r in ctl.launch_records]
            assert kinds[0] == "cold" and set(kinds[1:]) == {"warm"}
        finally:
            await ctl.stop()
        assert pool.list() == [] and ctl.replicas == {}

    run_async(scenario())


def test_controller_health_sweep_replaces_dead(tmp_path):
    async def scenario():
        ctl, pool, _ = _port_controller(tmp_path, min_replicas=2)
        await ctl.start()
        try:
            victim = ctl.replicas[sorted(ctl.replicas)[0]]
            await victim.server.stop()  # dies without draining
            victim.server = None
            await ctl.step()
            assert len(ctl.replicas) == 2 and victim.address not in ctl.replicas
            assert len(ctl.launch_records) == 3
        finally:
            await ctl.stop()

    run_async(scenario())


def test_controller_scale_from_zero_on_queue(tmp_path):
    """The reference's case through the controller's own loop: the fast tick
    (20 ms) wakes the empty pool once requests queue."""

    async def scenario():
        ctl, pool, depth = _port_controller(tmp_path, min_replicas=0, scale_to_zero=True,
                                            retention_s=0.05)
        await ctl.start()
        try:
            assert len(ctl.replicas) == 0
            depth["v"] = 3.0
            for _ in range(100):
                await asyncio.sleep(0.02)
                if ctl.replicas:
                    break
            assert len(ctl.replicas) == 1 and len(pool.list()) == 1
            depth["v"] = 0.0
            await asyncio.sleep(0.1)
            await ctl.step()
            assert len(ctl.replicas) == 0
        finally:
            await ctl.stop()

    run_async(scenario())


def test_controller_launch_failure_is_retried_next_tick(tmp_path):
    """A launch that raises leaves desired above current (the reference's
    ``_launch_one`` swallows it) and the next reconcile launches again."""

    class Flaky(port_launcher.FakeReplicaLauncher):
        fails = 1

        async def launch(self):
            if self.fails:
                self.fails -= 1
                raise RuntimeError("build failed")
            return await super().launch()

    async def scenario():
        ctl = port_controller.PoolController(
            port_controller.PoolConfig(min_replicas=1, interval_s=3600, sfz_interval_s=3600,
                                       policy="hpa"),
            Flaky(server_config=port_fake.FakeServerConfig()), pool=port_endpoint.EndpointPool(),
            flow_depth_fn=lambda: 0.0)
        await ctl.start()
        try:
            assert ctl.replicas == {} and ctl.variant.desired_replicas == 1
            await ctl.step()
            assert len(ctl.replicas) == 1 and len(ctl.launch_records) == 1
        finally:
            await ctl.stop()

    run_async(scenario())


# ------------------------------------------------------------------- harness
def _report_rows(P, rows):
    return [P.harness.RequestResult(**r) for r in rows]


def test_replay_report_equal_to_reference():
    rng = np.random.default_rng(0)
    rows = [dict(tenant=f"t{i % 3}", t_offset=float(i) / 10,
                 status=int(rng.choice([200, 200, 200, 503, 429, -1])),
                 e2e_s=float(rng.uniform(0, 4)),
                 ttft_s=None if i % 2 else float(rng.uniform(0, 1))) for i in range(97)]
    for ttft in (None, 0.5):
        a = ref_harness.ReplayReport(_report_rows(REF, rows), wall_s=12.345, slo_e2e_s=2.5,
                                     slo_ttft_s=ttft)
        b = port_harness.ReplayReport(_report_rows(PORT, rows), wall_s=12.345, slo_e2e_s=2.5,
                                      slo_ttft_s=ttft)
        assert a.summary() == b.summary() and a.slo_attainment == b.slo_attainment
    assert port_harness.ReplayReport().slo_attainment == 1.0
    assert port_harness.ReplayReport().summary() == ref_harness.ReplayReport().summary()


def test_replay_trace_equal_to_reference():
    """Both harnesses replay one trace (half streamed) open-loop
    against one port fake replica, and one against a closed port: the same
    statuses, tenants, offsets and TTFT presence; the closed port counts as
    transport errors."""
    trace = port_traces.multi_tenant_ramp(duration_s=3, tenants=["a", "b"], seed=4,
                                          start_rps=4, end_rps=8)
    for i, r in enumerate(trace):
        r.stream = bool(i % 2)

    async def scenario():
        server = port_fake.FakeModelServer(_fake_cfg(PORT))
        await server.start()
        try:
            out = []
            for H in (ref_harness, port_harness):
                rep = await H.replay_trace(server.address, trace, time_scale=0.05)
                rows = sorted((r.tenant, r.t_offset, r.status, r.ttft_s is not None)
                              for r in rep.results)
                out.append((rows, rep.statuses, rep.client_5xx, rep.total))
            dead = await port_harness.replay_trace(f"127.0.0.1:{port_launcher._free_port()}",
                                                   trace[:5], request_timeout_s=5)
        finally:
            await server.stop()
        return out, dead

    (a, b), dead = run_async(scenario())
    assert len(trace) >= 10 and a == b and b[1] == {"200": len(trace)} and b[2] == 0
    assert sum(t for *_, t in b[0]) == len(trace) // 2
    assert dead.client_5xx == 5 and dead.statuses == {"-1": 5} and dead.slo_attainment == 0.0


def test_harness_cli_replays_a_generated_trace(monkeypatch):
    """``python -m llmd_tpu_torch.pool.harness --router host:port --generate
    bursty``, in process, against a fake replica on another thread."""
    ready, stop = threading.Event(), threading.Event()
    box: dict = {}

    def serve():
        async def run():
            server = port_fake.FakeModelServer(_fake_cfg(PORT))
            await server.start()
            box["address"] = server.address
            ready.set()
            while not stop.is_set():
                await asyncio.sleep(0.02)
            await server.stop()

        asyncio.run(run())

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    assert ready.wait(10)
    monkeypatch.setattr(sys, "argv", ["harness", "--router", box["address"], "--generate",
                                      "bursty", "--duration-s", "2", "--time-scale", "0.1",
                                      "--seed", "3"])
    buf = io.StringIO()
    try:
        with redirect_stdout(buf):
            assert port_harness.main() == 0
    finally:
        stop.set()
        t.join(10)
    summary = json.loads(buf.getvalue())
    n = len(port_traces.bursty_trace(duration_s=2, seed=3))
    assert summary["requests"] == n and summary["statuses"] == {"200": n}
    assert summary["client_5xx"] == 0 and set(summary) == set(
        ref_harness.ReplayReport().summary())


# ------------------------------------------------------------ pool families
def test_pool_families_exposition_equal_to_reference():
    out = []
    for P in (REF, PORT):
        reg = P.metrics.Registry()
        fam = P.metrics.register_pool_metrics(reg)
        assert P.metrics.register_pool_metrics(reg).scale_decisions is fam.scale_decisions
        fam.desired_replicas.set_function(lambda: 3)
        fam.ready_replicas.set(2)
        for reason in ("floor", "hpa", "hpa", "replica_dead"):
            fam.scale_decisions.labels(reason=reason).inc()
        for kind, v in (("cold", 73.8), ("warm", 16.5), ("warm", 0.07), ("warm", 200.0)):
            fam.warm_start.labels(kind=kind).observe(v)
        out.append(reg.expose())
    assert out[0] == out[1]
    assert 'llmd_tpu:pool_warm_start_seconds_count{kind="warm"} 3' in out[1]
