"""The phase and decision ledgers of the port (``llmd_tpu_torch/obs/
attribution.py``, ``obs/decisions.py``) against the reference's, on the CPU:

- ``build_ledger`` and ``build_decision`` give the reference's answer on the
  same records: the timelines that both engines recorded for a speculative,
  a preempting and an offloading script, and hand-made records (an active
  one, an empty one, unknown events, a masked chain, a KV pull, the router's
  plane for the phase ledger);
- after the same speculative script, the port engine's
  ``request_phase_seconds`` observation counts (by phase) and its
  ``decision_*`` counters equal the JAX engine's;
- ``LLMD_DECISION_LEDGER=0`` attaches no decision exporter in either engine.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import llmd_tpu.obs.attribution as ref_attr
import llmd_tpu.obs.decisions as ref_dec
import llmd_tpu_torch.obs.attribution as port_attr
import llmd_tpu_torch.obs.decisions as port_dec
from llmd_tpu.core.request import SamplingParams as JaxSamplingParams
from llmd_tpu.engine import EngineConfig as JaxEngineConfig
from llmd_tpu.engine import LLMEngine as JaxEngine
from llmd_tpu.models import get_model_config as jax_model_config
from llmd_tpu.models import transformer as jt
from llmd_tpu_torch.core.request import SamplingParams
from llmd_tpu_torch.engine import EngineConfig, LLMEngine
from llmd_tpu_torch.models import get_model_config
from llmd_tpu_torch.models import transformer as tt

BASE = dict(page_size=8, num_pages=64, max_model_len=256, max_batch_size=4, prefill_chunk=32)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _weights():
    jcfg = dataclasses.replace(jax_model_config("tiny"), dtype="float32")
    tcfg = dataclasses.replace(get_model_config("tiny"), dtype="float32")
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, {k: np.asarray(v) for k, v in jp.items()}


def _echo(salt: int, n: int = 48, period: int = 3) -> list[int]:
    return [(salt * 7919 + j % period) % 286 + 1 for j in range(n)]


SCRIPTS = {
    "spec": (dict(spec_mode="ngram", spec_tokens=4),
             [(f"s{i}", _echo(i), 24) for i in range(3)] + [("plain", list(range(60, 90)), 12)]),
    "preempt": (dict(num_pages=16, enable_prefix_caching=False),
                [(f"p{i}", list(range(i * 7 + 1, i * 7 + 40)), 12) for i in range(4)]),
    "offload": (dict(num_pages=12, max_batch_size=2, cpu_offload_pages=64),
                [("a", list(range(1, 49)), 6), ("b", list(range(100, 170)), 6),
                 ("a2", list(range(1, 49)), 6)]),
}


@functools.cache
def _runs(case: str):
    """Both engines after ``case``'s script, requests one at a time in the
    offload script (so the third reloads the first's blocks)."""
    kw, requests = SCRIPTS[case]
    jcfg, tcfg, jp, npp = _weights()
    je = JaxEngine(jcfg, JaxEngineConfig(**BASE | kw, attn_impl="reference"), params=jp)
    te = LLMEngine(tcfg, EngineConfig(**BASE | kw), params=tt.params_from_numpy(tcfg, npp),
                   device="cpu")
    for eng, sp in ((je, JaxSamplingParams), (te, SamplingParams)):
        waves = [[r] for r in requests] if case == "offload" else [requests]
        for wave in waves:
            for rid, prompt, n in wave:
                eng.add_request(rid, prompt, sp(max_tokens=n, temperature=0.0))
            while eng.has_work():
                eng.step()
    return je, te, [rid for rid, _, _ in requests]


def _engine_records() -> list:
    recs = []
    for case in SCRIPTS:
        je, te, rids = _runs(case)
        recs += [eng.flight.get(rid) for eng in (je, te) for rid in rids]
    return recs


HANDMADE = [
    {"latency_ms": 12.5, "events": []},
    {"latency_ms": 30.0, "status": "active",
     "events": [{"event": "arrival", "t_ms": 1.0}, {"event": "admitted", "t_ms": 2.5},
                {"event": "prefill_start", "t_ms": 3.0}]},
    {"latency_ms": 40.0, "events": [
        {"event": "kv_pull", "t_ms": 5.0, "outcome": "hit", "blocks": 4, "ms": 4.9},
        {"event": "arrival", "t_ms": 5.5}, {"event": "admitted", "t_ms": 6.0},
        {"event": "prefill_start", "t_ms": 6.1}, {"event": "prefill_end", "t_ms": 9.0},
        {"event": "chain_dispatch", "t_ms": 9.5, "masked": True},
        {"event": "mystery", "t_ms": 20.0},
        {"event": "retired", "t_ms": 39.0, "spec_drafted": 10, "spec_accepted": 4,
         "spec_flips": 3, "cached_tokens": 16}]},
    {"latency_ms": 50.0, "events": [
        {"event": "arrival", "t_ms": 0.5}, {"event": "flow_enqueue", "t_ms": 1.0},
        {"event": "routing_decision", "t_ms": 3.0}, {"event": "forward", "t_ms": 4.0},
        {"event": "response", "t_ms": 49.0}]},
]


def test_build_ledger_matches_reference():
    recs = _engine_records() + HANDMADE
    assert len(recs) > 20
    for rec in recs:
        assert port_attr.build_ledger(rec) == ref_attr.build_ledger(rec), rec
    assert port_attr.PHASES == ref_attr.PHASES


def test_build_decision_matches_reference():
    """Engine records fold as the reference folds them; a router record (the
    router plane, not ported) folds to None."""
    recs = _engine_records() + HANDMADE[:3]
    decided = 0
    for rec in recs:
        want = ref_dec.build_decision(rec)
        assert port_dec.build_decision(rec) == want, rec
        decided += want is not None
    assert decided > 5
    router = {"latency_ms": 9.0, "events": [{"event": "route_decision", "t_ms": 1.0}]}
    assert ref_dec.build_decision(router)["plane"] == "router"
    assert port_dec.build_decision(router) is None


def _counts(registry, name: str) -> dict:
    return {labels: v for n, labels, v in registry.collect() if n == name}


def _phases(registry) -> dict:
    """request_phase_seconds observation counts, by phase."""
    out: dict = {}
    for labels, v in _counts(registry, "llmd_tpu:request_phase_seconds_count").items():
        phase = labels.split('phase="')[1].split('"')[0]
        out[phase] = out.get(phase, 0) + v
    return out


def test_phase_and_decision_counts_match_reference_after_spec_script():
    je, te, rids = _runs("spec")
    assert _phases(te.registry) == _phases(je.registry)
    assert _phases(te.registry)["unattributed"] == len(rids)
    assert _phases(te.registry)["spec"] >= 3
    for name in ("llmd_tpu:decision_ledgers_total", "llmd_tpu:decision_spec_wasted_tokens_total",
                 "llmd_tpu:decision_spec_flips_total"):
        assert _counts(te.registry, name) == _counts(je.registry, name), name
    assert _counts(te.registry, "llmd_tpu:decision_ledgers_total")['{plane="engine"}'] >= 3


def test_decision_ledger_off(monkeypatch):
    monkeypatch.setenv("LLMD_DECISION_LEDGER", "0")
    jcfg, tcfg, jp, npp = _weights()
    kw = BASE | SCRIPTS["spec"][0]
    je = JaxEngine(jcfg, JaxEngineConfig(**kw, attn_impl="reference"), params=jp)
    te = LLMEngine(tcfg, EngineConfig(**kw), params=tt.params_from_numpy(tcfg, npp),
                   device="cpu")
    for eng, sp in ((je, JaxSamplingParams), (te, SamplingParams)):
        assert eng._decisions_on is False
        eng.add_request("s", _echo(1), sp(max_tokens=12, temperature=0.0))
        while eng.has_work():
            eng.step()
    assert _counts(te.registry, "llmd_tpu:decision_ledgers_total") == {}
    ret = te.flight.get("s")["events"][-1]
    assert ret["event"] == "retired" and "spec_drafted" not in ret
    assert ([e["event"] for e in te.flight.get("s")["events"]]
            == [e["event"] for e in je.flight.get("s")["events"]])
