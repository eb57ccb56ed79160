"""Speculative decoding in the port (``spec_mode="ngram"``: prompt-lookup drafts,
``engine/spec.py``, verified by ``engine/verify_program.py``) against the JAX
engine, on the CPU, in float32, with the reference's pipelined defaults on.

Greedy acceptance makes speculation a pure latency lever: every emitted token
is the model's own argmax. So on the same weights the port with speculation,
the JAX engine with speculation and the port without it emit identical
tokens, on ``tiny``, ``tiny-moe`` (sorted dispatch with EPLB, and the capacity
einsum) and ``tiny-mla``, including a second round that hits the prefix
cache, and under preemption in a tight pool (with the page ledger audited
every step while rejected tails go back to the free list). The drafted,
accepted and rejected counts, the verify steps, the dropped copies and the
EPLB rebalances equal the JAX engine's. Where the capacity einsum drops
copies (its default capacity, or 0.5 here), which copies drop depends on the
rows of each batch, and a verify batch has other rows than a decode batch:
there the port with speculation is held to the JAX engine with speculation,
drops included, and the three-way identity is held at capacity 8.

The reference's LoRA case (``tests/test_spec_decode.py:143``) is in
``tests/test_torch_lora.py``.
"""

import dataclasses
import functools
from collections import Counter

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from llmd_tpu.core.request import SamplingParams as JaxSamplingParams
from llmd_tpu.engine import EngineConfig as JaxEngineConfig
from llmd_tpu.engine import LLMEngine as JaxEngine
from llmd_tpu.engine.spec import propose_ngram_draft as ref_propose
from llmd_tpu.models import get_model_config as jax_model_config
from llmd_tpu.models import transformer as jt
from llmd_tpu.parallel.eplb import EPLBConfig as JaxEPLBConfig
from llmd_tpu_torch.core.request import SamplingParams
from llmd_tpu_torch.engine import EngineConfig, LLMEngine
from llmd_tpu_torch.engine.spec import propose_ngram_draft
from llmd_tpu_torch.models import get_model_config
from llmd_tpu_torch.models import transformer as tt
from llmd_tpu_torch.parallel.eplb import EPLBConfig

BASE = dict(page_size=8, num_pages=64, max_model_len=256, max_batch_size=4, prefill_chunk=32)
SPEC = dict(spec_mode="ngram", spec_tokens=4)
COUNTS = ("spec_drafted", "spec_accepted", "spec_rejected", "n_spec_verify_steps",
          "moe_dropped_tokens", "eplb_rebalances", "total_preemptions")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@settings(max_examples=50, deadline=None)
@given(st.lists(st.integers(0, 6), max_size=40), st.integers(0, 6), st.integers(1, 4),
       st.integers(1, 3))
def test_propose_ngram_draft_matches_reference(tokens, k, ngram_max, ngram_min):
    assert (propose_ngram_draft(tokens, k, ngram_max, ngram_min)
            == ref_propose(tokens, k, ngram_max, ngram_min))


def test_propose_ngram_draft_unit():
    hist = [1, 2, 3, 1, 2, 3, 1, 2, 3]
    assert propose_ngram_draft(hist, k=3) == [1, 2, 3]
    assert propose_ngram_draft([1, 2, 3, 4, 5, 6], k=4) == []
    assert propose_ngram_draft(hist, k=2) == [1, 2]
    assert propose_ngram_draft([7], k=4) == []


@functools.cache
def _weights(model: str):
    jcfg = dataclasses.replace(jax_model_config(model), dtype="float32")
    tcfg = dataclasses.replace(get_model_config(model), dtype="float32")
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, {k: np.asarray(v) for k, v in jp.items()}


def _echo(salt: int, n: int = 48, period: int = 3) -> list[int]:
    """Periodic prompt (``bench.py --workload echo``): the drafter fires."""
    return [(salt * 7919 + j % period) % 286 + 1 for j in range(n)]


def _engines(model, cap=None, eplb=None, **kw):
    """(JAX engine with speculation, port with it, port without it), the
    same float32 weights."""
    jcfg, tcfg, jp, npp = _weights(model)
    if cap is not None:
        jcfg = dataclasses.replace(jcfg, moe_capacity_factor=cap)
        tcfg = dataclasses.replace(tcfg, moe_capacity_factor=cap)
    cfg = {**BASE, **kw}
    je = JaxEngine(jcfg, JaxEngineConfig(**cfg, **SPEC, attn_impl="reference",
                                         eplb=None if eplb is None else JaxEPLBConfig(*eplb)),
                   params=jp)
    port = [LLMEngine(tcfg, EngineConfig(**cfg, **spec, eplb=None if eplb is None
                                         else EPLBConfig(*eplb)),
                      params=tt.params_from_numpy(tcfg, npp), device="cpu")
            for spec in (SPEC, {})]
    return je, *port


def _drain(eng, requests, audit=False) -> dict[str, list[int]]:
    jax_side = isinstance(eng, JaxEngine)
    for rid, prompt, n in requests:
        eng.add_request(rid, prompt, (JaxSamplingParams if jax_side else SamplingParams)(
            max_tokens=n, temperature=0.0))
    out: dict[str, list[int]] = {rid: [] for rid, _, _ in requests}
    steps = 0
    while eng.has_work():
        for o in eng.step():
            out[o.request_id].extend(o.new_token_ids)
        steps += 1
        assert steps < 1000, "no forward progress"
        if audit:  # every page's refcount is the number of sequences listing it
            owned = Counter(pid for s in list(eng.running) + list(eng.waiting)
                            if s is not None for pid in s.pages)
            for pid, info in eng.alloc.pages.items():
                assert info.refs == owned.get(pid, 0), (steps, pid, info.refs)
    return out


CASES = {
    "tiny": dict(model="tiny"),
    "moe_sorted_eplb": dict(model="tiny-moe", moe_dispatch="sorted", eplb=(8, 2, 8),
                            decode_steps=2),
    # a capacity at which nothing drops: the three-way identity holds
    "moe_einsum": dict(model="tiny-moe", moe_dispatch="einsum", cap=8.0),
    "moe_einsum_drops": dict(model="tiny-moe", moe_dispatch="einsum", cap=0.5,
                             max_batch_size=6),
    "mla": dict(model="tiny-mla", num_pages=128, decode_steps=4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_spec_greedy_matches_reference_and_plain_decode(case):
    """Echo-heavy and arbitrary prompts, then a second round sharing the
    first echo prompt's prefix (a prefix-cache hit): spec port = spec JAX =
    plain port, and the speculation and MoE counts equal the JAX engine's."""
    kw = dict(CASES[case])
    je, te, plain = _engines(kw.pop("model"), **kw)
    rounds = [[("r0", _echo(1), 16), ("r1", list(range(10, 40)), 16),
               ("r2", _echo(2, period=4), 16)],
              [("hit", _echo(1) + [9, 9], 12)]]
    drops = case == "moe_einsum_drops"
    for requests in rounds:
        want = _drain(je, requests)
        assert _drain(te, requests) == want
        got = _drain(plain, requests)
        assert drops or got == want
    assert te.stats.n_spec_verify_steps > 0 and te.stats.spec_rejected > 0
    assert plain.stats.n_spec_verify_steps == 0
    assert te.metrics.prefix_cached_tokens.value > 0  # the second round hit
    for key in COUNTS:
        assert getattr(te.stats, key) == getattr(je.stats, key), key
    assert (te.stats.moe_dropped_tokens > 0) == drops
    if case == "moe_sorted_eplb":
        assert te.stats.eplb_rebalances > 1
    assert te.programs.quiesced() and te.programs.counters()["verify"][0] > 0


def test_spec_preemption_and_page_ledger():
    """A pool too small for two echo sequences: preemption by recompute with
    drafts in flight, rejected tails trimmed back to the free list, the page
    ledger consistent every step, the same tokens and counts as the JAX
    engine's and as plain decode's."""
    je, te, plain = _engines("tiny", num_pages=10, max_batch_size=2,
                             enable_prefix_caching=False)
    requests = [(f"r{i}", _echo(i, n=36), 16) for i in range(3)]
    want = _drain(je, requests)
    assert _drain(te, requests, audit=True) == want
    assert _drain(plain, requests) == want
    st = te.stats
    assert st.total_preemptions > 0 and st.spec_rejected > 0 and st.n_spec_verify_steps > 0
    for key in COUNTS:
        assert getattr(st, key) == getattr(je.stats, key), key


def test_echo_acceptance_metrics_and_temperature_fallback():
    """On echo traffic a verify step lands more than one draft token on
    average; the spec families are on /metrics; a sampled request never
    drafts (greedy acceptance is exact only for greedy rows)."""
    _, tcfg, _, npp = _weights("tiny")
    eng = LLMEngine(tcfg, EngineConfig(**BASE, **SPEC), params=tt.params_from_numpy(tcfg, npp),
                    device="cpu")
    eng.generate([_echo(i, n=64) for i in range(2)],
                 SamplingParams(max_tokens=48, temperature=0.0))
    st = eng.stats
    assert st.n_spec_verify_steps > 0
    assert st.spec_accepted / st.n_spec_verify_steps > 1.0
    assert st.spec_drafted >= st.spec_accepted + st.spec_rejected
    m = eng.metrics
    assert (m.spec_drafted.value, m.spec_accepted.value, m.spec_rejected.value) == (
        st.spec_drafted, st.spec_accepted, st.spec_rejected)
    text = eng.registry.expose()
    for fam in ("llmd_tpu:spec_drafted_tokens_total", "llmd_tpu:spec_accepted_tokens_total",
                "llmd_tpu:spec_rejected_tokens_total",
                'llmd_tpu:spec_acceptance_rate_count{constrained="no"} 2',
                'llmd_tpu:engine_step_duration_seconds_count{phase="spec_verify"}'):
        assert fam in text, fam
    drafted, verify_steps = st.spec_drafted, st.n_spec_verify_steps
    eng.generate([_echo(1)], SamplingParams(max_tokens=12, temperature=0.8))
    assert st.spec_drafted == drafted and st.n_spec_verify_steps == verify_steps


def test_spec_mode_validated():
    _, tcfg, _, _ = _weights("tiny")
    for bad in (dict(spec_mode="medusa"), dict(structured_mode="always")):
        with pytest.raises(ValueError, match=next(iter(bad))):
            LLMEngine(tcfg, EngineConfig(**BASE, **bad), device="cpu")
