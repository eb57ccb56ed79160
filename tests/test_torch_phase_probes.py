"""The sampled phase probes of the port engine (``_run_phase_probes``)
against the JAX engine's (``_observe_attn_phase`` / ``_observe_moe_phase``),
on the CPU, and the ``LLMD_MOE_DISPATCH`` override:

- after the same script of more than 128 decode dispatches, the
  ``step_duration`` sample counts of phases ``attn`` (every model) and
  ``moe_dispatch`` / ``moe_experts`` / ``moe_combine`` (the sorted MoE
  dispatch) equal the reference engine's, on tiny, tiny-moe sorted, tiny-moe
  einsum (no MoE probe) and tiny-mla; every other phase's count is equal too,
  the greedy tokens are, and no probe turned itself off;
- a probe that raises turns itself off and serving goes on;
- ``moe_dispatch="auto"`` takes ``LLMD_MOE_DISPATCH`` in both engines.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from llmd_tpu.core.request import SamplingParams as JaxSamplingParams
from llmd_tpu.engine import EngineConfig as JaxEngineConfig
from llmd_tpu.engine import LLMEngine as JaxEngine
from llmd_tpu.models import get_model_config as jax_model_config
from llmd_tpu.models import transformer as jt
from llmd_tpu_torch.core.request import SamplingParams
from llmd_tpu_torch.engine import EngineConfig, LLMEngine
from llmd_tpu_torch.models import get_model_config
from llmd_tpu_torch.models import transformer as tt

KW = dict(page_size=8, num_pages=96, max_model_len=256, max_batch_size=4, prefill_chunk=32,
          decode_steps=1)
PHASE_COUNT = "llmd_tpu:engine_step_duration_seconds_count"


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _weights(model: str):
    jcfg = dataclasses.replace(jax_model_config(model), dtype="float32")
    tcfg = dataclasses.replace(get_model_config(model), dtype="float32")
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, {k: np.asarray(v) for k, v in jp.items()}


def _run(eng, sp) -> dict:
    out: dict = {}
    for i in range(2):
        eng.add_request(f"r{i}", list(range(3 + 11 * i, 30 + 11 * i)),
                        sp(max_tokens=140, temperature=0.0))
    while eng.has_work():
        for o in eng.step():
            out.setdefault(o.request_id, []).extend(o.new_token_ids)
    return out


def _phase_counts(registry) -> dict:
    return {labels.split('"')[1]: v for name, labels, v in registry.collect()
            if name == PHASE_COUNT}


@pytest.mark.parametrize("model,dispatch", [("tiny", "auto"), ("tiny-moe", "sorted"),
                                            ("tiny-moe", "einsum"), ("tiny-mla", "sorted")])
def test_probe_sample_counts_match_reference(model, dispatch):
    jcfg, tcfg, jp, npp = _weights(model)
    je = JaxEngine(jcfg, JaxEngineConfig(**KW, moe_dispatch=dispatch, attn_impl="reference"),
                   params=jp)
    te = LLMEngine(tcfg, EngineConfig(**KW, moe_dispatch=dispatch),
                   params=tt.params_from_numpy(tcfg, npp), device="cpu")
    assert _run(te, SamplingParams) == _run(je, JaxSamplingParams)
    assert te.stats.n_decode_dispatches == je.stats.n_decode_dispatches >= 128
    port, ref = _phase_counts(te.registry), _phase_counts(je.registry)
    assert port == ref
    assert port["attn"] == te.stats.n_decode_dispatches // te._attn_probe_every >= 2
    sorted_moe = tcfg.is_moe and dispatch == "sorted"
    for phase in ("moe_dispatch", "moe_experts", "moe_combine"):
        assert port.get(phase, 0) == (port["attn"] if sorted_moe else 0), phase
    assert te._attn_probe_on and te._moe_probe_on == sorted_moe
    # each probe sample is its time x layers x decode_steps: positive
    sums = {labels.split('"')[1]: v for name, labels, v in te.registry.collect()
            if name == "llmd_tpu:engine_step_duration_seconds_sum"}
    assert sums["attn"] > 0


def test_failing_probe_turns_itself_off():
    _, tcfg, _, npp = _weights("tiny-moe")
    te = LLMEngine(tcfg, EngineConfig(**KW, moe_dispatch="sorted"),
                   params=tt.params_from_numpy(tcfg, npp), device="cpu")

    def boom(*a, **k):
        raise RuntimeError("probe failure")

    te._attn_probe_fn = boom
    te._moe_probe_fns = boom
    out = _run(te, SamplingParams)
    assert all(len(v) == 140 for v in out.values())  # serving went on
    assert not te._attn_probe_on and not te._moe_probe_on
    counts = _phase_counts(te.registry)
    assert "attn" not in counts and "moe_experts" not in counts


@pytest.mark.parametrize("env,want", [("einsum", "einsum"), ("sorted", "sorted"), ("", "sorted")])
def test_moe_dispatch_env_override(env, want, monkeypatch):
    monkeypatch.setenv("LLMD_MOE_DISPATCH", env)
    jcfg, tcfg, jp, npp = _weights("tiny-moe")
    je = JaxEngine(jcfg, JaxEngineConfig(**KW, attn_impl="reference"), params=jp)
    te = LLMEngine(tcfg, EngineConfig(**KW), params=tt.params_from_numpy(tcfg, npp),
                   device="cpu")
    assert te.moe_dispatch == je.moe_dispatch == want
    # an explicit choice is not overridden
    te2 = LLMEngine(tcfg, EngineConfig(**KW, moe_dispatch="sorted"),
                    params=tt.params_from_numpy(tcfg, npp), device="cpu")
    assert te2.moe_dispatch == "sorted"


def test_moe_dispatch_env_refuses_unknown(monkeypatch):
    monkeypatch.setenv("LLMD_MOE_DISPATCH", "dense")
    _, tcfg, _, npp = _weights("tiny-moe")
    with pytest.raises(ValueError, match="auto|sorted|einsum"):
        LLMEngine(tcfg, EngineConfig(**KW), params=tt.params_from_numpy(tcfg, npp),
                  device="cpu")
