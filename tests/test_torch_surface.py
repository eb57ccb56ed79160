"""The port engine's metric families against the JAX reference engine's, on
the CPU: both engines run the same float32 weights through the same request
script, step by step, and every counter the two engines share is held equal
sample by sample (prefill and decode tokens, preemptions, KV exhaustion, the
prefix-cache families, program dispatches by program, MoE dropped copies by
dispatch path), as are the observation counts of ``step_duration`` by phase
and of ``batch_occupancy``, and the MoE load-imbalance gauges under EPLB.
Durations are not compared.

Not compared, by design: the goodput and compile counters (the port's
unified program runs exactly its real rows, the reference's pads them, and a
compile is a jit cache entry there and a graph capture here), and the
reference's sampled attention probe (``step_duration{phase="attn"}``, every
64th decode dispatch; not ported, ROADMAP), which these scripts never reach.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest

from llmd_tpu.core.request import SamplingParams as JaxSamplingParams
from llmd_tpu.engine import EngineConfig as JaxEngineConfig
from llmd_tpu.engine import LLMEngine as JaxEngine
from llmd_tpu.models import get_model_config as jax_model_config
from llmd_tpu.models import transformer as jt
from llmd_tpu.parallel.eplb import EPLBConfig as JaxEPLBConfig
from llmd_tpu_torch.core.request import SamplingParams
from llmd_tpu_torch.engine import EngineConfig, LLMEngine
from llmd_tpu_torch.models import get_model_config
from llmd_tpu_torch.models import transformer as tt
from llmd_tpu_torch.parallel.eplb import EPLBConfig

COUNTERS = ("llmd_tpu:prefill_tokens_total", "llmd_tpu:decode_tokens_total",
            "llmd_tpu:preemptions_total", "llmd_tpu:kv_block_exhaustion_total",
            "llmd_tpu:engine_prefix_cached_tokens_total",
            "llmd_tpu:engine_prefix_prompt_tokens_total",
            "llmd_tpu:engine_program_dispatches_total",
            "llmd_tpu:moe_dropped_tokens_total")
GAUGES = ("llmd_tpu:engine_prefix_cache_hit_ratio", "llmd_tpu:moe_ep_load_imbalance",
          "vllm:num_requests_waiting", "vllm:num_requests_running",
          "vllm:kv_cache_usage_perc", "vllm:cache_config_info")
COUNTS = ("llmd_tpu:engine_step_duration_seconds_count",
          "llmd_tpu:engine_batch_occupancy_count", "llmd_tpu:engine_batch_occupancy_sum")


@functools.cache
def _weights(model: str):
    jcfg = dataclasses.replace(jax_model_config(model), dtype="float32")
    tcfg = dataclasses.replace(get_model_config(model), dtype="float32")
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, {k: np.asarray(v) for k, v in jp.items()}


def _drive(eng, waves) -> dict[str, list[int]]:
    """Each wave [(id, prompt, max_tokens)] is added once the previous one
    finished; step until done."""
    jax_side = isinstance(eng, JaxEngine)
    out: dict[str, list[int]] = {}
    for wave in waves:
        for rid, prompt, n in wave:
            sp = (JaxSamplingParams if jax_side else SamplingParams)(
                max_tokens=n, temperature=0.0)
            eng.add_request(rid, prompt, sp)
            out[rid] = []
        steps = 0
        while eng.has_work():
            for o in eng.step():
                out[o.request_id].extend(o.new_token_ids)
            steps += 1
            assert steps < 500, "no forward progress"
    return out


def _samples(registry, names) -> dict:
    return {(name, labels): value for name, labels, value in registry.collect()
            if name in names}


def _pair(model, waves, *, cap=None, eplb=None, **kw):
    jcfg, tcfg, jp, npp = _weights(model)
    if cap is not None:
        jcfg = dataclasses.replace(jcfg, moe_capacity_factor=cap)
        tcfg = dataclasses.replace(tcfg, moe_capacity_factor=cap)
    je = JaxEngine(jcfg, JaxEngineConfig(
        **kw, attn_impl="reference", eplb=None if eplb is None else JaxEPLBConfig(*eplb)),
        params=jp)
    te = LLMEngine(tcfg, EngineConfig(**kw, eplb=None if eplb is None else EPLBConfig(*eplb)),
                   params=tt.params_from_numpy(tcfg, npp), device="cpu")
    return _drive(je, waves), je, _drive(te, waves), te


def _assert_same_metrics(je, te) -> dict:
    ref = _samples(je.registry, COUNTERS + COUNTS)
    port = _samples(te.registry, COUNTERS + COUNTS)
    assert port == ref
    ref_g = _samples(je.registry, GAUGES)
    port_g = _samples(te.registry, GAUGES)
    assert port_g.keys() == ref_g.keys()
    for key, v in ref_g.items():
        assert port_g[key] == pytest.approx(v, rel=1e-9), key
    return port


SHARED = list(range(1, 41))  # five full pages of 8


def test_metrics_match_reference_with_prefix_hits_and_preemption():
    """tiny: two waves. The first overfills a tight pool (preemption by
    recompute, failed page allocations); the second repeats a first-wave
    prompt and shares its prefix with another (prefix-cache hits)."""
    waves = [[("a", SHARED + [50, 51, 52], 10), ("b", list(range(60, 95)), 10)],
             [("c", SHARED + [50, 51, 52], 6), ("d", SHARED + [70, 71], 6)]]
    ro, je, to, te = _pair("tiny", waves, page_size=8, num_pages=10, max_model_len=128,
                           max_batch_size=2, prefill_chunk=16, decode_steps=2)
    assert to == ro
    port = _assert_same_metrics(je, te)
    assert port[("llmd_tpu:preemptions_total", "")] > 0
    assert port[("llmd_tpu:kv_block_exhaustion_total", "")] > 0
    assert port[("llmd_tpu:engine_prefix_cached_tokens_total", "")] > 0
    phases = {labels for name, labels in port if name.startswith(
        "llmd_tpu:engine_step_duration")}
    assert {f'{{phase="{p}"}}' for p in ("unified", "pack", "pack_overlap",
                                          "decode_dispatch", "decode_process")} <= phases


@pytest.mark.parametrize("dispatch", ["sorted", "einsum"])
def test_moe_metrics_match_reference(dispatch):
    """tiny-moe on both dispatch paths (einsum at capacity 0.5, where copies
    drop): the dropped-copy counter by path equal, with everything else."""
    kw = dict(page_size=8, num_pages=64, max_model_len=256, max_batch_size=4,
              prefill_chunk=32, decode_steps=4, moe_dispatch=dispatch)
    cap = None
    if dispatch == "einsum":
        cap, kw["max_batch_size"] = 0.5, 6
    waves = [[("a", list(range(3, 30)), 9), ("b", list(range(40, 55)), 4)]]
    ro, je, to, te = _pair("tiny-moe", waves, cap=cap, **kw)
    assert to == ro
    port = _assert_same_metrics(je, te)
    dropped = port[("llmd_tpu:moe_dropped_tokens_total", f'{{path="{dispatch}"}}')]
    assert (dropped > 0) == (dispatch == "einsum")


def test_moe_eplb_imbalance_gauges_match_reference():
    """EPLB every 2 routed steps: the before/after load-imbalance gauges
    read the same loads and placements as the reference's."""
    kw = dict(page_size=8, num_pages=64, max_model_len=256, max_batch_size=4,
              prefill_chunk=32, decode_steps=1, moe_dispatch="sorted")
    waves = [[("a", list(range(3, 30)), 9), ("b", list(range(40, 55)), 4)]]
    ro, je, to, te = _pair("tiny-moe", waves, eplb=(8, 2, 8), **kw)
    assert to == ro
    _assert_same_metrics(je, te)
    gauges = _samples(te.registry, GAUGES)
    assert {('llmd_tpu:moe_ep_load_imbalance', '{when="before"}'),
            ('llmd_tpu:moe_ep_load_imbalance', '{when="after"}')} <= gauges.keys()


SPEC_STRUCTURED = ("llmd_tpu:spec_drafted_tokens_total", "llmd_tpu:spec_accepted_tokens_total",
                   "llmd_tpu:spec_rejected_tokens_total", "llmd_tpu:spec_acceptance_rate_count",
                   "llmd_tpu:spec_acceptance_rate_sum", "llmd_tpu:structured_requests_total",
                   "llmd_tpu:structured_cache_hits_total",
                   "llmd_tpu:structured_cache_misses_total",
                   "llmd_tpu:structured_violations_total",
                   "llmd_tpu:structured_compile_seconds_count",
                   "llmd_tpu:structured_mask_build_seconds_count")


def test_spec_structured_metrics_match_reference():
    """Speculation and structured outputs on (tiny, ``decode_steps`` 4,
    ``spec_tokens`` 4): two waves of an unconstrained echo row, a choice, a
    regex, a logit_bias row and a schema-echo row whose drafts the masked
    verify program accepts, the second wave repeating a grammar (a cache
    hit), a grammar-and-bias row (the unified degrade) and a sampled row.
    Every sample of the spec, structured and engine families equal to the
    JAX engine's, ``step_duration{phase="spec_verify"}`` and
    ``{phase="chain_stage"}`` counts included; the process-wide grammar
    caches start empty on both sides."""
    import llmd_tpu.structured as ref_structured
    import llmd_tpu_torch.structured as port_structured
    from llmd_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
    from llmd_tpu_torch.engine.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    item = {"type": "object", "properties": {"s": {"enum": ["on"]}}, "required": ["s"]}
    fmt = {"type": "json_schema", "json_schema": {"schema": {
        "type": "array", "items": item, "minItems": 4, "maxItems": 4}}}
    echo = [(7919 + j % 3) % 286 + 1 for j in range(40)]
    z = tok.encode("z")[0]
    stop = dict(stop_token_ids=(tok.eos_id,))
    waves = [[("echo", echo, dict(max_tokens=16)),
              ("choice", tok.encode("pick"), dict(max_tokens=16, guided_choice=["red", "blue"],
                                                  **stop)),
              ("regex", tok.encode("code"), dict(max_tokens=16, guided_regex=r"[ab]{6}", **stop)),
              ("schema", tok.encode('[{"s":"on"},{"s":"on"},'),
               dict(max_tokens=48, response_format=fmt, **stop))],
             [("bias", tok.encode("say"), dict(max_tokens=6, logit_bias={z: 100})),
              ("choice2", tok.encode("again"), dict(max_tokens=16, guided_choice=["red", "blue"],
                                                    **stop)),
              ("both", tok.encode("both"), dict(max_tokens=16, guided_choice=["red", "blue"],
                                                logit_bias={z: -1.0}, **stop)),
              ("sampled", echo, dict(max_tokens=8, temperature=0.8))]]
    kw = dict(page_size=8, num_pages=64, max_model_len=256, max_batch_size=4,
              prefill_chunk=32, decode_steps=4, spec_mode="ngram", spec_tokens=4)
    jcfg, tcfg, jp, npp = _weights("tiny")
    ref_structured.reset_global_cache()
    port_structured.reset_global_cache()
    je = JaxEngine(jcfg, JaxEngineConfig(**kw, attn_impl="reference"), params=jp,
                   tokenizer=JaxByteTokenizer())
    te = LLMEngine(tcfg, EngineConfig(**kw), params=tt.params_from_numpy(tcfg, npp),
                   device="cpu", tokenizer=tok)
    outs = []
    for eng in (je, te):
        make = JaxSamplingParams if eng is je else SamplingParams
        out: dict[str, list[int]] = {}
        for wave in waves:
            for rid, prompt, sp in wave:
                eng.add_request(rid, prompt, make(**{"temperature": 0.0, **sp}))
            steps = 0
            while eng.has_work():
                for o in eng.step():
                    out.setdefault(o.request_id, []).extend(o.new_token_ids)
                steps += 1
                assert steps < 1000, "no forward progress"
        outs.append({k: v for k, v in out.items() if k != "sampled"})
    assert outs[0] == outs[1]
    port = _assert_same_metrics(je, te)
    families = _samples(te.registry, SPEC_STRUCTURED)
    assert families == _samples(je.registry, SPEC_STRUCTURED)
    assert families[("llmd_tpu:spec_accepted_tokens_total", "")] > 0
    assert families[("llmd_tpu:structured_cache_hits_total", "")] > 0
    assert families[("llmd_tpu:structured_requests_total", '{kind="json_schema"}')] == 1
    assert families[("llmd_tpu:spec_acceptance_rate_count", '{constrained="yes"}')] > 0
    phases = {labels for name, labels in port if name.startswith(
        "llmd_tpu:engine_step_duration")}
    assert {'{phase="spec_verify"}', '{phase="chain_stage"}'} <= phases
    assert te.stats.structured_violations == je.stats.structured_violations
