"""PyTorch port's engine against the JAX reference engine, on the CPU.

Both engines serve ``tiny`` in float32 from the same numpy weights (the JAX
``init_params``); the reference runs its XLA attention (attn_impl="reference").
Greedy generations must be token-identical. The cases mirror
tests/test_engine.py. Sampled streams cannot match (jax.random and torch
generators differ), so sampling gets distributional checks only.
"""

import dataclasses
from collections import Counter

import jax
import numpy as np
import pytest
import torch

from llmd_tpu.core.request import SamplingParams as JaxSamplingParams
from llmd_tpu.engine import EngineConfig as JaxEngineConfig
from llmd_tpu.engine import LLMEngine as JaxEngine
from llmd_tpu.models import get_model_config as jax_model_config
from llmd_tpu.models.transformer import init_params as jax_init_params
from llmd_tpu_torch.core.request import SamplingParams
from llmd_tpu_torch.engine import EngineConfig, LLMEngine
from llmd_tpu_torch.engine.config import MeshConfig
from llmd_tpu_torch.models.lora import LoRAConfig
from llmd_tpu_torch.engine.sampling import greedy_tokens, sample_tokens
from llmd_tpu_torch.models import get_model_config
from llmd_tpu_torch.models.transformer import params_from_numpy

BASE = dict(page_size=8, num_pages=64, max_model_len=256, max_batch_size=4,
            prefill_chunk=32)


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jax_model_config("tiny"), dtype="float32")
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, {k: np.asarray(v) for k, v in jp.items()}


@pytest.fixture(scope="module")
def reference(weights):
    """generate(prompts, max_tokens, **sampling) on ONE JAX engine (prefix
    caching off, so every call computes from scratch), memoised."""
    jcfg, jp, _ = weights
    eng = JaxEngine(jcfg, JaxEngineConfig(**BASE, attn_impl="reference",
                                          enable_prefix_caching=False), params=jp)
    memo = {}

    def run(prompts, max_tokens, **kw):
        key = (tuple(map(tuple, prompts)), max_tokens, tuple(sorted(kw.items())))
        if key not in memo:
            memo[key] = eng.generate(prompts, JaxSamplingParams(
                max_tokens=max_tokens, temperature=0.0, **kw))
        return memo[key]

    return run


@pytest.fixture(scope="module")
def make(weights):
    _, _, npp = weights
    tcfg = dataclasses.replace(get_model_config("tiny"), dtype="float32")

    def build(event_sink=None, **kw):
        return LLMEngine(tcfg, EngineConfig(**{**BASE, **kw}),
                         params=params_from_numpy(tcfg, npp), event_sink=event_sink,
                         device="cpu")

    return build


def greedy(max_tokens, **kw):
    return SamplingParams(max_tokens=max_tokens, temperature=0.0, **kw)


def test_single_request_greedy(make, reference):
    prompt = list(range(10, 30))
    out = make().generate([prompt], greedy(8))
    assert len(out["req-0"]) == 8
    assert out == reference([prompt], 8)


def test_batch_equivalence(make, reference):
    """A concurrent batch (chunked prefill across sequences) matches the
    reference, and each sequence matches its solo run."""
    prompts = [list(range(3, 20)), list(range(40, 80)), list(range(100, 110))]
    batch = make().generate(prompts, greedy(5))
    assert batch == reference(prompts, 5)
    for i, p in enumerate(prompts):
        assert make().generate([p], greedy(5))["req-0"] == batch[f"req-{i}"]


def test_prefix_cache_reuse(make, reference):
    events = []
    eng = make(event_sink=events.extend)
    shared = list(range(1, 65))  # 8 full pages of 8
    cold = eng.generate([shared + [70]], greedy(6))
    assert cold == reference([shared + [70]], 6)
    assert events  # BlockStored events for the committed pages
    eng.add_request("warm", shared + [70], greedy(6))
    got, cached = [], 0
    while eng.has_work():
        for o in eng.step():
            if o.request_id == "warm":
                got.extend(o.new_token_ids)
                cached = o.num_cached_prompt_tokens
    assert got == cold["req-0"]
    assert cached == 64  # every full prompt block came from the cache
    assert eng.stats.total_prefill_tokens == 65 + 1  # the warm prompt re-ran 1 token


def test_preemption_under_page_pressure(make, reference):
    """Too few pages for the batch: preempt by recompute, continue the SAME
    greedy continuation."""
    prompts = [list(range(1, 30)), list(range(60, 95))]
    tight = make(num_pages=10, max_batch_size=2, enable_prefix_caching=False)
    got = tight.generate(prompts, greedy(16))
    assert tight.stats.total_preemptions > 0  # the point of the test
    assert got == reference(prompts, 16)
    prompts4 = [list(range(i * 7 + 1, i * 7 + 40)) for i in range(4)]
    got4 = make(num_pages=16, enable_prefix_caching=False).generate(prompts4, greedy(12))
    assert got4 == reference(prompts4, 12)


def test_no_page_leak_under_preemption_churn(make):
    """Every allocated page's refcount equals the number of sequences listing
    it, at every step (the reference's zombie-scheduling leak pin)."""
    eng = make(num_pages=10, max_batch_size=2, enable_prefix_caching=False)
    for i, p in enumerate([list(range(1, 30)), list(range(60, 95)), list(range(7, 44))]):
        eng.add_request(f"req-{i}", p, greedy(16))
    steps = 0
    while eng.has_work():
        eng.step()
        steps += 1
        assert steps < 600, "no forward progress"
        owned = Counter(pid for s in list(eng.running) + list(eng.waiting)
                        if s is not None for pid in s.pages)
        for pid, info in eng.alloc.pages.items():
            assert info.refs == owned.get(pid, 0), (steps, pid)


def test_multistep_decode_matches_single_step(make, reference):
    prompts = [list(range(5, 40)), list(range(50, 90))]
    multi = make(decode_steps=4)
    out = multi.generate(prompts, greedy(11))
    assert out == reference(prompts, 11)
    assert out == make(decode_steps=1).generate(prompts, greedy(11))
    # 11 tokens = 1 from prefill + 10 decoded in calls of 4 iterations each
    # (the decode program always runs decode_steps iterations, as the
    # reference's scan does; rows freeze once their budget is spent)
    assert multi.stats.n_decode_calls == 3
    assert multi.stats.n_decode_iterations == 12


def test_multistep_degrades_in_tight_pool(make, reference):
    eng = make(num_pages=3, max_model_len=24, max_batch_size=1, decode_steps=4)
    p = list(range(1, 20))
    assert eng.generate([p], greedy(5)) == reference([p], 5)


def test_stop_token(make, reference):
    """Greedy stream [a, b, c, ...] with stop token c: decode_steps=4 truncates
    mid-call at c (tokens past it are dropped)."""
    prompt = list(range(10, 30))
    first = reference([prompt], 6)["req-0"]
    stop = next(t for i, t in enumerate(first) if i >= 2 and t not in first[:i])
    k = first.index(stop)
    eng = make(decode_steps=4)
    out = eng.generate([prompt], greedy(16, stop_token_ids=[stop]))
    assert out["req-0"] == first[: k + 1]
    assert out == reference([prompt], 16, stop_token_ids=(stop,))


def test_top_k_one_equals_greedy(make):
    prompts = [list(range(5, 40)), list(range(50, 70))]
    sampled = make(decode_steps=4).generate(
        prompts, SamplingParams(max_tokens=8, temperature=1.3, top_k=1))
    assert sampled == make(decode_steps=4).generate(prompts, greedy(8))


def test_sampler_draws_only_from_top_k():
    """Every sampled id lies in its row's top-k set; top_p that the best token
    alone exceeds reduces to greedy; temperature 0 rows are the argmax."""
    g = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((6, 288), np.float32) * 3)
    top5 = torch.topk(logits, 5, dim=-1).indices
    temp = torch.tensor([1.0, 1.0, 2.0, 0.7, 0.0, 1.0])
    tk = torch.tensor([5, 5, 5, 5, 5, 0])
    tp = torch.tensor([1.0, 0.9, 1.0, 1.0, 1.0, 1e-6])
    seen = set()
    for _ in range(200):
        ids = sample_tokens(logits, g, temp, tk, tp)
        for r in range(4):
            assert int(ids[r]) in top5[r].tolist()
            seen.add((r, int(ids[r])))
        assert int(ids[4]) == int(greedy_tokens(logits)[4])
        assert int(ids[5]) == int(greedy_tokens(logits)[5])
    assert len(seen) > 4  # actually random, not stuck on the argmax
    assert torch.equal(greedy_tokens(logits),
                       torch.argmax(logits, -1).to(torch.int32))


def test_unserved_options_raise(make, reference):
    with pytest.raises(ValueError, match="spec_mode"):
        make(spec_mode="medusa")  # the reference's validation: off | ngram
    with pytest.raises(ValueError, match="unknown kv_cache_dtype"):  # the reference's words
        make(kv_cache_dtype="int4")
    # every field the port does not read raises when set away from its default
    for field, value in (("kv_layout", "packed"),):
        with pytest.raises(ValueError, match=field):
            make(**{field: value})
    # the mesh serves LoRA (and media, the KV data plane and the masked
    # programs): a meshed engine with an adapter bank constructs, its world
    # of CPU rank processes started and stopped
    meshed = make(mesh=MeshConfig(tp=2), lora=LoRAConfig(max_adapters=2, rank=4))
    try:
        assert meshed.rank_mesh.cfg == MeshConfig(tp=2) and meshed.lora_registry is not None
    finally:
        meshed.close()
    # served away from their defaults, each against the reference: the
    # pipelined dispatch off, at depth 1 without pack overlap, and
    # ``instrument`` (the unified program's outputs waited for before its
    # device time is stamped)
    prompt = list(range(10, 30))
    for kw in (dict(pipeline_decode=False, pack_overlap=False,
                    pipeline_prefill_sample=False),
               dict(pipeline_depth=1, pack_overlap=False),
               dict(instrument=True)):
        eng = make(decode_steps=2, **kw)
        assert eng.generate([prompt], greedy(5)) == reference([prompt], 5), kw
        st = eng.stats
        assert st.time_device > 0 and st.time_postprocess > 0
        assert st.time_prefill_steps >= st.time_device - st.time_device_decode
    eng = make()
    with pytest.raises(ValueError):  # logit_bias is served; a bias past 100 is refused
        eng.add_request("bias", prompt, SamplingParams(max_tokens=4, logit_bias={1: 200.0}))
    assert not eng.has_work()
    with pytest.raises(ValueError):
        eng.add_request("empty", [], greedy(4))
    with pytest.raises(ValueError):
        make(num_pages=4).add_request("big", list(range(100)), greedy(4))
