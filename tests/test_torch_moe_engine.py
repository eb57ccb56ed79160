"""PyTorch port's engine on a MoE model against the JAX reference engine, on
the CPU.

Both engines serve ``tiny-moe`` in float32 from the same numpy weights (the
JAX ``init_params``); the reference runs its XLA attention. Greedy tokens must
be identical, and so must the dropped copies of the capacity-einsum path and
the number of EPLB rebalances. Both engines run with ``pipeline_decode`` and
``pipeline_prefill_sample`` off here (``tests/test_torch_pipelined_decode.py``
holds them with both on): on the einsum path which tokens share a step
decides which copies drop.
"""

import dataclasses

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


@pytest.fixture(scope="module")
def moe_weights():
    jcfg = dataclasses.replace(jax_model_config("tiny-moe"), dtype="float32")
    tcfg = dataclasses.replace(get_model_config("tiny-moe"), dtype="float32")
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, {k: np.asarray(v) for k, v in jp.items()}


BASE = dict(page_size=8, num_pages=64, max_model_len=256, max_batch_size=4,
            prefill_chunk=32)
PROMPTS = [list(range(3, 30)), list(range(40, 55)), list(range(100, 140))]


def _pair(moe_weights, cap=None, eplb=None, **kw):
    """Greedy generations of both engines on the same float32 weights:
    (reference outputs, reference stats, port outputs, port stats)."""
    jcfg, tcfg, jp, npp = moe_weights
    if cap is not None:
        jcfg = dataclasses.replace(jcfg, moe_capacity_factor=cap)
        tcfg = dataclasses.replace(tcfg, moe_capacity_factor=cap)

    def run(prompts, max_tokens):
        je = JaxEngine(jcfg, JaxEngineConfig(
            **BASE | kw, attn_impl="reference", enable_prefix_caching=False,
            pipeline_decode=False, pipeline_prefill_sample=False,
            eplb=None if eplb is None else JaxEPLBConfig(*eplb)), params=jp)
        te = LLMEngine(tcfg, EngineConfig(**BASE | kw, pipeline_decode=False,
                                          pipeline_prefill_sample=False,
                                          eplb=None if eplb is None else EPLBConfig(*eplb)),
                       params=tt.params_from_numpy(tcfg, npp), device="cpu")
        ro = je.generate(prompts, JaxSamplingParams(max_tokens=max_tokens, temperature=0.0))
        to = te.generate(prompts, SamplingParams(max_tokens=max_tokens, temperature=0.0))
        return ro, je.stats, to, te.stats

    return run


def test_moe_engine_single_request_greedy(moe_weights):
    ro, _, to, st = _pair(moe_weights)([PROMPTS[0]], 8)
    assert len(to["req-0"]) == 8 and to == ro
    assert (st.moe_dispatch, st.moe_dropped_tokens) == ("sorted", 0)
    assert st.moe_backend == "torch_reference (cpu tensors)"


def test_moe_engine_batch_equivalence(moe_weights):
    """A concurrent batch (chunked prefill across sequences) matches the
    reference, and each sequence matches its solo run (drop-free path)."""
    ro, _, to, _ = _pair(moe_weights)(PROMPTS, 6)
    assert to == ro
    _, tcfg, _, npp = moe_weights
    for i, p in enumerate(PROMPTS):
        solo = LLMEngine(tcfg, EngineConfig(**BASE), params=tt.params_from_numpy(tcfg, npp),
                         device="cpu")
        assert solo.generate([p], SamplingParams(max_tokens=6, temperature=0.0))[
            "req-0"] == to[f"req-{i}"]


def test_moe_engine_multistep_decode(moe_weights):
    ro, _, to, st = _pair(moe_weights, decode_steps=4)(PROMPTS, 9)
    assert to == ro
    assert st.n_decode_calls > 0


def test_moe_engine_einsum_with_idle_slots_and_drops(moe_weights):
    """Capacity-einsum path, 6 decode slots for 3 requests (the reference's
    decode batch carries 3 idle rows), capacity factor 0.5: tokens identical
    and the dropped copies equal to the reference's."""
    ro, rs, to, st = _pair(moe_weights, cap=0.5, moe_dispatch="einsum",
                           max_batch_size=6, decode_steps=4)(PROMPTS, 9)
    assert to == ro
    assert st.moe_dispatch == "einsum"
    assert st.moe_dropped_tokens == rs.moe_dropped_tokens > 0


@pytest.mark.parametrize("decode_steps", [1, 4])
def test_moe_engine_eplb_rebalances(moe_weights, decode_steps):
    """EPLB every 2 routed steps (8 redundant slots): same tokens, same number
    of rebalances as the reference."""
    ro, rs, to, st = _pair(moe_weights, eplb=(8, 2, 8),
                           decode_steps=decode_steps)(PROMPTS, 9)
    assert to == ro
    assert st.eplb_rebalances == rs.eplb_rebalances >= 3


def test_moe_engine_config_checks(moe_weights):
    _, tcfg, _, npp = moe_weights
    for bad in (dict(moe_matmul="pallas"), dict(moe_dispatch="bogus"),
                dict(eplb=JaxEPLBConfig())):
        with pytest.raises(ValueError):
            LLMEngine(tcfg, EngineConfig(**BASE, **bad), device="cpu")
    dense = LLMEngine(dataclasses.replace(get_model_config("tiny"), dtype="float32"),
                      EngineConfig(**BASE), device="cpu")
    assert dense.stats.moe_dispatch == "n/a (dense model)"
