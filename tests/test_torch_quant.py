"""The port's int8 weight-only path against the JAX reference, on the CPU.

``llmd_tpu_torch.models.quant.quantize_params`` against
``llmd_tpu.models.quant.quantize_params`` on the same float32 weights (the
JAX ``init_params``): the int8 leaves bit-equal (both round half to even),
the scales to rel 1e-6. Then the int8 forward (``forward_core`` and
``unembed`` on the ``_q``/``_scale`` leaves) in float32 against the
reference's on the same quantized leaves: logits max abs <= 1e-4, same
argmax, expert counts and dropped copies equal. Then whole engines with
``quantize_weights="int8"`` and the reference's pipelined defaults on both
sides: greedy tokens, dropped copies and EPLB rebalances equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmd_tpu.core.request import SamplingParams as JaxSamplingParams
from llmd_tpu.engine import EngineConfig as JaxEngineConfig
from llmd_tpu.engine import LLMEngine as JaxEngine
from llmd_tpu.models import get_model_config as jax_model_config
from llmd_tpu.models import quant as jq
from llmd_tpu.models import transformer as jt
from llmd_tpu.ops import moe_dispatch as jmd
from llmd_tpu.parallel.eplb import EPLBConfig as JaxEPLBConfig
from llmd_tpu_torch.core.request import SamplingParams
from llmd_tpu_torch.engine import EngineConfig, LLMEngine
from llmd_tpu_torch.models import get_model_config
from llmd_tpu_torch.models import quant as tq
from llmd_tpu_torch.models import transformer as tt
from llmd_tpu_torch.ops.mla_decode import mla_paged_attention_latent
from llmd_tpu_torch.ops.paged_attention import paged_attention
from llmd_tpu_torch.parallel.eplb import EPLBConfig

# "tiny-untied": tiny with its own unembedding (the other branch of the
# unembedding's quantization)
MODELS = ["tiny", "tiny-untied", "tiny-moe", "tiny-mla", "tiny-mla-moe"]


@functools.cache
def _weights(model: str, dtype: str = "float32"):
    name, untie = (model[: -len("-untied")], True) if model.endswith("-untied") else (model, False)
    jcfg = dataclasses.replace(jax_model_config(name), dtype=dtype)
    tcfg = dataclasses.replace(get_model_config(name), dtype=dtype)
    if untie:
        jcfg = dataclasses.replace(jcfg, tie_embeddings=False)
        tcfg = dataclasses.replace(tcfg, tie_embeddings=False)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, {k: np.asarray(v) for k, v in jp.items()}


@functools.cache
def _quantized(model: str, dtype: str = "float32"):
    jcfg, tcfg, jp, npp = _weights(model, dtype)
    jq_params, _ = jq.quantize_params(jcfg, jp)
    tq_params = tq.quantize_params(tcfg, tt.params_from_numpy(tcfg, npp))
    return jcfg, tcfg, jq_params, tq_params


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model", MODELS)
def test_quantize_params_matches_reference(model, dtype):
    """Same leaves, int8 bit-equal, scales to rel 1e-6; the port's quantized
    layout is ``param_shapes(quantized=True)`` and ``params_from_numpy``
    takes the reference's quantized params as they are."""
    jcfg, tcfg, jqp, tqp = _quantized(model, dtype)
    assert set(jqp) == set(tqp)
    assert {k: tuple(v.shape) for k, v in tqp.items()} == tt.param_shapes(tcfg, quantized=True)
    n_int8 = 0
    for k, v in tqp.items():
        ref = np.asarray(jqp[k].astype(jnp.float32)) if k.endswith("_scale") else None
        if k.endswith("_q"):
            assert v.dtype == torch.int8
            np.testing.assert_array_equal(v.numpy(), np.asarray(jqp[k]))
            n_int8 += 1
        elif k.endswith("_scale"):
            assert v.dtype == torch.float32
            np.testing.assert_allclose(v.numpy(), ref, rtol=1e-6, atol=0)
    expected = {"tiny": 7, "tiny-untied": 7, "tiny-moe": 9, "tiny-mla": 4,
                "tiny-mla-moe": 6}[model]
    assert n_int8 == expected  # every quantizable leaf, plus the unembedding
    loaded = tt.params_from_numpy(tcfg, {k: np.asarray(v) for k, v in jqp.items()})
    for k, v in tqp.items():
        assert loaded[k].dtype == (v.dtype if k.endswith(("_q", "_scale")) else tcfg.torch_dtype)
        assert torch.equal(loaded[k].float(), v.float()), k


def test_quantize_rounds_half_to_even_and_keeps_zero_channels():
    """A channel whose values land on .5 steps rounds to even, as jnp.round;
    an all-zero channel gets scale 1, as in the reference."""
    w = np.zeros((1, 4, 3), np.float32)
    w[0, :, 0] = [127.0, 0.5, 1.5, -2.5]  # scale 1: q = 127, 0, 2, -2
    w[0, :, 1] = [1.0, 2.0, 3.0, 4.0]
    q, s = tq.quantize_one(torch.from_numpy(w), (1,))
    jqv, jsv = jq._quantize_one(jnp.asarray(w), (1,))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(s.numpy(), np.asarray(jsv))
    assert q[0, :, 0].tolist() == [127, 0, 2, -2] and s[0, 2] == 1.0


@pytest.mark.parametrize("model,path", [(m, "sorted") for m in MODELS] + [
    (m, "einsum") for m in MODELS if m.endswith("moe")])
def test_int8_forward_core_matches_reference(model, path):
    """Two mixed unified steps (and a decode step through K3's plain version
    on MLA) on the int8 leaves, float32: logits max abs <= 1e-4, same argmax,
    expert counts and dropped copies equal (capacity 0.5, so the einsum
    path drops)."""
    jcfg, tcfg, jqp, tqp = _quantized(model)
    jcfg = dataclasses.replace(jcfg, moe_capacity_factor=0.5)
    tcfg = dataclasses.replace(tcfg, moe_capacity_factor=0.5)
    rng = np.random.default_rng(4)
    P, ps = 16, 8
    jc, tc = jt.init_cache(jcfg, P, ps), tt.init_cache(tcfg, P, ps)
    table = [[3, 5, 7, -1], [9, 2, 11, -1]]
    steps = [([10, 7], [(0, 10), (0, 7)], paged_attention),
             ([1, 12], [(10, 11), (7, 19)], paged_attention)]
    if tcfg.is_mla:
        steps.append(([1, 1], [(11, 12), (19, 20)], mla_paged_attention_latent))
    sorted_path = path == "sorted"
    dropped = 0
    for q_lens, spans, attn in steps:
        N = sum(q_lens)
        toks = rng.integers(0, 288, N).astype(np.int32)
        pos = np.concatenate([np.arange(a, b) for a, b in spans]).astype(np.int32)
        sids = np.repeat(np.arange(len(q_lens)), q_lens).astype(np.int32)
        pts, lens = np.asarray(table, np.int32), np.array([b for _, b in spans], np.int32)
        cu = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
        hj, jc, cj, dj = jt.forward_core(
            jcfg, jqp, jc, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(sids),
            jnp.asarray(pts), jnp.asarray(lens),
            moe_dispatch_impl=jmd.make_sorted_dispatch() if sorted_path else None)
        ht, tc, ct, dt = tt.forward_core(
            tcfg, tqp, tc, _t(toks), _t(pos), _t(sids), _t(pts), _t(lens), cu_q_lens=_t(cu),
            num_seqs=_t(np.array([len(q_lens)], np.int32)), attn_impl=attn,
            moe_dispatch_impl=tt.SORTED_DISPATCH if sorted_path else None)
        lj = np.asarray(jt.unembed(jcfg, jqp, hj), np.float32)
        lt = tt.unembed(tcfg, tqp, ht).numpy()
        assert np.abs(lj - lt).max() <= 1e-4
        np.testing.assert_array_equal(lj.argmax(-1), lt.argmax(-1))
        if tcfg.is_moe:
            np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
            assert int(dt) == int(dj)
            dropped += int(dt)
    assert (dropped > 0) == (path == "einsum")


def test_int8_forward_equals_dequantized_plain_forward():
    """The int8 forward computes the plain forward on the dequantized weights
    ``q * s`` (the card's check of the int8 path, here in float32 on the
    CPU): logits to 1e-4, same argmax."""
    _, tcfg, _, tqp = _quantized("tiny-moe")
    plain = tq.dequantize_params(tqp, torch.float32)
    untied = dataclasses.replace(tcfg, tie_embeddings=False)
    assert set(plain) == set(tt.param_shapes(untied))
    rng = np.random.default_rng(2)
    toks = _t(rng.integers(0, 288, 12).astype(np.int32))
    pos = _t(np.arange(12, dtype=np.int32))
    sids, pts = _t(np.zeros(12, np.int32)), _t(np.array([[0, 1, -1, -1]], np.int32))
    lens, cu = _t(np.array([12], np.int32)), _t(np.array([0, 12], np.int32))
    ns = _t(np.array([1], np.int32))
    out = []
    for cfg, p in ((tcfg, tqp), (untied, plain)):
        h, *_ = tt.forward_core(cfg, p, tt.init_cache(cfg, 4, 8), toks, pos, sids, pts,
                                lens, cu_q_lens=cu, num_seqs=ns)
        out.append(tt.unembed(cfg, p, h))
    assert (out[0] - out[1]).abs().max() <= 1e-4
    assert torch.equal(out[0].argmax(-1), out[1].argmax(-1))


# ------------------------------------------------------------------ engine

BASE = dict(page_size=8, num_pages=128, max_model_len=256, max_batch_size=4,
            prefill_chunk=32, enable_prefix_caching=False, quantize_weights="int8")
PROMPTS = [list(range(3, 30)), list(range(40, 55)), list(range(100, 140))]
MAX_TOKENS = [9, 4, 13]


def _drive(eng, jax_side: bool) -> dict[str, list[int]]:
    for i, (p, n) in enumerate(zip(PROMPTS, MAX_TOKENS)):
        sp = (JaxSamplingParams if jax_side else SamplingParams)(max_tokens=n, temperature=0.0)
        eng.add_request(f"req-{i}", p, sp)
    out = {f"req-{i}": [] for i in range(len(PROMPTS))}
    steps = 0
    while eng.has_work():
        for o in eng.step():
            out[o.request_id].extend(o.new_token_ids)
        steps += 1
        assert steps < 500, "no forward progress"
    return out


@pytest.mark.parametrize("model,kw", [
    ("tiny", dict(decode_steps=4)),
    ("tiny-moe", dict(decode_steps=4, moe_dispatch="sorted")),
    ("tiny-moe", dict(decode_steps=4, moe_dispatch="einsum", max_batch_size=6, cap=0.5)),
    ("tiny-moe", dict(decode_steps=1, eplb=(8, 2, 8))),
    ("tiny-mla", dict(decode_steps=4)),
], ids=["tiny", "moe-sorted", "moe-einsum", "moe-eplb", "mla"])
def test_int8_engine_matches_reference(model, kw):
    """Both engines quantize the same float32 weights at construction,
    pipelined defaults on both sides: greedy tokens, dropped copies and EPLB
    rebalances equal; the port's int8 banks ran no grouped-GEMM kernel
    wrapper."""
    jcfg, tcfg, jp, npp = _weights(model)
    kw = dict(kw)
    cap, eplb = kw.pop("cap", None), kw.pop("eplb", None)
    if cap is not None:
        jcfg = dataclasses.replace(jcfg, moe_capacity_factor=cap)
        tcfg = dataclasses.replace(tcfg, moe_capacity_factor=cap)
    je = JaxEngine(jcfg, JaxEngineConfig(
        **BASE | kw, attn_impl="reference",
        eplb=None if eplb is None else JaxEPLBConfig(*eplb)), params=jp)
    te = LLMEngine(tcfg, EngineConfig(**BASE | kw, eplb=None if eplb is None
                                      else EPLBConfig(*eplb)),
                   params=tt.params_from_numpy(tcfg, npp), device="cpu")
    assert "unembed_q" in te.params and not any(
        k in te.params for k in ("wq", "wi", "moe_wi", "unembed"))
    assert te.params["embed"].dtype == torch.float32  # the gather table stays
    ro = _drive(je, True)
    to = _drive(te, False)
    assert to == ro
    assert te.stats.moe_dropped_tokens == je.stats.moe_dropped_tokens
    assert te.stats.eplb_rebalances == je.stats.eplb_rebalances
    if kw.get("moe_dispatch") == "einsum":
        assert te.stats.moe_dropped_tokens > 0
    if eplb is not None:
        assert te.stats.eplb_rebalances >= 3
        # the slot buffers hold int8 banks and their scales, gathered together
        ep = te._eplb_params
        assert ep["moe_wi_q"].dtype == torch.int8 and ep["moe_wi_scale"].dtype == torch.float32
        assert ep["moe_wi_q"].shape[1] == ep["moe_wi_scale"].shape[1] == 16
        assert "moe_wi" not in ep


def test_int8_engine_config_checks():
    tcfg = dataclasses.replace(get_model_config("tiny-moe"), dtype="float32")
    with pytest.raises(ValueError, match="quantize_weights"):
        LLMEngine(tcfg, EngineConfig(quantize_weights="int4"), device="cpu")
    with pytest.raises(ValueError, match="incompatible with quantize_weights"):
        LLMEngine(tcfg, EngineConfig(quantize_weights="int8", moe_matmul="pallas"),
                  device="cpu")
    eng = LLMEngine(tcfg, EngineConfig(quantize_weights="int8"), device="cpu")
    assert eng.quantization == "int8" and eng.params["moe_wi_q"].dtype == torch.int8
