"""PyTorch port's MLA slice against the JAX reference, on the CPU.

Covers the MLA parameters and the single-plane latent pool, K1's plain
version on that pool (the unified program's attention) against
``ragged_paged_attention_xla``, K3's plain version against the Pallas
``mla_decode`` kernel run in interpret mode, ``forward_core`` on ``tiny-mla``
and ``tiny-mla-moe``, and the engine (greedy tokens identical to the JAX
engine, cases mirroring ``tests/test_mla.py``). The reference pads the latent
row to 128 lanes; the port does not, so the port's inputs are zero-padded for
the JAX side and the first ``r + dr`` lanes compared. Inputs come from numpy
seeds and go to both sides; tolerances are stated per test.
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
from llmd_tpu.models import transformer as jt
from llmd_tpu.ops import mla_decode as jmla
from llmd_tpu.ops import moe_dispatch as jmd
from llmd_tpu_torch.core.request import SamplingParams
from llmd_tpu_torch.engine import EngineConfig, LLMEngine
from llmd_tpu_torch.engine.programs import select_decode_attn_impl
from llmd_tpu_torch.models import get_model_config
from llmd_tpu_torch.models import transformer as tt
from llmd_tpu_torch.ops.mla_decode import (
    mla_decode, mla_decode_ref, mla_paged_attention_latent)
from llmd_tpu_torch.ops.paged_attention import paged_attention, paged_attention_ref

JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(x):
    return np.asarray(x, np.float32)


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _pad(a, width=128):
    """Zero-pad the last axis to the reference's lane width."""
    return np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, width - a.shape[-1])])


def _cfgs(name, dtype="float32"):
    return (dataclasses.replace(jax_model_config(name), dtype=dtype),
            dataclasses.replace(get_model_config(name), dtype=dtype))


@functools.cache
def _weights(name):
    """(jax cfg, port cfg, reference params, the same as numpy), float32."""
    jcfg, tcfg = _cfgs(name)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, {k: np.asarray(v) for k, v in jp.items()}


# ------------------------------------------------------------ params and pool


@pytest.mark.parametrize("name", ["tiny-mla", "tiny-mla-moe", "moe-wide-mla"])
def test_mla_param_shapes_match_reference(name):
    jcfg, tcfg = _cfgs(name)
    ref = {k: tuple(v.shape) for k, v in
           jax.eval_shape(lambda k: jt.init_params(jcfg, k), jax.random.PRNGKey(0)).items()}
    assert tt.param_shapes(tcfg) == ref
    assert "wq" not in ref and "wk" not in ref and "wv" not in ref
    if name != "moe-wide-mla":  # full-size weights: shapes only
        got = tt.init_params(tcfg, torch.Generator().manual_seed(0))
        assert {k: tuple(v.shape) for k, v in got.items()} == ref


def test_mla_init_params_scales_and_norm():
    """The reference's scales: mla_wq/wdkv/wkr D^-0.5, mla_wuk dn^-0.5,
    mla_wuv r^-0.5, wo (H*dv)^-0.5; mla_kv_norm is ones (a norm)."""
    _, cfg = _cfgs("tiny-mla")
    p = tt.init_params(cfg, torch.Generator().manual_seed(3))
    assert torch.equal(p["mla_kv_norm"], torch.ones_like(p["mla_kv_norm"]))
    D, H, r = cfg.hidden_size, cfg.num_heads, cfg.mla_kv_lora_rank
    dn, dv = cfg.mla_qk_nope_dim, cfg.mla_v_head_dim
    for name, scale in (("mla_wq", D ** -0.5), ("mla_wdkv", D ** -0.5),
                        ("mla_wuk", dn ** -0.5), ("mla_wuv", r ** -0.5),
                        ("wo", (H * dv) ** -0.5)):
        assert abs(p[name].std().item() / scale - 1) < 0.05, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_numpy_round_trips_reference_params(dtype):
    jcfg, tcfg = _cfgs("tiny-mla-moe", dtype)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(1))
    tp = tt.params_from_numpy(tcfg, {k: np.asarray(v) for k, v in jp.items()})
    assert set(tp) == set(jp)
    for k in jp:
        assert tp[k].dtype == TD[dtype]
        np.testing.assert_array_equal(tp[k].float().numpy(), _np(jp[k]), err_msg=k)


def test_latent_pool_is_one_unpadded_plane():
    for name, width in (("tiny-mla", 80), ("moe-wide-mla", 160)):
        cfg = get_model_config(name)
        pool = tt.init_cache(cfg, 6, 8)
        assert tuple(pool.shape) == (cfg.num_layers * 6 + 1, 8, 1, width)  # + dump page
        assert pool.dtype == torch.bfloat16 and not pool.any()
    # the reference's pool is the same plane, lane-padded
    assert jt.init_cache(jax_model_config("tiny-mla"), 6, 8).shape == (12, 8, 1, 128)


def test_write_kv_single_plane_matches_reference():
    """The latent row is written once; v is ignored; slot -1 goes to the
    dump row (the port's pool ends in one, the reference's drops it)."""
    rng = np.random.default_rng(2)
    S, W = 40, 80
    cache = _pad(rng.standard_normal((S, 1, W), np.float32))
    k = rng.standard_normal((6, 1, W), np.float32)
    v = rng.standard_normal((6, 1, W), np.float32)
    slots = np.array([3, -1, 17, 39, -1, 0], np.int32)
    ref = _np(jt.write_kv(jnp.asarray(cache), jnp.asarray(_pad(k)), jnp.asarray(_pad(v)),
                          jnp.asarray(slots)))
    pool = np.concatenate([cache[..., :W], np.zeros((1, 1, W), np.float32)])
    got = tt.write_kv(_t(pool), _t(k), _t(v), _t(slots)).numpy()
    np.testing.assert_array_equal(got[:S], ref[..., :W])
    assert any(np.array_equal(got[S], k[i]) for i in (1, 4))  # one padding row's


# ------------------------------------------- K1 on the single-plane pool


def _latent_mixed_case(seed=3, H=4, W=80, ps=8):
    """Decode rows, a fresh prefill chunk, a continuation chunk, an empty
    table row and padding query rows over a random latent pool with -1
    table entries."""
    rng = np.random.default_rng(seed)
    q_lens = [1, 13, 1, 24, 7]
    kv_lens = [30, 13, 9, 55, 40]  # seq 3 and 4: continuation chunks
    B, maxp, P = len(q_lens) + 1, 9, 40
    pts = np.full((B, maxp), -1, np.int32)
    perm = rng.permutation(P)
    o = 0
    for b, kl in enumerate(kv_lens):
        n = -(-kl // ps)
        pts[b, :n] = perm[o:o + n]
        o += n
    N = sum(q_lens) + 4
    pos = np.full((N,), -1, np.int32)
    sids = np.zeros((N,), np.int32)
    cu = np.zeros((B + 1,), np.int32)
    off = 0
    for b, (ql, kl) in enumerate(zip(q_lens, kv_lens)):
        pos[off:off + ql] = np.arange(kl - ql, kl)
        sids[off:off + ql] = b
        off += ql
        cu[b + 1] = off
    cu[len(q_lens) + 1:] = off
    lens = np.ones((B,), np.int32)
    lens[:len(q_lens)] = kv_lens
    return dict(q=rng.standard_normal((N, H, W), np.float32),
                pool=rng.standard_normal((P, ps, 1, W), np.float32), pts=pts, pos=pos,
                sids=sids, lens=lens, cu=cu, ns=np.array([len(q_lens)], np.int32),
                valid=off, scale=(16 + 16) ** -0.5)


def test_single_plane_attention_matches_reference():
    """K1's plain version reads the one plane as K and V with Hk = 1, as
    ``ragged_paged_attention_xla`` does: float32, valid rows, atol 1e-5."""
    c = _latent_mixed_case()
    W = c["q"].shape[-1]
    ref = jt.ragged_paged_attention_xla(
        jnp.asarray(_pad(c["q"])), jnp.asarray(_pad(c["pool"])), jnp.asarray(c["pts"]),
        jnp.asarray(c["pos"]), jnp.asarray(c["sids"]), jnp.asarray(c["lens"]),
        scale=c["scale"])
    got = paged_attention(_t(c["q"]), _t(c["pool"]), _t(c["pts"]), _t(c["pos"]),
                          _t(c["sids"]), _t(c["lens"]), scale=c["scale"],
                          cu_q_lens=_t(c["cu"]), num_seqs=_t(c["ns"]))
    v = c["valid"]
    np.testing.assert_allclose(got[:v].numpy(), _np(ref)[:v, :, :W], atol=1e-5)


# ---------------------------------------------------- K3's plain version


def _latent_decode_case(seed=7, H=4, W=80, ps=8):
    """B = 5 one-token queries over a single-plane pool: kv_lens 0 (idle), 1,
    3 (partial page), 17 and 48 (all six pages); -1 past each sequence."""
    rng = np.random.default_rng(seed)
    kv_lens = np.array([0, 1, 3, 17, 48], np.int32)
    B, maxp, P = len(kv_lens), 6, 16
    pts = np.full((B, maxp), -1, np.int32)
    nxt = 0
    for b in range(B):
        for j in range(-(-int(kv_lens[b]) // ps)):
            pts[b, j] = nxt
            nxt += 1
    return (rng.standard_normal((B, H, W), np.float32),
            rng.standard_normal((P, ps, 1, W), np.float32), pts, kv_lens)


# f32: online softmax over pages vs one softmax, summation order only: 2e-6.
# bf16: both sides pre-scale q and round it to bf16, accumulate in f32 and
# round the output once; they differ by that rounding: 2e-2.
@pytest.mark.parametrize("dtype,atol", [("float32", 2e-6), ("bfloat16", 2e-2)])
def test_latent_decode_plain_matches_pallas_kernel(dtype, atol):
    q, pool, pts, kv_lens = _latent_decode_case()
    W, scale = q.shape[-1], (64 + 16) ** -0.5
    jd, td = JD[dtype], TD[dtype]
    B = q.shape[0]
    kw = dict(positions=jnp.asarray(np.maximum(kv_lens - 1, 0)),
              seq_slots=jnp.arange(B, dtype=jnp.int32), kv_lens=jnp.asarray(kv_lens),
              scale=scale)
    ref = _np(jmla.mla_paged_attention_latent(     # Pallas, interpret mode on the CPU
        jnp.asarray(_pad(q), jd), jnp.asarray(_pad(pool), jd), jnp.asarray(pts), **kw))
    qt, pt_ = _t(q, td), _t(pool, td)
    plain = mla_decode_ref(qt, pt_, _t(np.maximum(pts, 0)), _t(kv_lens), scale=scale)
    adapter = mla_paged_attention_latent(
        qt, pt_, _t(pts), _t(np.maximum(kv_lens - 1, 0)), torch.arange(B),
        _t(kv_lens), scale=scale)
    for got in (plain, adapter):
        assert got.dtype == td
        np.testing.assert_allclose(got.float().numpy(), ref[..., :W], atol=atol)
        assert not got[0].any()  # idle row (kv_len 0): exact zeros
    assert not ref[0].any() and not ref[..., W:].any()


def test_latent_decode_wrapper_on_cpu_uses_plain_version():
    q, pool, pts, kv_lens = _latent_decode_case(seed=8)
    launches, calls = mla_decode.launches, mla_decode_ref.calls
    out = mla_decode(_t(q), _t(pool), _t(np.maximum(pts, 0)), _t(kv_lens), scale=0.1)
    assert mla_decode.launches == launches  # no kernel launch on the CPU
    assert mla_decode_ref.calls == calls + 1
    assert out.shape == q.shape
    with pytest.raises(ValueError, match="one query row per sequence"):
        mla_paged_attention_latent(_t(q[:3]), _t(pool), _t(pts), None, None,
                                   _t(kv_lens), scale=0.1)


# ------------------------------------------------------------ forward_core


@pytest.mark.parametrize("name,path", [("tiny-mla", "dense"), ("tiny-mla-moe", "sorted"),
                                       ("tiny-mla-moe", "einsum")])
def test_forward_core_mla_matches_reference(name, path):
    """Two mixed flat batches (unified program: K1 on the latent pool), then
    a decode batch through the decode program's impl (K3's adapter) on the
    port side, all in float32 against the JAX ``forward_core`` on the same
    weights: logits max abs <= 1e-4, same argmax, expert counts and dropped
    copies equal, and the latent pools equal to 1e-5."""
    jcfg, tcfg, jp, npp = _weights(name)
    jcfg = dataclasses.replace(jcfg, moe_capacity_factor=0.5)  # the einsum drops
    tcfg = dataclasses.replace(tcfg, moe_capacity_factor=0.5)
    tp = tt.params_from_numpy(tcfg, npp)
    rng = np.random.default_rng(4)
    P, ps = 16, 8
    jc, tc = jt.init_cache(jcfg, P, ps), tt.init_cache(tcfg, P, ps)
    table = [[3, 5, 7, -1], [9, 2, 11, -1]]
    steps = [([10, 7], [(0, 10), (0, 7)], paged_attention),
             ([1, 12], [(10, 11), (7, 19)], paged_attention),
             ([1, 1], [(11, 12), (19, 20)], mla_paged_attention_latent)]
    for q_lens, spans, attn in steps:
        N = sum(q_lens)
        toks = rng.integers(0, 288, N).astype(np.int32)
        pos = np.concatenate([np.arange(a, b) for a, b in spans]).astype(np.int32)
        sids = np.repeat(np.arange(len(q_lens)), q_lens).astype(np.int32)
        pts, lens = np.asarray(table, np.int32), np.array([b for _, b in spans], np.int32)
        cu = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
        sorted_path = path == "sorted"
        hj, jc, cj, dj = jt.forward_core(
            jcfg, jp, jc, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(sids),
            jnp.asarray(pts), jnp.asarray(lens),
            moe_dispatch_impl=jmd.make_sorted_dispatch() if sorted_path else None)
        ht, tc, ct, dt = tt.forward_core(
            tcfg, tp, tc, _t(toks), _t(pos), _t(sids), _t(pts), _t(lens), cu_q_lens=_t(cu),
            num_seqs=_t(np.array([len(q_lens)], np.int32)), attn_impl=attn,
            moe_dispatch_impl=tt.SORTED_DISPATCH if sorted_path else None)
        lj, lt = _np(jt.unembed(jcfg, jp, hj)), tt.unembed(tcfg, tp, ht).numpy()
        assert np.abs(lj - lt).max() <= 1e-4
        np.testing.assert_array_equal(lj.argmax(-1), lt.argmax(-1))
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        assert int(dt) == int(dj)
    np.testing.assert_allclose(tc[:-1].numpy(), _np(jc)[..., :tcfg.kv_cache_head_dim],
                               atol=1e-5)  # all but the dump page
    assert not _np(jc)[..., tcfg.kv_cache_head_dim:].any()


# ------------------------------------------------------------------ engine

BASE = dict(page_size=8, num_pages=128, max_model_len=256, max_batch_size=4,
            prefill_chunk=32, decode_steps=4)
PROMPTS = [list(range(3, 40)), list(range(50, 75)), list(range(80, 140))]


@pytest.fixture(scope="module")
def tiny_mla():
    jcfg, tcfg, jp, npp = _weights("tiny-mla")
    refs = {}

    def reference(prompts, max_tokens, **kw):
        """The JAX engine's greedy tokens (XLA attention, prefix caching off,
        synchronous loop; greedy tokens do not depend on the pipelined
        dispatch the port runs by default), one engine per config, memoised."""
        key = tuple(sorted(kw.items()))
        if key not in refs:
            refs[key] = JaxEngine(jcfg, JaxEngineConfig(
                **BASE | kw, attn_impl="reference", enable_prefix_caching=False,
                pipeline_decode=False, pipeline_prefill_sample=False), params=jp)
        return refs[key].generate(prompts, JaxSamplingParams(max_tokens=max_tokens,
                                                             temperature=0.0))

    def port(**kw):
        return LLMEngine(tcfg, EngineConfig(**BASE | kw),
                         params=tt.params_from_numpy(tcfg, npp), device="cpu")

    return reference, port


def _greedy(n):
    return SamplingParams(max_tokens=n, temperature=0.0)


def test_mla_engine_single_request_greedy(tiny_mla):
    reference, port = tiny_mla
    p = list(range(10, 30))
    out = port().generate([p], _greedy(8))
    assert len(out["req-0"]) == 8 and out == reference([p], 8)


def test_mla_engine_chunked_prefill_matches_unchunked(tiny_mla):
    reference, port = tiny_mla
    prompt = list(range(5, 70))
    o1 = port(prefill_chunk=128).generate([prompt], _greedy(6))
    o2 = port(prefill_chunk=16).generate([prompt], _greedy(6))
    assert o1 == o2 == reference([prompt], 6)


def test_mla_engine_batch_equivalence(tiny_mla):
    reference, port = tiny_mla
    batch = port().generate(PROMPTS, _greedy(5))
    assert batch == reference(PROMPTS, 5)
    for i, p in enumerate(PROMPTS):
        assert port().generate([p], _greedy(5))["req-0"] == batch[f"req-{i}"]


def test_mla_engine_prefix_cache_reuse(tiny_mla):
    """Reused latent pages give the fresh run's tokens; different suffixes
    give different continuations."""
    reference, port = tiny_mla
    shared = list(range(1, 65))  # 8 full pages
    eng = port()
    a = eng.generate([shared + [70, 71]], _greedy(4))
    b = eng.generate([shared + [90, 91]], _greedy(4))
    assert b == port().generate([shared + [90, 91]], _greedy(4))
    assert b == reference([shared + [90, 91]], 4)
    assert a["req-0"] != b["req-0"]


def test_mla_engine_preemption_recompute(tiny_mla):
    reference, port = tiny_mla
    prompts = [list(range(1, 30)), list(range(60, 95))]
    tight = port(num_pages=10, max_batch_size=2, enable_prefix_caching=False)
    got = tight.generate(prompts, _greedy(12))
    assert tight.stats.total_preemptions > 0
    assert got == reference(prompts, 12, max_batch_size=2)


@pytest.mark.parametrize("decode_steps", [1, 4])
def test_mla_engine_decode_steps(tiny_mla, decode_steps):
    reference, port = tiny_mla
    eng = port(decode_steps=decode_steps)
    out = eng.generate(PROMPTS, _greedy(9))
    assert out == reference(PROMPTS, 9, decode_steps=decode_steps)
    assert eng.stats.n_decode_calls > 0


@pytest.mark.parametrize("dispatch", ["sorted", "einsum"])
def test_mla_moe_engine_matches_reference(dispatch):
    """tiny-mla-moe: greedy tokens and dropped copies equal to the JAX
    engine's on both dispatch paths (einsum at capacity 0.5 with idle decode
    slots, where copies drop)."""
    jcfg, tcfg = _cfgs("tiny-mla-moe")
    kw = dict(moe_dispatch=dispatch)
    if dispatch == "einsum":
        jcfg = dataclasses.replace(jcfg, moe_capacity_factor=0.5)
        tcfg = dataclasses.replace(tcfg, moe_capacity_factor=0.5)
        kw["max_batch_size"] = 6
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    je = JaxEngine(jcfg, JaxEngineConfig(
        **BASE | kw, attn_impl="reference", enable_prefix_caching=False,
        pipeline_decode=False, pipeline_prefill_sample=False), params=jp)
    te = LLMEngine(tcfg, EngineConfig(**BASE | kw, enable_prefix_caching=False,
                                      pipeline_decode=False, pipeline_prefill_sample=False),
                   params=tt.params_from_numpy(tcfg, {k: np.asarray(v) for k, v in jp.items()}),
                   device="cpu")
    ro = je.generate(PROMPTS, JaxSamplingParams(max_tokens=9, temperature=0.0))
    to = te.generate(PROMPTS, _greedy(9))
    assert to == ro
    assert te.stats.moe_dispatch == dispatch
    assert te.stats.moe_dropped_tokens == je.stats.moe_dropped_tokens
    assert (te.stats.moe_dropped_tokens > 0) == (dispatch == "einsum")


# -------------------------------------------------------------- provenance


def test_mla_attention_provenance_on_cpu():
    _, tcfg = _cfgs("tiny-mla")
    eng = LLMEngine(tcfg, EngineConfig(**BASE), device="cpu")
    assert eng.attn_backend == eng.stats.attn_backend == (
        "torch_reference_latent+torch_mla_latent_decode (cpu tensors)")
    assert eng._attn == {"unified": paged_attention, "decode": mla_paged_attention_latent}
    dense = LLMEngine(get_model_config("tiny"), EngineConfig(**BASE), device="cpu")
    assert dense.attn_backend == "torch_reference (cpu tensors)"
    assert select_decode_attn_impl(dense, paged_attention_ref) is paged_attention_ref
    assert select_decode_attn_impl(eng, paged_attention) is mla_paged_attention_latent


def test_lora_on_mla_raises():
    _, tcfg = _cfgs("tiny-mla")
    with pytest.raises(NotImplementedError, match="LoRA.*MLA"):
        tt.check_supported(tcfg, lora=True)
    params = {k: np.zeros(v, np.float32) for k, v in tt.param_shapes(tcfg).items()}
    with pytest.raises(NotImplementedError, match="LoRA.*MLA"):
        tt.params_from_numpy(tcfg, {**params, "lora_A_wq": np.zeros(1, np.float32)})
    tt.check_supported(tcfg)  # MLA itself is served
