"""PyTorch port's model layer against the JAX reference, on the CPU.

Inputs are made with numpy from a seed and handed to both sides; JAX runs on
the CPU. Tolerances are stated per test.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmd_tpu.models import transformer as jt
from llmd_tpu.models.registry import MODEL_REGISTRY as JAX_REGISTRY
from llmd_tpu_torch.models import MODEL_REGISTRY, get_model_config
from llmd_tpu_torch.models import transformer as tt
from llmd_tpu_torch.ops.paged_attention import (
    bf16_rounding_units, paged_attention, paged_attention_ref)


def _np(x):
    return np.asarray(x, np.float32)


def test_registry_matches_reference_field_for_field():
    assert list(MODEL_REGISTRY) == list(JAX_REGISTRY)
    for name, cfg in MODEL_REGISTRY.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(JAX_REGISTRY[name]), name
    assert get_model_config("llama-1b").torch_dtype == torch.bfloat16


@pytest.mark.parametrize("name", ["tiny-moe", "tiny-mla", "tiny-vl", "vl-uneven-pool"])
def test_unserved_architectures_raise(name):
    if name == "vl-uneven-pool":
        # 16 patches do not pool into 3 rows: the reference's tower cannot
        # run it either, so the port refuses it at construction
        bad = dataclasses.replace(get_model_config("tiny-vl"), mm_tokens=3)
        with pytest.raises(NotImplementedError, match="do not pool"):
            tt.init_params(bad, torch.Generator().manual_seed(0))
        return
    if name == "tiny-vl":
        # served since the vision slice: the params build, and forward_core
        # writes the media rows over the placeholders as the reference's does
        # (float32, logits max abs <= 1e-4)
        tt.init_params(get_model_config(name), torch.Generator().manual_seed(0))
        jcfg, tcfg, jp, tp = _params(name)
        k, ph = tcfg.mm_tokens, tcfg.mm_placeholder_id
        toks = np.array([5, 6] + [ph] * k + [7, 8], np.int32)
        N = len(toks)
        rng = np.random.default_rng(6)
        emb = rng.standard_normal((N, tcfg.hidden_size)).astype(np.float32)
        mask = toks == ph
        args = (toks, np.arange(N, dtype=np.int32), np.zeros(N, np.int32),
                np.array([[0, 1, -1]], np.int32), np.array([N], np.int32))
        hj = jt.forward_core(jcfg, jp, jt.init_cache(jcfg, 4, 8), *map(jnp.asarray, args),
                             mm_embeds=jnp.asarray(emb), mm_mask=jnp.asarray(mask))[0]
        t = torch.from_numpy
        run = lambda **kw: tt.forward_core(  # noqa: E731
            tcfg, tp, tt.init_cache(tcfg, 4, 8), *map(t, args),
            cu_q_lens=t(np.array([0, N], np.int32)), num_seqs=t(np.array([1], np.int32)),
            **kw)[0]
        ht = run(mm_embeds=t(emb), mm_mask=t(mask))
        lj, lt = _np(jt.unembed(jcfg, jp, hj)), tt.unembed(tcfg, tp, ht).numpy()
        assert np.abs(lj - lt).max() <= 1e-4
        assert np.abs(lt - tt.unembed(tcfg, tp, run()).numpy()).max() > 1e-2
        return
    cfg = get_model_config(name)
    if name in ("tiny-moe", "tiny-mla"):
        # MoE, MLA and int8 weights (int8 expert banks, the int8 attention
        # output projection) are served since their slices; LoRA adapters
        # on MoE since theirs (a malformed bank is refused), not on MLA
        params = {k: np.zeros(v, np.float32)
                  for k, v in tt.param_shapes(cfg, quantized=True).items()}
        key = "moe_wi" if name == "tiny-moe" else "wo"
        params[key + "_q"] = params[key + "_q"].astype(np.int8)
        assert tt.params_from_numpy(cfg, params)[key + "_q"].dtype == torch.int8
        bad = {**params, "lora_A_wq": np.zeros(1, np.float32)}
        if cfg.is_mla:
            with pytest.raises(NotImplementedError, match="LoRA adapters are unsupported on MLA"):
                tt.params_from_numpy(cfg, bad)
        else:
            with pytest.raises(ValueError, match="LoRA bank"):
                tt.params_from_numpy(cfg, bad)
        return


def test_building_blocks_match_reference():
    """rms_norm / rope / swiglu in float32: atol 1e-5 (op-order rounding)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 3, 64), np.float32)
    w = rng.standard_normal((64,), np.float32)
    got = tt.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
    np.testing.assert_allclose(got.numpy(), _np(jt.rms_norm(x, w, 1e-6)), atol=1e-5)

    pos = rng.integers(-1, 3000, (5,)).astype(np.int32)
    got = tt.rope(torch.from_numpy(x), torch.from_numpy(pos), 500000.0)
    ref = jt.rope(jnp.asarray(x), jnp.asarray(pos), 500000.0)
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=1e-5)

    h = rng.standard_normal((7, 32), np.float32)
    wi = rng.standard_normal((32, 96), np.float32) * 0.2
    wo = rng.standard_normal((48, 32), np.float32) * 0.2
    got = tt.swiglu(torch.from_numpy(h), torch.from_numpy(wi), torch.from_numpy(wo))
    np.testing.assert_allclose(got.numpy(), _np(jt.swiglu(h, wi, wo)), atol=1e-5)


def test_rms_norm_rounds_before_scaling_in_bf16():
    """bf16: the normalised value is cast to bf16 BEFORE the weight multiply,
    as in the reference — bitwise equal."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 128), np.float32)
    w = rng.standard_normal((128,), np.float32)
    got = tt.rms_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(), 1e-6)
    ref = jt.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), 1e-6)
    np.testing.assert_array_equal(got.float().numpy(), _np(ref))


def test_write_kv_matches_reference_and_drops_padding():
    rng = np.random.default_rng(2)
    S, Hk, D = 40, 2, 32
    cache = rng.standard_normal((S, 2 * Hk, D), np.float32)
    k = rng.standard_normal((6, Hk, D), np.float32)
    v = rng.standard_normal((6, Hk, D), np.float32)
    slots = np.array([3, -1, 17, 39, -1, 0], np.int32)
    ref = _np(jt.write_kv(jnp.asarray(cache), jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(slots)))
    # the port's pool ends in the dump row, where slot -1 goes
    pool = np.concatenate([cache, np.zeros((1, 2 * Hk, D), np.float32)])
    got = tt.write_kv(torch.from_numpy(pool), torch.from_numpy(k),
                      torch.from_numpy(v), torch.from_numpy(slots)).numpy()
    np.testing.assert_array_equal(got[:S], ref)
    kv = np.stack([k, v], 2).reshape(6, 2 * Hk, D)
    assert any(np.array_equal(got[S], kv[i]) for i in (1, 4))  # one padding row's


def _ragged_case(dtype, seed=3):
    """3 ragged prefill chunks + 3 decode rows over a random pool, with
    unmapped (-1) table entries, an empty table row and a padding tail."""
    rng = np.random.default_rng(seed)
    H, Hk, D, ps, P = 8, 2, 32, 8, 40
    q_lens = [13, 1, 24, 1, 7, 1]
    kv_lens = [13, 30, 40, 9, 55, 1]
    B, maxp = len(q_lens) + 1, 9
    pts = np.full((B, maxp), -1, np.int32)
    perm = rng.permutation(P)
    o = 0
    for b, kl in enumerate(kv_lens):
        n = -(-kl // ps)
        pts[b, :n] = perm[o:o + n]
        o += n
    N = sum(q_lens) + 5
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
    q = rng.standard_normal((N, H, D), np.float32)
    pool = rng.standard_normal((P, ps, 2 * Hk, D), np.float32)
    return dict(q=q, pool=pool, pts=pts, pos=pos, sids=sids, lens=lens, cu=cu,
                ns=np.array([len(q_lens)], np.int32), valid=off, scale=D ** -0.5)


# bf16: both sides round q/K/V identically (same bf16 inputs); outputs differ by
# the final bf16 rounding and the bf16 cast of the probabilities: 2e-2.
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_plain_attention_matches_reference(dtype, atol):
    c = _ragged_case(dtype)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    ref = jt.ragged_paged_attention_xla(
        jnp.asarray(c["q"], jd), jnp.asarray(c["pool"], jd), jnp.asarray(c["pts"]),
        jnp.asarray(c["pos"]), jnp.asarray(c["sids"]), jnp.asarray(c["lens"]),
        scale=c["scale"])
    t = torch.from_numpy
    got = paged_attention_ref(
        t(c["q"]).to(td), t(c["pool"]).to(td), t(c["pts"]), t(c["pos"]),
        t(c["sids"]), t(c["lens"]), scale=c["scale"], cu_q_lens=t(c["cu"]),
        num_seqs=t(c["ns"]))
    v = c["valid"]  # padding rows: the reference returns uniform garbage
    np.testing.assert_allclose(got[:v].float().numpy(), _np(ref)[:v], atol=atol)


def test_bf16_rounding_units_tell_f32_accumulation_from_bf16():
    """The kernel's bf16 check: a float32 result rounded once to bf16 reads
    <= 1 unit against the float32 plain version on the same bf16 inputs; the
    plain version run in bf16 (probabilities cast to bf16 before P.V) reads
    above 1."""
    c = _ragged_case("bfloat16")
    t = torch.from_numpy
    q, pool = t(c["q"]).bfloat16(), t(c["pool"]).bfloat16()
    rest = (t(c["pts"]), t(c["pos"]), t(c["sids"]), t(c["lens"]))
    v = c["valid"]
    ref = paged_attention_ref(q.float(), pool.float(), *rest, scale=c["scale"])[:v]
    assert bf16_rounding_units(ref.bfloat16(), ref) <= 1.0
    plain = paged_attention_ref(q, pool, *rest, scale=c["scale"])[:v]
    assert bf16_rounding_units(plain, ref) > 1.0


def test_forward_core_attends_through_the_wrapper():
    default = inspect.signature(tt.forward_core).parameters["attn_impl"].default
    assert default is paged_attention


def test_wrapper_on_cpu_tensors_uses_plain_version():
    c = _ragged_case("float32")
    t = torch.from_numpy
    launches, calls = paged_attention.launches, paged_attention_ref.calls
    got = paged_attention(t(c["q"]), t(c["pool"]), t(c["pts"]), t(c["pos"]),
                          t(c["sids"]), t(c["lens"]), scale=c["scale"],
                          cu_q_lens=t(c["cu"]), num_seqs=t(c["ns"]))
    assert paged_attention.launches == launches  # no kernel launch on the CPU
    assert paged_attention_ref.calls == calls + 1
    assert got.shape == c["q"].shape


def _params(name, dtype="float32"):
    jcfg = dataclasses.replace(JAX_REGISTRY[name], dtype=dtype)
    tcfg = dataclasses.replace(get_model_config(name), dtype=dtype)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tt.params_from_numpy(tcfg, {k: np.asarray(v) for k, v in jp.items()})
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("name", ["tiny", "tiny64"])
def test_forward_core_logits_match_reference(name):
    """Mixed flat batch (two prefill chunks, then a step with a decode row and a
    second chunk) in float32: logits max abs diff <= 1e-4, same argmax."""
    jcfg, tcfg, jp, tp = _params(name)
    rng = np.random.default_rng(4)
    P, ps = 16, 8
    steps = [
        # (tokens, positions, seq_slots, page_tables, kv_lens, cu)
        ([10, 7], [(0, 10), (0, 7)], [[3, 5, -1, -1], [9, -1, -1, -1]]),
        ([1, 12], [(10, 11), (7, 19)], [[3, 5, -1, -1], [9, 2, 11, -1]]),
    ]
    jc = jt.init_cache(jcfg, P, ps)
    tc = tt.init_cache(tcfg, P, ps)
    for q_lens, spans, table in steps:
        N = sum(q_lens)
        toks = rng.integers(0, 288, N).astype(np.int32)
        pos = np.concatenate([np.arange(a, b) for a, b in spans]).astype(np.int32)
        sids = np.repeat(np.arange(len(q_lens)), q_lens).astype(np.int32)
        pts = np.asarray(table, np.int32)
        lens = np.array([b for _, b in spans], np.int32)
        cu = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
        hj, jc, _, _ = jt.forward_core(jcfg, jp, jc, jnp.asarray(toks), jnp.asarray(pos),
                                       jnp.asarray(sids), jnp.asarray(pts),
                                       jnp.asarray(lens))
        t = torch.from_numpy
        ht, tc, cnt, drop = tt.forward_core(
            tcfg, tp, tc, t(toks), t(pos), t(sids), t(pts), t(lens), cu_q_lens=t(cu),
            num_seqs=t(np.array([len(q_lens)], np.int32)))
        assert cnt.shape == (tcfg.num_layers, 0) and int(drop) == 0  # dense model
        lj = _np(jt.unembed(jcfg, jp, hj))
        lt = tt.unembed(tcfg, tp, ht).numpy()
        assert np.abs(lj - lt).max() <= 1e-4
        np.testing.assert_array_equal(lj.argmax(-1), lt.argmax(-1))
    # the pools hold the same K/V (the reference's is lane-padded)
    np.testing.assert_allclose(tc[:-1].numpy(), _np(jc)[..., :tcfg.head_dim],
                               atol=1e-5)  # all but the dump page


def test_forward_matches_reference():
    """[B, T] wrapper with a padded row, float32: valid logits within 1e-4."""
    jcfg, tcfg, jp, tp = _params("tiny")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 288, (2, 6)).astype(np.int32)
    pos = np.array([np.arange(6), [0, 1, 2, 3, -1, -1]], np.int32)
    pts = np.array([[0, -1], [1, -1]], np.int32)
    lens = np.array([6, 4], np.int32)
    lj, _, _ = jt.forward(jcfg, jp, jt.init_cache(jcfg, 4, 8), jnp.asarray(toks),
                          jnp.asarray(pos), jnp.asarray(pts), jnp.asarray(lens))
    t = torch.from_numpy
    lt, _ = tt.forward(tcfg, tp, tt.init_cache(tcfg, 4, 8), t(toks), t(pos), t(pts), t(lens))
    valid = pos >= 0
    assert np.abs(_np(lj)[valid] - lt.numpy()[valid]).max() <= 1e-4
    assert not lt.numpy()[~valid].any()  # padding rows: zero hidden, zero logits


def test_params_from_numpy_takes_bf16_reference_params():
    jcfg, tcfg, jp, tp = _params("tiny", dtype="bfloat16")
    assert all(v.dtype == torch.bfloat16 for v in tp.values())
    np.testing.assert_array_equal(tp["wq"].float().numpy(), _np(jp["wq"]))
    # a bf16 LoRA bank of the reference comes in bit for bit, A in the port's
    # [L, Din, S, r] layout; a bank missing leaves is refused
    from llmd_tpu.models.lora import LoRAConfig, init_lora_params

    bank = {k: np.asarray(v) for k, v in init_lora_params(jcfg, LoRAConfig(2, 4)).items()}
    rng = np.random.default_rng(0)
    bank = {k: rng.standard_normal(v.shape).astype(v.dtype) for k, v in bank.items()}
    got = tt.params_from_numpy(tcfg, {**{k: np.asarray(v) for k, v in jp.items()}, **bank})
    assert got["lora_A_wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["lora_A_wq"].float().numpy(),
                                  _np(bank["lora_A_wq"]).transpose(0, 2, 1, 3))
    np.testing.assert_array_equal(got["lora_B_wo"].float().numpy(), _np(bank["lora_B_wo"]))
    with pytest.raises(ValueError, match="LoRA bank"):
        tt.params_from_numpy(tcfg, {**{k: np.asarray(v) for k, v in jp.items()},
                                    "lora_A_wq": np.zeros(1)})


def test_init_params_shapes_and_seed():
    cfg = get_model_config("tiny64")
    a = tt.init_params(cfg, torch.Generator().manual_seed(7))
    b = tt.init_params(cfg, torch.Generator().manual_seed(7))
    assert {k: tuple(v.shape) for k, v in a.items()} == tt.param_shapes(cfg)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["embed"].dtype == torch.bfloat16
