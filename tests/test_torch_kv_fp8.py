"""The fp8 KV pool (``EngineConfig.kv_cache_dtype="fp8"``) in the port against
the JAX reference, on the CPU.

The pool stores ``float8_e4m3fn`` at unit scale: writes clamp to +-448 and
cast (``llmd_tpu/models/transformer.py:390-423``), attention upcasts at use
(``:474-477``; the Pallas kernels dequantize in VMEM). Held here:

- the bytes ``write_kv`` stores on both pool layouts (K/V pairs, the MLA
  latent row) equal the reference's, values past +-448 and padding slots
  included, within the reference's round-trip bound (``tests/test_kv_fp8.py``);
- K1's plain version on an fp8 pool equals ``ragged_paged_attention_xla`` on
  the same pool, and K3's equals the reference's latent adapter (the Pallas
  kernel in interpret mode);
- greedy tokens identical to the JAX engine with ``kv_cache_dtype="fp8"``,
  pipelined defaults on both sides, on tiny (GQA), tiny-moe (sorted; dropped
  copies equal), tiny-mla, tiny with int8 weights and chunked prefill, and
  tiny with ngram speculation (drafted / accepted counts equal);
- teacher-forced logits with an fp8 pool close to the model-dtype pool's,
  and equal to the reference's fp8 logits;
- the config: "fp8" served, anything else refused with the reference's words.

The kernels' fp8 variants run only on the card (``tests/test_torch_kernel_gpu.py``).
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
from llmd_tpu_torch.core.request import SamplingParams
from llmd_tpu_torch.engine import EngineConfig, LLMEngine
from llmd_tpu_torch.models import get_model_config
from llmd_tpu_torch.models import transformer as tt
from llmd_tpu_torch.obs.costmodel import kv_bytes_per_token
from llmd_tpu_torch.ops.mla_decode import mla_decode_ref, mla_paged_attention_latent
from llmd_tpu_torch.ops.paged_attention import paged_attention, paged_attention_ref

FP8 = torch.float8_e4m3fn
BASE = dict(page_size=8, num_pages=64, max_model_len=256, max_batch_size=4, prefill_chunk=32)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pad(a, width=128):
    """Zero lanes up to the reference's padded width."""
    return np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, width - a.shape[-1])])


def _to_fp8(a: np.ndarray) -> torch.Tensor:
    """An fp8 pool as the engine writes one: clamped to +-448, cast."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).clamp(-448, 448).to(FP8)


def _jax_fp8(t: torch.Tensor) -> jax.Array:
    """The same fp8 bytes as a JAX array."""
    return jnp.asarray(t.view(torch.uint8).numpy().view(jnp.float8_e4m3fn))


def _bytes(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


# ------------------------------------------------------------- the write path


@pytest.mark.parametrize("model", ["tiny", "tiny-mla"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_write_kv_fp8_bytes_match_reference(model, dtype):
    """Both pool layouts (tiny: K/V pairs; tiny-mla: the latent row, v
    ignored): the port's write_kv stores the reference's bytes, for normal
    rows, for rows past +-448 (saturated by the clamp, never nan) and with
    padding slots (-1: the port's dump row, the reference's dropped write);
    the round trip stays within e4m3's 2^-4 relative error."""
    cfg = get_model_config(model)
    planes = 1 if cfg.is_mla else 2 * cfg.num_kv_heads
    hk, D = (1 if cfg.is_mla else cfg.num_kv_heads), cfg.kv_cache_head_dim
    S, N = 48, 7
    rng = np.random.default_rng(11)
    k = rng.standard_normal((N, hk, D)).astype(np.float32) * 3
    v = rng.standard_normal((N, hk, D)).astype(np.float32) * 3
    k[2, 0, :6] = [448.0, -448.0, 449.0, -1e4, 5e5, 1e-3]  # the clamp, and a subnormal
    v[4, -1, -3:] = [-700.0, 460.0, 2.0 ** -9]
    slots = np.array([0, 5, -1, 17, 46, -1, 33], np.int32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = jt.write_kv(jnp.zeros((S, planes, 128), jnp.float8_e4m3fn),
                      jnp.asarray(_pad(k), jd), jnp.asarray(_pad(v), jd), jnp.asarray(slots))
    pool = torch.zeros((S + 1, planes, D), dtype=FP8)  # + the dump row
    td = getattr(torch, dtype)
    got = tt.write_kv(pool, torch.from_numpy(k).to(td), torch.from_numpy(v).to(td),
                      torch.from_numpy(slots))
    assert got is pool and got.dtype == FP8
    np.testing.assert_array_equal(_bytes(got)[:S], _bytes(ref)[..., :D])
    assert torch.isfinite(got.float()).all() and np.isfinite(np.asarray(ref, np.float32)).all()
    assert _bytes(got)[S].any()  # the padding rows went to the dump row
    # round trip of the written rows (the clamped elements aside)
    live = slots >= 0
    rows = got.float().numpy()[slots[live]]
    want = k[live] if cfg.is_mla else np.stack([k, v], 2).reshape(N, planes, D)[live]
    want = torch.from_numpy(want).to(td).float().numpy()
    ok = np.abs(want) <= 448
    assert np.all(np.abs(rows - want)[ok] <= np.abs(want[ok]) * 2 ** -4 + 1e-3)
    assert np.all(np.abs(rows[~ok]) == 448)


def test_forward_core_writes_fp8_pool_in_place():
    """The engine's pool dtype reaches the per-layer write: an fp8 pool
    comes back fp8 (the same tensor) holding the new tokens' rows."""
    cfg = dataclasses.replace(get_model_config("tiny"), dtype="float32")
    params = tt.init_params(cfg, torch.Generator().manual_seed(0))
    cache = tt.init_cache(cfg, 8, 8, dtype=FP8)
    toks = torch.arange(3, 13, dtype=torch.int32)[None]
    pos = torch.arange(10, dtype=torch.int32)[None]
    _, out = tt.forward(cfg, params, cache, toks, pos, torch.tensor([[0, 1]], dtype=torch.int32),
                        torch.tensor([10], dtype=torch.int32))
    assert out is cache and out.dtype == FP8
    flat = _bytes(out).reshape(out.shape[0] * 8, -1)  # token slots; layer l's at 64 l + pos
    written = np.zeros(len(flat), bool)
    written[np.r_[0:10, 64:74]] = True
    assert flat[written].any(axis=1).all() and not flat[~written].any()


# ------------------------------------------------------ K1's plain version


def _gqa_case(rng, H=4, Hk=2, D=32, ps=8):
    """A ragged batch over a K/V pool: decode rows, a fresh chunk, a
    continuation chunk, an unused table row, padding query rows."""
    q_lens, kv_lens = [1, 13, 1, 24, 7], [30, 13, 9, 55, 40]
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
    off = 0
    for b, (ql, kl) in enumerate(zip(q_lens, kv_lens)):
        pos[off:off + ql] = np.arange(kl - ql, kl)
        sids[off:off + ql] = b
        off += ql
    lens = np.ones((B,), np.int32)
    lens[:len(q_lens)] = kv_lens
    return (rng.standard_normal((N, H, D), np.float32),
            rng.standard_normal((P, ps, 2 * Hk, D), np.float32) * 2, pts, pos, sids, lens, off)


# f32: fp8 pages upcast exactly on both sides; summation order only. bf16:
# both upcast to bf16 and run p @ v in bf16 after an f32 softmax; their bf16
# products round differently: 2e-2 on unit-scale outputs.
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("latent", [False, True], ids=["kv_pairs", "latent"])
def test_k1_plain_on_fp8_pool_matches_xla(dtype, atol, latent):
    rng = np.random.default_rng(5)
    if latent:  # tiny-mla's one plane at width 80, every head over it
        q, pool, pts, pos, sids, lens, v = _gqa_case(rng, H=4, Hk=1, D=80)
        pool = pool[:, :, :1]
    else:
        q, pool, pts, pos, sids, lens, v = _gqa_case(rng)
    D = q.shape[-1]
    p8 = _to_fp8(pool)
    scale = D ** -0.5
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jt.ragged_paged_attention_xla(
        jnp.asarray(_pad(q), jd), _jax_fp8(torch.nn.functional.pad(p8.view(torch.uint8),
                                                                     (0, 128 - D)).view(FP8)),
        jnp.asarray(pts), jnp.asarray(pos), jnp.asarray(sids), jnp.asarray(lens), scale=scale)
    t = torch.from_numpy
    got = paged_attention_ref(t(q).to(td), p8, t(pts), t(pos), t(sids), t(lens), scale=scale)
    assert got.dtype == td
    np.testing.assert_allclose(got[:v].float().numpy(),
                               np.asarray(ref, np.float32)[:v, :, :D], atol=atol)
    # the wrapper on CPU tensors is the plain version
    wrapped = paged_attention(t(q).to(td), p8, t(pts), t(pos), t(sids), t(lens), scale=scale,
                              cu_q_lens=None, num_seqs=None)
    assert torch.equal(wrapped[:v], got[:v])


# --------------------------------------------------------- K3's plain version


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-6), ("bfloat16", 2e-2)])
def test_k3_plain_on_fp8_pool_matches_pallas(dtype, atol):
    """mla_decode_ref over an fp8 latent pool against the reference's
    ``mla_paged_attention_latent`` (its adapter upcasts the pool; the Pallas
    kernel in interpret mode on the CPU). Tolerances as in
    ``tests/test_torch_mla.py``; idle rows exact zeros."""
    rng = np.random.default_rng(7)
    kv_lens = np.array([0, 1, 3, 17, 48], np.int32)
    B, H, W, ps, maxp = len(kv_lens), 4, 80, 8, 6
    pts = np.full((B, maxp), -1, np.int32)
    nxt = 0
    for b in range(B):
        for j in range(-(-int(kv_lens[b]) // ps)):
            pts[b, j] = nxt
            nxt += 1
    q = rng.standard_normal((B, H, W), np.float32)
    p8 = _to_fp8(rng.standard_normal((16, ps, 1, W), np.float32) * 2)
    scale = (64 + 16) ** -0.5
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = np.asarray(jmla.mla_paged_attention_latent(
        jnp.asarray(_pad(q), jd),
        _jax_fp8(torch.nn.functional.pad(p8.view(torch.uint8), (0, 128 - W)).view(FP8)),
        jnp.asarray(pts), positions=jnp.asarray(np.maximum(kv_lens - 1, 0)),
        seq_slots=jnp.arange(B, dtype=jnp.int32), kv_lens=jnp.asarray(kv_lens),
        scale=scale), np.float32)
    qt = torch.from_numpy(q).to(td)
    t = torch.from_numpy
    plain = mla_decode_ref(qt, p8, t(np.maximum(pts, 0)), t(kv_lens), scale=scale)
    adapter = mla_paged_attention_latent(qt, p8, t(pts), None, None, t(kv_lens), scale=scale)
    for got in (plain, adapter):
        assert got.dtype == td
        np.testing.assert_allclose(got.float().numpy(), ref[..., :W], atol=atol)
        assert not got[0].any()


# ------------------------------------------------------------ engine parity


@functools.cache
def _weights(model: str):
    jcfg = dataclasses.replace(jax_model_config(model), dtype="float32")
    tcfg = dataclasses.replace(get_model_config(model), dtype="float32")
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, {k: np.asarray(v) for k, v in jp.items()}


def _drain(eng, requests) -> dict[str, list[int]]:
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
    return out


def _echo(salt: int, n: int = 48, period: int = 3) -> list[int]:
    """A periodic prompt: prompt-lookup drafts fire."""
    return [(salt * 7919 + j % period) % 286 + 1 for j in range(n)]


PROMPTS = [("r0", list(range(3, 30)), 9), ("r1", list(range(40, 55)), 4),
           ("r2", list(range(100, 164)), 13)]
CASES = {
    "tiny": ("tiny", dict(decode_steps=4), PROMPTS),
    "tiny_moe_sorted": ("tiny-moe", dict(decode_steps=4, moe_dispatch="sorted"), PROMPTS),
    "tiny_mla": ("tiny-mla", dict(decode_steps=4, num_pages=128), PROMPTS),
    # the serving target of tests/test_kv_fp8.py:107: int8 weights, a 64-token
    # prompt through 16-token chunks
    "tiny_int8_chunked": ("tiny", dict(prefill_chunk=16, quantize_weights="int8"),
                          [("r0", list(range(5, 69)), 6), ("r1", list(range(70, 90)), 8)]),
    "tiny_ngram": ("tiny", dict(spec_mode="ngram", spec_tokens=4),
                   [("e0", _echo(1), 24), ("e1", _echo(2, 40), 16), ("p", PROMPTS[0][1], 9)]),
}
COUNTS = ("moe_dropped_tokens", "eplb_rebalances", "total_preemptions", "spec_drafted",
          "spec_accepted", "spec_rejected", "n_spec_verify_steps")


@pytest.mark.parametrize("case", list(CASES))
def test_engine_fp8_pool_matches_reference(case):
    """Greedy tokens identical to the JAX engine with kv_cache_dtype="fp8"
    (pipelined defaults on both sides; the reference on its XLA attention),
    and the counts equal; both pools fp8."""
    model, kw, requests = CASES[case]
    jcfg, tcfg, jp, npp = _weights(model)
    cfg = {**BASE, **kw, "kv_cache_dtype": "fp8"}
    je = JaxEngine(jcfg, JaxEngineConfig(**cfg, attn_impl="reference"), params=jp)
    te = LLMEngine(tcfg, EngineConfig(**cfg), params=tt.params_from_numpy(tcfg, npp),
                   device="cpu")
    assert je.cache.dtype == jnp.float8_e4m3fn and te.cache.dtype == FP8
    assert te.stats.kv_cache_dtype == je.stats.kv_cache_dtype == "fp8"
    want = _drain(je, requests)
    got = _drain(te, requests)
    assert got == want
    for name in COUNTS:
        assert getattr(te.stats, name) == getattr(je.stats, name), name
    if kw.get("spec_mode"):
        assert te.stats.spec_accepted > 0
    assert te.cache.dtype == FP8  # no program re-expanded the pool


def test_engine_pool_dtype_provenance_and_ledger():
    """EngineStats.kv_cache_dtype as the reference's ("fp8", else the model
    dtype's name), and the utilization ledger counts one byte a KV element."""
    jcfg, tcfg, jp, npp = _weights("tiny")
    for kv, want in ((None, "float32"), ("fp8", "fp8")):
        te = LLMEngine(tcfg, EngineConfig(**BASE, kv_cache_dtype=kv),
                       params=tt.params_from_numpy(tcfg, npp), device="cpu")
        je = JaxEngine(jcfg, JaxEngineConfig(**BASE, kv_cache_dtype=kv, attn_impl="reference"),
                       params=jp)
        assert te.stats.kv_cache_dtype == je.stats.kv_cache_dtype == want
        assert te.util.kv_cache_dtype == kv
    assert 2 * kv_bytes_per_token(tcfg, "fp8") == kv_bytes_per_token(
        dataclasses.replace(tcfg, dtype="bfloat16"))


# ------------------------------------------------------------------ logits


def test_fp8_pool_logits_teacher_forced():
    """The reference's check (tests/test_kv_fp8.py:68), on the port: logits
    over an fp8 pool stay close to the model-dtype pool's (cosine > 0.99,
    argmax agreement >= 0.8); and they equal the reference's fp8 logits on
    the same weights (float32, 1e-4)."""
    jcfg, tcfg, jp, npp = _weights("tiny")
    params = tt.params_from_numpy(tcfg, npp)
    T = 32
    toks = [[(7 * i + 3) % (tcfg.vocab_size - 2) + 1 for i in range(T)]]
    pt = torch.arange(8, dtype=torch.int32)[None]
    kv = torch.full((1,), T, dtype=torch.int32)

    def logits_for(dtype):
        out = tt.forward(tcfg, params, tt.init_cache(tcfg, 8, 8, dtype=dtype),
                         torch.tensor(toks, dtype=torch.int32), torch.arange(T)[None], pt, kv)
        return out[0][0].numpy()

    ref, got = logits_for(None), logits_for(FP8)
    cos = np.sum(ref * got, -1) / (np.linalg.norm(ref, axis=-1) * np.linalg.norm(got, axis=-1))
    assert np.all(cos > 0.99), cos.min()
    assert np.mean(np.argmax(ref, -1) == np.argmax(got, -1)) >= 0.8
    jlog = jt.forward(jcfg, jp, jt.init_cache(jcfg, 8, 8, dtype=jnp.float8_e4m3fn),
                      jnp.asarray(toks), jnp.arange(T)[None], jnp.asarray(pt.numpy()),
                      jnp.asarray(kv.numpy()))[0]
    np.testing.assert_allclose(got, np.asarray(jlog)[0], atol=1e-4)


# ------------------------------------------------------------------ config


def test_kv_cache_dtype_served_and_validated():
    tcfg = _weights("tiny")[1]
    EngineConfig(kv_cache_dtype="fp8").check_served()
    with pytest.raises(ValueError, match=r"unknown kv_cache_dtype='int4' \(supported: 'fp8'\)"):
        LLMEngine(tcfg, EngineConfig(**BASE, kv_cache_dtype="int4"), device="cpu")
