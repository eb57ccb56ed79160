"""MLA's latent attention kernels on the CPU: K3 (``ops/mla_decode``) and K1's
single-plane mode (``ops/paged_attention`` on a one-plane pool). Covers the
instance choice of both wrappers, their work decompositions (K3's ``_plan``
and K1's ``_plan`` at group 16, with torch emulations of the kernels' items
and split merges held against the plain versions and the JAX reference), the
refusals, and that CPU calls count no kernel instance.

The CUDA kernels run only on the card (``tests/test_torch_kernel_gpu.py``).
``_k3_items`` mirrors ``csrc/mla_decode.cu::mla_decode_mma_kernel``'s
prologue line for line, ``_k1_items`` that of
``csrc/paged_attention.cu::paged_attention_mma_kernel``. The JAX side runs
K3's Pallas kernel in interpret mode and K1's reference through
``ragged_paged_attention_xla``, both on the latent zero-padded to the
reference's lanes (a multiple of 128). Inputs come from numpy seeds and go to
both sides.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from llmd_tpu.models import transformer as jt
from llmd_tpu.ops import mla_decode as jmla
from llmd_tpu_torch.ops import mla_decode as md
from llmd_tpu_torch.ops import paged_attention as pa
from llmd_tpu_torch.ops.mla_decode import mla_decode, mla_decode_ref
from llmd_tpu_torch.ops.paged_attention import paged_attention, paged_attention_ref

NEG = float("-inf")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pad(a):
    """Zero-pad the last axis to the reference's lane width, a multiple of 128."""
    width = -(-a.shape[-1] // 128) * 128
    return np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, width - a.shape[-1])])


def _tables(rng, kv_lens, ps, extra_pages=1):
    """Page tables over a shuffled pool, -1 past each sequence."""
    need = [-(-int(k) // ps) for k in kv_lens]
    maxp = max(need + [1]) + extra_pages
    P = sum(need) + 3
    perm = rng.permutation(P)
    pts = np.full((len(kv_lens), maxp), -1, np.int32)
    o = 0
    for b, n in enumerate(need):
        pts[b, :n] = perm[o:o + n]
        o += n
    return pts, P


def _merge(m, l, o):
    """The kernels' split merge for one row: [splits, H], [splits, H],
    [splits, H, D] -> [H, D]; splits with m = -inf are skipped, a head no
    split saw is zeros."""
    big = m.amax(0)
    w = torch.where(m == NEG, 0.0, l * torch.exp(m - torch.where(big == NEG, 0.0, big)))
    wsum = w.sum(0)
    return torch.where(wsum[:, None] > 0,
                       (w[..., None] * o).sum(0) / wsum.clamp_min(1e-30)[:, None], 0.0)


def _partial(qs, rows, mask):
    """One item's partial (m, l, o/l) per query row from its keys: qs [n, D]
    (already scaled), rows [k, D] (the latent: K and V), mask [n, k] or [k]."""
    s = (qs @ rows.T).masked_fill(~mask, NEG)
    mx = s.amax(-1) if s.shape[-1] else torch.full(qs.shape[:1], NEG)
    p = torch.exp(s - torch.where(mx == NEG, 0.0, mx)[:, None])
    den = p.sum(-1)
    return mx, den, (p @ rows) / den.clamp_min(1e-30)[:, None]


# ------------------------------------------------------------------ instances


@pytest.mark.parametrize("dtype,H,W,want", [
    (torch.bfloat16, 16, 160, "mma"),   # moe-wide-mla
    (torch.bfloat16, 4, 80, "simt"),    # tiny-mla: the mma template spills at width 80
    (torch.float32, 16, 160, "simt"),   # float32 stays off the tensor cores
    (torch.float32, 4, 80, "simt"),
    (torch.bfloat16, 8, 160, "simt"),   # no instance at all (the wrapper refuses)
])
def test_k3_instance(dtype, H, W, want):
    assert md._instance(dtype, H, W) == want


@pytest.mark.parametrize("dtype,H,W,want", [
    (torch.bfloat16, 16, 160, "mma"),   # moe-wide-mla: 4 tokens x 16 heads a tile
    (torch.bfloat16, 4, 80, "simt"),    # tiny-mla: the mma template spills at width 80
    (torch.float32, 16, 160, "simt"),
    (torch.float32, 4, 80, "simt"),
    (torch.bfloat16, 8, 160, "simt"),   # 8 heads at 160: simt's blocks of 8
    (torch.bfloat16, 32, 160, "simt"),
    (torch.bfloat16, 16, 96, "simt"),   # no latent instance (the wrapper refuses)
])
def test_k1_latent_instance(dtype, H, W, want):
    assert pa._instance(dtype, 1, W, H) == want


def test_registry_mla_models_in_bf16_take_mma_at_width_160():
    """moe-wide-mla (16 heads at width 160) runs both latent kernels on mma;
    the tiny MLA models (4 heads at width 80) on simt."""
    from llmd_tpu_torch.models import MODEL_REGISTRY

    seen = {}
    for name, cfg in MODEL_REGISTRY.items():
        if not cfg.is_mla:
            continue
        W = cfg.mla_kv_lora_rank + cfg.mla_rope_dim
        want = "mma" if (cfg.num_heads, W) == (16, 160) else "simt"
        assert md._instance(torch.bfloat16, cfg.num_heads, W) == want, name
        assert pa._instance(torch.bfloat16, 1, W, cfg.num_heads) == want, name
        seen[name] = want
    assert seen["moe-wide-mla"] == "mma" and seen["tiny-mla"] == "simt"


# ------------------------------------------------------------------ K3's plan


def _k3_items(plan, kv_lens, max_keys):
    """K3's mma work items as (sequence, split, first key, end key); an item
    with end key <= first key only marks its partials empty."""
    for b, kv in enumerate(kv_lens):
        kv = min(int(kv), max_keys)
        for sp in range(plan.splits):
            k_lo = sp * plan.split_keys
            yield b, sp, k_lo, min(k_lo + plan.split_keys, kv)


def test_k3_plan_at_the_smoke_shapes():
    # decode B=64+2 over a 1024-key table: 8 splits of 128, four items an SM
    p = md._plan(66, 64, 16)
    assert (p.splits, p.split_keys) == (8, 128)
    # the smoke run's table of 63 pages: 6 splits of 192 keys
    assert md._plan(66, 63, 16) == md.Plan(6, 192)
    # decode B=8 at kv up to 5120: the merge's 16 splits of 320 keys
    assert md._plan(8, 320, 16) == md.Plan(16, 320)
    # profile_engine's table (max_model_len 4096) at batch 8 and 32
    assert md._plan(8, 256, 16) == md.Plan(16, 256)
    assert md._plan(32, 256, 16) == md.Plan(16, 256)
    # enough sequences fill the card alone: one split over the whole table
    assert md._plan(600, 64, 16) == md.Plan(1, 1024)
    # a table too short to split, and an empty one
    assert md._plan(1, 6, 16) == md.Plan(1, 96)
    assert md._plan(4, 0, 16) == md.Plan(1, 0)


@settings(max_examples=80, deadline=None)
@given(st.data())
def test_k3_plan_covers_every_key_of_a_live_sequence_once(data):
    """Every key below a sequence's (table-clamped) kv_len falls in exactly
    one split; idle sequences (kv_len 0) have every split empty; the splits
    cover the table in whole stages and pages, at most MAX_SPLITS of them."""
    ps = data.draw(st.sampled_from([8, 16, 32]))
    B = data.draw(st.integers(1, 40))
    max_pages = data.draw(st.integers(0, 400))
    max_keys = max_pages * ps
    kv_lens = data.draw(st.lists(st.integers(0, max_keys + 40), min_size=B, max_size=B))
    num_sms = data.draw(st.sampled_from([1, 8, 132, 100000]))
    plan = md._plan(B, max_pages, ps, num_sms)
    assert 1 <= plan.splits <= pa.MAX_SPLITS
    assert plan.splits * plan.split_keys >= max_keys > (plan.splits - 1) * plan.split_keys \
        or max_keys == 0
    if plan.splits > 1:
        assert plan.split_keys % pa.STAGE_KEYS == 0 and plan.split_keys % ps == 0
        assert plan.split_keys >= md.MIN_SPLIT_KEYS
    count = np.zeros((B, max(max_keys, 1)), np.int32)
    live = np.zeros((B, plan.splits), bool)
    for b, sp, k_lo, k_hi in _k3_items(plan, kv_lens, max_keys):
        if k_hi > k_lo:
            count[b, k_lo:k_hi] += 1
            live[b, sp] = True
    for b, kv in enumerate(kv_lens):
        kv = min(kv, max_keys)
        assert (count[b, :kv] == 1).all() and (count[b, kv:] == 0).all()
        if kv == 0:
            assert not live[b].any()


# ------------------------------------------------------- K1's plan at group 16


def _k1_items(plan, cu, kv_lens, num_seqs, max_keys):
    """K1's mma work items that hold query rows, as (sequence, first token
    row, tokens, causal limit of the first token, split, first key, end
    key); the single-plane mode has one "kv head"."""
    for slot in range(plan.slots):
        for sp in range(plan.splits):
            if num_seqs <= 0:
                continue
            b = max(i for i in range(num_seqs) if i + cu[i] // plan.tq <= slot)
            q_start, q_len = int(cu[b]), int(cu[b + 1] - cu[b])
            t0 = (slot - b - q_start // plan.tq) * plan.tq
            if t0 >= q_len:
                continue
            ntok = min(plan.tq, q_len - t0)
            lim0 = int(kv_lens[b]) - q_len + t0 + 1
            tile_lim = min(lim0 + ntok - 1, max_keys)
            k_lo = sp * plan.split_keys
            yield b, q_start + t0, ntok, lim0, sp, k_lo, min(k_lo + plan.split_keys, tile_lim)


def test_k1_latent_plan_at_the_smoke_shapes():
    # moe-wide-mla's mixed shape: 432 rows in tiles of 4 tokens x 16 heads
    p = pa._plan(432, 40, 128, 16, 16, 1)
    assert (p.tq, p.slots, p.kv_heads, p.splits, p.split_keys) == (4, 148, 1, 4, 512)
    assert p.grid == (1, 148, 4)
    # tiny-mla's 4 heads at width 80: tiles of 16 tokens
    assert pa._plan(64, 4, 8, 8, 4, 1).tq == 16
    # a 512-token chunk at kv 2048 beside decode rows: 128 tiles + 4 slots
    p = pa._plan(515, 4, 128, 16, 16, 1)
    assert (p.slots, p.splits) == (133, 4)


@settings(max_examples=50, deadline=None)
@given(st.data())
def test_k1_latent_plan_covers_every_attended_key_once(data):
    """At group 16 (tiles of 4 tokens): every (row, key) pair below the row's
    causal limit falls in exactly one item, no item attends past a row's
    limit, and every split of every valid row is written once."""
    ps = data.draw(st.sampled_from([8, 16]))
    nb = data.draw(st.integers(1, 5))
    q_lens = [data.draw(st.integers(0, 13)) for _ in range(nb)]
    kv_lens = [q + data.draw(st.integers(0, 1300)) for q in q_lens]
    pad_seqs = data.draw(st.integers(0, 2))
    num_sms = data.draw(st.sampled_from([1, 132, 100000]))
    max_pages = max(-(-k // ps) for k in kv_lens) + data.draw(st.integers(0, 3))
    max_keys = max_pages * ps
    cu = np.concatenate([[0], np.cumsum(q_lens), np.full(pad_seqs, sum(q_lens))])
    kv = np.asarray(kv_lens + [1] * pad_seqs)
    plan = pa._plan(sum(q_lens) + 2, nb + pad_seqs, max_pages, ps, 16, 1, num_sms)
    assert plan.tq == 4 and plan.kv_heads == 1
    lims = []
    for b in range(nb):
        lims += [min(kv_lens[b] - q_lens[b] + i + 1, max_keys) for i in range(q_lens[b])]
    count = np.zeros((len(lims), max(max_keys, 1)), np.int32)
    written = []
    for b, n0, ntok, lim0, sp, k_lo, k_hi in _k1_items(plan, cu, kv, nb, max_keys):
        for t in range(ntok):
            hi = min(k_hi, lim0 + t, max_keys)
            assert hi <= lims[n0 + t]
            if hi > k_lo:
                count[n0 + t, k_lo:hi] += 1
            written.append((n0 + t, sp))
    for n, lim in enumerate(lims):
        assert (count[n, :lim] == 1).all() and (count[n, lim:] == 0).all()
    assert sorted(written) == [(n, sp) for n in range(len(lims)) for sp in range(plan.splits)]


# ------------------------------------------------------------------- refusals


def _k3_inputs(B=3, H=16, W=160, ps=16, dtype=torch.float32):
    rng = np.random.default_rng(0)
    kv = np.array([0, 5, 40][:B] + [7] * max(B - 3, 0), np.int32)
    pts, P = _tables(rng, kv, ps)
    return dict(q=_t(rng.standard_normal((B, H, W), np.float32)).to(dtype),
                pool=_t(rng.standard_normal((P, ps, 1, W), np.float32)).to(dtype),
                pts=_t(np.maximum(pts, 0)), lens=_t(kv))


def _misaligned(t):
    """A copy of ``t`` whose data starts 2 bytes past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 8, dtype=t.dtype)
    out = flat[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 != 0
    return out


def test_k3_check_accepts_both_shapes_and_dtypes():
    for H, W in md.SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            c = _k3_inputs(H=H, W=W, dtype=dtype)
            md._check(c["q"], c["pool"], c["pts"], c["lens"])


def test_k3_check_refusals():
    c = _k3_inputs()

    def check(**over):
        d = {**c, **over}
        md._check(d["q"], d["pool"], d["pts"], d["lens"])

    with pytest.raises(ValueError, match="no kernel instance"):  # 8 heads at 160
        check(**{k: v for k, v in _k3_inputs(H=8).items() if k == "q"})
    with pytest.raises(ValueError, match="no kernel instance"):  # width 96
        d = _k3_inputs(H=16, W=96)
        check(q=d["q"], pool=d["pool"])
    with pytest.raises(ValueError, match="no kernel instance"):  # a two-plane pool
        check(pool=c["pool"].expand(-1, -1, 2, -1).contiguous())
    with pytest.raises(TypeError):  # float16
        check(q=c["q"].half(), pool=c["pool"].half())
    with pytest.raises(TypeError):  # q and pool of different types
        check(q=c["q"].bfloat16())
    with pytest.raises(ValueError, match="do not match"):
        check(lens=c["lens"][:-1])
    with pytest.raises(ValueError, match="do not match"):
        check(pts=c["pts"][:-1])
    with pytest.raises(ValueError, match="contiguous"):
        check(q=c["q"].transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError, match="16-byte aligned"):
        check(q=_misaligned(c["q"]))
    with pytest.raises(ValueError, match="16-byte aligned"):
        check(pool=_misaligned(c["pool"]))
    with pytest.raises(ValueError, match="q's device"):
        check(lens=c["lens"].to("meta"))


@pytest.mark.parametrize("dtype,H,W,want", [
    (torch.bfloat16, 16, 160, "mma_fp8"),   # moe-wide-mla over an fp8 latent pool
    (torch.bfloat16, 4, 80, "simt_fp8"),    # tiny-mla
    (torch.float32, 16, 160, "simt_fp8"),
])
def test_instances_on_fp8_latent_pools(dtype, H, W, want):
    """Both latent kernels over an fp8 pool take their instance's fp8 variant."""
    assert md._instance(dtype, H, W, torch.float8_e4m3fn) == want
    assert pa._instance(dtype, 1, W, H, torch.float8_e4m3fn) == want


def test_k3_check_takes_fp8_pools_beside_either_q():
    for H, W in md.SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            c = _k3_inputs(H=H, W=W, dtype=dtype)
            md._check(c["q"], c["pool"].to(torch.float8_e4m3fn), c["pts"], c["lens"])
    c = _k3_inputs()
    p8 = c["pool"].to(torch.float8_e4m3fn)
    for q, pool in ((c["q"].to(torch.float8_e4m3fn), p8), (c["q"].half(), p8),
                    (c["q"], c["pool"].to(torch.float8_e5m2))):
        with pytest.raises(TypeError, match="float8_e4m3fn"):
            md._check(q, pool, c["pts"], c["lens"])
    with pytest.raises(ValueError, match="no kernel instance"):  # width 96, fp8 or not
        d = _k3_inputs(H=16, W=96)
        md._check(d["q"], d["pool"].to(torch.float8_e4m3fn), d["pts"], d["lens"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_launch_passes_the_pool_dtype_and_the_same_plan(monkeypatch, dtype):
    """K3's C entry point gets the pool's dtype as its own code (2 for fp8);
    every other argument but the pool and the outputs is the upcast twin's:
    one plan for both."""
    calls = []

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(md, "_library", lambda: lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(md, "_num_sms", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: _Stream())
    c = _k3_inputs(B=8, dtype=dtype)
    for pool in (c["pool"], c["pool"].to(torch.float8_e4m3fn)):
        md._launch(c["q"], pool, c["pts"], c["lens"], 0.1,
                   md._instance(dtype, 16, 160, pool.dtype))
    # (q, pool, tables, lens, out, scratch, B, H, D, ps, maxp, scale, dtype,
    # kv_dtype, instance, splits, split_keys, stream)
    a, b = calls
    assert a[12] == b[12] == md._DTYPE_CODE[dtype]
    assert (a[13], b[13]) == (md._POOL_CODE[dtype], 2)
    assert a[1] != b[1] and a[:1] + a[2:4] + a[6:13] + a[14:] == b[:1] + b[2:4] + b[6:13] + b[14:]


def test_k3_wrapper_refuses_other_devices():
    c = {k: v.to("meta") for k, v in _k3_inputs().items()}
    with pytest.raises(ValueError, match="unsupported device"):
        mla_decode(c["q"], c["pool"], c["pts"], c["lens"], scale=0.1)


def test_k1_check_on_a_latent_pool_returns_all_heads_and_refuses_other_widths():
    rng = np.random.default_rng(1)

    def check(H, W):
        q = _t(rng.standard_normal((3, H, W), np.float32))
        pool = _t(rng.standard_normal((6, 16, 1, W), np.float32))
        pts = _t(np.zeros((2, 2), np.int32))
        lens, cu, ns = _t(np.array([3, 1], np.int32)), _t(np.array([0, 2, 3], np.int32)), \
            _t(np.array([2], np.int32))
        return pa._check(q, pool, pts, lens, cu, ns)

    assert check(16, 160) == 16 and check(4, 80) == 4 and check(8, 160) == 8
    with pytest.raises(ValueError, match="no kernel instance"):
        check(16, 96)
    with pytest.raises(ValueError, match="no kernel instance"):  # 12 heads: not blocks of 8
        check(12, 160)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_calls_leave_the_instance_counts_alone(dtype):
    c = _k3_inputs(dtype=dtype)
    k3 = (mla_decode.launches, dict(mla_decode.launches_by_instance), mla_decode_ref.calls)
    got = mla_decode(c["q"], c["pool"], c["pts"], c["lens"], scale=0.1)
    assert got.shape == c["q"].shape and got.dtype == dtype
    assert (mla_decode.launches, mla_decode.launches_by_instance) == k3[:2]
    assert set(k3[1]) == {"mma", "simt", "mma_fp8", "simt_fp8"}
    assert mla_decode_ref.calls == k3[2] + 1

    lc = _latent_case(np.random.default_rng(2), 16, 160, 16, [5, 1], [9, 40])
    k1 = (paged_attention.launches, dict(paged_attention.launches_by_instance))
    out = paged_attention(*(_t(lc[k]).to(dtype) if k in ("q", "pool") else _t(lc[k])
                            for k in ("q", "pool", "pts", "pos", "sids", "lens")),
                          scale=lc["scale"], cu_q_lens=_t(lc["cu"]), num_seqs=_t(lc["ns"]))
    assert out.dtype == dtype
    assert (paged_attention.launches, paged_attention.launches_by_instance) == k1


# -------------------------------------------------- K3's decomposition, emulated


def _k3_emulate(q, pool, pts, kv_lens, scale, plan):
    """K3's mma arithmetic in float32, item by item: each (sequence, split)
    makes partial (m, l, o/l) per head from its keys (m = -inf where it has
    none), then every sequence merges its splits (with one split, the item's
    own result; an idle sequence is zeros)."""
    B, H, D = q.shape
    ps = pool.shape[1]
    max_keys = pts.shape[1] * ps
    rows = pool.reshape(-1, D)
    qs = q * scale  # float32: scaling and rounding to the type is one step
    m = torch.full((plan.splits, B, H), NEG)
    l = torch.zeros((plan.splits, B, H))
    o = torch.zeros((plan.splits, B, H, D))
    for b, sp, k_lo, k_hi in _k3_items(plan, kv_lens, max_keys):
        if k_hi <= k_lo:
            continue
        keys = torch.arange(k_lo, k_hi)
        slot = pts[b, keys // ps].long() * ps + keys % ps
        m[sp, b], l[sp, b], o[sp, b] = _partial(qs[b], rows[slot],
                                                torch.ones(len(keys), dtype=torch.bool))
    return torch.stack([_merge(m[:, b], l[:, b], o[:, b]) for b in range(B)])


# (H, W, ps, kv_lens, SMs): idle rows, keys at one page, partial pages, whole
# splits; 100000 SMs split as far as the table allows
K3_EMULATED = [
    (4, 80, 8, [0, 1, 3, 17, 48], 132),
    (4, 80, 8, [0, 1, 300, 700, 1024], 132),
    (16, 160, 16, [0, 17, 256, 512, 1000], 100000),
    (16, 160, 16, [4096], 132),   # one sequence: 16 splits of 256
    (16, 160, 16, [0, 0], 132),   # only idle rows: every split empty
]


@pytest.mark.parametrize("H,W,ps,kv_lens,sms", K3_EMULATED)
def test_k3_emulated_decomposition_matches_plain_and_reference(H, W, ps, kv_lens, sms):
    """f32, atol 1e-5 (summation order; the merge rescales by exp(m - max
    m)): K3's items and split merge under ``_plan`` against the plain
    version and the Pallas kernel in interpret mode on the same numpy inputs;
    idle rows are exact zeros."""
    rng = np.random.default_rng(sum(kv_lens) + W)
    pts, P = _tables(rng, kv_lens, ps)
    pts = np.maximum(pts, 0)  # as the adapter passes them: every entry names a page
    kv = np.asarray(kv_lens, np.int32)
    q = rng.standard_normal((len(kv), H, W), np.float32)
    pool = rng.standard_normal((P, ps, 1, W), np.float32)
    scale = (W - 96) ** -0.5 if W > 96 else 80 ** -0.5
    plan = md._plan(len(kv), pts.shape[1], ps, sms)
    if sms == 100000 or max(kv_lens) == 4096:
        assert plan.splits > 1
    got = _k3_emulate(_t(q), _t(pool), _t(pts), kv, scale, plan)
    plain = mla_decode_ref(_t(q), _t(pool), _t(pts), _t(kv), scale=scale)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5)
    ref = np.asarray(jmla.mla_paged_attention_latent(  # Pallas, interpret mode on the CPU
        jnp.asarray(_pad(q)), jnp.asarray(_pad(pool)), jnp.asarray(pts),
        positions=jnp.asarray(np.maximum(kv - 1, 0)),
        seq_slots=jnp.arange(len(kv), dtype=jnp.int32), kv_lens=jnp.asarray(kv),
        scale=scale), np.float32)
    np.testing.assert_allclose(got.numpy(), ref[..., :W], atol=1e-5)
    assert not got[torch.from_numpy(kv == 0)].any()


# ---------------------------------------- K1's single-plane decomposition, emulated


def _latent_case(rng, H, W, ps, q_lens, kv_lens, pad_rows=3, pad_seqs=1):
    """A ragged batch over a single-plane latent pool (queries are each
    sequence's last q_len tokens) with trailing padding rows and table rows."""
    nb = len(q_lens)
    pts, P = _tables(rng, kv_lens, ps)
    pts = np.concatenate([pts, np.full((pad_seqs, pts.shape[1]), -1, np.int32)])
    N = sum(q_lens) + pad_rows
    pos = np.full((N,), -1, np.int32)
    sids = np.zeros((N,), np.int32)
    cu = np.zeros((nb + pad_seqs + 1,), np.int32)
    off = 0
    for b, (ql, kl) in enumerate(zip(q_lens, kv_lens)):
        pos[off:off + ql] = np.arange(kl - ql, kl)
        sids[off:off + ql] = b
        off += ql
        cu[b + 1] = off
    cu[nb + 1:] = off
    lens = np.ones((nb + pad_seqs,), np.int32)
    lens[:nb] = kv_lens
    return dict(q=rng.standard_normal((N, H, W), np.float32),
                pool=rng.standard_normal((P, ps, 1, W), np.float32), pts=pts, pos=pos,
                sids=sids, lens=lens, cu=cu, ns=np.array([nb], np.int32), nb=nb, valid=off,
                scale=(W - 96) ** -0.5 if W > 96 else 80 ** -0.5)


def _k1_latent_emulate(c, plan):
    """K1's mma arithmetic on one plane in float32, item by item: each (query
    tile, split) makes partial (m, l, o/l) for its tokens x all H heads from
    the same latent rows (K and V), causally masked; rows merge their splits.
    Padding rows are zeros."""
    q, pool, pts = _t(c["q"]), _t(c["pool"]), _t(c["pts"])
    N, H, D = q.shape
    ps = pool.shape[1]
    max_keys = pts.shape[1] * ps
    rows = pool.reshape(-1, D)
    m = torch.full((plan.splits, N, H), NEG)
    l = torch.zeros((plan.splits, N, H))
    o = torch.zeros((plan.splits, N, H, D))
    for b, n0, ntok, lim0, sp, k_lo, k_hi in _k1_items(plan, c["cu"], c["lens"], c["nb"],
                                                      max_keys):
        keys = torch.arange(k_lo, max(k_hi, k_lo))
        page = pts[b, keys // ps].long()
        slot = page.clamp(min=0) * ps + keys % ps
        for t in range(ntok):
            mask = (page >= 0) & (keys < min(lim0 + t, max_keys))
            n = n0 + t
            m[sp, n], l[sp, n], o[sp, n] = _partial(q[n] * c["scale"], rows[slot], mask)
    out = torch.zeros((N, H, D))
    for n in range(c["valid"]):
        out[n] = _merge(m[:, n], l[:, n], o[:, n])
    return out


# (H, W, ps, q_lens, kv_lens, SMs): decode rows, a chunk of TQ + 1 = 5 tokens,
# chunks longer than a tile, kv at whole pages / stages / splits
K1_EMULATED = [
    (16, 160, 16, [1, 5, 1, 13], [300, 5, 1, 700], 132),
    (16, 160, 16, [9, 1, 1], [1100, 2048, 512], 100000),
    (16, 160, 16, [1, 1, 1, 1], [16, 64, 512, 1024], 100000),
    (4, 80, 8, [17, 1, 33], [17, 600, 1500], 100000),  # tiny-mla: tiles of 16 tokens
]


@pytest.mark.parametrize("H,W,ps,q_lens,kv_lens,sms", K1_EMULATED)
def test_k1_latent_emulated_decomposition_matches_plain_and_reference(H, W, ps, q_lens,
                                                                     kv_lens, sms):
    """f32, valid rows, atol 1e-5: K1's single-plane items and split merge
    under ``_plan`` (group H, one "kv head") against the plain version and
    ``ragged_paged_attention_xla`` with one plane; padding rows are zeros."""
    c = _latent_case(np.random.default_rng(sum(kv_lens) + W), H, W, ps, q_lens, kv_lens)
    plan = pa._plan(c["q"].shape[0], c["pts"].shape[0], c["pts"].shape[1], ps, H, 1, sms)
    if sms == 100000:
        assert plan.splits > 1
    got = _k1_latent_emulate(c, plan)
    v = c["valid"]
    plain = paged_attention_ref(*(_t(c[k]) for k in ("q", "pool", "pts", "pos", "sids",
                                                     "lens")), scale=c["scale"])
    np.testing.assert_allclose(got[:v].numpy(), plain[:v].numpy(), atol=1e-5)
    ref = np.asarray(jt.ragged_paged_attention_xla(
        jnp.asarray(_pad(c["q"])), jnp.asarray(_pad(c["pool"])), jnp.asarray(c["pts"]),
        jnp.asarray(c["pos"]), jnp.asarray(c["sids"]), jnp.asarray(c["lens"]),
        scale=c["scale"]), np.float32)
    np.testing.assert_allclose(got[:v].numpy(), ref[:v, :, :W], atol=1e-5)
    assert not got[v:].any()
