"""K1's wrapper on the CPU: the instance choice, the mma instance's work
decomposition (``_plan`` and a torch emulation of the kernel's items and
split merge, held against the plain version and the JAX reference), the
wrapper's refusals, and the precision design of P·V in bfloat16.

The CUDA kernel itself runs only on the card (``tests/test_torch_kernel_gpu.py``);
what it computes from ``_plan`` is mirrored here by ``_items``, line for line
with ``csrc/paged_attention.cu::paged_attention_mma_kernel``'s prologue.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from llmd_tpu.models import transformer as jt
from llmd_tpu_torch.ops import paged_attention as pa
from llmd_tpu_torch.ops.paged_attention import (
    GROUP_SIZES, HEAD_DIMS, bf16_rounding_units, paged_attention, paged_attention_ref)


def _items(plan, cu, kv_lens, num_seqs, max_keys):
    """The mma kernel's work items that hold query rows, as (sequence, first
    token row, tokens, causal limit of the first token, split, first key,
    end key). Token t of the item attends keys [first key, min(end key,
    lim0 + t, max_keys)); an item with end key <= first key only marks its
    rows' partials empty."""
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
            k_hi = min(k_lo + plan.split_keys, tile_lim)
            yield b, q_start + t0, ntok, lim0, sp, k_lo, k_hi


def _row_limits(cu, kv_lens, num_seqs, max_keys):
    """Causal limit of every valid token row (keys [0, limit) attended)."""
    lims = []
    for b in range(num_seqs):
        q_len = int(cu[b + 1] - cu[b])
        lims += [min(int(kv_lens[b]) - q_len + i + 1, max_keys) for i in range(q_len)]
    return np.asarray(lims, np.int64)


# ------------------------------------------------------------------ instances


@pytest.mark.parametrize("dtype,planes,D,qpk,want", [
    (torch.bfloat16, 16, 64, 4, "mma"),    # llama-1b
    (torch.bfloat16, 8, 64, 4, "mma"),     # moe-wide-sim
    (torch.bfloat16, 4, 32, 2, "mma"),
    (torch.bfloat16, 16, 128, 8, "mma"),
    (torch.bfloat16, 16, 128, 1, "mma"),
    (torch.float32, 16, 64, 4, "simt"),    # float32 stays off the tensor cores
    (torch.bfloat16, 1, 160, 8, "simt"),   # 8 heads on a latent pool: no mma instance
    (torch.bfloat16, 1, 80, 4, "simt"),    # tiny-mla's (the mma template spills at 80)
    (torch.bfloat16, 16, 96, 4, "simt"),   # no mma instance (and no kernel at all)
    (torch.bfloat16, 16, 64, 3, "simt"),
    (torch.bfloat16, 1, 160, 16, "mma"),   # moe-wide-mla's latent pool
    (torch.float32, 1, 160, 16, "simt"),
])
def test_instance(dtype, planes, D, qpk, want):
    assert pa._instance(dtype, planes, D, qpk) == want


def test_every_registry_gqa_model_takes_mma_in_bf16():
    from llmd_tpu_torch.models import MODEL_REGISTRY

    for name, cfg in MODEL_REGISTRY.items():
        if cfg.is_mla or cfg.num_kv_heads == 0:
            continue
        qpk = cfg.num_heads // cfg.num_kv_heads
        if cfg.head_dim in HEAD_DIMS and qpk in GROUP_SIZES:
            assert pa._instance(torch.bfloat16, 2 * cfg.num_kv_heads, cfg.head_dim,
                                qpk) == "mma", name


# ------------------------------------------------------------------------ plan


def test_plan_at_the_smoke_shapes():
    # llama-1b decode B=64 (table 64 pages of 16): the tiles fill the card
    p = pa._plan(64, 64, 64, 16, 4, 8)
    assert (p.tq, p.slots, p.splits, p.split_keys) == (16, 68, 1, 1024)
    assert p.grid == (8, 68, 1)  # kv heads fastest
    # decode B=8 at kv up to 5120: 8 splits of 640 keys
    p = pa._plan(8, 8, 320, 16, 4, 8)
    assert (p.slots, p.splits, p.split_keys) == (9, 8, 640)
    # a 2048-token prefill step: one split
    assert pa._plan(2048, 32, 128, 16, 4, 8).splits == 1
    # one sequence at kv 32768: no more splits than the merge holds
    assert pa._plan(1, 1, 2048, 16, 4, 8).splits == pa.MAX_SPLITS
    # the splits cover the table, each a whole number of stages and pages
    for args in [(1, 1, 256, 16, 4, 8), (4, 4, 512, 16, 4, 8), (3, 3, 200, 8, 2, 2),
                 (5, 5, 100, 32, 8, 1)]:
        p = pa._plan(*args)
        max_keys = args[2] * args[3]
        assert p.splits * p.split_keys >= max_keys > (p.splits - 1) * p.split_keys
        if p.splits > 1:
            assert p.split_keys % pa.STAGE_KEYS == 0 and p.split_keys % args[3] == 0
            assert p.split_keys >= pa.MIN_SPLIT_KEYS
    # an empty table: one split, nothing to read
    assert pa._plan(4, 4, 0, 16, 4, 8).splits == 1


@settings(max_examples=60, deadline=None)
@given(st.data())
def test_plan_covers_every_attended_key_once(data):
    """Every (row, key) pair with key < the row's causal limit falls in
    exactly one work item; no item attends a key past its row's limit; every
    tile of every sequence has a slot; the merge finds every split of every
    valid row written, and there are at most MAX_SPLITS of them."""
    qpk = data.draw(st.sampled_from(GROUP_SIZES))
    tq = pa.MMA_ROWS // qpk
    ps = data.draw(st.sampled_from([8, 16, 32]))
    nb = data.draw(st.integers(1, 5))
    q_lens = [data.draw(st.integers(0, 3 * tq + 1)) for _ in range(nb)]
    kv_lens = [q + data.draw(st.integers(0, 1400)) for q in q_lens]
    pad_seqs = data.draw(st.integers(0, 2))
    pad_rows = data.draw(st.integers(0, 5))
    num_sms = data.draw(st.sampled_from([1, 8, 132, 100000]))
    kv_heads = data.draw(st.sampled_from([1, 2, 8]))
    max_pages = max(-(-k // ps) for k in kv_lens) + data.draw(st.integers(0, 3))
    max_keys = max_pages * ps
    cu = np.concatenate([[0], np.cumsum(q_lens), np.full(pad_seqs, sum(q_lens))])
    kv = np.asarray(kv_lens + [1] * pad_seqs)
    N, B = sum(q_lens) + pad_rows, nb + pad_seqs
    plan = pa._plan(N, B, max_pages, ps, qpk, kv_heads, num_sms)

    # every tile of every sequence lies inside the grid
    for b in range(nb):
        for j in range(-(-q_lens[b] // tq)):
            assert b + cu[b] // tq + j < plan.slots

    lims = _row_limits(cu, kv, nb, max_keys)
    count = np.zeros((len(lims), max(max_keys, 1)), np.int32)
    for b, n0, ntok, lim0, sp, k_lo, k_hi in _items(plan, cu, kv, nb, max_keys):
        for t in range(ntok):
            hi = min(k_hi, lim0 + t, max_keys)
            assert hi <= lims[n0 + t]  # never past the row's causal limit
            if hi > k_lo:
                count[n0 + t, k_lo:hi] += 1
    for n, lim in enumerate(lims):
        assert (count[n, :max(lim, 0)] == 1).all(), (n, lim)
        assert (count[n, max(lim, 0):] == 0).all()
    # the merge reads every split of a valid row: each was written once, by
    # an item with keys or by one that marks the row's partial empty
    assert plan.splits <= pa.MAX_SPLITS
    written = [(n0 + t, sp) for _, n0, ntok, _, sp, _, _ in
               _items(plan, cu, kv, nb, max_keys) for t in range(ntok)]
    assert sorted(written) == [(n, sp) for n in range(len(lims))
                               for sp in range(plan.splits)]


# ------------------------------------------------------------------- refusals


def _inputs(H=8, Hk=2, D=32, ps=8, dtype=torch.float32):
    """A small ragged batch (a 5-token chunk, a decode row) as torch tensors."""
    c = _ragged(np.random.default_rng(0), H, Hk, D, ps, [5, 1], [9, 20])
    t = torch.from_numpy
    return dict(q=t(c["q"]).to(dtype), pool=t(c["pool"]).to(dtype), pts=t(c["pts"]),
                pos=t(c["pos"]), sids=t(c["sids"]), lens=t(c["lens"]), cu=t(c["cu"]),
                ns=t(np.array([c["nb"]], np.int32)), scale=c["scale"])


def _check(c, **over):
    c = {**c, **over}
    return pa._check(c["q"], c["pool"], c["pts"], c["lens"], c["cu"], c["ns"])


def _misaligned(t):
    """A copy of ``t`` whose data starts 2 bytes past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 8, dtype=t.dtype)
    out = flat[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 != 0
    return out


def test_check_accepts_and_returns_the_group():
    assert _check(_inputs()) == 4
    assert _check(_inputs(dtype=torch.bfloat16, H=16, Hk=2, D=64)) == 8


def test_check_refusals():
    c = _inputs()
    with pytest.raises(ValueError, match="no kernel instance"):  # 3 heads per kv head
        _check(_inputs(H=6, Hk=2))
    with pytest.raises(ValueError, match="no kernel instance"):  # head dim 48
        _check(_inputs(D=48))
    with pytest.raises(TypeError):  # float16
        _check(c, q=c["q"].half(), pool=c["pool"].half())
    with pytest.raises(TypeError):  # q and pool of different types
        _check(c, q=c["q"].bfloat16())
    with pytest.raises(ValueError, match="cu_q_lens"):
        _check(c, cu=c["cu"][:-1])
    with pytest.raises(ValueError, match="cu_q_lens and num_seqs"):
        _check(c, ns=None)
    with pytest.raises(ValueError, match="contiguous"):
        _check(c, q=c["q"].transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError, match="16-byte aligned"):
        _check(c, q=_misaligned(c["q"]))
    with pytest.raises(ValueError, match="16-byte aligned"):
        _check(c, pool=_misaligned(c["pool"]))
    with pytest.raises(ValueError, match="q's device"):
        _check(c, lens=c["lens"].to("meta"))


def test_wrapper_refuses_other_devices():
    c = _inputs()
    m = {k: (v.to("meta") if isinstance(v, torch.Tensor) else v) for k, v in c.items()}
    with pytest.raises(ValueError, match="unsupported device"):
        paged_attention(m["q"], m["pool"], m["pts"], m["pos"], m["sids"], m["lens"],
                        scale=c["scale"], cu_q_lens=m["cu"], num_seqs=m["ns"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_calls_leave_the_instance_counts_alone(dtype):
    c = _inputs(dtype=dtype)
    launches = paged_attention.launches
    by_instance = dict(paged_attention.launches_by_instance)
    calls = paged_attention_ref.calls
    got = paged_attention(c["q"], c["pool"], c["pts"], c["pos"], c["sids"], c["lens"],
                          scale=c["scale"], cu_q_lens=c["cu"], num_seqs=c["ns"])
    assert got.shape == c["q"].shape and got.dtype == dtype
    assert paged_attention.launches == launches
    assert paged_attention.launches_by_instance == by_instance
    assert set(by_instance) == {"mma", "simt"}
    assert paged_attention_ref.calls == calls + 1


# ----------------------------------------------- the decomposition, emulated


def _emulate(q, pool, pts, kv_lens, cu, num_seqs, scale, plan):
    """The mma instance's arithmetic in float32, item by item: each work item
    (query tile, kv head, split) produces a partial (m, l, o/l) per row from
    its keys (m = -inf where it has none); rows then merge all their splits
    as the kernel does (with one split, the item's own result). Padding rows
    are zeros."""
    N, H, D = q.shape
    _, ps, HkC, _ = pool.shape
    Hk, qpk = HkC // 2, H // (HkC // 2)
    max_keys = pts.shape[1] * ps
    rows = pool.reshape(-1, HkC, D)
    m = torch.full((plan.splits, N, H), float("-inf"))
    l = torch.zeros((plan.splits, N, H))
    o = torch.zeros((plan.splits, N, H, D))
    for b, n0, ntok, lim0, sp, k_lo, k_hi in _items(plan, cu, kv_lens, num_seqs, max_keys):
        keys = torch.arange(k_lo, max(k_hi, k_lo))
        page = pts[b, keys // ps].long()
        slot = page.clamp(min=0) * ps + keys % ps
        lim = (lim0 + torch.arange(ntok)).clamp(max=max_keys)  # [ntok]
        mask = (page >= 0)[None, :] & (keys[None, :] < lim[:, None])  # [ntok, keys]
        for g in range(Hk):
            k, v = rows[slot, 2 * g], rows[slot, 2 * g + 1]
            qg = q[n0:n0 + ntok, g * qpk:(g + 1) * qpk]  # [ntok, qpk, D]
            s = torch.einsum("tqd,kd->tqk", qg, k) * scale
            s = s.masked_fill(~mask[:, None, :], float("-inf"))
            mx = s.amax(-1) if s.shape[-1] else torch.full(qg.shape[:2], float("-inf"))
            p = torch.exp(s - torch.where(mx == float("-inf"), 0.0, mx)[..., None])
            den = p.sum(-1)
            part = torch.einsum("tqk,kd->tqd", p, v) / den.clamp_min(1e-30)[..., None]
            sl = (sp, slice(n0, n0 + ntok), slice(g * qpk, (g + 1) * qpk))
            m[sl], l[sl], o[sl] = mx, den, part
    if plan.splits == 1:
        return o[0] * (l[0] > 0)[..., None]
    out = torch.zeros((N, H, D))
    for n in range(int(cu[num_seqs])):
        ms, ls, os_ = m[:, n], l[:, n], o[:, n]  # [splits, H(, D)]
        big = ms.amax(0)
        w = torch.where(ms == float("-inf"), 0.0,
                        ls * torch.exp(ms - torch.where(big == float("-inf"), 0.0, big)))
        wsum = w.sum(0)
        out[n] = (w[..., None] * os_).sum(0) / wsum.clamp_min(1e-30)[:, None]
    return out


def _ragged(rng, H, Hk, D, ps, q_lens, kv_lens, pad_rows=3, pad_seqs=1, holes=True):
    nb = len(q_lens)
    B = nb + pad_seqs
    need = [-(-k // ps) for k in kv_lens]
    maxp = max(need) + 1
    P = sum(need) + 2
    perm = rng.permutation(P)
    pts = np.full((B, maxp), -1, np.int32)
    o = 0
    for b in range(nb):
        pts[b, :need[b]] = perm[o:o + need[b]]
        o += need[b]
    if holes and need[0] > 2:
        pts[0, 1] = -1  # an unmapped page inside a sequence: never attended
    N = sum(q_lens) + pad_rows
    pos = np.full((N,), -1, np.int32)
    sids = np.zeros((N,), np.int32)
    cu = np.zeros((B + 1,), np.int32)
    off = 0
    for b, (ql, kl) in enumerate(zip(q_lens, kv_lens)):
        pos[off:off + ql] = np.arange(kl - ql, kl)
        sids[off:off + ql] = b
        off += ql
        cu[b + 1] = off
    cu[nb + 1:] = off
    lens = np.ones((B,), np.int32)
    lens[:nb] = kv_lens
    q = rng.standard_normal((N, H, D), np.float32)
    pool = rng.standard_normal((P, ps, 2 * Hk, D), np.float32)
    return dict(q=q, pool=pool, pts=pts, pos=pos, sids=sids, lens=lens, cu=cu, nb=nb,
                valid=off, scale=D ** -0.5)


# (H, Hk, D, ps, q_lens, kv_lens, SMs): q_len up to 3*TQ + 1 (TQ = 64 / qpk),
# kv up to 4 splits of 512 keys (100000 SMs: the plan splits as far as it can)
EMULATED = [
    (8, 2, 32, 8, [49, 1, 17, 1], [49, 300, 700, 1], 132),            # qpk 4: TQ 16
    (8, 2, 32, 16, [49, 1, 17, 2], [1100, 2048, 1500, 530], 100000),  # 4 splits
    (8, 8, 32, 16, [65, 1, 0, 3], [1900, 512, 40, 1024], 100000),     # qpk 1: TQ 64
    (16, 2, 32, 16, [25, 9, 1], [25, 1000, 1537], 100000),            # qpk 8: TQ 8
    (4, 2, 32, 8, [97, 1], [200, 1], 132),                            # qpk 2: TQ 32
]


@pytest.mark.parametrize("H,Hk,D,ps,q_lens,kv_lens,sms", EMULATED)
def test_emulated_decomposition_matches_plain_and_reference(H, Hk, D, ps, q_lens,
                                                           kv_lens, sms):
    """f32, valid rows, atol 1e-5 (summation order; the merge rescales by
    exp(m - max m)): the items and the split merge of ``_plan`` against the
    plain version and JAX's ``ragged_paged_attention_xla`` on the same numpy
    inputs; padding rows are zeros."""
    rng = np.random.default_rng(sum(kv_lens))
    c = _ragged(rng, H, Hk, D, ps, q_lens, kv_lens)
    t = torch.from_numpy
    plan = pa._plan(c["q"].shape[0], c["pts"].shape[0], c["pts"].shape[1], ps, H // Hk,
                    Hk, sms)
    if sms == 100000:
        assert plan.splits > 1
    got = _emulate(t(c["q"]), t(c["pool"]), t(c["pts"]), c["lens"], c["cu"], c["nb"],
                   c["scale"], plan)
    v = c["valid"]
    ref = paged_attention_ref(t(c["q"]), t(c["pool"]), t(c["pts"]), t(c["pos"]),
                              t(c["sids"]), t(c["lens"]), scale=c["scale"])
    np.testing.assert_allclose(got[:v].numpy(), ref[:v].numpy(), atol=1e-5)
    jref = jt.ragged_paged_attention_xla(
        jnp.asarray(c["q"]), jnp.asarray(c["pool"]), jnp.asarray(c["pts"]),
        jnp.asarray(c["pos"]), jnp.asarray(c["sids"]), jnp.asarray(c["lens"]),
        scale=c["scale"])
    np.testing.assert_allclose(got[:v].numpy(), np.asarray(jref, np.float32)[:v], atol=1e-5)
    assert not got[v:].any()


# --------------------------------------------------------- precision design


def test_p_split_into_two_bf16_terms_stays_within_one_rounding_unit():
    """The mma instance's P·V in bfloat16: P = bf16(P) + bf16(P - bf16(P)),
    two products into one f32 accumulator, reads <= 1 rounding unit against
    the f32 plain version on the same bf16 inputs (256 rows, 700 keys, D 64);
    P rounded to bf16 once (one product) reads above 1, as the check's
    p_bf16 control does."""
    rng = np.random.default_rng(7)
    bf = lambda a: torch.from_numpy(a).bfloat16().float()  # noqa: E731
    q = bf(rng.standard_normal((256, 64), np.float32))
    k = bf(rng.standard_normal((700, 64), np.float32))
    v = bf(rng.standard_normal((700, 64), np.float32))
    p = torch.softmax(q @ k.T * 64 ** -0.5, dim=-1)
    ref = p @ v
    hi = p.bfloat16().float()
    lo = (p - hi).bfloat16().float()
    split = (hi @ v + lo @ v).bfloat16()
    once = (hi @ v).bfloat16()
    assert bf16_rounding_units(split, ref) <= 1.0
    assert bf16_rounding_units(once, ref) > 1.0
