"""The CUDA kernels against their plain PyTorch versions, on the card: ragged
paged attention (K1, on K/V pools and on MLA's single-plane latent pool), the
MoE grouped GEMMs (K2 ragged, K4 per-expert) and MLA's latent decode (K3).
bfloat16 runs each attention kernel's mma instance, float32 its simt one; the
instance counts say which ran.
Every test here needs a CUDA device and skips without one.

On a GPU machine (``tests/conftest.py`` imports jax; where jax is not
installed, ``--noconftest`` skips it):

    python -m pytest --noconftest -m gpu tests/test_torch_kernel_gpu.py
"""

import time

import numpy as np
import pytest
import torch

from llmd_tpu_torch.ops import paged_attention as pa
from llmd_tpu_torch.ops.grouped_gemm import (
    grouped_gemm, grouped_gemm_ref, ragged_grouped_gemm, ragged_grouped_gemm_ref)
from llmd_tpu_torch.ops.mla_decode import (
    mla_decode, mla_decode_ref, mla_paged_attention_latent)
from llmd_tpu_torch.ops.paged_attention import (
    bf16_rounding_units, paged_attention, paged_attention_ref)

pytestmark = pytest.mark.gpu

# float32: summation order and exp rounding only (max abs). bfloat16: against
# the plain version in float32 on the same bf16 inputs, element by element in
# units of one bf16 rounding of the output; float32 accumulation rounded once
# reads <= 1 (bf16_rounding_units).
F32_ATOL = 2e-5
BF16_UNITS = 1.0
# grouped GEMMs in float32: unit-scale outputs summed over D <= 1024 in
# another order than cuBLAS's: max abs <= GEMM_F32_ATOL.
GEMM_F32_ATOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _case(H, Hk, D, ps, q_lens, kv_lens, dtype, device, seed, planes=None, max_pages=None):
    rng = np.random.default_rng(seed)
    nb = len(q_lens)
    B = nb + 2  # trailing unused table rows
    need = [-(-k // ps) for k in kv_lens]
    maxp = max(need) + 1 if max_pages is None else max_pages
    P = sum(need) + 4
    perm = rng.permutation(P)
    pts = np.full((B, maxp), -1, np.int32)
    o = 0
    for b in range(nb):
        pts[b, : need[b]] = perm[o : o + need[b]]
        o += need[b]
    N = sum(q_lens) + 3  # trailing padding rows
    pos = np.full((N,), -1, np.int32)
    sids = np.zeros((N,), np.int32)
    cu = np.zeros((B + 1,), np.int32)
    off = 0
    for b, (ql, kl) in enumerate(zip(q_lens, kv_lens)):
        pos[off : off + ql] = np.arange(kl - ql, kl)
        sids[off : off + ql] = b
        off += ql
        cu[b + 1] = off
    cu[nb + 1 :] = off
    lens = np.ones((B,), np.int32)
    lens[:nb] = kv_lens
    q = torch.from_numpy(rng.standard_normal((N, H, D), np.float32))
    pool = torch.from_numpy(rng.standard_normal((P, ps, planes or 2 * Hk, D), np.float32))
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    args = (q.to(device, dtype), pool.to(device, dtype), t(pts), t(pos), t(sids), t(lens))
    kw = dict(scale=D ** -0.5, cu_q_lens=t(cu), num_seqs=t(np.array([nb], np.int32)))
    return args, kw, off


MIXED = ([37, 1, 1, 64, 1], [37, 5, 300, 100, 1])  # chunks, decode rows, kv 1-300
# (H, Hk, D, ps, q_lens, kv_lens). bf16 runs the mma instance (query tiles of
# TQ = 64 / qpk tokens, KV splits from _plan), f32 the simt one.
K1_SHAPES = [
    (4, 2, 32, 8, *MIXED), (32, 8, 64, 16, *MIXED), (8, 8, 128, 16, *MIXED),
    (16, 2, 64, 16, *MIXED),
    # qpk 1, 2, 4, 8 at D 64 and 128, and D 32
    (8, 8, 64, 16, *MIXED), (16, 8, 64, 16, *MIXED), (64, 8, 64, 16, *MIXED),
    (16, 8, 128, 16, *MIXED), (32, 8, 128, 16, *MIXED), (64, 8, 128, 16, *MIXED),
    (8, 8, 32, 16, *MIXED), (16, 2, 32, 16, *MIXED),
    # one sequence at kv 4096: many KV splits
    (32, 8, 64, 16, [1], [4096]),
    # a chunk of TQ + 1 tokens (TQ 16 at qpk 4; 65 at qpk 1) beside decode rows
    (32, 8, 64, 16, [17, 1, 1], [17, 600, 33]),
    (8, 8, 128, 16, [65, 1], [300, 2000]),
    # a 512-token chunk at kv 2048 beside decode rows
    (32, 8, 64, 16, [512, 1, 1, 1], [2048, 100, 1500, 7]),
]


def _check_k1(cuda, H, Hk, D, ps, q_lens, kv_lens, dtype, **kw_case):
    args, kw, valid = _case(H, Hk, D, ps, q_lens, kv_lens, dtype, cuda,
                            seed=H + D + len(q_lens), **kw_case)
    before = paged_attention.launches
    got = paged_attention(*args, **kw)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    q, pool, *rest = args
    ref = paged_attention_ref(q.float(), pool.float(), *rest, **kw)[:valid]
    if dtype == torch.float32:
        err = (got[:valid] - ref).abs().max().item()
        assert err <= F32_ATOL, err
    else:
        units = bf16_rounding_units(got[:valid], ref)
        assert units <= BF16_UNITS, units
    assert torch.count_nonzero(got[valid:]) == 0  # padding rows are zeros


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("H,Hk,D,ps,q_lens,kv_lens", K1_SHAPES)
def test_kernel_matches_plain(cuda, H, Hk, D, ps, q_lens, kv_lens, dtype):
    _check_k1(cuda, H, Hk, D, ps, q_lens, kv_lens, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernel_matches_plain_at_split_multiples(cuda, dtype):
    """kv lengths at whole pages, whole 64-key stages and whole KV splits:
    six one-token rows over a 256-page table, split as the card's plan says."""
    plan = pa._plan(6 + 3, 6 + 2, 256, 16, 4, 8, pa._num_sms(cuda.index or 0))
    L = plan.split_keys
    assert plan.splits > 1 and L % 64 == 0
    kv = [16, 64, L, 2 * L, (4096 // L) * L, 4096]
    _check_k1(cuda, 32, 8, 64, 16, [1] * 6, kv, dtype, max_pages=256)


def test_paged_attention_instance_counts(cuda):
    """bf16 K/V pools and moe-wide-mla's bf16 latent pool (16 heads at width
    160) launch the mma instance; float32, and tiny-mla's latent pool (4
    heads at width 80) in bf16, the simt one; each launch counts once in
    ``launches`` and once in its instance."""
    cases = ((torch.bfloat16, "mma", {}, (32, 8, 64)), (torch.float32, "simt", {}, (32, 8, 64)),
             (torch.bfloat16, "mma", {"planes": 1}, (16, 1, 160)),
             (torch.float32, "simt", {"planes": 1}, (16, 1, 160)),
             (torch.bfloat16, "simt", {"planes": 1}, (4, 1, 80)))
    for dtype, inst, extra, (H, Hk, D) in cases:
        args, kw, _ = _case(H, Hk, D, 16, [3, 1], [40, 200], dtype, cuda, seed=5, **extra)
        before = dict(paged_attention.launches_by_instance)
        n = paged_attention.launches
        paged_attention(*args, **kw)
        torch.cuda.synchronize()
        assert paged_attention.launches == n + 1
        assert paged_attention.launches_by_instance == {**before, inst: before[inst] + 1}


def test_kernel_refuses_misaligned_q(cuda):
    args, kw, _ = _case(32, 8, 64, 16, [1], [10], torch.bfloat16, cuda, seed=0)
    q = args[0]
    odd = torch.empty(q.numel() + 8, dtype=q.dtype, device=cuda)[1:1 + q.numel()].view(q.shape)
    odd.copy_(q)
    with pytest.raises(ValueError, match="16-byte aligned"):
        paged_attention(odd, *args[1:], **kw)


def test_engine_greedy_tokens_same_with_kernel(cuda):
    """The engine on the card (the kernel) emits the same greedy tokens as on
    the CPU (the plain version), same float32 weights, mixed prefill/decode."""
    import dataclasses

    from llmd_tpu_torch.core.request import SamplingParams
    from llmd_tpu_torch.engine import EngineConfig, LLMEngine
    from llmd_tpu_torch.models import get_model_config
    from llmd_tpu_torch.models.transformer import init_params

    cfg = dataclasses.replace(get_model_config("tiny64"), dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    prompts = [list(range(5, 60)), list(range(100, 110)), list(range(7, 200, 3))]
    ecfg = dict(page_size=8, num_pages=64, max_model_len=256, max_batch_size=4,
                prefill_chunk=32, decode_steps=4)
    sp = SamplingParams(max_tokens=12, temperature=0.0)
    before = paged_attention.launches
    on_card = LLMEngine(cfg, EngineConfig(**ecfg), params=params,
                        device=cuda).generate(prompts, sp)
    assert paged_attention.launches > before
    on_cpu = LLMEngine(cfg, EngineConfig(**ecfg), params=params,
                       device="cpu").generate(prompts, sp)
    assert on_card == on_cpu


def test_forward_on_card_matches_cpu(cuda):
    """The [B, T] ``forward`` packs its valid rows for the kernel: float32
    logits on the card (the kernel) match the CPU (the plain version) within
    1e-4 on valid rows; padding rows are zeros on both."""
    import dataclasses

    from llmd_tpu_torch.models import get_model_config
    from llmd_tpu_torch.models import transformer as tt

    cfg = dataclasses.replace(get_model_config("tiny64"), dtype="float32")
    params = tt.init_params(cfg, torch.Generator().manual_seed(1))
    rng = np.random.default_rng(6)
    toks = torch.from_numpy(rng.integers(0, 288, (3, 9)).astype(np.int32))
    pos = torch.tensor([list(range(9)), list(range(5)) + [-1] * 4,
                        list(range(3)) + [-1] * 6], dtype=torch.int32)
    pts = torch.tensor([[0, 1], [2, -1], [3, -1]], dtype=torch.int32)
    lens = torch.tensor([9, 5, 3], dtype=torch.int32)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        p = {k: v.to(dev) for k, v in params.items()}
        before = paged_attention.launches
        logits, _ = tt.forward(cfg, p, tt.init_cache(cfg, 4, 8, device=dev), toks.to(dev),
                               pos.to(dev), pts.to(dev), lens.to(dev))
        assert paged_attention.launches - before == (cfg.num_layers if dev.type == "cuda" else 0)
        outs.append(logits.cpu())
    valid = pos >= 0
    assert (outs[0][valid] - outs[1][valid]).abs().max().item() <= 1e-4
    assert not outs[0][~valid].any() and not outs[1][~valid].any()


def test_kernel_refuses_unsupported_shape(cuda):
    args, kw, _ = _case(12, 4, 64, 16, [1], [10], torch.float32, cuda, seed=0)
    with pytest.raises(ValueError):  # 3 query heads per kv head: no instance
        paged_attention(*args, **kw)


def _gemm_operands(groups, rows, D, F, S, dtype, device, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((groups, rows, D), np.float32))
    w = torch.from_numpy(rng.standard_normal((S, D, F), np.float32) * D ** -0.5)
    return x.to(device, dtype), w.to(device, dtype), rng


def _hold(got, ref, dtype):
    if dtype == torch.float32:
        err = (got - ref).abs().max().item()
        assert err <= GEMM_F32_ATOL, err
    else:
        units = bf16_rounding_units(got, ref)
        assert units <= BF16_UNITS, units


# (nb, bc, D, F, S): the decode and prefill blocks of moe-wide-sim (wi and wo
# widths), ragged widths (F = 200, D = 100: the simt instance in bf16 too),
# one-row and 130-row blocks; rows 64 and 65 (either side of the wgmma
# instance's m64 / 128-row tiles), D 136 (not a multiple of its 64-deep step),
# F = 200 at D = 8 and 16 (below one column tile and one depth step), every
# block on one slot (S 1), and runs of consecutive blocks on one slot (12
# blocks over 2 slots: slots 1 0 0 1 0 0 1 0 0 0 0 1 from the seed)
RGG_SHAPES = [(48, 8, 1024, 1024, 32), (96, 128, 512, 1024, 64), (7, 1, 64, 200, 4),
              (5, 37, 100, 200, 3), (3, 130, 128, 64, 2), (4, 64, 256, 192, 3),
              (3, 65, 136, 128, 2), (7, 8, 8, 200, 4), (5, 16, 16, 200, 3),
              (9, 32, 512, 256, 1), (12, 8, 1024, 1024, 2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("nb,bc,D,F,S", RGG_SHAPES)
def test_ragged_grouped_gemm_matches_plain(cuda, nb, bc, D, F, S, dtype):
    """Random slots, random dead rows (multiplied like live ones), and
    zero-row blocks (exact zeros)."""
    x, w, rng = _gemm_operands(nb, bc, D, F, S, dtype, cuda, seed=nb + D)
    slot = torch.from_numpy(rng.integers(0, S, nb).astype(np.int32)).to(cuda)
    rows_np = rng.integers(0, bc + 1, nb).astype(np.int32)
    rows_np[::3] = 0
    rows = torch.from_numpy(rows_np).to(cuda)
    before = ragged_grouped_gemm.launches
    got = ragged_grouped_gemm(x, w, slot, rows)
    torch.cuda.synchronize()
    assert ragged_grouped_gemm.launches == before + 1
    ref = ragged_grouped_gemm_ref(x.float(), w.float(), slot, rows)
    _hold(got, ref, dtype)
    assert torch.count_nonzero(got[rows == 0]) == 0


# (G, C, D, F): moe-wide-sim capacity shapes at decode (C 5) and prefill
# (C 320), ragged widths, one-row groups; C 64, 65 and 130 (across the wgmma
# instance's row tiles), F = 200 at D = 8 and 16
GG_SHAPES = [(32, 5, 1024, 1024), (32, 320, 512, 1024), (6, 1, 64, 200), (4, 37, 100, 200),
             (4, 64, 256, 192), (3, 65, 136, 128), (2, 130, 128, 64), (6, 5, 8, 200),
             (3, 16, 16, 200)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("G,C,D,F", GG_SHAPES)
def test_grouped_gemm_matches_plain(cuda, G, C, D, F, dtype):
    x, w, rng = _gemm_operands(G, C, D, F, G, dtype, cuda, seed=G + C)
    counts_np = rng.integers(0, C + 1, G).astype(np.int32)
    counts_np[::4] = 0
    counts = torch.from_numpy(counts_np).to(cuda)
    before = grouped_gemm.launches
    got = grouped_gemm(x, w, counts)
    torch.cuda.synchronize()
    assert grouped_gemm.launches == before + 1
    _hold(got, grouped_gemm_ref(x.float(), w.float(), counts), dtype)
    assert torch.count_nonzero(got[counts == 0]) == 0


def test_grouped_gemm_instance_counts(cuda):
    """At moe-wide-sim widths bf16 launches only the wgmma instance and f32
    only the simt one, on both wrappers; a bf16 input at an odd offset (not
    16-byte aligned) is copied, not refused."""
    for dtype, inst in ((torch.bfloat16, "wgmma"), (torch.float32, "simt")):
        x, w, rng = _gemm_operands(6, 8, 1024, 1024, 4, dtype, cuda, seed=3)
        slot = torch.from_numpy(rng.integers(0, 4, 6).astype(np.int32)).to(cuda)
        live = torch.full((6,), 8, dtype=torch.int32, device=cuda)
        rgg, gg = (dict(f.launches_by_instance) for f in (ragged_grouped_gemm, grouped_gemm))
        got = ragged_grouped_gemm(x, w, slot, live)
        got4 = grouped_gemm(x[:4], w, live[:4])
        torch.cuda.synchronize()
        for f, before in ((ragged_grouped_gemm, rgg), (grouped_gemm, gg)):
            assert f.launches_by_instance == {**before, inst: before[inst] + 1}
        _hold(got, ragged_grouped_gemm_ref(x.float(), w.float(), slot, live), dtype)
        _hold(got4, grouped_gemm_ref(x[:4].float(), w.float(), live[:4]), dtype)
    wb = w.to(torch.bfloat16)
    odd = torch.empty(x.numel() + 1, dtype=torch.bfloat16, device=cuda)[1:].view(x.shape)
    odd.copy_(x)
    assert odd.data_ptr() % 16 != 0
    _hold(ragged_grouped_gemm(odd, wb, slot, live),
          ragged_grouped_gemm_ref(odd.float(), wb.float(), slot, live), torch.bfloat16)


@pytest.mark.parametrize("dispatch", ["sorted", "einsum"])
def test_moe_engine_greedy_tokens_same_with_kernels(cuda, dispatch):
    """tiny-moe in float32: the engine on the card (K1 and K2 or K4) emits the
    same greedy tokens as on the CPU (the plain versions), same weights."""
    import dataclasses

    from llmd_tpu_torch.core.request import SamplingParams
    from llmd_tpu_torch.engine import EngineConfig, LLMEngine
    from llmd_tpu_torch.models import get_model_config
    from llmd_tpu_torch.models.transformer import init_params

    cfg = dataclasses.replace(get_model_config("tiny-moe"), dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    prompts = [list(range(5, 60)), list(range(100, 110)), list(range(7, 200, 3))]
    ecfg = dict(page_size=8, num_pages=64, max_model_len=256, max_batch_size=4,
                prefill_chunk=32, decode_steps=4, moe_dispatch=dispatch)
    sp = SamplingParams(max_tokens=12, temperature=0.0)
    kernel = ragged_grouped_gemm if dispatch == "sorted" else grouped_gemm
    before = kernel.launches
    eng = LLMEngine(cfg, EngineConfig(**ecfg), params=params, device=cuda)
    on_card = eng.generate(prompts, sp)
    assert kernel.launches > before
    cpu = LLMEngine(cfg, EngineConfig(**ecfg), params=params, device="cpu")
    assert cpu.generate(prompts, sp) == on_card
    assert cpu.stats.moe_dropped_tokens == eng.stats.moe_dropped_tokens


# ------------------------------------------------------------------- MLA


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("H,W,ps", [(16, 160, 16), (4, 80, 8)])  # moe-wide-mla, tiny-mla
def test_latent_kernel_matches_plain(cuda, H, W, ps, dtype):
    """K1 on the single-plane latent pool: decode rows, a fresh prefill chunk
    and continuation chunks at the latent width, against the plain version
    reading the one plane as K and V."""
    q_lens = [37, 1, 1, 64, 1, 20]
    kv_lens = [37, 5, 300, 100, 1, 140]
    args, kw, valid = _case(H, 1, W, ps, q_lens, kv_lens, dtype, cuda, seed=W, planes=1)
    kw["scale"] = 0.125
    before = paged_attention.launches
    got = paged_attention(*args, **kw)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    q, pool, *rest = args
    ref = paged_attention_ref(q.float(), pool.float(), *rest, **kw)[:valid]
    if dtype == torch.float32:
        err = (got[:valid] - ref).abs().max().item()
        assert err <= F32_ATOL, err
    else:
        units = bf16_rounding_units(got[:valid], ref)
        assert units <= BF16_UNITS, units
    assert torch.count_nonzero(got[valid:]) == 0  # padding rows are zeros


def _latent_decode_case(B, H, W, ps, dtype, device, seed):
    """B one-token queries; kv_len 0 (idle) on every fifth row, the rest 1 to
    700 from the seed; pages shuffled, -1 past each sequence."""
    rng = np.random.default_rng(seed)
    kv = rng.integers(1, 701, B).astype(np.int32)
    kv[::5] = 0
    need = -(-kv // ps)
    maxp = int(need.max()) + 1
    P = int(need.sum()) + 3
    perm = rng.permutation(P)
    pts = np.full((B, maxp), -1, np.int32)
    o = 0
    for b in range(B):
        pts[b, : need[b]] = perm[o : o + need[b]]
        o += need[b]
    q = torch.from_numpy(rng.standard_normal((B, H, W), np.float32)).to(device, dtype)
    pool = torch.from_numpy(rng.standard_normal((P, ps, 1, W), np.float32)).to(device, dtype)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return q, pool, t(pts), t(kv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,H,W,ps", [(64, 16, 160, 16), (7, 16, 160, 16), (9, 4, 80, 8)])
def test_mla_decode_kernel_matches_plain(cuda, B, H, W, ps, dtype):
    """K3 against its plain version. The kernel pre-scales q and rounds it to
    its dtype, as the reference does; the float32 oracle takes that rounded
    q at scale 1. Idle rows (kv_len 0) are exact zeros."""
    q, pool, pts, kv = _latent_decode_case(B, H, W, ps, dtype, cuda, seed=B + W)
    scale = 0.125
    before = mla_decode.launches
    got = mla_paged_attention_latent(q, pool, pts, None, None, kv, scale=scale)
    torch.cuda.synchronize()
    assert mla_decode.launches == before + 1
    q_scaled = (q.float() * scale).to(dtype).float()
    ref = mla_decode_ref(q_scaled, pool.float(), pts.clamp(min=0), kv, scale=1.0)
    if dtype == torch.float32:
        err = (got - ref).abs().max().item()
        assert err <= F32_ATOL, err
    else:
        units = bf16_rounding_units(got, ref)
        assert units <= BF16_UNITS, units
    assert torch.count_nonzero(got[kv == 0]) == 0


def _k3_case(H, W, ps, kv, dtype, device, seed):
    """One query row per sequence at the given kv lengths (0: idle), pages
    shuffled, table entries past each sequence clamped to page 0 as the
    adapter passes them."""
    rng = np.random.default_rng(seed)
    kv = np.asarray(kv, np.int32)
    need = -(-kv // ps)
    maxp = max(int(need.max()), 1) + 1
    P = int(need.sum()) + 3
    perm = rng.permutation(P)
    pts = np.zeros((len(kv), maxp), np.int32)
    o = 0
    for b in range(len(kv)):
        pts[b, : need[b]] = perm[o : o + need[b]]
        o += need[b]
    q = torch.from_numpy(rng.standard_normal((len(kv), H, W), np.float32)).to(device, dtype)
    pool = torch.from_numpy(rng.standard_normal((P, ps, 1, W), np.float32)).to(device, dtype)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return q, pool, t(pts), t(kv)


def _check_k3(cuda, H, W, ps, kv, dtype, seed):
    """K3 on its instance (bf16 at moe-wide-mla's shape: mma; f32 and
    tiny-mla's shape: simt) against the plain version on the kernel's
    rounded q at scale 1; idle rows exact zeros."""
    from llmd_tpu_torch.ops import mla_decode as md

    q, pool, pts, lens = _k3_case(H, W, ps, kv, dtype, cuda, seed)
    scale = 0.125
    want = md._instance(dtype, H, W)
    assert want == ("mma" if dtype == torch.bfloat16 and (H, W) in md.MMA_SHAPES else "simt")
    before = dict(mla_decode.launches_by_instance)
    got = mla_paged_attention_latent(q, pool, pts, None, None, lens, scale=scale)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in mla_decode.launches_by_instance.items()} == {
        k: int(k == want) for k in before}
    q_scaled = (q.float() * scale).to(dtype).float()
    ref = mla_decode_ref(q_scaled, pool.float(), pts, lens, scale=1.0)
    live = lens > 0
    if dtype == torch.float32:
        err = (got[live] - ref[live]).abs().max().item()
        assert err <= F32_ATOL, err
    else:
        units = bf16_rounding_units(got[live], ref[live])
        assert units <= BF16_UNITS, units
    assert torch.count_nonzero(got[~live]) == 0


# (H, W, ps, kv): B 1 at kv 1 / 16 / 17 / 4096 (16 splits), B 8 with an idle
# row, tiny-mla's heads (simt in both dtypes)
K3_CASES = [
    (16, 160, 16, [1]), (16, 160, 16, [16]), (16, 160, 16, [17]), (16, 160, 16, [4096]),
    (16, 160, 16, [4096, 1, 17, 16, 0, 2048, 3000, 600]),
    (4, 80, 8, [1, 17, 4096, 0, 16, 999, 256, 5]),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("H,W,ps,kv", K3_CASES)
def test_mla_decode_kernel_cases(cuda, H, W, ps, kv, dtype):
    _check_k3(cuda, H, W, ps, kv, dtype, seed=len(kv) + W)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_mla_decode_kernel_b64_with_idle_rows(cuda, dtype):
    rng = np.random.default_rng(64)
    kv = np.concatenate([rng.integers(1, 1025, 64), [0, 0]])
    _check_k3(cuda, 16, 160, 16, kv, dtype, seed=64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_mla_decode_kernel_at_split_multiples(cuda, dtype):
    """kv at whole pages, 64-key stages and whole KV splits, as the card's
    plan splits a 4096-key table over 7 sequences."""
    from llmd_tpu_torch.ops import mla_decode as md

    plan = md._plan(8, 4096 // 16 + 1, 16, md._num_sms(cuda.index or 0))
    L = plan.split_keys
    assert plan.splits > 1 and L % 64 == 0
    _check_k3(cuda, 16, 160, 16, [16, 64, L, 2 * L, (4096 // L) * L, 4096, 3 * L, 0], dtype,
              seed=L)


def _check_k1_latent(cuda, H, W, ps, q_lens, kv_lens, dtype, seed, max_pages=None):
    args, kw, valid = _case(H, 1, W, ps, q_lens, kv_lens, dtype, cuda, seed=seed, planes=1,
                            max_pages=max_pages)
    kw["scale"] = 0.125
    want = pa._instance(dtype, 1, W, H)
    assert want == ("mma" if dtype == torch.bfloat16 and W == 160 else "simt")
    before = dict(paged_attention.launches_by_instance)
    got = paged_attention(*args, **kw)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in paged_attention.launches_by_instance.items()} == {
        k: int(k == want) for k in before}
    q, pool, *rest = args
    ref = paged_attention_ref(q.float(), pool.float(), *rest, **kw)[:valid]
    if dtype == torch.float32:
        err = (got[:valid] - ref).abs().max().item()
        assert err <= F32_ATOL, err
    else:
        units = bf16_rounding_units(got[:valid], ref)
        assert units <= BF16_UNITS, units
    assert torch.count_nonzero(got[valid:]) == 0  # padding rows are zeros


_DECODE_KV = list(np.random.default_rng(5).integers(128, 1025, 64))
# (H, W, ps, q_lens, kv_lens): decode rows; a chunk of TQ + 1 tokens (TQ 4 at
# 16 heads, 16 at 4) beside decode rows; a 512-token chunk at kv 2048
K1_LATENT_CASES = [
    (16, 160, 16, [1] * 64, _DECODE_KV),
    (16, 160, 16, [5, 1, 1], [900, 33, 1]),
    (16, 160, 16, [512, 1, 1, 1], [2048, 100, 1500, 7]),
    (4, 80, 8, [17, 1, 1], [17, 600, 33]),
    (4, 80, 8, [512, 1], [2048, 300]),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("H,W,ps,q_lens,kv_lens", K1_LATENT_CASES)
def test_latent_kernel_cases(cuda, H, W, ps, q_lens, kv_lens, dtype):
    _check_k1_latent(cuda, H, W, ps, q_lens, kv_lens, dtype, seed=sum(q_lens) + W)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_latent_kernel_at_split_multiples(cuda, dtype):
    """Six one-token rows over a 256-page latent table, kv at whole pages,
    stages and the splits of the card's plan (tiles of 4 tokens x 16 heads)."""
    plan = pa._plan(6 + 3, 6 + 2, 256, 16, 16, 1, pa._num_sms(cuda.index or 0))
    L = plan.split_keys
    assert plan.splits > 1 and L % 64 == 0
    _check_k1_latent(cuda, 16, 160, 16, [1] * 6, [16, 64, L, 2 * L, (4096 // L) * L, 4096],
                     dtype, seed=L, max_pages=256)


def test_mla_kernels_refuse_unsupported_shapes(cuda):
    q, pool, pts, kv = _latent_decode_case(4, 4, 160, 16, torch.float32, cuda, seed=0)
    with pytest.raises(ValueError):  # 4 heads at width 160: no K3 instance
        mla_decode(q, pool, pts.clamp(min=0), kv, scale=0.1)
    args, kw, _ = _case(16, 1, 96, 16, [1], [10], torch.float32, cuda, seed=0, planes=1)
    with pytest.raises(ValueError):  # latent width 96: no K1 latent instance
        paged_attention(*args, **kw)


def test_mla_engine_greedy_tokens_same_with_kernels(cuda):
    """tiny-mla in float32 on the card: the engine through K1-latent and K3
    emits the same greedy tokens as the same engine with the plain versions
    passed in their place, same weights, mixed prefill/decode."""
    import dataclasses
    import functools

    from llmd_tpu_torch.core.request import SamplingParams
    from llmd_tpu_torch.engine import EngineConfig, LLMEngine
    from llmd_tpu_torch.models import get_model_config
    from llmd_tpu_torch.models.transformer import init_params

    cfg = dataclasses.replace(get_model_config("tiny-mla"), dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    prompts = [list(range(5, 60)), list(range(100, 110)), list(range(7, 200, 3))]
    ecfg = dict(page_size=8, num_pages=64, max_model_len=256, max_batch_size=4,
                prefill_chunk=32, decode_steps=4)
    sp = SamplingParams(max_tokens=12, temperature=0.0)
    k1, k3 = paged_attention.launches, mla_decode.launches
    on_card = LLMEngine(cfg, EngineConfig(**ecfg), params=params, device=cuda)
    assert on_card.attn_backend == "cuda_paged_attention_latent+cuda_mla_latent_decode"
    kernels = on_card.generate(prompts, sp)
    assert paged_attention.launches > k1 and mla_decode.launches > k3
    plain = LLMEngine(cfg, EngineConfig(**ecfg), params=params, device=cuda)
    plain._attn = {"unified": paged_attention_ref,
                   "decode": functools.partial(mla_paged_attention_latent,
                                               decode=mla_decode_ref)}
    k1, k3 = paged_attention.launches, mla_decode.launches
    assert plain.generate(prompts, sp) == kernels
    assert (paged_attention.launches, mla_decode.launches) == (k1, k3)


# ------------------------------------------- the decode program's CUDA graph


def _engine(model, cuda, decode_graph=True, **kw):
    from llmd_tpu_torch.engine import EngineConfig, LLMEngine
    from llmd_tpu_torch.models import get_model_config

    ecfg = dict(page_size=8, num_pages=96, max_model_len=256, max_batch_size=4,
                prefill_chunk=32, decode_steps=4) | kw
    return LLMEngine(get_model_config(model), EngineConfig(**ecfg), seed=0, device=cuda,
                     decode_graph=decode_graph)


def _launches():
    return {fn.__name__: (fn.launches, dict(fn.launches_by_instance)) for fn in
            (paged_attention, mla_decode, ragged_grouped_gemm, grouped_gemm)}


GRAPH_MODELS = [("tiny", {}), ("tiny-moe", {"moe_dispatch": "sorted"}),
                ("tiny-moe", {"moe_dispatch": "einsum"}), ("tiny-mla", {})]


@pytest.mark.parametrize("model,kw", GRAPH_MODELS,
                         ids=["tiny", "tiny-moe-sorted", "tiny-moe-einsum", "tiny-mla"])
def test_decode_graph_matches_eager(cuda, model, kw):
    """bf16 registry weights: the decode program replayed from its graph
    gives the greedy tokens and kernel launches of the same program run
    eagerly, with the pipelined dispatch on; one capture, one replay a call."""
    _check_graph_matches_eager(cuda, model, kw)


@pytest.mark.parametrize("model,kw", GRAPH_MODELS,
                         ids=["tiny", "tiny-moe-sorted", "tiny-moe-einsum", "tiny-mla"])
def test_int8_decode_graph_matches_eager(cuda, model, kw):
    """The same with int8 weight-only weights: replayed = eager tokens and
    launches, and no grouped-GEMM launch (int8 banks run plain products)."""
    counts = _check_graph_matches_eager(cuda, model, kw | {"quantize_weights": "int8"})
    assert counts["ragged_grouped_gemm"][0] == counts["grouped_gemm"][0] == 0
    assert counts["paged_attention"][0] > 0


def _check_graph_matches_eager(cuda, model, kw) -> dict:
    """Replayed vs eager on one model and config; returns the kernel launches
    of the replayed run."""
    from llmd_tpu_torch.core.request import SamplingParams

    prompts = [list(range(5, 60)), list(range(100, 110)), list(range(7, 200, 3))]
    sp = SamplingParams(max_tokens=13, temperature=0.0)
    out, counts, stats = {}, {}, {}
    for graph in (True, False):
        eng = _engine(model, cuda, decode_graph=graph, **kw)
        before = _launches()
        out[graph] = eng.generate(prompts, sp)
        after = _launches()
        counts[graph] = {n: (after[n][0] - before[n][0],
                             {i: after[n][1][i] - before[n][1][i] for i in after[n][1]})
                         for n in after}
        stats[graph] = eng.stats
    assert out[True] == out[False]
    assert counts[True] == counts[False]
    g = stats[True]
    assert g.decode_graph_captures == 1 and g.decode_graph_replays == g.n_decode_calls > 0
    assert g.n_chained_dispatches > 0
    assert stats[False].decode_graph_captures == stats[False].decode_graph_replays == 0
    assert g.moe_dropped_tokens == stats[False].moe_dropped_tokens
    return counts[True]


def test_decode_graph_sampling_draws_fresh_numbers(cuda):
    """Sampled rows under replay: the generator registered with the graph
    advances every replay, so the streams are not stuck on one draw and two
    runs of the same prompts differ."""
    from llmd_tpu_torch.core.request import SamplingParams

    eng = _engine("tiny", cuda, decode_steps=2)
    sp = SamplingParams(max_tokens=24, temperature=1.5)
    prompts = [list(range(5, 30))] * 3
    a, b = eng.generate(prompts, sp), eng.generate(prompts, sp)
    assert eng.stats.decode_graph_captures == 1 and eng.stats.decode_graph_replays > 4
    streams = list(a.values()) + list(b.values())
    assert all(len(set(s[1:])) > 3 for s in streams)  # decoded tokens vary
    assert len({tuple(s) for s in streams}) == len(streams)  # runs differ


def test_capture_survives_another_threads_device_calls(cuda):
    """A capture in one thread is not invalidated by what a second engine of
    the process does meanwhile on its own stream (allocating, copying to
    pinned memory, reading back, waiting on an event), and the replay gives
    the eager result."""
    import threading

    from llmd_tpu_torch.engine.cuda_graph import CapturedProgram

    torch.manual_seed(0)
    x = torch.randn(1024, 1024, device=cuda) / 32
    out = torch.empty_like(x)

    def fn():
        y = x
        for _ in range(64):
            y = torch.tanh(y @ x)
        out.copy_(y)
        return out

    prog = CapturedProgram(fn, cuda, torch.Generator(device=cuda))
    stop, running, errors = threading.Event(), threading.Event(), []

    def other():
        n = 0
        with torch.cuda.stream(torch.cuda.Stream(cuda)):
            while not stop.is_set():
                n = n % 64 + 1
                try:
                    t = torch.ones(4096 * n, device=cuda) * 2
                    host = torch.empty(16, pin_memory=True)
                    host.copy_(t[:16], non_blocking=True)
                    done = torch.cuda.Event()
                    done.record()
                    done.synchronize()
                    assert t.sum().item() == 8192.0 * n and host.sum().item() == 32.0
                except Exception as e:  # noqa: BLE001 — reported below
                    errors.append(repr(e))
                    return
                running.set()

    th = threading.Thread(target=other)
    th.start()
    try:
        assert running.wait(30)
        got = prog().clone()
        torch.cuda.synchronize(cuda)
    finally:
        stop.set()
        th.join(30)
    assert not errors, errors
    torch.testing.assert_close(got, fn().clone())


def test_decode_graph_launch_counters(cuda):
    """After replays, each wrapper's counters hold what the capture counted
    times the replays (the warm-up and the capture itself count nothing),
    per instance too."""
    from llmd_tpu_torch.core.request import SamplingParams
    from llmd_tpu_torch.engine.cuda_graph import launch_counters

    eng = _engine("tiny-moe", cuda, moe_dispatch="sorted")
    cfg, k = eng.model_cfg, eng.cfg.decode_steps
    before = _launches()
    eng.generate([list(range(5, 40)), list(range(50, 70))],
                 SamplingParams(max_tokens=14, temperature=0.0))
    after = _launches()
    graph = eng._decode_fn
    per = {fn.__name__: c for fn, c in zip(launch_counters(), graph.per_replay)}
    assert per["paged_attention"][0] == cfg.num_layers * k
    assert per["ragged_grouped_gemm"][0] == 2 * cfg.num_layers * k
    assert per["mla_decode"][0] == per["grouped_gemm"][0] == 0
    replays, unified = eng.stats.decode_graph_replays, eng.stats.n_unified_steps
    assert replays > 1
    unified_per = {"paged_attention": cfg.num_layers, "ragged_grouped_gemm": 2 * cfg.num_layers}
    for name, (n, by) in per.items():
        got = after[name][0] - before[name][0]
        assert got == n * replays + unified_per.get(name, 0) * unified, name
    bf16 = {"paged_attention": "mma", "ragged_grouped_gemm": "wgmma"}
    for name, inst in bf16.items():
        assert per[name][1][inst] == per[name][0]


def test_decode_graph_reads_eplb_placement_in_place(cuda):
    """An EPLB rebalance between calls changes what the replayed graph
    computes: new logical expert weights re-gathered in place into the
    physical slots (same buffers) change the replayed tokens, to those of
    the same program run eagerly on the new weights."""
    from llmd_tpu_torch.core.request import SamplingParams
    from llmd_tpu_torch.engine.decode_program import decode_program, run_chained
    from llmd_tpu_torch.parallel.eplb import EPLBConfig

    eng = _engine("tiny-moe", cuda, eplb=EPLBConfig(window_size=4, step_interval=2,
                                                    num_redundant_experts=4))
    eng.generate([list(range(5, 40))], SamplingParams(max_tokens=10, temperature=0.0))
    buf, graph = eng._decode_bufs, eng._decode_fn
    ptrs = {n: t.data_ptr() for n, t in eng._eplb_params.items()}

    def pack():
        buf.idle()
        for i in range(4):  # every slot live: 20 tokens on pages 4i, 4i+1, 4i+2
            buf.tokens[i], buf.positions[i], buf.kv_lens[i] = 11 + i, 19, 20
            buf.page_tables[i, :3] = torch.arange(4 * i, 4 * i + 3)
            buf.steps_left[i] = 4

    def eager():
        pack()
        return run_chained(lambda: decode_program(
            eng.model_cfg, eng._run_params(), eng.cache, buf, 4, eng._gen,
            attn_impl=eng._attn["decode"], moe_dispatch_impl=eng._moe_dispatch_impl),
            buf, drops=True, counts=True).clone()

    def replayed():
        pack()
        return graph().clone()

    old = replayed()
    assert torch.equal(old, eager())
    g = torch.Generator(device=cuda).manual_seed(7)
    for name in ("moe_wi", "moe_wo"):
        w = eng.params[name]
        w.copy_(torch.randn(w.shape, generator=g, device=cuda).to(w.dtype) * w.float().std())
    eng._eplb_rebalance()
    assert {n: t.data_ptr() for n, t in eng._eplb_params.items()} == ptrs
    new = replayed()
    assert torch.equal(new, eager())
    n_tok = 4 * 4
    assert not torch.equal(new[:n_tok], old[:n_tok])


def test_decode_graph_metrics_count_what_replays_produced(cuda):
    """The decode program's metric families move on the host when a replayed
    call's readback is processed: each call adds to ``decode_tokens`` exactly
    the tokens it produced (the graph's warm-up and capture add nothing), and
    the replayed engine's counters equal the eager engine's on the same
    prompts."""
    from llmd_tpu_torch.core.request import SamplingParams

    prompts = [list(range(5, 60)), list(range(100, 110))]
    sp = SamplingParams(max_tokens=13, temperature=0.0)
    counters = {}
    for graph in (True, False):
        eng = _engine("tiny", cuda, decode_graph=graph)
        m, process, calls = eng.metrics, eng._decode_process, []

        def counted(rec, m=m, eng=eng, process=process, calls=calls):
            before, n_out = m.decode_tokens.value, len(eng._outputs)
            process(rec)
            produced = sum(len(o.new_token_ids) for o in eng._outputs[n_out:])
            calls.append((m.decode_tokens.value - before, produced))

        eng._decode_process = counted
        eng.generate(prompts, sp)
        st = eng.stats
        assert calls and all(delta == produced for delta, produced in calls), calls
        if graph:
            assert st.decode_graph_captures == 1 and st.decode_graph_replays == len(calls)
        assert m.decode_tokens.value == st.total_decode_tokens
        assert m.prefill_tokens.value == st.total_prefill_tokens
        assert m.program_dispatches.labels(program="decode").value == st.n_decode_dispatches
        counters[graph] = {(n, lab): v for n, lab, v in eng.registry.collect()
                           if n.endswith("_total") and "goodput" not in n
                           and "compiles" not in n}
    assert counters[True] == counters[False]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernel_matches_plain_at_verify_shape(cuda, dtype):
    """K1 at the speculative verify batch: 64 sequences of 5 query tokens
    (the last token and a 4-token draft) at kv 128-1024, llama-1b heads."""
    rng = np.random.default_rng(5)
    kv = rng.integers(128, 1025, 64).tolist()
    _check_k1(cuda, 32, 8, 64, 16, [5] * 64, kv, dtype)


def test_masked_decode_graph_matches_eager(cuda):
    """The masked decode program replayed from its graph (captured at the
    first constrained call, beside the plain program's) against the same
    program run eagerly: the same tokens for a mixed batch (plain, choice,
    regex, logit_bias rows) over chained calls, one capture per program and
    a replay a call; an engine that never sees a constrained row captures
    only the plain program."""
    from llmd_tpu_torch.core.request import SamplingParams
    from llmd_tpu_torch.engine.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    z = tok.encode("z")[0]
    reqs = [(tok.encode("the quick brown fox"), dict(max_tokens=20, ignore_eos=True)),
            (tok.encode("pick a color"), dict(guided_choice=["red", "green", "blue"])),
            (tok.encode("emit bits"), dict(guided_regex=r"[ab]{24}")),
            (tok.encode("say"), dict(max_tokens=9, logit_bias={z: 100}))]
    out, stats = {}, {}
    for graph in (True, False):
        eng = _engine("tiny", cuda, decode_graph=graph, decode_steps=4)
        eng.tokenizer = tok
        for i, (p, kw) in enumerate(reqs):
            eng.add_request(f"r{i}", p, SamplingParams(**{
                "max_tokens": 40, "temperature": 0.0, "stop_token_ids": (tok.eos_id,), **kw}))
        got = {}
        while eng.has_work():
            for o in eng.step():
                got.setdefault(o.request_id, []).extend(o.new_token_ids)
        out[graph], stats[graph] = got, eng.stats
        assert eng.stats.structured_violations == 0 and eng.programs.quiesced()
        if graph:
            counts = eng.compile_counts()
            assert counts["decode_masked"] == 1 and eng.stats.n_chained_dispatches > 0
            masked = eng.programs.counters()["decode_masked"][0]
            assert masked > 0
    assert out[True] == out[False]
    assert stats[True].decode_graph_replays == stats[True].n_decode_calls
    plain = _engine("tiny", cuda, decode_steps=4)
    plain.generate([list(range(5, 40))], SamplingParams(max_tokens=12, temperature=0.0))
    assert plain.compile_counts()["decode_masked"] == 0 and plain._mask_buffers is None


# ------------------------------------------------ fp8 pools (float8_e4m3fn)


def _fp8(pool):
    """The pool as the engine writes an fp8 pool: clamped to +-448, cast."""
    return pool.float().clamp(-448.0, 448.0).to(torch.float8_e4m3fn)


def _count_one(fn, want, call):
    before = dict(fn.launches_by_instance)
    out = call()
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in fn.launches_by_instance.items()} == {
        k: int(k == want) for k in before}
    return out


FP8_K1_CASES = [(32, 8, 64, 16, *MIXED), (8, 8, 128, 16, *MIXED), (16, 2, 32, 16, *MIXED),
                (32, 8, 64, 16, [1], [4096]), (32, 8, 64, 16, [512, 1, 1, 1],
                                                [2048, 100, 1500, 7]),
                (32, 8, 64, 16, [5] * 64, list(np.random.default_rng(5).integers(128, 1025,
                                                                                64)))]


@pytest.mark.parametrize("H,Hk,D,ps,q_lens,kv_lens", FP8_K1_CASES)
def test_fp8_k1_equals_bf16_instance_on_upcast_pool(cuda, H, Hk, D, ps, q_lens, kv_lens):
    """K1's mma instance over an fp8 pool converts each stage to bf16 in
    shared memory and computes as the bf16 instance does: its output equals
    the bf16 instance's on ``pool.to(torch.bfloat16)`` bit for bit, under the
    same plan; and it stays within one bf16 rounding unit of the plain
    version (which upcasts the fp8 pool) in float32."""
    args, kw, valid = _case(H, Hk, D, ps, q_lens, kv_lens, torch.bfloat16, cuda,
                            seed=H + D + len(q_lens))
    q, pool, *rest = args
    p8 = _fp8(pool)
    got = _count_one(paged_attention, "mma_fp8", lambda: paged_attention(q, p8, *rest, **kw))
    twin = _count_one(paged_attention, "mma",
                      lambda: paged_attention(q, p8.to(torch.bfloat16), *rest, **kw))
    assert torch.equal(got, twin)
    ref = paged_attention_ref(q.float(), p8, *rest, **kw)[:valid]
    assert bf16_rounding_units(got[:valid], ref) <= BF16_UNITS


@pytest.mark.parametrize("H,W,ps,q_lens,kv_lens", K1_LATENT_CASES[:3])
def test_fp8_k1_latent_equals_bf16_instance_on_upcast_pool(cuda, H, W, ps, q_lens, kv_lens):
    args, kw, valid = _case(H, 1, W, ps, q_lens, kv_lens, torch.bfloat16, cuda,
                            seed=sum(q_lens) + W, planes=1)
    kw["scale"] = 0.125
    q, pool, *rest = args
    p8 = _fp8(pool)
    got = _count_one(paged_attention, "mma_fp8", lambda: paged_attention(q, p8, *rest, **kw))
    twin = paged_attention(q, p8.to(torch.bfloat16), *rest, **kw)
    assert torch.equal(got, twin)
    ref = paged_attention_ref(q.float(), p8, *rest, **kw)[:valid]
    assert bf16_rounding_units(got[:valid], ref) <= BF16_UNITS


# (H, Hk, D, planes): K/V pools at each head dim, the latent widths of the
# simt instance (160 at 8 heads a block, 80 at 4)
FP8_SIMT = [(32, 8, 64, None), (8, 8, 128, None), (16, 2, 32, None), (16, 1, 160, 1),
            (4, 1, 80, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("H,Hk,D,planes", FP8_SIMT)
def test_fp8_k1_simt(cuda, H, Hk, D, planes, dtype):
    """The simt instance over an fp8 pool converts each element as it reads
    it: equal bit for bit to the simt instance of q's dtype on the pool
    upcast to q's dtype; float32 within F32_ATOL of the plain version.
    bfloat16 q reaches simt_fp8 through the wrapper on tiny-mla's latent
    pool (width 80); the others are launched directly."""
    args, kw, valid = _case(H, Hk, D, 16, *MIXED, dtype, cuda, seed=H + D, planes=planes)
    q, pool, pts, pos, sids, lens = args
    p8 = _fp8(pool)
    group = pa._check(q, p8, pts, lens, kw["cu_q_lens"], kw["num_seqs"])
    launch = lambda p: pa._launch(q, p, pts, lens, kw["cu_q_lens"], kw["num_seqs"],  # noqa: E731
                                  kw["scale"], group, "simt")
    got = launch(p8)
    torch.cuda.synchronize()
    assert torch.equal(got, launch(p8.to(dtype)))
    if pa._instance(dtype, p8.shape[2], D, group, p8.dtype) == "simt_fp8":
        wrapped = _count_one(paged_attention, "simt_fp8",
                             lambda: paged_attention(q, p8, pts, pos, sids, lens, **kw))
        assert torch.equal(wrapped, got)
    ref = paged_attention_ref(q.float(), p8, pts, pos, sids, lens, **kw)[:valid]
    if dtype == torch.float32:
        assert (got[:valid] - ref).abs().max().item() <= F32_ATOL
    else:
        assert bf16_rounding_units(got[:valid], ref) <= BF16_UNITS


@pytest.mark.parametrize("kv", [list(np.random.default_rng(64).integers(1, 1025, 64)) + [0, 0],
                                [1], [17], [4096, 1, 17, 16, 0, 2048, 3000, 600]],
                         ids=["b64_idle", "b1_kv1", "b1_kv17", "b8_splits"])
def test_fp8_k3_equals_bf16_instance_on_upcast_pool(cuda, kv):
    """K3's mma instance over an fp8 latent pool: bit for bit the bf16
    instance on the upcast pool; f32 simt over the same fp8 pool equal to the
    f32 simt on the pool upcast to f32 and within F32_ATOL of the plain
    version; idle rows exact zeros."""
    from llmd_tpu_torch.ops import mla_decode as md

    q, pool, pts, lens = _k3_case(16, 160, 16, kv, torch.bfloat16, cuda, seed=len(kv) + 7)
    p8 = _fp8(pool)
    scale = 0.125
    got = _count_one(mla_decode, "mma_fp8",
                     lambda: mla_paged_attention_latent(q, p8, pts, None, None, lens,
                                                        scale=scale))
    twin = mla_paged_attention_latent(q, p8.to(torch.bfloat16), pts, None, None, lens,
                                      scale=scale)
    assert torch.equal(got, twin)
    live = lens > 0
    q_scaled = (q.float() * scale).to(torch.bfloat16).float()
    ref = mla_decode_ref(q_scaled, p8, pts, lens, scale=1.0)
    if int(lens.max()) > 1:
        assert bf16_rounding_units(got[live], ref[live]) <= BF16_UNITS
    else:  # one key: the row itself
        assert torch.equal(got[live].float(), ref[live])
    assert torch.count_nonzero(got[~live]) == 0
    q32 = q.float()
    f32 = _count_one(mla_decode, "simt_fp8",
                     lambda: mla_paged_attention_latent(q32, p8, pts, None, None, lens,
                                                        scale=scale))
    assert torch.equal(f32, md._launch(q32, p8.float(), pts, lens, scale, "simt"))
    ref32 = mla_decode_ref(q32 * scale, p8, pts, lens, scale=1.0)
    assert (f32[live] - ref32[live]).abs().max().item() <= F32_ATOL


def test_fp8_k3_simt_at_tiny_mla(cuda):
    """tiny-mla's latent decode (4 heads at width 80) runs simt in bf16 too:
    over an fp8 pool, bit for bit the bf16 simt on the upcast pool."""
    q, pool, pts, lens = _k3_case(4, 80, 8, [1, 17, 4096, 0, 16, 999], torch.bfloat16, cuda,
                                  seed=80)
    p8 = _fp8(pool)
    got = _count_one(mla_decode, "simt_fp8",
                     lambda: mla_paged_attention_latent(q, p8, pts, None, None, lens,
                                                        scale=0.125))
    assert torch.equal(got, mla_paged_attention_latent(q, p8.to(torch.bfloat16), pts, None,
                                                       None, lens, scale=0.125))


@pytest.mark.parametrize("model", ["tiny", "tiny-mla"])
def test_fp8_decode_graph_matches_eager(cuda, model):
    """An fp8 pool through the captured decode program: replayed = eager
    tokens and launches, every K1 / K3 launch on an fp8 variant."""
    counts = _check_graph_matches_eager(cuda, model, {"kv_cache_dtype": "fp8"})
    for name in ("paged_attention", "mla_decode"):
        n, by = counts[name]
        assert by["mma"] == by["simt"] == 0 and by["mma_fp8"] + by["simt_fp8"] == n
    assert counts["paged_attention"][0] > 0


def test_fp8_engine_tokens_same_with_kernels(cuda):
    """float32 tiny64 over an fp8 pool: the engine on the card (the simt fp8
    variants) emits the greedy tokens of the engine on the CPU (the plain
    versions, which upcast the pool at use)."""
    import dataclasses

    from llmd_tpu_torch.core.request import SamplingParams
    from llmd_tpu_torch.engine import EngineConfig, LLMEngine
    from llmd_tpu_torch.models import get_model_config
    from llmd_tpu_torch.models.transformer import init_params

    cfg = dataclasses.replace(get_model_config("tiny64"), dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    prompts = [list(range(5, 60)), list(range(100, 110)), list(range(7, 200, 3))]
    ecfg = dict(page_size=8, num_pages=64, max_model_len=256, max_batch_size=4,
                prefill_chunk=32, decode_steps=4, kv_cache_dtype="fp8")
    sp = SamplingParams(max_tokens=12, temperature=0.0)
    before = paged_attention.launches_by_instance["simt_fp8"]
    on_card = LLMEngine(cfg, EngineConfig(**ecfg), params=params,
                        device=cuda).generate(prompts, sp)
    assert paged_attention.launches_by_instance["simt_fp8"] > before
    on_cpu = LLMEngine(cfg, EngineConfig(**ecfg), params=params,
                       device="cpu").generate(prompts, sp)
    assert on_card == on_cpu


# ------------------------------------------- the KV data plane on the card


def _kvplane_prompts():
    return [list(range(5, 60)), list(range(100, 140)), list(range(7, 200, 3))]


@pytest.mark.parametrize("model", ["tiny", "tiny-mla"])
def test_kvplane_inject_under_captured_decode_graph(cuda, model):
    """Blocks pulled from a prefill engine are injected, in place, into a
    decode engine whose decode graph was captured before the inject: the
    pool keeps its address, the injected pages hold the producer's bytes,
    and the replayed program gives the eager program's tokens and launches
    over them (K1, and K3 on tiny-mla)."""
    from llmd_tpu_torch.core.request import SamplingParams
    from llmd_tpu_torch.disagg.transfer import (
        PulledKV, drain_staged, export_begin, gather_pages, inject_into_engine)

    prompts = _kvplane_prompts()
    producer = _engine(model, cuda)
    producer.generate(prompts, SamplingParams(max_tokens=1, temperature=0.0))
    pulled = []
    for p in prompts:
        _, staged = export_begin(producer, "x", p)
        pulled.append(PulledKV(staged.hashes, staged.chunks, drain_staged(staged.parts)))
    sp = SamplingParams(max_tokens=12, temperature=0.0)
    out, counts = {}, {}
    for graph in (True, False):
        eng = _engine(model, cuda, decode_graph=graph)
        eng.generate([list(range(210, 240))], sp)  # captures the decode graph first
        ptr = eng.cache.data_ptr()
        for p, pk in zip(prompts, pulled):
            assert inject_into_engine(eng, pk, p) == len(pk.block_hashes)
            pids = [eng.alloc.cached[h] for h in pk.block_hashes]
            got = gather_pages(eng.cache, pids, eng.cfg.num_pages).cpu()
            assert torch.equal(got.view(torch.uint8), pk.blocks.view(torch.uint8))
        assert eng.cache.data_ptr() == ptr
        before = _launches()
        out[graph] = eng.generate(prompts, sp)
        after = _launches()
        counts[graph] = {n: after[n][0] - before[n][0] for n in after}
        assert eng.stats.decode_graph_captures == (1 if graph else 0)
    assert out[True] == out[False]
    assert counts[True] == counts[False] and counts[True]["paged_attention"] > 0
    if model == "tiny-mla":
        assert counts[True]["mla_decode"] > 0


def test_kvplane_staging_ordered_against_later_page_writes(cuda, monkeypatch):
    """stage_pages gathers on the current stream and copies on a side stream;
    a write to the same pages enqueued right after (behind a long kernel, so
    the host runs far ahead) cannot reach the staged bytes, and the drain
    waits on the copies' own events, never on the whole device."""
    from llmd_tpu_torch.disagg.transfer import drain_staged, gather_pages, stage_pages

    P = 64
    cache = torch.randn(2 * P + 1, 16, 4, 64, device=cuda, dtype=torch.bfloat16)
    want = cache.clone()
    big = torch.randn(4096, 4096, device=cuda)
    for _ in range(8):
        big = big @ big / 64  # keeps the stream busy while the host enqueues
    pids = [3, 17, 40, 41, 63]
    parts = stage_pages(lambda ids: gather_pages(cache, ids, P), pids, staging_pages=2)
    rows = torch.tensor([l * P + p for l in range(2) for p in pids], device=cuda)
    cache.index_fill_(0, rows, 0.0)  # a later step rewrites the released pages

    def no_sync(*a, **kw):
        raise AssertionError("drain_staged must not synchronize the device")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    blocks = drain_staged(parts)
    monkeypatch.undo()
    assert blocks.device.type == "cpu" and blocks.shape == (5, 2, 16, 4, 64)
    for i, p in enumerate(pids):
        for l in range(2):
            assert torch.equal(blocks[i, l], want[l * P + p].cpu())
    assert (cache[rows] == 0).all()


def test_kvplane_export_survives_engine_steps_on_card(cuda):
    """An export staged before steps that recycle its pages equals the one
    taken before them (the reference's test_export_survives_engine_steps)."""
    from llmd_tpu_torch.core.request import SamplingParams
    from llmd_tpu_torch.disagg.transfer import drain_staged, export_begin

    eng = _engine("tiny", cuda, num_pages=24)
    prompt = list(range(40, 64))
    eng.generate([prompt], SamplingParams(max_tokens=2, temperature=0.0, ignore_eos=True))
    _, truth = export_begin(eng, "a", prompt)
    truth = drain_staged(truth.parts)
    _, staged = export_begin(eng, "b", prompt)
    eng.generate([[(97 + 41 * i + j) % 280 + 1 for j in range(40)] for i in range(8)],
                 SamplingParams(max_tokens=4, temperature=0.0, ignore_eos=True))
    assert torch.equal(drain_staged(staged.parts), truth)


# -------------------------------------------------------------------- LoRA


def _lora_run(cuda, graph: bool, model: str = "tiny", **kw):
    """Greedy tokens and launches of base and adapter rows where the second
    adapter is loaded only after the first call, which captures the decode
    graph: a replayed graph reads the bank in place."""
    from llmd_tpu_torch.core.request import SamplingParams
    from llmd_tpu_torch.models.lora import LoRAConfig

    eng = _engine(model, cuda, decode_graph=graph, lora=LoRAConfig(max_adapters=4, rank=8), **kw)
    eng.load_lora_adapter("a", seed=1)
    sp = SamplingParams(max_tokens=13, temperature=0.0)
    out = {}
    for rid, p, lora in (("base", list(range(5, 60)), None), ("a", list(range(5, 60)), "a")):
        eng.add_request(rid, p, sp, lora_id=lora)
    ptr = eng._lora_params["lora_B_wq"].data_ptr()
    while eng.has_work():
        for o in eng.step():
            out.setdefault(o.request_id, []).extend(o.new_token_ids)
    captured = eng.stats.decode_graph_captures
    eng.load_lora_adapter("b", seed=2)  # after the capture
    before = _launches()
    for rid, p, lora in (("b", list(range(5, 60)), "b"), ("base2", list(range(7, 40)), None),
                         ("a2", list(range(7, 40)), "a")):
        eng.add_request(rid, p, sp, lora_id=lora)
    while eng.has_work():
        for o in eng.step():
            out.setdefault(o.request_id, []).extend(o.new_token_ids)
    after = _launches()
    assert eng._lora_params["lora_B_wq"].data_ptr() == ptr
    counts = {n: after[n][0] - before[n][0] for n in after}
    return out, counts, captured, eng.stats


def test_lora_decode_graph_matches_eager_with_adapter_loaded_after_capture(cuda):
    """bf16 tiny under adapters: the replayed decode program = eager, tokens
    and launch counts, with an adapter loaded after the graph's capture; the
    adapters visibly change their rows."""
    g, gc, captured, st = _lora_run(cuda, True)
    e, ec, _, _ = _lora_run(cuda, False)
    assert captured == 1 and st.decode_graph_captures == 1
    assert st.decode_graph_replays == st.n_decode_calls > 0
    assert g == e and gc == ec
    assert g["base"] != g["a"] and g["b"] != g["base"]


def test_lora_moe_kernels_under_adapters(cuda):
    """tiny-moe (sorted dispatch) under adapters: K1 and K2 launch on their
    bf16 instances in every program, replayed = eager."""
    g, gc, _, _ = _lora_run(cuda, True, model="tiny-moe", moe_dispatch="sorted")
    e, ec, _, _ = _lora_run(cuda, False, model="tiny-moe", moe_dispatch="sorted")
    assert g == e and gc == ec
    assert gc["paged_attention"] > 0 and gc["ragged_grouped_gemm"] > 0


def test_lora_embed_on_card_matches_cpu(cuda):
    """The embed program on the card (K1 per layer per chunk) against the
    same engine on the CPU, float32, under an adapter: max abs <= 1e-5."""
    import dataclasses

    from llmd_tpu_torch.engine import EngineConfig, LLMEngine
    from llmd_tpu_torch.models import get_model_config
    from llmd_tpu_torch.models.lora import LoRAConfig, make_adapter_weights
    from llmd_tpu_torch.models.transformer import init_params

    cfg = dataclasses.replace(get_model_config("tiny"), dtype="float32")
    lcfg = LoRAConfig(max_adapters=2, rank=8)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    w = make_adapter_weights(cfg, lcfg, torch.Generator().manual_seed(3))
    ids = list(range(3, 100))
    vecs = []
    for dev in (cuda, "cpu"):
        eng = LLMEngine(cfg, EngineConfig(page_size=8, num_pages=64, max_model_len=256,
                                          prefill_chunk=32, lora=lcfg), params=params,
                        device=dev)
        eng.load_lora_adapter("a", w)
        before = paged_attention.launches
        vecs.append(np.asarray(eng.embed(ids, "a")))
        if dev == cuda:
            assert paged_attention.launches - before == cfg.num_layers * 4  # 97 tokens, 4 chunks
    assert np.abs(vecs[0] - vecs[1]).max() <= 1e-5


# -------------------------------------------------------------- multimodal


def test_vision_tower_f32_on_card_matches_cpu(cuda):
    """The tower (no kernel of its own: plain products, f32 scores) at a
    CLIP-like shape (patch 14, 112 px: 64 patches pooled into 16 rows;
    hidden 256, 4 layers), float32 with TF32 off: the card's output within
    1e-4 of the CPU's, relative to its max abs."""
    import dataclasses

    from llmd_tpu_torch.models import get_model_config
    from llmd_tpu_torch.models.vision import bytes_to_pixels, encode_images, init_vision_params

    cfg = dataclasses.replace(get_model_config("tiny-vl"), dtype="float32", mm_tokens=16,
                              vision_patch=14, vision_image_size=112, vision_layers=4,
                              vision_hidden=256, vision_heads=8)
    params = init_vision_params(cfg, torch.Generator().manual_seed(0), "cpu")
    px = torch.from_numpy(np.stack([bytes_to_pixels(cfg, b"img-%d" % i) for i in range(3)]))
    precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        ref = encode_images(cfg, params, px)
        got = encode_images(cfg, {k: v.to(cuda) for k, v in params.items()},
                            px.to(cuda)).cpu()
    finally:
        torch.set_float32_matmul_precision(precision)
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()


def test_vision_combined_pd_request_runs_k1(cuda):
    """One media chat through a tiny-vl server on the card with its
    in-process tower: 200, K1 once per layer of every forward (the media
    rows' unified step included) on the bf16 instance, no plain version."""
    import dataclasses

    from llmd_tpu_torch.engine import EngineConfig
    from llmd_tpu_torch.engine.server import EngineServer
    from llmd_tpu_torch.models import get_model_config

    cfg = get_model_config("tiny-vl")
    server = EngineServer(cfg, EngineConfig(page_size=8, num_pages=96, max_model_len=256,
                                            max_batch_size=4, prefill_chunk=32),
                          host="127.0.0.1", port=0, device=cuda)
    image = {"type": "image_url", "image_url": {"url": "data:image/x-raw;base64,aW1hZ2U="}}
    body = {"messages": [{"role": "user", "content": [{"type": "text", "text": "what is it"},
                                                       image]}],
            "max_tokens": 9, "temperature": 0.0, "ignore_eos": True}
    server.start()
    try:
        st0 = dataclasses.replace(server.engine.stats)
        before, plain = _launches(), paged_attention_ref.calls
        status, got = server.generate(body, chat=True)
        after = _launches()
        st = server.engine.stats
    finally:
        server.stop()
    assert status == 200 and got["usage"]["completion_tokens"] == 9
    forwards = (st.n_unified_steps - st0.n_unified_steps
                + st.n_decode_iterations - st0.n_decode_iterations)
    k1 = after["paged_attention"][0] - before["paged_attention"][0]
    mma = after["paged_attention"][1]["mma"] - before["paged_attention"][1]["mma"]
    assert k1 == mma == cfg.num_layers * forwards > 0
    assert paged_attention_ref.calls == plain
    assert server._vision is not None and server._vision.device.type == "cuda"


# ------------------------------------------------- the observability plane

def _probe_run(cuda, model, probes: bool, graph: bool, kw: dict):
    """bf16 ``model`` at decode_steps 1 with a probe every 4th dispatch (or
    none): the greedy tokens, the kernels' launches by instance, the probes
    taken and the plain versions' calls."""
    from llmd_tpu_torch.core.request import SamplingParams

    eng = _engine(model, cuda, decode_graph=graph, decode_steps=1, **kw)
    eng._attn_probe_every = 4
    if not probes:
        eng._attn_probe_on = eng._moe_probe_on = False
    plain = (paged_attention_ref.calls, mla_decode_ref.calls, ragged_grouped_gemm_ref.launches)
    before = _launches()
    out = eng.generate([list(range(5, 40)), list(range(50, 70))],
                       SamplingParams(max_tokens=30, temperature=0.0))
    after = _launches()
    counts = {n: {i: after[n][1][i] - before[n][1][i] for i in after[n][1]} for n in after}
    taken = sum(v for name, labels, v in eng.registry.collect()
                if name == "llmd_tpu:engine_step_duration_seconds_count" and "attn" in labels)
    assert (paged_attention_ref.calls, mla_decode_ref.calls,
            ragged_grouped_gemm_ref.launches) == plain  # no plain version ran
    assert eng._attn_probe_on == probes
    return out, counts, taken, eng


@pytest.mark.parametrize("model,kw,kernel", [
    ("tiny", {}, "paged_attention"), ("tiny-mla", {}, "mla_decode"),
    ("tiny-moe", {"moe_dispatch": "sorted"}, "ragged_grouped_gemm")])
def test_phase_probes_launch_the_served_instances(cuda, model, kw, kernel):
    """The attn probe launches the decode program's attention (K1, or K3 on
    MLA), the MoE probe the sorted dispatch's experts (K2), each on the
    instance the served path launches (``mma`` / ``wgmma`` for bf16 at these
    widths, K3 ``simt`` at tiny-mla's), never a plain version; probes
    between graph replays leave the replayed tokens equal to an eager
    engine's without probes. The first probe's warm-up run is one more
    launch set than the probes observed."""
    got, with_probes, taken, eng = _probe_run(cuda, model, True, True, kw)
    ref, without, _, _ = _probe_run(cuda, model, False, False, kw)
    assert got == ref
    assert taken >= 2 and eng.stats.decode_graph_replays > 8
    (instance,) = [i for i, n in without[kernel].items() if n]  # the served instance
    extra = {n: {i: with_probes[n][i] - without[n][i] for i in with_probes[n]}
             for n in with_probes}
    per_run = 2 if kernel == "ragged_grouped_gemm" else 1  # experts: wi then wo
    assert extra[kernel][instance] == per_run * (taken + 1), extra
    assert sum(extra[kernel].values()) == extra[kernel][instance]
    if kernel == "mla_decode":
        assert sum(extra["paged_attention"].values()) == 0  # K3 serves MLA decode
    if kernel == "ragged_grouped_gemm":
        assert extra["paged_attention"]["mma"] == taken + 1
        assert eng._moe_probe_on


def test_capture_profile_holds_k1_events_and_phases(cuda, tmp_path):
    """A ``capture_profile`` window over served decode on the card: its trace
    holds K1's kernel events and the engine's ``llmd.decode_dispatch``
    range; the HBM gauges read the caching allocator."""
    import json
    import threading

    from llmd_tpu_torch.core.request import SamplingParams
    from llmd_tpu_torch.obs.device import DeviceMonitor
    from llmd_tpu_torch.obs.metrics import Registry

    eng = _engine("tiny", cuda, decode_steps=2)
    reg = Registry()
    mon = DeviceMonitor(reg, devices=[cuda], stall_s=0, probe_interval_s=0, poll_s=0.05,
                        profile_dir=str(tmp_path))
    mon.start()
    stop = threading.Event()

    def serve():
        i = 0
        while not stop.is_set():
            eng.generate([list(range(5 + i, 60 + i))], SamplingParams(max_tokens=40,
                                                                     temperature=0.0))
            i += 1

    t = threading.Thread(target=serve)
    t.start()
    try:
        time.sleep(0.5)  # the first capture of the decode graph is done
        result = mon.capture_profile(1.0)
    finally:
        stop.set()
        t.join()
    time.sleep(0.2)
    text = reg.expose()
    mon.stop()
    trace = json.loads((tmp_path / result["dir"] / "trace.json").read_text())
    names = [e.get("name", "") for e in trace["traceEvents"]]
    assert any("paged_attention" in n for n in names)
    assert "llmd.decode_dispatch" in names
    limit = torch.cuda.get_device_properties(cuda).total_memory
    assert f'llmd_tpu:device_hbm_limit_bytes{{device="cuda:{cuda.index}"}} {limit}' in text


def test_profile_windows_over_replayed_decode_behind_the_server(cuda, tmp_path, monkeypatch):
    """Repeated ``/debug/profile`` windows while the port server's engine
    replays its decode graph for 8 clients: every window answers 200 and
    holds K1 kernel events. The tracer starts and stops with the step loop
    paused (stopping it while the engine thread replays a graph can
    deadlock the two threads)."""
    import json
    import threading
    import urllib.request

    from llmd_tpu_torch.engine import EngineConfig
    from llmd_tpu_torch.engine.server import EngineServer
    from llmd_tpu_torch.models import get_model_config

    monkeypatch.setenv("LLMD_PROFILE_DIR", str(tmp_path))
    monkeypatch.setenv("LLMD_WATCHDOG_STALL_S", "0")
    monkeypatch.setenv("LLMD_FABRIC_PROBE_INTERVAL_S", "1")
    server = EngineServer(get_model_config("tiny"), EngineConfig(
        page_size=8, num_pages=256, max_model_len=256, max_batch_size=8, prefill_chunk=32,
        decode_steps=4), model_name="test/tiny", host="127.0.0.1", port=0, device=cuda)
    server.start()
    base = f"http://{server.address}"
    stop = threading.Event()

    def post(body):
        req = urllib.request.Request(base + "/v1/completions", json.dumps(body).encode(),
                                     {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status

    def client(i):
        while not stop.is_set():
            post({"prompt_token_ids": list(range(3 + i, 40 + i)), "max_tokens": 120,
                  "temperature": 0.0, "ignore_eos": True})

    clients = [threading.Thread(target=client, args=(i,), daemon=True) for i in range(8)]
    for t in clients:
        t.start()
    windows = []
    try:
        time.sleep(1.0)  # the decode graph is captured and replaying
        for i in range(12):
            with urllib.request.urlopen(
                    f"{base}/debug/profile?seconds={0.2 + 0.1 * (i % 3)}", timeout=120) as r:
                status, cap = r.status, json.loads(r.read())
            events = json.loads((tmp_path / cap["dir"] / "trace.json").read_text())
            windows.append((status, sum(1 for e in events["traceEvents"]
                                        if e.get("cat") == "kernel"
                                        and "paged_attention" in e.get("name", ""))))
        assert server.engine.stats.decode_graph_replays > 12
    finally:
        stop.set()
        for t in clients:
            t.join(timeout=60)
        server.stop()
    assert all(status == 200 and k1 > 0 for status, k1 in windows), windows


# ----------------------------------------------- the launch surface (slice 16)


def _allocated() -> int:
    """``memory_allocated`` with cuBLAS's per-handle workspaces released
    first (a thread's first product on a stream makes one; the library keeps
    it, no engine does)."""
    torch.cuda.synchronize()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    return torch.cuda.memory_allocated()


def test_launch_dropped_server_and_engine_return_their_hbm_without_gc(cuda):
    """llama-1b behind the server: built, serving, stopped and dropped, with
    the cycle collector off; then an engine dropped after ``generate`` (its
    decode graph captured). ``memory_allocated`` is back at its baseline
    each time."""
    import gc
    import json
    import urllib.request

    from llmd_tpu_torch.core.request import SamplingParams
    from llmd_tpu_torch.engine import EngineConfig, LLMEngine
    from llmd_tpu_torch.engine.server import EngineServer
    from llmd_tpu_torch.models import get_model_config

    kw = dict(page_size=16, num_pages=512, max_model_len=2048, max_batch_size=8,
              prefill_chunk=512, decode_steps=4)
    cfg = get_model_config("llama-1b")
    gc.collect()
    torch.cuda.empty_cache()
    base = _allocated()
    gc.disable()
    try:
        srv = EngineServer(cfg, EngineConfig(**kw), host="127.0.0.1", port=0, device=cuda)
        srv.start()
        body = json.dumps({"prompt": "hello " * 40, "max_tokens": 16,
                           "temperature": 0}).encode()
        req = urllib.request.Request(f"http://{srv.address}/v1/completions", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            assert r.status == 200
        held = torch.cuda.memory_allocated()
        srv.stop()
        del srv, req
        after_server = _allocated()
        eng = LLMEngine(cfg, EngineConfig(**kw), device=cuda)
        eng.generate([list(range(5, 300))], SamplingParams(max_tokens=12, temperature=0.0))
        assert eng.stats.decode_graph_captures == 1
        del eng
        after_engine = _allocated()
    finally:
        gc.enable()
    assert held > base + 2**30  # the weights and the pool were there
    assert after_server == base and after_engine == base, (base, after_server, after_engine)


def _tune_table(batch, ps, pps, H, D, planes, bkv, bq):
    from llmd_tpu_torch.ops import attn_tune

    return attn_tune.AttnTuneTable(entries=({
        "batch": batch, "page_size": ps, "pages_per_seq": pps,
        "head_layout": attn_tune.head_layout_key(H, D, planes), "bkv": bkv, "bq": bq,
        "tuned_on": torch.cuda.get_device_name(0)},))


@pytest.mark.parametrize("bkv", [64, 32, 16, 8, 4, 1])
def test_k1_under_every_tuned_plan_matches_plain(cuda, bkv):
    """K1 at the tuner's decode shape (llama-1b heads, 64 rows over a 64-page
    table) under each candidate plan: bf16 on mma within one rounding unit
    of the plain version in float32, the plan the table gives; f32 (simt,
    no plan) within F32_ATOL."""
    kv = list(np.random.default_rng(bkv).integers(128, 1025, 64))
    for dtype in (torch.bfloat16, torch.float32):
        args, kw, v = _case(32, 8, 64, 16, [1] * 64, kv, dtype, cuda, bkv, max_pages=64)
        N = args[0].shape[0]
        table = _tune_table(N, 16, 64, 32, 64, 16, bkv, pa.MMA_ROWS // 4)
        plan = pa._plan(N, args[2].shape[0], 64, 16, 4, 8,
                        override=pa.plan_override(table, N, 16, 64, 32, 64, 16))
        assert (plan.splits, plan.split_keys) == pa.tuned_split_keys(bkv, 1024, 16)
        got = paged_attention(*args, **kw, tune=table)
        ref = paged_attention_ref(args[0].float(), args[1].float(), *args[2:], **kw)
        torch.cuda.synchronize()
        if dtype == torch.bfloat16:
            assert bf16_rounding_units(got[:v], ref[:v]) <= BF16_UNITS
        else:
            assert (got[:v] - ref[:v]).abs().max().item() <= F32_ATOL
        assert not got[v:].any()


def test_tuned_decode_graph_matches_eager(cuda, tmp_path):
    """An engine built from a table whose entry sets its decode launch to 4
    KV splits: the decode program replayed from its graph (the plan baked in
    at capture) gives the eager program's tokens and launch counts."""
    from llmd_tpu_torch.engine.engine import LLMEngine  # noqa: F401
    from llmd_tpu_torch.ops import attn_tune

    path = str(tmp_path / "tune.json")
    table = attn_tune.merge_and_save(path, list(_tune_table(4, 8, 32, 4, 64, 4, 8, 32).entries))
    eng = _engine("tiny64", cuda, decode_graph=True, attn_tune_file=path)
    assert eng.attn_tune_hash == table.sha
    override = pa.plan_override(eng.attn_tune_table, 4, 8, 32, 4, 64, 4)
    assert pa._plan(4, 4, 32, 8, 2, 2, override=override).splits == 4
    del eng
    counts = _check_graph_matches_eager(cuda, "tiny64", {"attn_tune_file": path})
    assert counts["paged_attention"][1]["mma"] == counts["paged_attention"][0] > 0


def test_pallas_mode_refused_on_a_cpu_engine(cuda):
    from llmd_tpu_torch.engine import EngineConfig, LLMEngine
    from llmd_tpu_torch.models import get_model_config

    with pytest.raises(ValueError, match="attn_impl='pallas'.*CUDA"):
        LLMEngine(get_model_config("tiny"), EngineConfig(attn_impl="pallas"), device="cpu")
    eng = LLMEngine(get_model_config("tiny64"), EngineConfig(attn_impl="pallas"), device=cuda)
    assert eng.attn_backend == "cuda_paged_attention" and eng.attn_fallback_reason is None


# ------------------------------------------------------------------ the mesh
# One rank's shapes under the (dp, sp, ep, tp) mesh (llmd_tpu_torch/parallel):
# llama-1b's heads at tp=2 / tp=4, moe-wide-mla's at tp=2 (K1's latent mode and
# K3 on their simt instances: the mma ones take 16 heads), tiny-mla's at tp=2,
# an ep=2 receiver's bucketed rows for K2 and the local slots' groups for K4.


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("H,Hk", [(16, 4), (8, 2)], ids=["tp2", "tp4"])
def test_mesh_k1_at_tp_rank_heads(cuda, H, Hk, dtype):
    _check_k1(cuda, H, Hk, 64, 16, *MIXED, dtype)
    _check_k1(cuda, H, Hk, 64, 16, [1] * 64, list(range(128, 1024, 14)), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_mesh_latent_kernels_at_tp2_heads(cuda, dtype):
    """K1's latent mode at moe-wide-mla's tp=2 heads (8 at width 160) and K3
    at the tp=2 heads of moe-wide-mla and tiny-mla (8 at 160, 2 at 80)."""
    q_lens, kv_lens = [37, 1, 1, 64, 1, 20], [37, 5, 300, 100, 1, 140]
    args, kw, valid = _case(8, 1, 160, 16, q_lens, kv_lens, dtype, cuda, seed=8, planes=1)
    got = paged_attention(*args, **kw)
    q, pool, *rest = args
    ref = paged_attention_ref(q.float(), pool.float(), *rest, **kw)[:valid]
    if dtype == torch.float32:
        assert (got[:valid] - ref).abs().max().item() <= F32_ATOL
    else:
        assert bf16_rounding_units(got[:valid], ref) <= BF16_UNITS
    for H, W, ps in ((8, 160, 16), (2, 80, 8)):
        _check_k3(cuda, H, W, ps, [1, 17, 4096, 0, 16, 999, 256, 5], dtype, seed=H + W)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_mesh_grouped_gemms_at_ep2_local_shapes(cuda, dtype):
    """K2 on an ep=2 receiver's rows as the EP exchange builds them (two
    senders' buckets of cap = 32 tokens x top-4 rows, pads on the sentinel
    slot, 16 local slots, moe-wide-sim widths) and K4 over the 16 local
    groups at the decode batch's capacity."""
    from llmd_tpu_torch.ops.moe_dispatch import _row_plan, pick_block_size

    rng = np.random.default_rng(5)
    T, S, k, ep, D, F = 64, 32, 4, 2, 1024, 1024
    Sl, tpc = S // ep, T // ep
    cap = tpc * k
    idx = np.argsort(rng.random((T, S)), axis=1)[:, :k]
    recv = np.full((ep * cap,), -1, np.int64)
    for src in range(ep):
        mine = idx[src * tpc:(src + 1) * tpc].reshape(-1)
        mine = mine[mine < Sl]
        recv[src * cap:src * cap + len(mine)] = mine
    bc = pick_block_size(ep * cap, Sl, pallas=True)
    row, slot, rows, Tp = _row_plan(torch.from_numpy(np.where(recv >= 0, recv, Sl)), Sl, bc)
    xr = torch.from_numpy(rng.standard_normal((ep * cap, D), np.float32))
    xs = torch.zeros((Tp + 1, D)).index_copy_(0, row.long(), xr)[:Tp]
    w = torch.from_numpy(rng.standard_normal((Sl, D, F), np.float32) * D ** -0.5)
    x, w = xs.view(-1, bc, D).to(cuda, dtype), w.to(cuda, dtype)
    slot, rows = slot.to(cuda), rows.to(cuda)
    got = ragged_grouped_gemm(x, w, slot, rows)
    _hold(got, ragged_grouped_gemm_ref(x.float(), w.float(), slot, rows), dtype)
    assert torch.count_nonzero(got[rows == 0]) == 0
    xg, wg, rng = _gemm_operands(Sl, 10, D, F, Sl, dtype, cuda, seed=16)
    counts = torch.from_numpy(rng.integers(0, 11, Sl).astype(np.int32)).to(cuda)
    _hold(grouped_gemm(xg, wg, counts), grouped_gemm_ref(xg.float(), wg.float(), counts), dtype)


def test_mesh_nccl_collectives_captured_in_a_graph(cuda):
    """A one-rank NCCL group: all_reduce, all_gather and all_to_all_single
    captured in one CUDA graph and replayed equal the eager calls."""
    import datetime
    import socket

    import torch.distributed as dist

    from llmd_tpu_torch.parallel.checks import collectives_in_graph

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        res = collectives_in_graph()
    finally:
        dist.destroy_process_group()
    assert res == {"world": 1, "max_abs_diff": 0.0}
