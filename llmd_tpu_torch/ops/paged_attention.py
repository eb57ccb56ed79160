"""Ragged paged attention: the CUDA kernel's wrapper, its plain version, and
their counters.

Port of ``llmd_tpu/ops/paged_attention.py::paged_attention_tpu`` (K1, the
Pallas ragged-paged-attention kernel on the TPU). The uniform attention-impl
signature is kept, so ``forward_core`` swaps implementations freely:

    impl(q, layer_cache, page_tables, positions, seq_slots, kv_lens, *,
         scale, cu_q_lens, num_seqs) -> [N, H, D]

with q ``[N, H, D]`` and the pool ``[P, page_size, 2*Hk, D]`` at the UNPADDED
head dim (K of kv head g at plane 2g, V at 2g+1). A pool of ONE plane,
``[P, page_size, 1, D]``, is MLA's latent pool: every head attends over the
same row, which is both K and V (absorbed MLA runs as MQA at the latent width
``D = r + dr``; the reference's ``ragged_paged_attention_xla`` reads it so).

* :func:`paged_attention` launches ``csrc/paged_attention.cu`` for CUDA tensors
  and raises if it cannot; for CPU tensors (the tests) it calls the plain
  version. There is no fallback from the kernel to the plain version.
  The source has two instances, chosen by :func:`_instance` from the dtype
  and the pool's shape alone: ``"mma"`` (bfloat16 K/V pools, and MLA's
  single-plane latent pool at the widths of :data:`LATENT_MMA_HEADS`: tensor
  cores, K/V tiles staged through shared memory by asynchronous copies, a
  latent tile read as K and as V, query tiles of :data:`MMA_ROWS` rows and
  KV splits laid out by :func:`_plan`) and ``"simt"`` (float32: CUDA-core
  FMAs, one block per query token). Each instance also reads a
  ``float8_e4m3fn`` pool (``EngineConfig.kv_cache_dtype="fp8"``, unit
  scales) beside a q of either dtype: ``"mma_fp8"`` copies the raw fp8 pages
  and converts each stage to bfloat16 in shared memory, so it computes
  exactly what ``"mma"`` computes on ``pool.to(torch.bfloat16)``;
  ``"simt_fp8"`` converts each element as it reads it. They take every shape
  their bfloat16 / float32 twins take. ``paged_attention.launches`` counts
  the wrapper's launches (one per layer), ``.launches_by_instance`` them per
  instance; a CUDA-graph replay of a program that launches it adds what
  the capture counted (``engine/cuda_graph.py``), so both count device
  launches.
* :func:`paged_attention_ref` is the plain PyTorch version, a port of
  ``ragged_paged_attention_xla`` (``llmd_tpu/models/transformer.py:428``): the
  tests' oracle and the kernel's yardstick on the card. An fp8 pool is
  upcast to q's dtype at use, as there (``:474-477``).

The kernel masks by ``cu_q_lens``/``kv_lens``, the plain version by
``positions``; the two agree because every sequence's queries are its last
``q_len`` tokens (the engine packs them so). Rows that attend nothing (padding)
are zeros from the kernel and a uniform average from the plain version:
compare valid rows only.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional

import torch

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the pool's dtype: q's, or float8_e4m3fn (unit scales) beside either
_POOL_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}
FP8 = torch.float8_e4m3fn
_INSTANCE_CODE = {"simt": 0, "mma": 1}
HEAD_DIMS = (32, 64, 128)
GROUP_SIZES = (1, 2, 4, 8)  # query heads per kv head with a kernel instance
# single-plane (MLA latent) pools. simt: latent width -> query heads per
# block; a block serves that many heads of the one plane, the grid covers H
# with H / heads-per-block blocks per token (160: moe-wide-mla; 80:
# tiny-mla). mma: latent width -> the heads it takes, all in one query tile
# (qpk = H over one "kv head"); at tiny-mla's width 80 the template spills,
# so simt serves it in bfloat16 too.
LATENT_HEADS_PER_BLOCK = {160: 8, 80: 4}
LATENT_MMA_HEADS = {160: 16}


def paged_attention_ref(
    q: torch.Tensor,  # [N, H, D]
    layer_cache: torch.Tensor,  # [P, ps, 2*Hk, D]
    page_tables: torch.Tensor,  # [B, max_pages] (-1 = unmapped)
    positions: torch.Tensor,  # [N] global positions (-1 = padding row)
    seq_slots: torch.Tensor,  # [N] owning batch row per token
    kv_lens: torch.Tensor,  # [B] tokens resident incl. this step's
    *,
    scale: float,
    cu_q_lens: Optional[torch.Tensor] = None,  # unused (uniform signature)
    num_seqs: Optional[torch.Tensor] = None,  # unused (uniform signature)
) -> torch.Tensor:
    """Gather + mask reference: each query gathers its own sequence's pages
    through the page table, 32 tokens at a time (bounded peak memory), with
    f32 scores and softmax."""
    paged_attention_ref.calls += 1
    N, H, D = q.shape
    _, ps, HkC, _ = layer_cache.shape
    single_plane = HkC == 1  # MLA latent pool: the row is K and V, Hk = 1
    Hk = 1 if single_plane else HkC // 2
    B, maxp = page_tables.shape
    qpk = H // Hk
    S = maxp * ps
    dev = q.device
    b_all = seq_slots.long().clamp(0, B - 1)
    pts = page_tables.long()
    lens = kv_lens.long()
    pos_all = positions.long()
    key_pos = torch.arange(S, device=dev)
    out = torch.empty_like(q)
    for c0 in range(0, N, 32):
        qc, posc, bc = q[c0:c0 + 32], pos_all[c0:c0 + 32], b_all[c0:c0 + 32]
        C = qc.shape[0]
        pt = pts[bc]  # [C, maxp] owning sequence's pages, in order
        kv = layer_cache[pt.clamp(min=0)].reshape(C, S, HkC, D)
        if kv.dtype == FP8:  # fp8 pages upcast at use: p @ v never runs in fp8
            kv = kv.to(q.dtype)
        if single_plane:
            kc = vc = kv  # [C, S, 1, D] shared latent
        else:
            kc, vc = kv[:, :, 0::2], kv[:, :, 1::2]  # [C, S, Hk, D]
        qg = qc.reshape(C, Hk, qpk, D)
        s = torch.einsum("nkqd,nskd->nkqs", qg.float(), kc.float()) * scale
        # key j sits at sequence position j (page tables list pages in order)
        mask = ((pt[:, key_pos // ps] >= 0)
                & (key_pos[None, :] <= posc[:, None])
                & (key_pos[None, :] < lens[bc][:, None])
                & (posc[:, None] >= 0))  # [C, S]
        s = s.masked_fill(~mask[:, None, None, :], -1e30)
        p = torch.softmax(s, dim=-1)
        # fully masked (padding) rows: uniform garbage; callers ignore them
        o = torch.einsum("nkqs,nskd->nkqd", p.to(vc.dtype), vc)
        out[c0:c0 + C] = o.reshape(C, H, D)
    return out


paged_attention_ref.calls = 0

BF16_UNIT = 2.0 ** -8  # unit roundoff of bfloat16 (8 significant bits)


def bf16_rounding_units(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest error of a bfloat16 output ``got`` against a float32 reference
    computed from the same bfloat16 inputs, in units of one rounding of the
    output: each element is held to ``2^-8·|ref|`` (round to nearest) plus
    ``2^-14`` of the largest magnitude in its head's row (room for float32
    summation order). A kernel that accumulates in float32 and rounds once
    reads at most 1; one that keeps the probabilities or the P·V accumulator
    in bfloat16 reads far above 1 on the rows' small elements."""
    ref = ref.float()
    mag = ref.abs()
    limit = BF16_UNIT * mag + 2.0 ** -14 * mag.amax(dim=-1, keepdim=True)
    err = (got.float() - ref).abs()
    return (err / limit.clamp_min(torch.finfo(torch.float32).tiny)).max().item()


@functools.cache
def _library():
    """The kernel's C entry point, with every argument type declared (an
    undeclared pointer would pass as a 32-bit int and be cut)."""
    from llmd_tpu_torch.native.build import load

    fn = load("paged_attention").lib.llmd_paged_attention
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_float]
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def build() -> float:
    """Build (or load the cached build of) the kernel; returns seconds taken."""
    from llmd_tpu_torch.native.build import load

    _library()
    return load("paged_attention").seconds


# The mma instance's work decomposition (csrc/paged_attention.cu): a work item
# is (query tile, kv head, KV split); a tile holds MMA_ROWS // qpk tokens of
# one sequence x the qpk query heads of its kv head, token-major.
MMA_ROWS = 64
STAGE_KEYS = 64  # keys per shared-memory stage; a split is a whole number of them
MIN_SPLIT_KEYS = 512  # a split shorter than this costs more in partials than it gains
ITEMS_PER_SM = 4  # below this many work items per SM, the keys are split
MAX_SPLITS = 16  # the kernel's split merge holds this many in registers


@dataclasses.dataclass(frozen=True)
class Plan:
    """The mma instance's grid: ``kv_heads`` x ``slots`` query-tile slots x
    ``splits``, the heads fastest. Sequence b's tiles of ``tq`` tokens sit at
    slots ``b + cu_q_lens[b] // tq`` onwards (the kernel finds them there);
    split s covers keys ``[s * split_keys, (s + 1) * split_keys)``."""

    tq: int
    slots: int
    kv_heads: int
    splits: int
    split_keys: int

    @property
    def grid(self) -> tuple[int, int, int]:
        return (self.kv_heads, self.slots, self.splits)


def split_keys(items: int, max_keys: int, page_size: int, min_split_keys: int,
               num_sms: int) -> tuple[int, int]:
    """(splits, keys per split) of a table of ``max_keys`` keys for ``items``
    work items, shared by the attention kernels' plans: the keys are split
    only when the items alone give fewer than ``ITEMS_PER_SM`` per SM, into
    at most ``MAX_SPLITS`` chunks of at least ``min_split_keys`` keys, a whole
    number of stages and pages; with one split, it covers the whole table."""
    splits = 1
    if 0 < items < ITEMS_PER_SM * num_sms:
        splits = min(-(-ITEMS_PER_SM * num_sms // items), max_keys // min_split_keys,
                     MAX_SPLITS)
    if splits <= 1:
        return 1, max_keys
    step = math.lcm(STAGE_KEYS, page_size)
    per = -(-max_keys // splits)
    per = -(-per // step) * step
    return -(-max_keys // per), per


def _plan(num_tokens: int, num_seqs: int, max_pages: int, page_size: int, qpk: int,
          kv_heads: int, num_sms: int = 132) -> Plan:
    """The mma instance's grid and KV splits (:func:`split_keys`, at
    ``MIN_SPLIT_KEYS``), from what the host knows without reading a device
    tensor: the token count, the page-table rows, the table width, the page
    size and the heads."""
    tq = MMA_ROWS // qpk
    slots = -(-num_tokens // tq) + num_seqs
    splits, per = split_keys(slots * kv_heads, max_pages * page_size, page_size,
                             MIN_SPLIT_KEYS, num_sms)
    return Plan(tq, slots, kv_heads, splits, per)


@functools.cache
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _instance(dtype: torch.dtype, planes: int, head_dim: int, qpk: int,
              pool_dtype: Optional[torch.dtype] = None) -> str:
    """The kernel instance for these inputs (``qpk``: query heads per kv
    head, all H on a single-plane pool; ``pool_dtype``: the pool's, q's
    ``dtype`` when not given): ``"mma"`` for a bfloat16 q on a K/V pool
    (planes 2*Hk) at a head dim of ``HEAD_DIMS`` and a group of
    ``GROUP_SIZES``, or on a latent pool (one plane) at a width and head
    count of ``LATENT_MMA_HEADS``; ``"simt"`` otherwise (float32 stays off
    the tensor cores, which would take it in TF32). On a float8_e4m3fn pool
    the same choice with ``"_fp8"`` appended."""
    base = "simt"
    if dtype == torch.bfloat16:
        if planes == 1:
            base = "mma" if LATENT_MMA_HEADS.get(head_dim) == qpk else "simt"
        elif head_dim in HEAD_DIMS and qpk in GROUP_SIZES:
            base = "mma"
    return base + "_fp8" if pool_dtype == FP8 else base


def _check(q: torch.Tensor, layer_cache: torch.Tensor, page_tables: torch.Tensor,
           kv_lens: torch.Tensor, cu_q_lens: Optional[torch.Tensor],
           num_seqs: Optional[torch.Tensor]) -> int:
    """Raise for anything the kernel does not take; return the query heads
    per kv head (H/Hk for a K/V pool, H for a single-plane pool)."""
    if cu_q_lens is None or num_seqs is None:
        raise ValueError("paged_attention: the kernel needs cu_q_lens and num_seqs")
    N, H, D = q.shape
    P, ps, HkC, Dc = layer_cache.shape
    B, maxp = page_tables.shape
    if q.dtype not in _DTYPE_CODE or layer_cache.dtype not in (q.dtype, FP8):
        raise TypeError(f"paged_attention: q {q.dtype} / pool {layer_cache.dtype}; "
                        "the kernel takes a float32 or bfloat16 q over a pool of "
                        "q's dtype or float8_e4m3fn")
    if HkC == 1:  # single-plane latent pool: simt serves H in blocks of `per`
        per = LATENT_HEADS_PER_BLOCK.get(D, 0)
        group = H
        ok = Dc == D and per > 0 and H % per == 0
    else:
        Hk = HkC // 2
        group = H // Hk if Hk and H % Hk == 0 else 0
        ok = Dc == D and D in HEAD_DIMS and HkC % 2 == 0 and group in GROUP_SIZES
    if not ok:
        raise ValueError(
            f"paged_attention: no kernel instance for H={H} planes={HkC} D={D} "
            f"(K/V pools: head dims {HEAD_DIMS}, groups {GROUP_SIZES}; latent pools: "
            f"widths {sorted(LATENT_HEADS_PER_BLOCK)} with H a multiple of "
            f"{LATENT_HEADS_PER_BLOCK})")
    if cu_q_lens.shape[0] != B + 1 or kv_lens.shape[0] != B:
        raise ValueError(f"paged_attention: cu_q_lens {tuple(cu_q_lens.shape)} / "
                         f"kv_lens {tuple(kv_lens.shape)} do not match B={B}")
    if not (q.is_contiguous() and layer_cache.is_contiguous()):
        raise ValueError("paged_attention: q and the pool must be contiguous")
    if q.data_ptr() % 16 or layer_cache.data_ptr() % 16:
        raise ValueError("paged_attention: q and the pool must be 16-byte aligned")
    if any(t.device != q.device for t in (layer_cache, page_tables, kv_lens, cu_q_lens,
                                          num_seqs)):
        raise ValueError("paged_attention: all inputs must be on q's device")
    return group


def _int32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def _launch(q: torch.Tensor, layer_cache: torch.Tensor, page_tables: torch.Tensor,
            kv_lens: torch.Tensor, cu_q_lens: torch.Tensor, num_seqs: torch.Tensor,
            scale: float, group: int, instance: str) -> torch.Tensor:
    """One launch of ``instance`` (``"mma"`` or ``"simt"``; an ``"_fp8"``
    suffix is implied by the pool's dtype) on checked inputs (``group``:
    query heads per kv head, as :func:`_check` returns it); counts nothing."""
    instance = instance.removesuffix("_fp8")
    N, H, D = q.shape
    _, ps, HkC, _ = layer_cache.shape
    B, maxp = page_tables.shape
    out = torch.empty_like(q)
    if N == 0:
        return out
    plan, scratch = Plan(0, 0, 0, 0, 0), None
    per_block = LATENT_HEADS_PER_BLOCK[D] if HkC == 1 and instance == "simt" else group
    if instance == "mma":
        plan = _plan(N, B, maxp, ps, group, max(HkC // 2, 1), _num_sms(q.device.index or 0))
        if plan.splits > 1:  # partial (o, m, l) of every split, merged by the kernel
            scratch = torch.empty(plan.splits * N * H * (D + 2), dtype=torch.float32,
                                  device=q.device)
    pt, lens, cu, ns = (_int32(page_tables), _int32(kv_lens), _int32(cu_q_lens),
                        _int32(num_seqs))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _library()(
            q.data_ptr(), layer_cache.data_ptr(), pt.data_ptr(), lens.data_ptr(),
            cu.data_ptr(), ns.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), N, H, HkC, per_block, D, ps,
            maxp, float(scale), _DTYPE_CODE[q.dtype], _POOL_CODE[layer_cache.dtype],
            _INSTANCE_CODE[instance], plan.tq,
            plan.slots, plan.splits, plan.split_keys, stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel ({instance}) launch failed: "
                           f"cudaError {err}")
    return out


def paged_attention(
    q: torch.Tensor,
    layer_cache: torch.Tensor,
    page_tables: torch.Tensor,
    positions: torch.Tensor,
    seq_slots: torch.Tensor,
    kv_lens: torch.Tensor,
    *,
    scale: float,
    cu_q_lens: Optional[torch.Tensor] = None,
    num_seqs: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Ragged paged attention: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Raises for anything the kernel does not take."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, layer_cache, page_tables, positions,
                                   seq_slots, kv_lens, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    group = _check(q, layer_cache, page_tables, kv_lens, cu_q_lens, num_seqs)
    instance = _instance(q.dtype, layer_cache.shape[2], q.shape[2], group, layer_cache.dtype)
    out = _launch(q, layer_cache, page_tables, kv_lens, cu_q_lens, num_seqs, scale,
                  group, instance)
    paged_attention.launches += 1
    paged_attention.launches_by_instance[instance] += 1
    return out


paged_attention.launches = 0
paged_attention.launches_by_instance = {"mma": 0, "simt": 0, "mma_fp8": 0, "simt_fp8": 0}
