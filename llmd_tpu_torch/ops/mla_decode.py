"""Latent-width decode attention for MLA's single-plane pool: the CUDA kernel's
wrapper, its plain version, and their counters.

Port of ``llmd_tpu/ops/mla_decode.py`` (K3, the Pallas ``mla_decode_pallas``
kernel on the TPU), with the reference's names:

* :func:`mla_decode` launches ``csrc/mla_decode.cu`` for CUDA tensors and
  raises if it cannot; for CPU tensors it calls the plain version. There is
  no fallback from the kernel to the plain version. The source has two
  instances, chosen by :func:`_instance` from the dtype and the shape alone:
  ``"mma"`` (bfloat16 at :data:`MMA_SHAPES`: tensor cores, the latent staged through shared memory
  by asynchronous copies and read as K and as V, work items of (sequence, KV
  split) laid out by :func:`_plan`) and ``"simt"`` (float32, and tiny-mla's
  shape: CUDA-core FMAs, one block per sequence). Each also reads a
  ``float8_e4m3fn`` latent pool (unit scale) beside a q of either dtype,
  ``"mma_fp8"`` / ``"simt_fp8"``: the kernel reads the fp8 pages itself
  (the reference's adapter upcasts the whole layer's pool before its
  kernel, ``llmd_tpu/ops/mla_decode.py:195-199``, which on the card would
  write a bf16 copy of the layer on every call). ``mla_decode.launches``
  counts the wrapper's launches (one per layer), ``.launches_by_instance``
  them per instance; a CUDA-graph replay adds what its capture counted
  (``engine/cuda_graph.py``).
* :func:`mla_decode_ref` is the plain PyTorch version: the tests' oracle and
  the kernel's yardstick on the card. It reads the pool in float32, so an
  fp8 pool is upcast at use.
* :func:`mla_paged_attention_latent` is the uniform attention-impl adapter
  the engine's decode program takes on MLA models.

Absorbed-MLA decode is MQA at the latent width ``Dkv = r + dr``: one query
row per sequence, and every head attends over the same latent row per token,
which is both key and value. As in the reference: q is scaled by ``scale``
and rounded back to its dtype before the scores; only the first ``kv_len``
tokens of a sequence are read; a sequence with ``kv_len`` 0 gets exact zeros;
scores, softmax and the weighted sum run in float32. The pool is unpadded
(``[P, ps, 1, Dkv]``), where the reference pads it to 128 lanes.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from llmd_tpu_torch.ops.paged_attention import _POOL_CODE, FP8, _num_sms, split_keys

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_INSTANCE_CODE = {"simt": 0, "mma": 1}
# (heads, latent width) with a kernel instance: moe-wide-mla, tiny-mla (simt,
# both dtypes); the mma instance's (bfloat16): moe-wide-mla's (at tiny-mla's
# width 80 the template spills, so simt serves it in bfloat16 too)
SHAPES = ((16, 160), (4, 80))
MMA_SHAPES = ((16, 160),)


def mla_decode_ref(
    q: torch.Tensor,  # [B, H, Dkv] one query row per sequence
    layer_cache: torch.Tensor,  # [P, ps, 1, Dkv] single-plane latent pool
    page_tables: torch.Tensor,  # [B, maxp] (entries below kv_len valid)
    kv_lens: torch.Tensor,  # [B] tokens resident incl. this step's
    *,
    scale: float,
) -> torch.Tensor:
    """Gather + mask plain version, 32 sequences at a time (bounded peak
    memory): float32 scores of the pre-scaled q against every resident latent
    row, softmax, weighted sum of the same rows; kv_len 0 gives zeros."""
    mla_decode_ref.calls += 1
    B, H, D = q.shape
    _, ps, planes, _ = layer_cache.shape
    if planes != 1:
        raise ValueError("mla_decode_ref: serves the single-plane latent pool")
    maxp = page_tables.shape[1]
    S = maxp * ps
    qs = (q.float() * scale).to(q.dtype).float()
    key_pos = torch.arange(S, device=q.device)
    out = torch.empty_like(q)
    for b0 in range(0, B, 32):
        pt = page_tables[b0:b0 + 32].long().clamp(min=0)
        C = pt.shape[0]
        kv = layer_cache[pt].reshape(C, S, D).float()  # [C, S, Dkv]: K == V
        s = torch.einsum("chd,csd->chs", qs[b0:b0 + C], kv)
        mask = (key_pos[None, :] < kv_lens[b0:b0 + C].long()[:, None])[:, None, :]
        s = s.masked_fill(~mask, float("-inf"))
        m = s.amax(dim=-1, keepdim=True).clamp_min(torch.finfo(torch.float32).min)
        p = torch.exp(s - m)  # 0 where masked; a row with no key is all 0
        l = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("chs,csd->chd", p, kv)
        out[b0:b0 + C] = torch.where(l > 0, o / l.clamp_min(1e-30), 0.0).to(q.dtype)
    return out


mla_decode_ref.calls = 0


@functools.cache
def _library():
    """The kernel's C entry point, with every argument type declared (an
    undeclared pointer would pass as a 32-bit int and be cut)."""
    from llmd_tpu_torch.native.build import load

    fn = load("mla_decode").lib.llmd_mla_decode
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def build() -> float:
    """Build (or load the cached build of) the kernel; returns seconds taken."""
    from llmd_tpu_torch.native.build import load

    _library()
    return load("mla_decode").seconds


# The mma instance's work decomposition (csrc/mla_decode.cu): a work item is
# (sequence, KV split), the splits laid out as K1's (a whole number of 64-key
# stages and pages, at most 16, csrc/mma_attention.cuh). A latent key is 320
# bytes at width 160 (K1 reads 256 per kv head), and a split's partials are
# 16 heads x (160 + 2) floats, 10 KB written and read again by the merge: at
# 128 keys (40 KB of latent) a quarter of the split's own bytes. A work item
# is short (a decode row has one fragment pair of heads), so the latency of
# its prologue and first stages, not those bytes, sets its time: on an H100,
# decode B=64+2 over a 1008-key table took 0.0231 ms at 256 keys a split
# (3 splits), 0.0188 ms at 128 (6 splits) and 0.0237 ms at 64 (8 splits of
# 128: 528 items, two waves at two blocks an SM); B=8 over 5072 keys 0.019
# ms at all three (16 splits).
MIN_SPLIT_KEYS = 128


@dataclasses.dataclass(frozen=True)
class Plan:
    """The mma instance's grid: ``splits`` x B items, the splits fastest;
    split s covers keys ``[s * split_keys, (s + 1) * split_keys)``."""

    splits: int
    split_keys: int


def _plan(batch: int, max_pages: int, page_size: int, num_sms: int = 132) -> Plan:
    """The mma instance's KV splits (``paged_attention.split_keys`` at
    ``MIN_SPLIT_KEYS``), from what the host knows without reading a device
    tensor: the batch, the table width and the page size."""
    return Plan(*split_keys(batch, max_pages * page_size, page_size, MIN_SPLIT_KEYS,
                            num_sms))


def _instance(dtype: torch.dtype, heads: int, width: int,
              pool_dtype: Optional[torch.dtype] = None) -> str:
    """The kernel instance for these inputs: ``"mma"`` for a bfloat16 q at a
    (heads, width) of ``MMA_SHAPES``; ``"simt"`` otherwise (float32 stays off
    the tensor cores, which would take it in TF32). On a float8_e4m3fn pool
    (``pool_dtype``; q's dtype when not given) the same with ``"_fp8"``."""
    base = "mma" if dtype == torch.bfloat16 and (heads, width) in MMA_SHAPES else "simt"
    return base + "_fp8" if pool_dtype == FP8 else base


def _check(q: torch.Tensor, layer_cache: torch.Tensor, page_tables: torch.Tensor,
           kv_lens: torch.Tensor) -> None:
    """Raise for anything the kernel does not take."""
    B, H, D = q.shape
    P, ps, planes, Dc = layer_cache.shape
    if q.dtype not in _DTYPE_CODE or layer_cache.dtype not in (q.dtype, FP8):
        raise TypeError(f"mla_decode: q {q.dtype} / pool {layer_cache.dtype}; "
                        "the kernel takes a float32 or bfloat16 q over a pool of "
                        "q's dtype or float8_e4m3fn")
    if planes != 1 or Dc != D or (H, D) not in SHAPES:
        raise ValueError(f"mla_decode: no kernel instance for H={H} D={D} "
                         f"planes={planes} ((heads, width) in {SHAPES}, one plane)")
    if page_tables.shape[0] != B or kv_lens.shape != (B,):
        raise ValueError(f"mla_decode: page_tables {tuple(page_tables.shape)} / kv_lens "
                         f"{tuple(kv_lens.shape)} do not match B={B}")
    if not (q.is_contiguous() and layer_cache.is_contiguous()):
        raise ValueError("mla_decode: q and the pool must be contiguous")
    if q.data_ptr() % 16 or layer_cache.data_ptr() % 16:
        raise ValueError("mla_decode: q and the pool must be 16-byte aligned")
    if any(t.device != q.device for t in (layer_cache, page_tables, kv_lens)):
        raise ValueError("mla_decode: all inputs must be on q's device")


def _launch(q: torch.Tensor, layer_cache: torch.Tensor, page_tables: torch.Tensor,
            kv_lens: torch.Tensor, scale: float, instance: str) -> torch.Tensor:
    """One launch of ``instance`` (``"mma"`` or ``"simt"``; an ``"_fp8"``
    suffix is implied by the pool's dtype) on checked inputs (counts
    nothing)."""
    instance = instance.removesuffix("_fp8")
    B, H, D = q.shape
    ps = layer_cache.shape[1]
    maxp = page_tables.shape[1]
    out = torch.empty_like(q)
    if B == 0:
        return out
    plan, scratch = Plan(1, maxp * ps), None
    if instance == "mma":
        plan = _plan(B, maxp, ps, _num_sms(q.device.index or 0))
        if plan.splits > 1:  # partial (o, m, l) of every split, merged by the kernel
            scratch = torch.empty(plan.splits * B * H * (D + 2), dtype=torch.float32,
                                  device=q.device)
    pt = page_tables.to(torch.int32).contiguous()
    lens = kv_lens.to(torch.int32).contiguous()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _library()(q.data_ptr(), layer_cache.data_ptr(), pt.data_ptr(),
                         lens.data_ptr(), out.data_ptr(),
                         None if scratch is None else scratch.data_ptr(), B, H, D, ps, maxp,
                         float(scale), _DTYPE_CODE[q.dtype], _POOL_CODE[layer_cache.dtype],
                         _INSTANCE_CODE[instance],
                         plan.splits, plan.split_keys, stream)
    if err != 0:
        raise RuntimeError(f"mla_decode kernel ({instance}) launch failed: cudaError {err}")
    return out


def mla_decode(
    q: torch.Tensor,
    layer_cache: torch.Tensor,
    page_tables: torch.Tensor,
    kv_lens: torch.Tensor,
    *,
    scale: float,
) -> torch.Tensor:
    """Latent decode attention: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Page-table entries below ``kv_len`` must name
    pages of the pool (the kernel reads them on the device and does not
    check). Raises for anything the kernel does not take."""
    if q.device.type == "cpu":
        return mla_decode_ref(q, layer_cache, page_tables, kv_lens, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"mla_decode: unsupported device {q.device}")
    _check(q, layer_cache, page_tables, kv_lens)
    instance = _instance(q.dtype, q.shape[1], q.shape[2], layer_cache.dtype)
    out = _launch(q, layer_cache, page_tables, kv_lens, scale, instance)
    mla_decode.launches += 1
    mla_decode.launches_by_instance[instance] += 1
    return out


mla_decode.launches = 0
mla_decode.launches_by_instance = {"mma": 0, "simt": 0, "mma_fp8": 0, "simt_fp8": 0}


def mla_paged_attention_latent(
    q: torch.Tensor,  # [N, H, Dkv] one query row per sequence (N == B)
    layer_cache: torch.Tensor,  # [P, ps, 1, Dkv]
    page_tables: torch.Tensor,  # [B, maxp] (-1 = unmapped)
    positions: torch.Tensor,  # [N] (unused: decode attends the whole prefix)
    seq_slots: torch.Tensor,  # [N] (unused: row i IS sequence i at decode)
    kv_lens: torch.Tensor,  # [B]
    *,
    scale: float,
    cu_q_lens: Optional[torch.Tensor] = None,  # unused (uniform impl signature)
    num_seqs: Optional[torch.Tensor] = None,  # unused (uniform impl signature)
    decode=None,
) -> torch.Tensor:
    """Uniform-signature adapter for the decode program of MLA models: one
    query row per sequence. ``-1`` page entries lie at or past ``kv_len`` and
    are never read; they are clamped to 0 only so every entry names a page.
    ``decode`` is the latent decode to run (default :func:`mla_decode`; the
    kernel-vs-plain checks pass :func:`mla_decode_ref`)."""
    del positions, seq_slots, cu_q_lens, num_seqs
    if q.shape[0] != page_tables.shape[0]:
        raise ValueError(
            "latent decode attention takes one query row per sequence "
            f"(got N={q.shape[0]}, B={page_tables.shape[0]}); mixed batches go "
            "through paged_attention")
    decode = decode if decode is not None else mla_decode
    return decode(q, layer_cache, page_tables.clamp(min=0), kv_lens, scale=scale)
