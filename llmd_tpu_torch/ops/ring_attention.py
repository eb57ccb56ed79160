"""Ring attention: causal attention over the ``sp`` axis of the rank mesh
(port of ``llmd_tpu/ops/ring_attention.py``).

Each sp rank holds S/n query rows and S/n K/V rows. Attention runs in n ring
steps: attend the local queries to the resident K/V block under an online
softmax (f32 running max, denominator and accumulator, so the result is exact
attention whatever the order), then hand the block to the next rank of the
ring (``RankMesh.ring_shift``: one ``batch_isend_irecv`` over the sp group,
NCCL on cards, gloo on the CPU). The last step's rotation would feed nothing
and is skipped. K/V travel at their Hk heads: the block attend is GQA-native
(query head h of the flat layout is (h // G, h % G) of the grouped one).

Causality by global position: a block strictly newer than every local query
is skipped, the diagonal block is masked triangular, older blocks attend in
full. ``zigzag`` (the default of :func:`sp_flash_prefill`) gives rank d the
chunks d and 2n-1-d of the sequence, so every rank does about the same causal
work at every step (two C x C sub-attends: low keys to high queries always,
low to low when src <= my, high to high when src >= my); the contiguous
layout leaves the last rank working at every step.

The block attend is plain torch in f32, as the reference's is XLA einsums:
no kernel. :func:`make_ring_attn_impl` is the engine's ``unified_ring``
attention: each sp rank runs its own rows of the ring layout
(``parallel/rows.ring_plan``) through the dense layers, and the impl runs the
ring on those rows' q and raw k/v (``forward_core`` passes ``chunk_k`` /
``chunk_v``), valid only for one fresh sequence at offset 0, which the engine
checks; nothing is gathered over sp. :func:`sp_flash_prefill` is the same
ring over a whole sequence held by every rank, its result gathered over sp
(its unit tests' entry).
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch

from llmd_tpu_torch.parallel.rows import ring_order

NEG_INF = -1e30


def _block_attn(q, k, v, mask, m_prev, l_prev, acc_prev, scale):
    """One K/V block's contribution under online softmax, GQA-native.
    q: [Sq, Hk, G, D]; k, v: [Sk, Hk, D]; mask: [Sq, Sk] (True = attend);
    m, l: [Sq, Hk, G]; acc: [Sq, Hk, G, D] (f32)."""
    s = torch.einsum("qhgd,khd->qhgk", q.float(), k.float()) * scale
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    m_new = torch.maximum(m_prev, s.amax(dim=-1))
    # a fully masked row keeps exp(NEG_INF - NEG_INF) from becoming 1
    alive = m_new > NEG_INF / 2
    p = torch.exp(torch.where(alive[..., None], s - m_new[..., None], NEG_INF))
    correction = torch.exp(torch.where(alive, m_prev - m_new, 0.0))
    l_new = l_prev * correction + p.sum(dim=-1)
    acc_new = acc_prev * correction[..., None] + torch.einsum("qhgk,khd->qhgd", p, v.float())
    return m_new, l_new, acc_new


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                           mesh, axis_name: str = "sp", scale: float,
                           zigzag: bool = False) -> torch.Tensor:
    """Exact causal attention over this rank's shard of the sequence.

    q: [S_local, H, D]; k, v: [S_local, Hk, D] (H a multiple of Hk). Contiguous
    layout: rank s holds rows s*S_local... Zig-zag: rank s holds chunk s then
    chunk 2n-1-s, each S_local/2 rows. Returns [S_local, H, D] in q's dtype."""
    n, my = mesh.size(axis_name), mesh.index(axis_name)
    S, H, D = q.shape
    Hk = k.shape[1]
    G = H // Hk
    qg = q.reshape(S, Hk, G, D)
    dev = q.device
    m = torch.full((S, Hk, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((S, Hk, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((S, Hk, G, q.shape[-1]), dtype=torch.float32, device=dev)
    kb, vb = k, v
    ar = torch.arange(S, device=dev)
    for i in range(n):
        src = (my - i) % n  # whose block this rank holds at step i
        if not zigzag:
            if src <= my:  # strictly future blocks never attend
                mask = (src * S + ar)[None, :] <= (my * S + ar)[:, None]
                m, l, acc = _block_attn(qg, kb, vb, mask, m, l, acc, scale)
        else:
            C = S // 2
            c = ar[:C]
            q_lo, q_hi = my * C + c, (2 * n - 1 - my) * C + c
            k_lo, k_hi = src * C + c, (2 * n - 1 - src) * C + c
            lo, hi = slice(0, C), slice(C, S)
            if src <= my:  # low keys -> low queries: same-or-older chunk
                m[lo], l[lo], acc[lo] = _block_attn(
                    qg[lo], kb[lo], vb[lo], k_lo[None, :] <= q_lo[:, None],
                    m[lo], l[lo], acc[lo], scale)
            # low keys -> high queries: every low chunk precedes every high one
            m[hi], l[hi], acc[hi] = _block_attn(
                qg[hi], kb[lo], vb[lo], k_lo[None, :] <= q_hi[:, None],
                m[hi], l[hi], acc[hi], scale)
            if src >= my:  # high keys -> high queries: order reverses with rank
                m[hi], l[hi], acc[hi] = _block_attn(
                    qg[hi], kb[hi], vb[hi], k_hi[None, :] <= q_hi[:, None],
                    m[hi], l[hi], acc[hi], scale)
            # high keys -> low queries: strictly future for every pair
        if i < n - 1:  # the last rotation would feed nothing
            kb, vb = mesh.ring_shift([kb, vb], axis_name)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(S, H, q.shape[-1]).to(q.dtype)


def sp_flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, *,
                     scale: Optional[float] = None, axis_name: str = "sp",
                     zigzag: bool = True) -> torch.Tensor:
    """Causal attention of the whole sequence q [S, H, D], k/v [S, Hk, D]
    (the same on every rank), computed ring-parallel over ``mesh``'s
    ``axis_name`` axis; returns [S, H, D] on every rank. Zig-zag needs S to
    divide by 2n: otherwise it warns and takes the contiguous layout, which
    needs S to divide by n (ValueError otherwise), as the reference."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    n = mesh.size(axis_name)
    S = q.shape[0]
    use_zigzag = zigzag and n > 1 and S % (2 * n) == 0
    if zigzag and n > 1 and not use_zigzag:
        warnings.warn(f"ring attention: S={S} not divisible by 2*{n}; "
                      "using the contiguous (imbalanced) layout")
    if S % n != 0:
        raise ValueError(f"sequence length {S} must divide by the {axis_name} "
                         f"axis size {n} (pad upstream)")
    my, b = mesh.index(axis_name), S // n
    if use_zigzag:
        perm = torch.from_numpy(ring_order(S, n, zigzag=True)).to(q.device)
        rows = perm[my * b:(my + 1) * b]
        out_l = ring_attention_sharded(q[rows], k[rows], v[rows], mesh=mesh,
                                       axis_name=axis_name, scale=scale, zigzag=True)
        out = mesh.gather(out_l, axis_name)  # rows in zig-zag order
        return torch.empty_like(out).index_copy_(0, perm, out)
    sl = slice(my * b, (my + 1) * b)
    out_l = ring_attention_sharded(q[sl], k[sl], v[sl], mesh=mesh, axis_name=axis_name,
                                   scale=scale, zigzag=False)
    return mesh.gather(out_l, axis_name)


def ring_layout(tokens: int, n: int, zigzag: bool = True) -> str:
    """The layout the engine's ring program runs for a ``tokens``-row
    batch budget: "zigzag" when it divides by 2n, else "contiguous"."""
    return "zigzag" if zigzag and tokens % (2 * n) == 0 else "contiguous"


def make_ring_attn_impl(mesh, axis_name: str = "sp", zigzag: bool = True):
    """The ``unified_ring`` program's attention impl (the engine's uniform
    signature): ring attention over this rank's rows of the chunk, its q and
    its raw ``chunk_k`` / ``chunk_v``, not the pool. The rows are this sp
    rank's of the ring layout (``parallel/rows.ring_plan``: zig-zag or
    contiguous, pad rows at position -1 past the sequence, in every real
    query's future), one fresh sequence packed at offset 0 (positions
    0..N-1, no earlier K/V), which the engine checks: there causality by row
    equals causality by position. The K/V were written to the pool before
    this call, so decode goes on from the pool."""

    def impl(q, layer_cache, page_tables, positions, seq_slots, kv_lens, *,
             scale, cu_q_lens=None, num_seqs=None, chunk_k=None, chunk_v=None):
        del layer_cache, page_tables, positions, seq_slots, kv_lens, cu_q_lens, num_seqs
        if chunk_k is None or chunk_v is None:
            raise ValueError("ring attn impl needs the chunk's raw k/v "
                             "(forward_core passes chunk_k/chunk_v)")
        return ring_attention_sharded(q, chunk_k, chunk_v, mesh=mesh, axis_name=axis_name,
                                      scale=scale, zigzag=zigzag)

    return impl


def reference_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               scale: Optional[float] = None) -> torch.Tensor:
    """Dense causal attention, the ring's plain oracle (GQA k/v repeated up
    to the query heads)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if k.shape[1] != q.shape[1]:
        reps = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(reps, dim=1)
        v = v.repeat_interleave(reps, dim=1)
    S = q.shape[0]
    s = torch.einsum("qhd,khd->qhk", q.float(), k.float()) * scale
    mask = torch.tril(torch.ones((S, S), dtype=torch.bool, device=q.device))
    s = torch.where(mask[:, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("qhk,khd->qhd", p, v.float()).to(q.dtype)
