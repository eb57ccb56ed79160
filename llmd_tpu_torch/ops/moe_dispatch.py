"""Token-sorted, drop-free MoE dispatch (port of ``llmd_tpu/ops/moe_dispatch.py``):
on one device, and the expert-parallel exchange over a mesh.

* Sort the flat ``(token, k)`` copies by physical slot id (EPLB's replica
  choice already happened in ``moe_block``, so the sort key is the placement).
* Scatter the activations into a block-aligned buffer whose per-slot segments
  start at multiples of the GEMM block size ``bc``: static shapes,
  data-dependent fill, no drops, no host read (so a CUDA graph captures it).
* Run the expert MLP as two block-ragged grouped GEMMs (K2,
  ``ops/grouped_gemm.ragged_grouped_gemm``: the CUDA kernel on the card, its
  plain version for CPU tensors), ``silu(gate) * up`` between them in the
  activation dtype. int8 banks (per-slot scales given) run the reference's
  ``_experts_xla`` instead: batched products over the block-gathered banks,
  times the block-gathered scales, with the block size of its XLA path (no
  K2 launch; the reference's kernel is bf16-only too).
* Combine by the inverse permutation, weighted by the router probabilities.
  A token's k copies are contiguous, so the combine adds them in order of k
  without atomics (a deterministic sum on the card).

The reference's ``mode="drop"`` scatters have no torch counterpart: sentinel
copies write to one dump row past the buffer, which is then sliced off.

Expert parallel (``make_sorted_dispatch(mesh)`` with ep > 1; reference
``_ep_moe_body``): the ranks of one ep group hold the same rows (their
(dp, sp) part of a split step, ``parallel/rows``), padded to a multiple of ep,
and each owns one 1/ep slice of them. Its routed copies are
bucketed by the ep rank that owns their slot, each bucket of ``cap = tpc·k``
rows (all of the slice's copies could go to one rank, so nothing drops), and
two ``all_to_all_single`` calls over the ep group send the rows and their
slot ids. The receiver runs the sorted experts (K2) on its ``ep·cap`` rows
over its S/ep local slots, the ``-1`` pads as the sentinel slot, and one
``all_to_all_single`` sends the rows back. The origin weights them and adds
each token's k copies in order of k (as the local combine: no atomics), and
an all-gather over ep gives every rank of the group its rows back.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from llmd_tpu_torch.ops.grouped_gemm import ragged_grouped_gemm


def pick_block_size(tokens_k: int, slots: int, pallas: bool) -> int:
    """GEMM block rows: about one slot's expected share, power of two.

    The padded buffer is ``Tk + S*bc`` rows, so small ``bc`` keeps the
    drop-free layout near-dense at decode shapes (Tk ~ S) while prefill
    (Tk >> S) gets larger blocks. ``pallas`` (the kernel flag; set on the
    card) keeps at least 8 rows, so the block plans equal the reference's.
    """
    bc = 1
    while bc * slots < tokens_k and bc < 128:
        bc *= 2
    return max(8, bc) if pallas else bc


def _row_plan(slot: torch.Tensor, S: int, bc: int):
    """Static-shape placement of N routed copies into a block-aligned buffer.
    ``slot`` is [N] int in [0, S]; S is the padding sentinel.

    Returns (row [N], block_slot [nb], block_rows [nb], Tp), all int32 but Tp:
    ``row[i]`` is copy i's row in the padded buffer (== Tp for sentinels, the
    dump row); block b holds rows of expert slot ``block_slot[b]``, with
    ``block_rows[b]`` of them real.
    """
    N = slot.shape[0]
    dev = slot.device
    slot = slot.long()
    ss, order = torch.sort(slot, stable=True)
    # copies per slot; a scatter-add, since bincount reads its input's maximum
    # back to the host (no capture in a CUDA graph)
    cnt = torch.zeros((S + 1,), dtype=torch.long, device=dev).scatter_add_(
        0, slot, torch.ones_like(slot))[:S]
    cnt_pad = (cnt + bc - 1) // bc * bc
    starts = torch.cumsum(cnt, 0) - cnt  # raw sorted-order starts
    starts_pad = torch.cumsum(cnt_pad, 0) - cnt_pad  # block-aligned starts
    Tp = ((N + bc - 1) // bc + S) * bc  # worst-case padding, static
    sc = ss.clamp(max=S - 1)
    pos_in_slot = torch.arange(N, device=dev) - starts[sc]
    row_sorted = torch.where(ss < S, starts_pad[sc] + pos_in_slot,
                             torch.full_like(ss, Tp))
    row = torch.empty_like(row_sorted).scatter_(0, order, row_sorted)
    nb = Tp // bc
    bstart = torch.arange(nb, device=dev) * bc
    # segments are bc-aligned, so each block belongs to exactly one slot:
    # the last one whose padded start is <= the block start
    block_slot = (torch.searchsorted(starts_pad, bstart, right=True) - 1).clamp(0, S - 1)
    block_rows = (starts_pad[block_slot] + cnt[block_slot] - bstart).clamp(0, bc)
    return (row.to(torch.int32), block_slot.to(torch.int32),
            block_rows.to(torch.int32), Tp)


def dispatch_stage(x, idx, topw, valid, S: int, bc: int):
    """Sort + scatter: flat (token, k) copies into the block buffer.

    Returns (xs [Tp, D], row [T*k], tok [T*k], wf [T*k], block_slot [nb],
    block_rows [nb])."""
    T, D = x.shape
    k = idx.shape[1]
    slot = torch.where(valid > 0, idx.long(), S).reshape(T * k)
    row, block_slot, block_rows, Tp = _row_plan(slot, S, bc)
    tok = torch.arange(T * k, device=x.device) // k
    xs = x.new_zeros((Tp + 1, D))  # + the dump row for sentinel copies
    xs.index_copy_(0, row.long(), x[tok])
    wf = torch.where(slot < S, topw.reshape(T * k), 0).to(x.dtype)
    return xs[:Tp], row, tok, wf, block_slot, block_rows


def experts_stage(xs, block_slot, block_rows, wi, wo, *,
                  gemm: Callable = ragged_grouped_gemm):
    """Per-block expert MLP on the sorted buffer: [Tp, D] -> [Tp, D]. Two K2
    launches (wi, then wo); ``silu(gate) * up`` in the activation dtype."""
    Tp, D = xs.shape
    bc = Tp // block_slot.shape[0]
    gate_up = gemm(xs.reshape(-1, bc, D), wi, block_slot, block_rows)
    gate, up = gate_up.chunk(2, dim=-1)
    ye = gemm(F.silu(gate) * up, wo, block_slot, block_rows)
    return ye.reshape(Tp, D)


def experts_scaled(xs, block_slot, wi, wo, wi_scale, wo_scale):
    """The int8 expert MLP on the sorted buffer (reference ``_experts_xla``):
    each block's bank and per-output-channel scales gathered by its slot,
    ``(x @ q.to(dt)) * s.to(dt)`` for wi and wo. Dead rows are zero and
    ``silu(0) * 0 == 0``, so no mask is needed."""
    Tp, D = xs.shape
    nb = block_slot.shape[0]
    dt = xs.dtype
    bs = block_slot.long()
    gate_up = torch.bmm(xs.view(nb, Tp // nb, D), wi[bs].to(dt)) * wi_scale[bs][:, None, :].to(dt)
    gate, up = gate_up.chunk(2, dim=-1)
    ye = torch.bmm(F.silu(gate) * up, wo[bs].to(dt)) * wo_scale[bs][:, None, :].to(dt)
    return ye.reshape(Tp, D)


def combine_stage(ye, row, tok, wf, T: int):
    """Inverse permutation + router-prob weighting back to [T, D]. The k
    copies of a token are contiguous (``tok = arange(T*k) // k``): they are
    added in order of k in the activation dtype, as the reference's
    scatter-add adds them."""
    Tp, D = ye.shape
    g = (ye[row.long().clamp(max=Tp - 1)] * wf[:, None]).view(T, -1, D)
    y = g[:, 0]
    for j in range(1, g.shape[1]):
        y = y + g[:, j]
    return y


def sorted_moe_local(x, idx, topw, valid, wi, wo, wi_scale=None, wo_scale=None, *,
                     bc: Optional[int] = None, gemm: Callable = ragged_grouped_gemm):
    """Single-device token-sorted MoE: gather/scatter only, no collective.
    On the card the block size of the bf16 path keeps the kernel's minimum of
    8 rows. ``gemm`` is K2's wrapper; the card-side kernel-vs-plain checks
    pass its plain version. ``wi_scale``/``wo_scale`` (int8 banks): the
    scaled plain experts (:func:`experts_scaled`) at the XLA block size."""
    T, D = x.shape
    S = wi.shape[0]
    if bc is None:
        bc = pick_block_size(T * idx.shape[1], S, pallas=x.is_cuda and wi_scale is None)
    xs, row, tok, wf, block_slot, block_rows = dispatch_stage(x, idx, topw, valid, S, bc)
    if wi_scale is None:
        ye = experts_stage(xs, block_slot, block_rows, wi, wo, gemm=gemm)
    else:
        ye = experts_scaled(xs, block_slot, wi, wo, wi_scale, wo_scale)
    return combine_stage(ye, row, tok, wf, T)


def _sorted_rows(xr, lslot, Sl: int, bc: int, wi, wo, wi_scale, wo_scale, gemm):
    """The receiver's experts: rows already one per copy, each with a local
    slot id in [0, Sl] (Sl: a pad). Output row i is input row i's."""
    D = xr.shape[1]
    row, block_slot, block_rows, Tp = _row_plan(lslot, Sl, bc)
    xs = xr.new_zeros((Tp + 1, D))  # + the dump row for the pads
    xs.index_copy_(0, row.long(), xr)
    xs = xs[:Tp]
    if wi_scale is None:
        ye = experts_stage(xs, block_slot, block_rows, wi, wo, gemm=gemm)
    else:
        ye = experts_scaled(xs, block_slot, wi, wo, wi_scale, wo_scale)
    return ye[row.long().clamp(max=Tp - 1)]


def ep_moe(x, idx, topw, valid, wi, wo, wi_scale=None, wo_scale=None, *, mesh,
           gemm: Callable = ragged_grouped_gemm) -> torch.Tensor:
    """The expert-parallel sorted MoE (module docstring). ``wi``/``wo`` (and
    the int8 scales) are this rank's S/ep slots; x/idx/topw/valid are this
    rank's rows, the same on every rank of its ep group. Returns y [T, D]."""
    T, D = x.shape
    k = idx.shape[1]
    ep = mesh.size("ep")
    Sl = wi.shape[0]
    S = Sl * ep
    Tp = -(-T // ep) * ep
    if Tp != T:
        def pad(a):
            return torch.cat([a, a.new_zeros((Tp - T, *a.shape[1:]))])
        x, idx, topw, valid = pad(x), pad(idx), pad(topw), pad(valid)  # pad rows invalid
    tpc = Tp // ep
    o = mesh.index("ep") * tpc
    x_o, idx_o, w_o, v_o = (a[o : o + tpc] for a in (x, idx, topw, valid))
    dev = x.device
    n = cap = tpc * k  # a bucket holds every copy of the slice: no drops
    slot = torch.where(v_o > 0, idx_o.long(), S).reshape(n)
    dest = torch.where(slot < S, slot // Sl, ep)  # ep: not sent
    dsort, order = torch.sort(dest, stable=True)
    dcnt = torch.zeros((ep + 1,), dtype=torch.long, device=dev).scatter_add_(
        0, dest, torch.ones_like(dest))[:ep]
    dstart = torch.cumsum(dcnt, 0) - dcnt
    pos = torch.arange(n, device=dev) - dstart[dsort.clamp(max=ep - 1)]
    sendrow = torch.where(dsort < ep, dsort * cap + pos, ep * cap)
    entry_tok = order // k
    send_x = x.new_zeros((ep * cap + 1, D)).index_copy_(0, sendrow, x_o[entry_tok])
    send_slot = torch.full((ep * cap + 1,), -1, dtype=torch.int32, device=dev).index_copy_(
        0, sendrow, slot[order].to(torch.int32))
    recv_x = mesh.all_to_all(send_x[: ep * cap], "ep")
    recv_slot = mesh.all_to_all(send_slot[: ep * cap], "ep")
    r = mesh.index("ep")
    lslot = torch.where(recv_slot >= 0, recv_slot - r * Sl, Sl)
    bc = pick_block_size(ep * cap, Sl, pallas=x.is_cuda and wi_scale is None)
    ye = _sorted_rows(recv_x, lslot, Sl, bc, wi, wo, wi_scale, wo_scale, gemm)
    back = mesh.all_to_all(ye, "ep")
    g = back[sendrow.clamp(max=ep * cap - 1)]
    wf = torch.where(dsort < ep, w_o.reshape(n)[order], 0).to(x.dtype)
    # back to (token, k) order, then each token's copies added in order of k
    by_copy = torch.empty_like(g).index_copy_(0, order, g * wf[:, None]).view(tpc, k, D)
    y_o = by_copy[:, 0]
    for j in range(1, k):
        y_o = y_o + by_copy[:, j]
    return mesh.gather(y_o, "ep")[:T]


def make_sorted_dispatch(mesh=None, gemm: Callable = ragged_grouped_gemm) -> Callable:
    """The ``moe_block`` dispatch_impl ``impl(x, idx, topw, valid, wi, wo,
    wi_scale, wo_scale) -> y``: routing, top-k and the EPLB replica choice
    happened upstream (shared with the einsum path). ``mesh`` (a
    ``parallel/mesh.RankMesh``) with ep > 1: :func:`ep_moe`, whose banks are
    this rank's slots; otherwise the one-device path (every rank of a mesh
    without ep runs its rows on its whole banks). ``gemm``: K2's wrapper or
    its plain version."""
    if mesh is not None and mesh.size("ep") > 1:
        return functools.partial(ep_moe, mesh=mesh, gemm=gemm)
    if gemm is ragged_grouped_gemm:
        return sorted_moe_local
    return functools.partial(sorted_moe_local, gemm=gemm)
