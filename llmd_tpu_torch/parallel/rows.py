"""A step's rows split over the mesh, as the reference binds them.

The reference binds the flat token dimension of its row-parallel programs to
``("dp", "sp")`` jointly (``llmd_tpu/engine/engine.py``: ``_unified``,
``_verify``, ``_verify_masked``, ``_embed``) and the decode programs' slot
rows to ``"dp"`` alone (``_decode_multi``, ``_decode_multi_masked``); rows
stay replicated over ep and tp, and the KV pool, sharded over tp only, is
whole on every dp / sp replica. The port runs each rank's rows only:

- :func:`flat_plan`: the unified, verify and embed programs' flat rows in
  contiguous, near-equal slices over the joint (dp, sp) index, dp-major (the
  order of ``P(("dp", "sp"))``): part p holds rows ``[b[p], b[p+1])`` and the
  first ``N % n`` parts one row more;
- :func:`block_plan`: the decode programs' slots in contiguous blocks of
  ``ceil(B / dp)`` over dp, the last block padded with idle slots (an uneven
  GSPMD shard is padded so);
- :func:`ring_plan`: the ``unified_ring`` program's rows over sp in the ring
  layout (zig-zag or contiguous, ``ops/ring_attention``), padded to its
  multiple; replicated over dp.

These are pure host functions: every rank of a world calls them on the host
arrays of the command stream and derives the same parts. :func:`local_batch`
gives a part its rows of every per-row array and, for each sequence with rows
in it, its page-table row, its local ``cu_q_lens`` and its kv length = the
position of its last local row + 1, so K1's causal offset (query i of a
sequence at ``kv_len - q_len + i``) is the unsplit batch's for those rows.

:class:`RowSplit` is ``forward_core``'s device view of a split step: the
all-gather of per-row tensors over the plan's axes back into the step's row
order (each part padded to the widest part), and the sum over them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

FLAT_AXES = ("dp", "sp")
DECODE_AXES = ("dp",)
RING_AXES = ("sp",)


@dataclass(frozen=True)
class RowPlan:
    """A step's ``n_rows`` rows over the mesh axes ``axes``: part p (the rank
    at row-major index p over ``axes``) runs rows ``parts[p]`` (the step's row
    of each local row; -1 a pad row, idle)."""

    axes: tuple[str, ...]
    parts: tuple[np.ndarray, ...]
    n_rows: int

    @property
    def width(self) -> int:
        """The rows a part sends in a gather (the widest part's)."""
        return max(len(p) for p in self.parts)

    def take(self) -> Optional[np.ndarray]:
        """[n_rows] int64: where row r sits in the parts' concatenation, each
        part padded to :attr:`width`; None when that is row r itself."""
        w = self.width
        pos = np.concatenate([p * w + np.arange(len(rows)) for p, rows in enumerate(self.parts)])
        rows = np.concatenate(self.parts)
        real = rows >= 0
        out = np.empty((self.n_rows,), np.int64)
        out[rows[real]] = pos[real]
        if len(self.parts) * w == self.n_rows and np.array_equal(out, np.arange(self.n_rows)):
            return None
        return out


def flat_bounds(n_rows: int, parts: int) -> np.ndarray:
    """[parts + 1] row offsets of :func:`flat_plan`'s slices."""
    base, extra = divmod(n_rows, parts)
    sizes = np.full((parts,), base, np.int64)
    sizes[:extra] += 1
    return np.concatenate([[0], np.cumsum(sizes)])


def flat_plan(n_rows: int, parts: int, axes: tuple[str, ...] = FLAT_AXES) -> RowPlan:
    b = flat_bounds(n_rows, parts)
    return RowPlan(axes, tuple(np.arange(b[p], b[p + 1]) for p in range(parts)), n_rows)


def block_plan(n_slots: int, parts: int, axes: tuple[str, ...] = DECODE_AXES) -> RowPlan:
    per = -(-n_slots // parts)
    blocks = []
    for p in range(parts):
        ids = np.arange(p * per, (p + 1) * per)
        blocks.append(np.where(ids < n_slots, ids, -1))
    return RowPlan(axes, tuple(blocks), n_slots)


def ring_order(n_rows: int, parts: int, zigzag: bool) -> np.ndarray:
    """The ring layout's row order over ``n_rows`` (a multiple of ``2 *
    parts`` for zig-zag, of ``parts`` otherwise): rank d holds the d-th
    ``n_rows / parts`` of it; zig-zag gives rank d chunks d and 2n-1-d."""
    if not zigzag:
        return np.arange(n_rows)
    c = n_rows // (2 * parts)
    ids = np.stack([np.arange(parts), 2 * parts - 1 - np.arange(parts)], axis=1).reshape(-1)
    return (ids[:, None] * c + np.arange(c)[None, :]).reshape(-1)


def ring_plan(n_rows: int, parts: int, zigzag: bool,
              axes: tuple[str, ...] = RING_AXES) -> RowPlan:
    """One fresh sequence's ``n_rows`` rows in the ring layout, padded with
    pad rows (-1) to the layout's multiple (2n zig-zag, n contiguous)."""
    mult = 2 * parts if zigzag else parts
    padded = n_rows + (-n_rows) % mult
    order = ring_order(padded, parts, zigzag)
    order = np.where(order < n_rows, order, -1)
    b = padded // parts
    return RowPlan(axes, tuple(order[p * b:(p + 1) * b] for p in range(parts)), n_rows)


def take_rows(a: np.ndarray, rows: np.ndarray, fill) -> np.ndarray:
    """``a[rows]``, ``fill`` where a row is -1 (a pad)."""
    out = np.full((len(rows), *a.shape[1:]), fill, dtype=a.dtype)
    real = rows >= 0
    out[real] = a[rows[real]]
    return out


def local_batch(batch: dict[str, np.ndarray], rows: np.ndarray,
                per_row: tuple[str, ...]) -> dict[str, np.ndarray]:
    """A flat part's batch: ``rows`` (contiguous, from :func:`flat_plan`) of
    the step's packed ``batch`` (``tokens``, ``positions``, ``seq_slots``,
    ``page_tables``, ``kv_lens``, ``cu_q_lens``, and the per-row arrays named
    in ``per_row``). Each sequence with rows in the part keeps its page-table
    row, its local query count and kv length = its kv length less its rows
    past the part; ``seq_slots`` count from the part's first sequence (pad
    rows past the last sequence, as the embed program packs them, on 0). A
    part with no sequence gets one empty one (no query row, kv length 1, no
    page), so every shape keeps a sequence row."""
    lo = int(rows[0]) if len(rows) else 0
    hi = lo + len(rows)
    cu = batch["cu_q_lens"].astype(np.int64)
    first, last = np.maximum(cu[:-1], lo), np.minimum(cu[1:], hi)
    mine = np.nonzero(last > first)[0]
    out = {k: batch[k][lo:hi] for k in ("tokens", "positions", *per_row)}
    if len(mine) == 0:
        out["page_tables"] = np.full((1, batch["page_tables"].shape[1]), -1, np.int32)
        out["kv_lens"] = np.ones((1,), np.int32)
        out["cu_q_lens"] = np.zeros((2,), np.int32)
        out["seq_slots"] = np.zeros((hi - lo,), np.int32)
    else:
        q = last[mine] - first[mine]
        out["page_tables"] = batch["page_tables"][mine]
        out["kv_lens"] = (batch["kv_lens"][mine] - (cu[1:][mine] - last[mine])).astype(np.int32)
        out["cu_q_lens"] = np.concatenate([[0], np.cumsum(q)]).astype(np.int32)
        out["seq_slots"] = np.clip(batch["seq_slots"][lo:hi] - mine[0], 0,
                                   len(mine) - 1).astype(np.int32)
    out["num_seqs"] = np.array([len(out["kv_lens"])], np.int32)
    return out


def pick_plan(plan: RowPlan, picks: np.ndarray) -> tuple[list[np.ndarray], RowPlan]:
    """The step rows ``picks`` as the parts hold them: per part, the local
    index of each picked row it runs, and the plan of their gather back into
    the picks' order."""
    local, parts = [], []
    for rows in plan.parts:
        where = {int(g): j for j, g in enumerate(rows) if g >= 0}
        own = [(i, where[int(g)]) for i, g in enumerate(picks) if int(g) in where]
        local.append(np.array([j for _, j in own], np.int64))
        parts.append(np.array([i for i, _ in own], np.int64))
    return local, RowPlan(plan.axes, tuple(parts), len(picks))


class RowSplit:
    """This rank's part of a split step on the device: ``gather`` all-gathers
    a per-row tensor of the part's rows over the plan's axes into the step's
    row order, ``reduce`` sums over them."""

    def __init__(self, mesh, plan: RowPlan, device: torch.device) -> None:
        self.mesh = mesh
        self.axes = plan.axes
        self.width = plan.width
        take = plan.take()
        self.take = None if take is None else torch.from_numpy(take).to(device)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        pad = self.width - x.shape[0]
        if pad:
            x = torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])
        out = self.mesh.gather(x, self.axes)
        return out if self.take is None else out[self.take]

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return self.mesh.reduce(x, self.axes)
