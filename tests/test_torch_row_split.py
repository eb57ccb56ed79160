"""The row split of a step over the mesh (``llmd_tpu_torch/parallel/rows.py``)
as pure functions, on the CPU, against the reference's bindings: the flat
programs' rows over the joint (dp, sp) index in ``P(("dp", "sp"))`` order,
the decode programs' slots over dp, the ring layout over sp.

- the slices are contiguous, cover every row once and follow the dp-major
  order of the mesh's ranks (hypothesis over sizes and meshes);
- each part's ``cu_q_lens`` / ``kv_lens`` give a sequence that straddles two
  parts the causal offset of the unsplit batch (hypothesis over packings);
- the decode blocks, padded with idle slots, and a DP rank's slot range;
- the einsum MoE path over split rows (threads as the parts, the routing
  gathered at a barrier): the outputs, expert counts and dropped copies of
  the unsplit batch (hypothesis), and of the JAX ``moe_block`` on the
  reference's static batch;
- K1's plain version over each part's rows and metadata, concatenated,
  equals it over the unsplit batch, and equals the JAX
  ``ragged_paged_attention_xla``.
"""

import dataclasses
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from llmd_tpu.models import get_model_config as jax_model_config
from llmd_tpu.models import transformer as jt
from llmd_tpu_torch.models import get_model_config
from llmd_tpu_torch.models import transformer as tt
from llmd_tpu_torch.ops.paged_attention import paged_attention_ref
from llmd_tpu_torch.parallel import rows as tr
from llmd_tpu_torch.parallel.mesh import MeshConfig, rank_coords


class _Parts:
    """The parts of a split as threads of ``run``: ``mesh(p)`` is what
    ``RowSplit`` reads of part p's mesh, its gather and sum meeting at a
    barrier (the parts' tensors in part order)."""

    class Mesh:
        def __init__(self, parts, p):
            self.parts, self.p = parts, p

        def size(self, axes):
            return self.parts.n

        def index(self, axes):
            return self.p

        def _meet(self, x):
            ps = self.parts
            ps.buf[self.p] = x
            ps.barrier.wait()
            out = list(ps.buf)
            ps.barrier.wait()
            return out

        def gather(self, x, axes, dim=0):
            return torch.cat(self._meet(x), dim=dim)

        def reduce(self, x, axes):
            parts = self._meet(x)
            out = parts[0].clone()
            for t in parts[1:]:
                out = out + t
            return out

    def __init__(self, n):
        self.n = n
        self.buf = [None] * n
        self.barrier = threading.Barrier(n, timeout=60)

    def run(self, fn):
        res, errs = [None] * self.n, []

        def one(p):
            try:
                res[p] = fn(p, self.Mesh(self, p))
            except Exception as e:  # noqa: BLE001 — re-raised below
                errs.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=one, args=(p,)) for p in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        if errs:
            raise errs[0]
        return res


# ------------------------------------------------------------------ the plans


@settings(max_examples=60, deadline=None)
@given(n=st.integers(0, 70), dp=st.integers(1, 4), sp=st.integers(1, 3))
def test_flat_slices_cover_every_row_once_in_dp_major_order(n, dp, sp):
    """Part p = d * sp + s (the rank at (d, s), whatever its ep / tp) runs a
    contiguous slice; the slices in rank order are the rows 0..n-1; sizes
    differ by at most one, the larger first; the gather's ``take`` puts
    every row back in place."""
    plan = tr.flat_plan(n, dp * sp)
    assert plan.axes == ("dp", "sp")
    cfg = MeshConfig(dp=dp, sp=sp, ep=2, tp=2)
    for r in range(cfg.num_devices):
        c = rank_coords(cfg, r)
        p = c["dp"] * sp + c["sp"]
        rows = plan.parts[p]
        assert np.array_equal(rows, np.arange(rows[0], rows[0] + len(rows)) if len(rows)
                              else rows)
    np.testing.assert_array_equal(np.concatenate(plan.parts), np.arange(n))
    sizes = [len(p) for p in plan.parts]
    assert max(sizes) - min(sizes) <= 1 and sizes == sorted(sizes, reverse=True)
    w = plan.width
    padded = np.concatenate([np.concatenate([p, np.full(w - len(p), -7)]) for p in plan.parts])
    take = plan.take()
    np.testing.assert_array_equal(padded if take is None else padded[take], np.arange(n))


@pytest.mark.parametrize("B,dp", [(8, 2), (7, 2), (10, 4), (4, 4), (3, 4)])
def test_decode_blocks_pad_the_last_block_with_idle_slots(B, dp):
    """Blocks of ceil(B / dp) slots in slot order, the last padded with idle
    slots (-1), as an uneven GSPMD shard; a DP rank frontend's slot range
    (``dp_ranks == dp``, B divisible) is its block; the gather drops the
    pads."""
    plan = tr.block_plan(B, dp)
    per = -(-B // dp)
    assert plan.axes == ("dp",) and all(len(p) == per for p in plan.parts)
    flat = np.concatenate(plan.parts)
    np.testing.assert_array_equal(flat[flat >= 0], np.arange(B))
    assert (flat[B:] == -1).all() and (flat[:B] >= 0).all()
    if B % dp == 0:
        spr = B // dp  # engine.py: slots_per_rank, rank r owns [r*spr, (r+1)*spr)
        for r in range(dp):
            np.testing.assert_array_equal(plan.parts[r], np.arange(r * spr, (r + 1) * spr))
        assert plan.take() is None
    else:
        np.testing.assert_array_equal(np.arange(dp * per)[plan.take()], np.arange(B))


@pytest.mark.parametrize("n,sp,zigzag", [(33, 2, True), (64, 2, True), (30, 4, True),
                                         (33, 2, False), (9, 4, False)])
def test_ring_plan_is_the_ring_layout(n, sp, zigzag):
    """Rank s's rows are the s-th block of the ring layout over the sequence
    padded to the layout's multiple (zig-zag: chunks s and 2n-1-s of 2n, as
    the reference's ``sp_flash_prefill`` permutes them), pads past the
    sequence; every row once."""
    plan = tr.ring_plan(n, sp, zigzag)
    mult = 2 * sp if zigzag else sp
    padded = n + (-n) % mult
    c = padded // (2 * sp)
    order = (np.concatenate([np.r_[s * c:(s + 1) * c, (2 * sp - 1 - s) * c:(2 * sp - s) * c]
                             for s in range(sp)]) if zigzag else np.arange(padded))
    np.testing.assert_array_equal(np.concatenate(plan.parts),
                                  np.where(order < n, order, -1))
    flat = np.concatenate(plan.parts)
    np.testing.assert_array_equal(np.sort(flat[flat >= 0]), np.arange(n))


def _packing(rng, n_seqs, max_q, page_size=4, max_pages=12, pad=0):
    """A packed mixed batch: each sequence its last q_len tokens (a decode
    row or a prefill chunk) at its own pages; ``pad`` rows past the last
    sequence at position -1 (the embed program's layout)."""
    q = rng.integers(1, max_q + 1, n_seqs)
    kv = np.array([rng.integers(qi, max_pages * page_size + 1) for qi in q])
    cu = np.concatenate([[0], np.cumsum(q)]).astype(np.int32)
    N = int(cu[-1]) + pad
    pos = np.full((N,), -1, np.int32)
    sids = np.zeros((N,), np.int32)
    for b in range(n_seqs):
        pos[cu[b]:cu[b + 1]] = np.arange(kv[b] - q[b], kv[b])
        sids[cu[b]:cu[b + 1]] = b
    perm = rng.permutation(n_seqs * max_pages).reshape(n_seqs, max_pages).astype(np.int32)
    pts = np.where(np.arange(max_pages)[None, :] * page_size < kv[:, None], perm, -1)
    return {"tokens": rng.integers(1, 100, N).astype(np.int32), "positions": pos,
            "seq_slots": sids, "page_tables": pts.astype(np.int32),
            "kv_lens": kv.astype(np.int32), "cu_q_lens": cu}


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 10_000), n_seqs=st.integers(1, 6), max_q=st.integers(1, 20),
       parts=st.integers(2, 4), pad=st.integers(0, 5))
def test_straddling_sequences_keep_the_unsplit_causal_offset(seed, n_seqs, max_q, parts, pad):
    """Every part's local batch: each of its sequences' query i sits at
    ``kv_len - q_len + i`` (K1's causal offset) = its position in the step,
    its kv length is its last local row's position + 1, its page-table row
    is the sequence's; every real row appears in exactly one part; a part
    without a sequence has one empty one (no query row, kv length 1)."""
    rng = np.random.default_rng(seed)
    batch = _packing(rng, n_seqs, max_q, pad=pad)
    N = batch["tokens"].shape[0]
    plan = tr.flat_plan(N, parts)
    seen = 0
    for rows in plan.parts:
        loc = tr.local_batch(batch, rows, ())
        np.testing.assert_array_equal(loc["positions"], batch["positions"][rows])
        cu, lens = loc["cu_q_lens"], loc["kv_lens"]
        assert loc["num_seqs"][0] == len(lens) == loc["page_tables"].shape[0] == len(cu) - 1
        for b in range(len(lens)):
            q_len = cu[b + 1] - cu[b]
            for i in range(q_len):
                row = cu[b] + i
                assert loc["positions"][row] == lens[b] - q_len + i
                g = batch["seq_slots"][rows[row]]
                np.testing.assert_array_equal(loc["page_tables"][loc["seq_slots"][row]],
                                              batch["page_tables"][g])
            if q_len:
                assert lens[b] == loc["positions"][cu[b + 1] - 1] + 1
        seen += int(cu[-1])
        if cu[-1] == 0:
            assert len(lens) == 1 and lens[0] == 1 and (loc["page_tables"] == -1).all()
    assert seen == int(batch["cu_q_lens"][-1])


def test_parts_with_no_rows_and_the_pick_gather():
    """Fewer rows than parts: the last parts run none; the sampled rows'
    gather plan puts each part's picks back in their order."""
    plan = tr.flat_plan(3, 4)
    assert [len(p) for p in plan.parts] == [1, 1, 1, 0]
    local, picks = tr.pick_plan(tr.flat_plan(10, 3), np.array([1, 3, 4, 9]))
    assert [p.tolist() for p in local] == [[1, 3], [0], [2]]
    assert [p.tolist() for p in picks.parts] == [[0, 1], [2], [3]]
    ring = tr.ring_plan(5, 2, True)  # chunks of 2 of 8 rows: [0 1 6 7 | 2 3 4 5]
    assert [p.tolist() for p in ring.parts] == [[0, 1, -1, -1], [2, 3, 4, -1]]
    local, picks = tr.pick_plan(ring, np.array([4]))
    assert [p.tolist() for p in local] == [[], [2]]


# ------------------------------------------------------------- MoE, einsum


def _moe_inputs(seed, T, dtype="float32", **over):
    cfg = dataclasses.replace(get_model_config("tiny-moe"), dtype=dtype, **over)
    rng = np.random.default_rng(seed)
    D, E, Fe = cfg.hidden_size, cfg.moe_num_experts, cfg.moe_intermediate_size
    return (cfg, rng.standard_normal((T, D)).astype(np.float32),
            (rng.standard_normal((D, E)) * 0.1).astype(np.float32),
            (rng.standard_normal((E, D, 2 * Fe)) * 0.05).astype(np.float32),
            (rng.standard_normal((E, Fe, D)) * 0.05).astype(np.float32), rng)


def _split_moe(cfg, x, router, wi, wo, mask, ids, size, parts):
    """moe_block over ``parts`` threads, each its flat slice of the rows:
    (y of every row, counts summed, drops summed)."""
    plan = tr.flat_plan(len(x), parts)

    def part(p, mesh):
        r = plan.parts[p]
        return tt.moe_block(cfg, torch.from_numpy(x[r]), torch.from_numpy(router),
                            torch.from_numpy(wi), torch.from_numpy(wo),
                            token_mask=torch.from_numpy(mask[r]), dispatch_impl=None,
                            rows=(torch.from_numpy(ids[r]), size),
                            row_split=tr.RowSplit(mesh, plan, torch.device("cpu")))

    out = _Parts(parts).run(part)
    return (torch.cat([o[0] for o in out]).numpy(), sum(o[1] for o in out).numpy(),
            int(sum(int(o[2]) for o in out)))


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 10_000), T=st.integers(1, 24), extra=st.integers(0, 8),
       parts=st.integers(2, 4), dbo=st.booleans(), cf=st.sampled_from([0.25, 0.5, 1.0]))
def test_einsum_positions_from_gathered_routing_equal_the_unsplit_batch(
        seed, T, extra, parts, dbo, cf):
    """Split rows, the routing gathered over the split: each part's rows get
    the capacity positions of the whole static batch, so the outputs equal
    the unsplit ``moe_block``'s (float32, 1e-6), and the expert counts and
    dropped copies summed over the parts equal its own."""
    cfg, x, router, wi, wo, rng = _moe_inputs(seed, T, moe_dbo=dbo, moe_capacity_factor=cf)
    size = T + extra + (T + extra) % 2
    ids = np.sort(rng.choice(size, T, replace=False)).astype(np.int64)
    mask = rng.random(T) < 0.85
    y, c, d = _split_moe(cfg, x, router, wi, wo, mask, ids, size, parts)
    yw, cw, dw = tt.moe_block(cfg, torch.from_numpy(x), torch.from_numpy(router),
                              torch.from_numpy(wi), torch.from_numpy(wo),
                              token_mask=torch.from_numpy(mask), dispatch_impl=None,
                              rows=(torch.from_numpy(ids), size))
    np.testing.assert_allclose(y, yw.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(c, cw.numpy())
    assert d == int(dw)


@pytest.mark.parametrize("dbo", [False, True])
def test_einsum_split_equals_the_reference_static_batch(dbo):
    """tests/test_torch_moe.py's padded-layout case, split over three parts:
    the rows' outputs, the expert counts and the dropped copies of the JAX
    ``moe_block`` on the reference's static batch (float32, atol 1e-5)."""
    cfg, x, router, wi, wo, _ = _moe_inputs(0, 10, moe_capacity_factor=0.5, moe_dbo=dbo)
    jcfg = dataclasses.replace(jax_model_config("tiny-moe"), dtype="float32",
                               moe_capacity_factor=0.5, moe_dbo=dbo)
    size = 16
    slots = np.array([0, 1, 3, 4, 6, 9, 10, 12, 13, 15])
    xp = np.zeros((size, x.shape[1]), np.float32)
    xp[slots] = x
    mask = np.zeros(size, bool)
    mask[slots] = True
    yj, cj, dj = jt.moe_block(jcfg, jnp.asarray(xp), jnp.asarray(router), jnp.asarray(wi),
                              jnp.asarray(wo), token_mask=jnp.asarray(mask),
                              return_dropped=True)
    y, c, d = _split_moe(cfg, x, router, wi, wo, np.ones(10, bool), slots, size, 3)
    np.testing.assert_allclose(y, np.asarray(yj, np.float32)[slots], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(c, np.asarray(cj))
    assert d == int(dj) > 0


# --------------------------------------------------------------- attention


@pytest.mark.parametrize("parts,pad", [(2, 0), (3, 0), (4, 3), (7, 0)])
def test_k1_plain_over_split_rows_equals_the_unsplit_batch(parts, pad):
    """K1's plain version on each part's rows with its local metadata,
    concatenated: bitwise the unsplit batch's on every real row, which
    matches the JAX ``ragged_paged_attention_xla`` (float32, 1e-5). Three
    sequences of 5, 17 and 9 query rows, so slices straddle them."""
    rng = np.random.default_rng(3)
    H, Hk, D, ps, P = 4, 2, 32, 4, 40
    q_lens, kv = [5, 17, 9], [20, 30, 9]
    cu = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
    N = int(cu[-1]) + pad
    pos = np.full((N,), -1, np.int32)
    sids = np.zeros((N,), np.int32)
    pts = np.full((3, 8), -1, np.int32)
    pages = rng.permutation(P)
    for b in range(3):
        pos[cu[b]:cu[b + 1]] = np.arange(kv[b] - q_lens[b], kv[b])
        sids[cu[b]:cu[b + 1]] = b
        need = -(-kv[b] // ps)
        pts[b, :need] = pages[b * 8:b * 8 + need]
    batch = {"tokens": np.zeros((N,), np.int32), "positions": pos, "seq_slots": sids,
             "page_tables": pts, "kv_lens": np.array(kv, np.int32), "cu_q_lens": cu}
    q = rng.standard_normal((N, H, D)).astype(np.float32)
    pool = rng.standard_normal((P, ps, 2 * Hk, D)).astype(np.float32)
    want = paged_attention_ref(torch.from_numpy(q), torch.from_numpy(pool),
                               torch.from_numpy(pts), torch.from_numpy(pos),
                               torch.from_numpy(sids), torch.from_numpy(batch["kv_lens"]),
                               scale=D ** -0.5).numpy()
    got = []
    for rows in tr.flat_plan(N, parts).parts:
        loc = {k: torch.from_numpy(v) for k, v in tr.local_batch(batch, rows, ()).items()}
        got.append(paged_attention_ref(torch.from_numpy(q[rows]), torch.from_numpy(pool),
                                       loc["page_tables"], loc["positions"], loc["seq_slots"],
                                       loc["kv_lens"], scale=D ** -0.5).numpy())
    real = pos >= 0
    got = np.concatenate(got)
    np.testing.assert_array_equal(got[real], want[real])
    xla = np.asarray(jt.ragged_paged_attention_xla(
        jnp.asarray(q), jnp.asarray(pool), jnp.asarray(pts), jnp.asarray(pos),
        jnp.asarray(sids), jnp.asarray(batch["kv_lens"]), scale=D ** -0.5))
    np.testing.assert_allclose(got[real], xla[real], rtol=0, atol=1e-5)
