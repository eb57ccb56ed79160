"""PyTorch port's MoE slice against the JAX reference, on the CPU.

Covers the plain versions of the grouped GEMMs (K2 ragged, K4 per-expert)
against the Pallas kernels run in interpret mode, the sorted dispatch's row
plan, ``moe_block`` on both dispatch paths, ``forward_core`` on ``tiny-moe``,
and the EPLB copy (the engine is in ``test_torch_moe_engine.py``). Inputs
come from numpy seeds and go to both sides; tolerances are stated per test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmd_tpu.models import get_model_config as jax_model_config
from llmd_tpu.models import transformer as jt
from llmd_tpu.ops import grouped_gemm as jgg
from llmd_tpu.ops import moe_dispatch as jmd
from llmd_tpu.parallel import eplb as jeplb
from llmd_tpu.parallel.eplb import EPLBConfig as JaxEPLBConfig
from llmd_tpu_torch.models import get_model_config
from llmd_tpu_torch.models import transformer as tt
from llmd_tpu_torch.ops import grouped_gemm as tgg
from llmd_tpu_torch.ops import moe_dispatch as tmd
from llmd_tpu_torch.parallel import eplb as teplb
from llmd_tpu_torch.parallel.eplb import EPLBConfig
from llmd_tpu_torch.parallel.mesh import MeshConfig, RankMesh

JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(x):
    return np.asarray(x, np.float32)


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _assert_bf16_close(got, want):
    """Two bf16 results of the same float32-accumulated product, summed in
    different orders: within one bf16 ulp (2^-7 relative), 1e-5 absolute
    near zero."""
    np.testing.assert_allclose(_np(got), _np(want), rtol=2.0 ** -7, atol=1e-5)


# ------------------------------------------------------------ grouped GEMMs


def _gemm_case(G, C, D, F, S, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((G, C, D)).astype(np.float32)
    w = (rng.standard_normal((S, D, F)) * D ** -0.5).astype(np.float32)
    return rng, x, w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nb,bc,D,F,S", [(6, 8, 64, 200, 3), (4, 16, 32, 128, 5)])
def test_ragged_grouped_gemm_plain_matches_pallas(nb, bc, D, F, S, dtype):
    """Random dead rows (multiplied like live ones), zero-row blocks (zeros),
    F = 200 (not a tile multiple). float32: atol 1e-5; bf16: one ulp."""
    rng, x, w = _gemm_case(nb, bc, D, F, S, seed=nb + F)
    slot = rng.integers(0, S, nb).astype(np.int32)
    rows = rng.integers(0, bc + 1, nb).astype(np.int32)
    rows[::3] = 0
    ref = jgg.ragged_grouped_gemm(jnp.asarray(x, JD[dtype]), jnp.asarray(w, JD[dtype]),
                                  jnp.asarray(slot), jnp.asarray(rows), interpret=True)
    got = tgg.ragged_grouped_gemm_ref(_t(x, TD[dtype]), _t(w, TD[dtype]), _t(slot), _t(rows))
    assert got.dtype == TD[dtype]
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), _np(ref), rtol=0, atol=1e-5)
    else:
        _assert_bf16_close(got.float(), ref)
    assert not got[_t(rows) == 0].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,C,D,F", [(5, 7, 64, 200), (4, 1, 32, 128)])
def test_grouped_gemm_plain_matches_pallas(G, C, D, F, dtype):
    """Zero-count groups are zeros; F = 200. float32: atol 1e-5; bf16: one ulp."""
    rng, x, w = _gemm_case(G, C, D, F, G, seed=G + C)
    counts = rng.integers(1, C + 1, G).astype(np.int32)
    counts[::2] = 0
    ref = jgg.grouped_gemm(jnp.asarray(x, JD[dtype]), jnp.asarray(w, JD[dtype]),
                           jnp.asarray(counts), interpret=True)
    got = tgg.grouped_gemm_ref(_t(x, TD[dtype]), _t(w, TD[dtype]), _t(counts))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), _np(ref), rtol=0, atol=1e-5)
    else:
        _assert_bf16_close(got.float(), ref)
    assert not got[_t(counts) == 0].any()


def test_wrappers_on_cpu_tensors_use_plain_versions():
    rng, x, w = _gemm_case(3, 4, 16, 24, 3, seed=0)
    x, w = _t(x), _t(w)
    slot, live = torch.tensor([2, 0, 1]), torch.tensor([4, 0, 2])
    before = (tgg.ragged_grouped_gemm.launches, tgg.grouped_gemm.launches,
              tgg.ragged_grouped_gemm_ref.launches, tgg.grouped_gemm_ref.launches)
    a = tgg.ragged_grouped_gemm(x, w, slot, live)
    b = tgg.make_moe_matmul()(x, w, live)
    assert (tgg.ragged_grouped_gemm.launches, tgg.grouped_gemm.launches) == before[:2]
    assert tgg.ragged_grouped_gemm_ref.launches == before[2] + 1
    assert tgg.grouped_gemm_ref.launches == before[3] + 1
    assert torch.equal(a, tgg.ragged_grouped_gemm_ref(x, w, slot, live))
    assert torch.equal(b, tgg.grouped_gemm_ref(x, w, live))
    # over a mesh: the EP exchange when ep > 1 (held against the JAX meshed
    # dispatch in tests/test_torch_wide_ep_mesh.py), the one-device path
    # on a mesh without ep
    cpu = torch.device("cpu")
    assert tmd.make_sorted_dispatch(RankMesh(MeshConfig(tp=2), 1, cpu, {})) \
        is tmd.sorted_moe_local
    ep = tmd.make_sorted_dispatch(RankMesh(MeshConfig(ep=2, tp=2), 3, cpu, {}),
                                  gemm=tgg.ragged_grouped_gemm_ref)
    assert ep.func is tmd.ep_moe and ep.keywords["gemm"] is tgg.ragged_grouped_gemm_ref
    assert ep.keywords["mesh"].index("ep") == 1


# ------------------------------------------------------------- row plan


def test_pick_block_size_equals_reference():
    for tk in (1, 7, 8, 64, 127, 128, 513, 4096, 100_000):
        for slots in (4, 8, 32, 64):
            for pallas in (False, True):
                assert (tmd.pick_block_size(tk, slots, pallas)
                        == jmd.pick_block_size(tk, slots, pallas))


@pytest.mark.parametrize("T,k,S,bc", [(12, 2, 5, 2), (32, 4, 32, 8), (40, 2, 8, 16),
                                      (9, 3, 6, 1)])
def test_dispatch_stage_equals_reference(T, k, S, bc):
    """Row plan (row, block_slot, block_rows, Tp) and the scattered buffer,
    over random slots with sentinels (invalid tokens): equal."""
    rng = np.random.default_rng(T * S)
    D = 8
    x = rng.standard_normal((T, D)).astype(np.float32)
    idx = rng.integers(0, S, (T, k)).astype(np.int32)
    topw = rng.random((T, k)).astype(np.float32)
    valid = (rng.random((T, 1)) < 0.8).astype(np.int32)
    ref = jmd.dispatch_stage(jnp.asarray(x), jnp.asarray(idx), jnp.asarray(topw),
                             jnp.asarray(valid), S, bc)
    got = tmd.dispatch_stage(_t(x), _t(idx), _t(topw), _t(valid), S, bc)
    names = ("xs", "row", "tok", "wf", "block_slot", "block_rows")
    for name, g, r in zip(names, got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
    slot = np.where(valid > 0, idx, S).reshape(-1)
    _, _, _, tp_ref = jmd._row_plan(jnp.asarray(slot), S, bc)
    assert tmd._row_plan(_t(slot), S, bc)[3] == tp_ref


# ------------------------------------------------------------- moe_block


def _moe_case(dtype="float32", T=16, seed=0, **cfg_over):
    cfg = dataclasses.replace(get_model_config("tiny-moe"), dtype=dtype, **cfg_over)
    jcfg = dataclasses.replace(jax_model_config("tiny-moe"), dtype=dtype, **cfg_over)
    rng = np.random.default_rng(seed)
    D, E, Fe = cfg.hidden_size, cfg.moe_num_experts, cfg.moe_intermediate_size
    x = rng.standard_normal((T, D)).astype(np.float32)
    router = (rng.standard_normal((D, E)) * 0.1).astype(np.float32)
    wi = (rng.standard_normal((E, D, 2 * Fe)) * 0.05).astype(np.float32)
    wo = (rng.standard_normal((E, Fe, D)) * 0.05).astype(np.float32)
    return cfg, jcfg, x, router, wi, wo


def _eplb_tables(E, extra):
    loads = np.ones((1, E), np.int64)
    loads[0, 0], loads[0, 3] = 100, 40  # hot experts get the redundant slots
    return jeplb.rebalance(loads, E + extra, ep_size=1)


CASES = {
    "plain": {},
    "token_mask": {"mask": True},
    "dbo": {"cfg": {"moe_dbo": True}},
    "eplb": {"eplb": 4},
    "drops": {"cfg": {"moe_capacity_factor": 0.5}},
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("path", ["sorted", "einsum"])
@pytest.mark.parametrize("case", list(CASES))
def test_moe_block_matches_reference(case, path, dtype):
    """y: float32 atol 1e-5 (summation order); bf16 atol 2e-2 (the paths round
    silu(gate)*up, the GEMM outputs and the weighted copies to bf16 at the same
    points, in other orders). Expert counts and dropped copies equal."""
    spec = CASES[case]
    cfg, jcfg, x, router, wi, wo = _moe_case(dtype, T=32 if case == "dbo" else 16,
                                             **spec.get("cfg", {}))
    T, E = x.shape[0], cfg.moe_num_experts
    mask = np.arange(T) % 3 != 0 if spec.get("mask") else None
    eplb_j = eplb_t = None
    if spec.get("eplb"):
        s2e, slots, counts = _eplb_tables(E, spec["eplb"])
        wi, wo = wi[s2e[0]], wo[s2e[0]]
        eplb_j = (jnp.asarray(slots[0]), jnp.asarray(counts[0]))
        eplb_t = (_t(slots[0]), _t(counts[0]))
    jdt, tdt = JD[dtype], TD[dtype]
    yj, cj, dj = jt.moe_block(
        jcfg, jnp.asarray(x, jdt), jnp.asarray(router, jdt), jnp.asarray(wi, jdt),
        jnp.asarray(wo, jdt), eplb=eplb_j,
        token_mask=None if mask is None else jnp.asarray(mask),
        dispatch_impl=jmd.make_sorted_dispatch() if path == "sorted" else None,
        return_dropped=True)
    yt, ct, dt = tt.moe_block(
        cfg, _t(x, tdt), _t(router, tdt), _t(wi, tdt), _t(wo, tdt), eplb=eplb_t,
        token_mask=None if mask is None else _t(mask),
        dispatch_impl=tt.SORTED_DISPATCH if path == "sorted" else None)
    assert yt.dtype == tdt
    np.testing.assert_allclose(yt.float().numpy(), _np(yj), rtol=0,
                               atol=1e-5 if dtype == "float32" else 2e-2)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    assert int(dt) == int(dj)
    if case == "drops" and path == "einsum":
        assert int(dt) > 0  # the capacity really overflowed


@pytest.mark.parametrize("dbo", [False, True])
def test_moe_block_einsum_in_reference_padded_layout(dbo):
    """The reference runs the einsum on a static batch (decode: a row per slot,
    idle slots masked). The port's packed rows placed with ``rows=(slot ids,
    size)`` give the reference's outputs on those rows, its expert counts and
    its dropped count (capacity, cumsum order and DBO halves all follow the
    padded batch). float32, atol 1e-5."""
    cfg, jcfg, x, router, wi, wo = _moe_case(T=10, moe_capacity_factor=0.5, moe_dbo=dbo)
    size = 16
    slots = np.array([0, 1, 3, 4, 6, 9, 10, 12, 13, 15])
    xp = np.zeros((size, x.shape[1]), np.float32)
    xp[slots] = x
    mask = np.zeros(size, bool)
    mask[slots] = True
    s2e, tabs, counts = _eplb_tables(cfg.moe_num_experts, 4)
    wi, wo = wi[s2e[0]], wo[s2e[0]]
    yj, cj, dj = jt.moe_block(jcfg, jnp.asarray(xp), jnp.asarray(router), jnp.asarray(wi),
                              jnp.asarray(wo), eplb=(jnp.asarray(tabs[0]),
                                                     jnp.asarray(counts[0])),
                              token_mask=jnp.asarray(mask), return_dropped=True)
    yt, ct, dt = tt.moe_block(cfg, _t(x), _t(router), _t(wi), _t(wo),
                              eplb=(_t(tabs[0]), _t(counts[0])), dispatch_impl=None,
                              rows=(_t(slots), size))
    np.testing.assert_allclose(yt.numpy(), _np(yj)[slots], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    assert int(dt) == int(dj) > 0


def test_sorted_moe_local_matches_reference_pallas_interpret():
    """The sorted path end to end against the reference's with its Pallas
    kernel in interpret mode, at the reference's block size: float32, atol
    1e-5."""
    cfg, _, x, router, wi, wo = _moe_case(T=24)
    rng = np.random.default_rng(5)
    k, S = cfg.moe_top_k, cfg.moe_num_experts
    idx = np.argsort(rng.random((24, S)), axis=1)[:, :k].astype(np.int32)
    topw = rng.random((24, k)).astype(np.float32)
    valid = (rng.random((24, 1)) < 0.9).astype(np.int32)
    bc = jmd.pick_block_size(24 * k, S, True)
    ref = jmd.sorted_moe_local(jnp.asarray(x), jnp.asarray(idx), jnp.asarray(topw),
                               jnp.asarray(valid), jnp.asarray(wi), jnp.asarray(wo),
                               use_pallas=True, interpret=True, bc=bc)
    got = tmd.sorted_moe_local(_t(x), _t(idx), _t(topw), _t(valid), _t(wi), _t(wo), bc=bc)
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=0, atol=1e-5)


# ------------------------------------------------------------- forward_core


@pytest.fixture(scope="module")
def moe_weights():
    jcfg = dataclasses.replace(jax_model_config("tiny-moe"), dtype="float32")
    tcfg = dataclasses.replace(get_model_config("tiny-moe"), dtype="float32")
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    npp = {k: np.asarray(v) for k, v in jp.items()}
    return jcfg, tcfg, jp, npp


def test_moe_params_from_reference_and_init_shapes(moe_weights):
    jcfg, tcfg, jp, npp = moe_weights
    tp = tt.params_from_numpy(tcfg, npp)
    assert {k: tuple(v.shape) for k, v in tp.items()} == {k: v.shape for k, v in npp.items()}
    a = tt.init_params(tcfg, torch.Generator().manual_seed(3))
    assert {k: tuple(v.shape) for k, v in a.items()} == tt.param_shapes(tcfg)
    # the reference's scales: router/moe_wi D^-0.5, moe_wo Fe^-0.5
    assert abs(a["moe_wo"].std().item() * tcfg.moe_intermediate_size ** 0.5 - 1) < 0.05
    assert abs(a["router"].std().item() * tcfg.hidden_size ** 0.5 - 1) < 0.05


@pytest.mark.parametrize("path", ["sorted", "einsum"])
def test_forward_core_moe_matches_reference(moe_weights, path):
    """tiny-moe float32, two mixed flat batches: logits max abs <= 1e-4, same
    argmax, expert counts [L, E] and dropped copies equal."""
    jcfg, tcfg, jp, npp = moe_weights
    jcfg = dataclasses.replace(jcfg, moe_capacity_factor=0.5)  # the einsum drops
    tcfg = dataclasses.replace(tcfg, moe_capacity_factor=0.5)
    tp = tt.params_from_numpy(tcfg, npp)
    rng = np.random.default_rng(4)
    P, ps = 16, 8
    jc, tc = jt.init_cache(jcfg, P, ps), tt.init_cache(tcfg, P, ps)
    steps = [([10, 7], [(0, 10), (0, 7)], [[3, 5, -1, -1], [9, -1, -1, -1]]),
             ([1, 12], [(10, 11), (7, 19)], [[3, 5, -1, -1], [9, 2, 11, -1]])]
    for q_lens, spans, table in steps:
        N = sum(q_lens)
        toks = rng.integers(0, 288, N).astype(np.int32)
        pos = np.concatenate([np.arange(a, b) for a, b in spans]).astype(np.int32)
        sids = np.repeat(np.arange(len(q_lens)), q_lens).astype(np.int32)
        pts, lens = np.asarray(table, np.int32), np.array([b for _, b in spans], np.int32)
        cu = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
        hj, jc, cj, dj = jt.forward_core(
            jcfg, jp, jc, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(sids),
            jnp.asarray(pts), jnp.asarray(lens),
            moe_dispatch_impl=jmd.make_sorted_dispatch() if path == "sorted" else None)
        ht, tc, ct, dt = tt.forward_core(
            tcfg, tp, tc, _t(toks), _t(pos), _t(sids), _t(pts), _t(lens), cu_q_lens=_t(cu),
            num_seqs=_t(np.array([len(q_lens)], np.int32)),
            moe_dispatch_impl=tt.SORTED_DISPATCH if path == "sorted" else None)
        lj, lt = _np(jt.unembed(jcfg, jp, hj)), tt.unembed(tcfg, tp, ht).numpy()
        assert np.abs(lj - lt).max() <= 1e-4
        np.testing.assert_array_equal(lj.argmax(-1), lt.argmax(-1))
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        assert int(dt) == int(dj)
        assert (int(dt) > 0) == (path == "einsum")


# ------------------------------------------------------------------- EPLB


def test_eplb_copy_equals_reference():
    rng = np.random.default_rng(0)
    for L, E, extra, ep in ((2, 16, 8, 4), (3, 8, 4, 1), (1, 32, 32, 1)):
        loads = rng.zipf(1.5, size=(L, E)).astype(np.int64)
        got, want = teplb.rebalance(loads, E + extra, ep), jeplb.rebalance(loads, E + extra, ep)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(teplb.assign_replica_counts(loads[0], E + extra),
                                      jeplb.assign_replica_counts(loads[0], E + extra))
        np.testing.assert_array_equal(
            teplb.place_slots(loads[0], got[2][0], ep), jeplb.place_slots(loads[0], want[2][0], ep))
        assert (teplb.balance_ratio(loads[0], got[0][0], got[2][0], ep)
                == jeplb.balance_ratio(loads[0], want[0][0], want[2][0], ep))
    tj, tp = jeplb.ExpertLoadTracker(2, 4, 3), teplb.ExpertLoadTracker(2, 4, 3)
    for _ in range(5):
        c = rng.integers(0, 9, (2, 4))
        tj.record(c)
        tp.record(c)
    np.testing.assert_array_equal(tp.loads(), tj.loads())
    assert dataclasses.asdict(EPLBConfig()) == dataclasses.asdict(JaxEPLBConfig())
