"""The port's ring attention (``ops/ring_attention.py``) against the JAX
reference, on the CPU.

``sp_flash_prefill`` runs on gloo worlds of CPU rank processes
(``tests/torch_mesh_worker.py``; one 4-rank world: the sp ring at n = 4, and
at n = 2 beside tp = 2) and in this process at n = 1, against the JAX
``reference_causal_attention`` on the same inputs: within 1e-5 in float32,
zig-zag and contiguous, GQA, and bf16 inputs as the reference's test holds
them. The engine's ``unified_ring`` program on that world at
``MeshConfig(sp=2, tp=2)``: its layout string, ring steps 1 for one fresh
prompt, none for a continuation chunk or a two-sequence step, and greedy
tokens equal to the JAX engine's under the same mesh, on tiny and tiny-mla;
each sp rank ran its rows of the ring layout (the other steps' rows split
over sp), and every rank's pool holds its tp peer's bytes on rank 0.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmd_tpu.core.request import SamplingParams as JaxSamplingParams
from llmd_tpu.engine import EngineConfig as JaxEngineConfig
from llmd_tpu.engine import LLMEngine as JaxEngine
from llmd_tpu.models import get_model_config as jax_model_config
from llmd_tpu.models import transformer as jt
from llmd_tpu.ops import ring_attention as jra
from llmd_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from llmd_tpu_torch.engine.config import EngineConfig, MeshConfig
from llmd_tpu_torch.models import get_model_config
from llmd_tpu_torch.ops import ring_attention as tra
from llmd_tpu_torch.parallel.mesh import RankMesh
from torch_mesh_worker import WorldRun, rows_as_planned

RING = dict(page_size=8, num_pages=64, max_model_len=256, max_batch_size=4,
            prefill_chunk=64)
MESH = dict(sp=2, tp=2)
FRESH = list(range(7, 40))  # 33 tokens: one fresh self-contained chunk
LONG = list(range(5, 105))  # two chunks: the second starts at 64
PAIR = [list(range(10, 40)), list(range(50, 80))]


def _qkv(S, H=4, Hk=4, D=32, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((S, H, D)).astype(np.float32),
            rng.standard_normal((S, Hk, D)).astype(np.float32),
            rng.standard_normal((S, Hk, D)).astype(np.float32))


def _ring_call(mesh, q, k, v, zigzag, bf16=False):
    return {"kind": "call", "mesh": MeshConfig(**mesh),
            "fn": "llmd_tpu_torch.parallel.checks:ring_prefill",
            "kw": dict(q=q, k=k, v=v, zigzag=zigzag, bf16=bf16)}


# (name, mesh, S, H, Hk, zigzag, bf16)
UNIT = [(f"n{n}-{'zz' if zz else 'ct'}-{'gqa' if hk < 4 else 'mha'}", mesh, S, 4, hk, zz, False)
        for n, mesh in ((4, dict(sp=4)), (2, MESH))
        for zz in (True, False) for S, hk in ((64, 4), (48, 1))] + [
    ("n4-bf16", dict(sp=4), 32, 4, 4, True, True),
    ("n4-degrade", dict(sp=4), 36, 4, 2, True, False)]  # S % 2n != 0: contiguous


def _weights(name):
    jcfg = dataclasses.replace(jax_model_config(name), dtype="float32")
    tcfg = dataclasses.replace(get_model_config(name), dtype="float32")
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, {k: np.asarray(v) for k, v in jp.items()}


@pytest.fixture(scope="module")
def weights():
    return {name: _weights(name) for name in ("tiny", "tiny-mla")}


@pytest.fixture(scope="module")
def world(weights, tmp_path_factory):
    """One 4-rank world for every case of this file."""
    cases = {name: _ring_call(mesh, *_qkv(S, H, Hk, seed=i), zigzag=zz, bf16=bf)
             for i, (name, mesh, S, H, Hk, zz, bf) in enumerate(UNIT)}
    for name, phases in (("tiny", [[FRESH], [LONG], PAIR]), ("tiny-mla", [[FRESH]])):
        _, tcfg, _, npp = weights[name]
        cases["engine-" + name] = {
            "kind": "engine", "mesh": MeshConfig(**MESH), "model_cfg": tcfg,
            "engine_cfg": EngineConfig(**RING, mesh=MeshConfig(**MESH)), "params": npp,
            "phases": phases, "max_tokens": 4}
    run = WorldRun(list(cases.values()), 4, str(tmp_path_factory.mktemp("ring")))
    yield run, list(cases)
    run.reap()


def _result(world, name):
    run, names = world
    code, res = run.results()
    assert code == 0 and len(res) == len(names), (code, res, run.log_text())
    out = res[names.index(name)]
    assert "error" not in out, out
    return out


@pytest.mark.parametrize("case", UNIT, ids=[u[0] for u in UNIT])
def test_sp_flash_prefill_matches_the_reference_oracle(world, case):
    i = UNIT.index(case)
    name, mesh, S, H, Hk, zigzag, bf16 = case
    q, k, v = _qkv(S, H, Hk, seed=i)
    res = _result(world, name)
    assert res["agree"]  # every rank holds the whole result
    if bf16:
        jq, jk, jv = (jnp.asarray(t, jnp.bfloat16) for t in (q, k, v))
        want = np.asarray(jra.reference_causal_attention(jq, jk, jv), np.float32)
        np.testing.assert_allclose(res["result"], want, rtol=3e-2, atol=3e-2)
    else:
        want = np.asarray(jra.reference_causal_attention(q, k, v))
        assert np.abs(res["result"] - want).max() <= 1e-5


def test_single_shard_and_the_layout_rules():
    """n = 1 is dense attention; S % 2n != 0 warns and takes the contiguous
    layout; S % n != 0 raises; the engine's layout follows its token budget."""
    one = RankMesh(MeshConfig(), 0, torch.device("cpu"), {})
    q, k, v = _qkv(20, 4, 2, seed=9)
    want = np.asarray(jra.reference_causal_attention(q, k, v))
    for zz in (True, False):
        got = tra.sp_flash_prefill(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), one, zigzag=zz)
        assert np.abs(got.numpy() - want).max() <= 1e-5
    np.testing.assert_allclose(
        tra.reference_causal_attention(*map(torch.from_numpy, (q, k, v))).numpy(), want,
        rtol=0, atol=1e-5)
    two = RankMesh(MeshConfig(sp=2), 0, torch.device("cpu"), {})
    with pytest.raises(ValueError, match="must divide"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            tra.sp_flash_prefill(*(torch.zeros((5, 2, 4)) for _ in range(3)), two)
    assert tra.ring_layout(64, 2) == "zigzag" and tra.ring_layout(66, 2) == "contiguous"
    impl = tra.make_ring_attn_impl(one)
    got = impl(torch.from_numpy(q), None, None, None, None, None, scale=32 ** -0.5,
               chunk_k=torch.from_numpy(k), chunk_v=torch.from_numpy(v))
    assert np.abs(got.numpy() - want).max() <= 1e-5
    with pytest.raises(ValueError, match="chunk_k"):
        impl(torch.from_numpy(q), None, None, None, None, None, scale=1.0)


@pytest.mark.parametrize("name", ["tiny", "tiny-mla"])
def test_engine_ring_program_equals_the_meshed_reference(weights, world, name):
    """tests/test_ring_attention.py's engine cases (and
    tests/test_mla.py::test_ring_prefill_parity_under_sp) on the port at
    sp=2 beside tp=2: the ring serves the fresh prompt's step only, and the
    tokens equal the JAX engine's under the same mesh, phase by phase."""
    jcfg, _, jp, _ = weights[name]
    je = JaxEngine(jcfg, JaxEngineConfig(**RING, mesh=JaxMeshConfig(**MESH)), params=jp)
    assert je.sp_attn_backend == "ring_zigzag(sp=2)"
    res = _result(world, "engine-" + name)
    phases = [[FRESH], [LONG], PAIR] if name == "tiny" else [[FRESH]]
    want, steps = [], []
    for n, phase in enumerate(phases):
        for i, p in enumerate(phase):
            je.add_request(f"r{n}-{i}", p, JaxSamplingParams(max_tokens=4, temperature=0.0))
        got: dict = {}
        while je.has_work():
            for o in je.step():
                got.setdefault(o.request_id, []).extend(o.new_token_ids)
        want.append([got[f"r{n}-{i}"] for i in range(len(phase))])
        steps.append(je.stats.n_ring_prefill_steps)
    assert res["stats"]["sp_attn_backend"] == "ring_zigzag(sp=2)"
    assert res["tokens"] == want and res["agree"], res
    assert res["ring_steps"] == steps == ([1, 2, 2] if name == "tiny" else [1])
    assert rows_as_planned(res, MeshConfig(**MESH)) == [] and res["pools_equal"]
    progs = {e[0] for e in res["row_logs"][0]}
    assert {"unified_ring", "decode"} <= progs and ("unified" in progs) == (name == "tiny")
