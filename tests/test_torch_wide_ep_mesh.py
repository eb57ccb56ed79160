"""The port's expert parallelism and wide-EP group over a real mesh, against
the JAX reference, on the CPU.

One gloo world of 8 CPU rank processes (``tests/torch_mesh_worker.py``)
runs every case of this file:

- the sorted dispatch's EP exchange (``ops/moe_dispatch.ep_moe``) at
  ``(dp=2, ep=4)`` in float32 and at ``ep=8`` on int8 banks, against the JAX
  ``make_sorted_dispatch(mesh)`` on its 8 virtual devices
  (``tests/test_moe_dispatch.py``'s ep-axis cases) within 1e-5;
- tiny-moe under ``MeshConfig(dp=2, ep=2, tp=2)`` with ``dp_ranks=2``, on
  the sorted and the einsum dispatch, each step's rows split over dp: greedy
  tokens and dropped copies equal to the JAX engine's under the same mesh,
  every rank's ops equal rank 0's, every rank ran the rows of its dp part
  (the EP exchange splitting them further over ep), and every rank's pool
  holds its tp peer's bytes on rank 0;
- ``WideEPEngineGroup`` over that mesh (``tests/test_wide_ep_group.py``'s
  mesh case): both rank ports answer completions over HTTP, and a
  ``dp_ranks`` that is not ``mesh.dp`` raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from llmd_tpu.core.request import SamplingParams as JaxSamplingParams
from llmd_tpu.engine import EngineConfig as JaxEngineConfig
from llmd_tpu.engine import LLMEngine as JaxEngine
from llmd_tpu.models import get_model_config as jax_model_config
from llmd_tpu.models import transformer as jt
from llmd_tpu.ops import moe_dispatch as jmd
from llmd_tpu.parallel import mesh as jmesh
from llmd_tpu_torch.engine.config import EngineConfig, MeshConfig
from llmd_tpu_torch.engine.dp_group import WideEPEngineGroup
from llmd_tpu_torch.models import get_model_config
from torch_mesh_worker import WorldRun, rows_as_planned

WIDE = dict(dp=2, ep=2, tp=2)
SMALL = dict(page_size=8, num_pages=64, max_model_len=96, max_batch_size=4,
             prefill_chunk=16, decode_steps=2)
PROMPTS = [list(range(3, 30)), list(range(40, 55)), list(range(100, 140)),
           list(range(60, 70))]


def _dispatch_inputs(int8: bool):
    """tests/test_moe_dispatch.py's ep-axis inputs."""
    if not int8:
        T, D, S, k = 24, 16, 8, 2
        rng = np.random.default_rng(1)
        return dict(
            x=rng.normal(size=(T, D)).astype(np.float32),
            idx=rng.integers(0, S, size=(T, k)).astype(np.int32),
            topw=rng.random((T, k)).astype(np.float32),
            valid=(rng.random((T, 1)) < 0.9).astype(np.int32),
            wi=(rng.normal(size=(S, D, 2 * 8)).astype(np.float32) * 0.1),
            wo=(rng.normal(size=(S, 8, D)).astype(np.float32) * 0.1))
    T, D, S, k = 16, 8, 8, 2
    rng = np.random.default_rng(2)
    return dict(
        x=rng.normal(size=(T, D)).astype(np.float32),
        idx=rng.integers(0, S, size=(T, k)).astype(np.int32),
        topw=np.full((T, k), 0.5, np.float32), valid=np.ones((T, 1), np.int32),
        wi=rng.integers(-127, 128, size=(S, D, 8)).astype(np.int8),
        wo=rng.integers(-127, 128, size=(S, 4, D)).astype(np.int8),
        wi_scale=np.full((S, 8), 0.01, np.float32), wo_scale=np.full((S, D), 0.02, np.float32))


DISPATCH = {"dispatch-dp2-ep4": (dict(dp=2, ep=4), False), "dispatch-ep8-int8": (dict(ep=8), True)}


def _weights():
    jcfg = dataclasses.replace(jax_model_config("tiny-moe"), dtype="float32")
    tcfg = dataclasses.replace(get_model_config("tiny-moe"), dtype="float32")
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, {k: np.asarray(v) for k, v in jp.items()}


@pytest.fixture(scope="module")
def weights():
    return _weights()


@pytest.fixture(scope="module")
def world(weights, tmp_path_factory):
    """One 8-rank world for every case of this file."""
    _, tcfg, _, npp = weights
    cases = {name: {"kind": "call", "mesh": MeshConfig(**mesh),
                    "fn": "llmd_tpu_torch.parallel.checks:ep_dispatch",
                    "kw": _dispatch_inputs(int8)}
             for name, (mesh, int8) in DISPATCH.items()}
    for path in ("sorted", "einsum"):
        cases["engine-" + path] = {
            "kind": "engine", "mesh": MeshConfig(**WIDE), "model_cfg": tcfg,
            "engine_cfg": EngineConfig(**SMALL, mesh=MeshConfig(**WIDE), dp_ranks=2,
                                       moe_dispatch=path),
            "params": npp, "phases": [PROMPTS], "max_tokens": 5}
    cases["group"] = {"kind": "group", "mesh": MeshConfig(**WIDE), "model_cfg": tcfg,
                      "engine_cfg": EngineConfig(**SMALL, mesh=MeshConfig(**WIDE)),
                      "prompts": ["hello rank", "hello rank one"]}
    run = WorldRun(list(cases.values()), 8, str(tmp_path_factory.mktemp("wide_ep")),
                   deadline_s=300)
    yield run, list(cases)
    run.reap()


def _result(world, name):
    run, names = world
    code, res = run.results()
    assert code == 0 and len(res) == len(names), (code, res, run.log_text())
    out = res[names.index(name)]
    assert "error" not in out, out
    return out


@pytest.mark.parametrize("name", list(DISPATCH))
def test_ep_exchange_matches_the_meshed_reference_dispatch(world, name):
    mesh, int8 = DISPATCH[name]
    inp = _dispatch_inputs(int8)
    jm = jmesh.build_mesh(jmesh.MeshConfig(**mesh))
    args = [jnp.asarray(inp[k]) for k in ("x", "idx", "topw", "valid", "wi", "wo")]
    if int8:
        args += [jnp.asarray(inp["wi_scale"]), jnp.asarray(inp["wo_scale"])]
    want = np.asarray(jmd.make_sorted_dispatch(jm)(*args))
    local = np.asarray(jmd.make_sorted_dispatch()(*args))
    res = _result(world, name)
    assert res["agree"]  # every rank holds every row
    np.testing.assert_allclose(res["result"], want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(res["result"], local, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("path", ["sorted", "einsum"])
def test_wide_ep_mesh_engine_equals_the_meshed_reference(weights, world, path):
    """dp=2 x ep=2 x tp=2, prompts on both DP ranks, each dp part of a step
    on its own ranks: the EP exchange spans the ep group's rows (sorted) or
    the local slots' capacity products sum over ep, at the positions of the
    whole step's gathered routing (einsum); tokens and dropped copies equal
    the JAX engine's; each rank ran its part's rows, the pools agree."""
    jcfg, _, jp, _ = weights
    je = JaxEngine(jcfg, JaxEngineConfig(**SMALL, mesh=jmesh.MeshConfig(**WIDE), dp_ranks=2,
                                         moe_dispatch=path), params=jp)
    for i, p in enumerate(PROMPTS):
        je.add_request(f"r{i}", p, JaxSamplingParams(max_tokens=5, temperature=0.0),
                       rank=i % 2)
    got: dict = {}
    while je.has_work():
        for o in je.step():
            got.setdefault(o.request_id, []).extend(o.new_token_ids)
    res = _result(world, "engine-" + path)
    assert res["tokens"] == [[got[f"r{i}"] for i in range(len(PROMPTS))]] and res["agree"]
    assert res["stats"]["moe_dispatch"] == path
    assert res["stats"]["moe_dropped_tokens"] == je.stats.moe_dropped_tokens
    assert rows_as_planned(res, MeshConfig(**WIDE)) == [] and res["pools_equal"]


def test_wide_ep_group_over_the_mesh_answers_on_both_rank_ports(world):
    res = _result(world, "group")
    assert res["ranks"] == 2 and len(set(res["endpoints"])) == 2
    assert res["answers"] == [(200, 3), (200, 3)]
    assert res["decode_tokens"] >= 4


def test_group_rank_count_mismatch_rejected_over_a_mesh():
    """The ranks come from mesh.dp; a dp_ranks that differs raises before
    any rank process starts."""
    with pytest.raises(ValueError, match="dp_ranks"):
        WideEPEngineGroup(_weights()[1], EngineConfig(
            page_size=8, num_pages=64, max_batch_size=4,
            mesh=MeshConfig(**WIDE), dp_ranks=4), device="cpu")
