"""The port's (dp, sp, ep, tp) mesh against the JAX reference, on the CPU.

The layout and sharding rules are held to the reference's ``build_mesh`` and
``shard_pytree`` on its 8 virtual CPU devices (the fused gate+up leaves
aside, whose halves the port shards apart). Meshed engines run as gloo worlds
of CPU rank processes (``tests/torch_mesh_worker.py``, one world for all of
this file's engine cases) from the reference's float32 weights:

- tiny at tp=2 in float32, with int8 weights and over an fp8 pool, and
  tiny-mla at tp=2 (heads sharded, the latent pool replicated): greedy tokens
  equal the JAX engine's under the same ``MeshConfig``; one prefill's logits
  within 1e-4 of the reference forward's;
- tiny-moe at ep=2 with EPLB: tokens, dropped copies and rebalances equal;
- a step's rows split over (dp, sp) (``parallel/rows``): tiny at dp=2 with
  mixed prompts and the pipelined defaults, with ngram speculation and the
  embed program, and with a CPU-offload reload; tiny at sp=2 on the plain
  unified program; tiny-moe at dp=2 on the einsum dispatch with EPLB:
  tokens, spec counts, offload loads, dropped copies and rebalances equal
  the JAX engine's under the same ``MeshConfig``, one prefill's logits at
  dp=2 and at sp=2 within 1e-4;
- every engine case: each rank ran through its dense layers the rows the
  reference's binding gives it, op by op, and after serving every rank's
  pool holds the bytes of its tp peer on rank 0;
- every rank's device ops gave rank 0's tokens;
- a world whose rank 1 is killed raises on rank 0 within its timeout, and
  the world script exits non-zero.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmd_tpu.core.request import SamplingParams as JaxSamplingParams
from llmd_tpu.engine import EngineConfig as JaxEngineConfig
from llmd_tpu.engine import LLMEngine as JaxEngine
from llmd_tpu.models import get_model_config as jax_model_config
from llmd_tpu.models import quant as jq
from llmd_tpu.models import transformer as jt
from llmd_tpu.ops import moe_dispatch as jmd
from llmd_tpu.parallel import mesh as jmesh
from llmd_tpu.parallel.eplb import EPLBConfig as JaxEPLBConfig
from llmd_tpu_torch.engine.config import EngineConfig, MeshConfig
from llmd_tpu_torch.models import get_model_config
from llmd_tpu_torch.models import quant as tq
from llmd_tpu_torch.models import transformer as tt
from llmd_tpu_torch.parallel import mesh as tmesh
from llmd_tpu_torch.parallel.eplb import EPLBConfig
from torch_mesh_worker import WorldRun, rows_as_planned

BASE = dict(page_size=8, num_pages=64, max_model_len=256, max_batch_size=4,
            prefill_chunk=32, decode_steps=2)
PROMPTS = [list(range(11, 41)), list(range(5, 20)), list(range(100, 140))]
EPLB = (8, 2, 2)  # window, interval, redundant experts
# tests/test_ring_attention.py's engine phases: one fresh prompt (the ring),
# a two-chunk prompt (the ring for its first chunk only), two prompts at once
RING_PHASES = [[list(range(7, 40))], [list(range(5, 105))], [list(range(10, 40)),
                                                             list(range(50, 80))]]
# requests a meshed engine once refused: the masked programs' (logit_bias,
# a grammar) and an adapter's
SERVED = [("bias", [3, 4, 5], {"logit_bias": {5: -100}}, {}),
          ("choice", [3, 4, 5], {"guided_choice": ["a", "b"], "max_tokens": 4}, {}),
          ("adapter", list(range(11, 41)), {}, {"lora_id": "adapter"}),
          ("plain", list(range(5, 20)), {}, {})]
# most of the vocabulary in each prompt: prompt lookup finds a draft for
# nearly every generated token
ECHO = [list(range(1, 200)), list(range(5, 205))]
# tests/test_torch_kv_offload.py's scenario: prompt A cold, prompt B (A's
# pages leave HBM for the CPU tier), A again (reloaded)
OFFLOAD = dict(num_pages=12, max_batch_size=2, cpu_offload_pages=64)
OFFLOAD_PHASES = [[list(range(1, 49))], [list(range(100, 170))], [list(range(1, 49))]]
# the split's engine cases: (world case, model, mesh, phases, engine kwargs)
SPLIT = {"dp2": ("tiny", dict(dp=2), [PROMPTS, PROMPTS[1:]], {}),
         "dp2_offload": ("tiny", dict(dp=2), OFFLOAD_PHASES, OFFLOAD),
         "sp2": ("tiny", dict(sp=2), [PROMPTS], {}),
         "dp2_einsum": ("tiny-moe", dict(dp=2), [PROMPTS],
                        dict(moe_dispatch="einsum", eplb=EPLB))}
ENGINE_CASES = ("tp", "tp_int8", "tp_fp8", "mla_tp", "tp_spec_embed", "tp_sampled", "ep_eplb",
                "sp_ring", "dp2_spec_embed", *SPLIT)


def _weights(name: str, seed: int = 0):
    jcfg = dataclasses.replace(jax_model_config(name), dtype="float32")
    tcfg = dataclasses.replace(get_model_config(name), dtype="float32")
    jp = jt.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, {k: np.asarray(v) for k, v in jp.items()}


def _jax_tokens(jcfg, jp, mesh: dict, prompts, max_tokens=6, **kw):
    eplb = kw.pop("eplb", None)
    eng = JaxEngine(jcfg, JaxEngineConfig(
        **BASE | kw, mesh=jmesh.MeshConfig(**mesh),
        eplb=None if eplb is None else JaxEPLBConfig(*eplb)), params=jp)
    out = eng.generate(prompts, JaxSamplingParams(max_tokens=max_tokens, temperature=0.0))
    return [out[f"req-{i}"] for i in range(len(prompts))], eng.stats


def _jax_phases(jcfg, jp, mesh: dict, phases, max_tokens=6, **kw):
    """The JAX engine's greedy tokens phase by phase (each phase's prompts
    added, then stepped until idle), and its stats."""
    eplb = kw.pop("eplb", None)
    eng = JaxEngine(jcfg, JaxEngineConfig(
        **BASE | kw, mesh=jmesh.MeshConfig(**mesh),
        eplb=None if eplb is None else JaxEPLBConfig(*eplb)), params=jp)
    out = []
    for n, phase in enumerate(phases):
        for i, p in enumerate(phase):
            eng.add_request(f"r{n}-{i}", p, JaxSamplingParams(max_tokens=max_tokens,
                                                              temperature=0.0))
        got: dict = {}
        while eng.has_work():
            for o in eng.step():
                got.setdefault(o.request_id, []).extend(o.new_token_ids)
        out.append([got[f"r{n}-{i}"] for i in range(len(phase))])
    return out, eng


def _engine_case(tcfg, npp, mesh: dict, phases, **kw):
    eplb = kw.pop("eplb", None)
    return {"kind": "engine", "mesh": MeshConfig(**mesh), "model_cfg": tcfg,
            "engine_cfg": EngineConfig(**BASE | kw, mesh=MeshConfig(**mesh),
                                       eplb=None if eplb is None else EPLBConfig(*eplb)),
            "params": npp, "phases": phases}


def _options_case(tcfg, npp, fs_path: str) -> dict:
    """The engine options and requests a meshed engine once refused (the
    offload tiers, LoRA, a connector; logit_bias, a grammar, an adapter),
    served at tp=2 and by a one-card twin of the same config."""
    from llmd_tpu_torch.models.lora import LoRAConfig, make_adapter_weights

    lcfg = LoRAConfig(max_adapters=2, rank=4)
    w = make_adapter_weights(tcfg, lcfg, torch.Generator().manual_seed(7))
    ecfg = EngineConfig(**BASE, mesh=MeshConfig(tp=2), cpu_offload_pages=4,
                        offload_fs_path=fs_path, lora=lcfg, kv_connector="in-memory")
    reqs = [(rid, p, {"max_tokens": 6, "temperature": 0.0, **skw}, akw)
            for rid, p, skw, akw in SERVED]
    return {"kind": "script", "mesh": MeshConfig(tp=2), "model_cfg": tcfg, "engine_cfg": ecfg,
            "params": npp, "twin": True, "tokenizer": True,
            "actions": [("load", "adapter", {k: v.numpy() for k, v in w.items()}),
                        ("run", reqs)]}


@pytest.fixture(scope="module")
def weights():
    return {name: _weights(name) for name in ("tiny", "tiny-mla", "tiny-moe")}


@pytest.fixture(scope="module")
def world(weights, tmp_path_factory):
    """One 2-rank world for every engine and logits case of this file,
    started at once so it runs beside the JAX engines."""
    _, tt_cfg, _, tiny = weights["tiny"]
    _, mla_cfg, _, mla = weights["tiny-mla"]
    _, moe_cfg, _, moe = weights["tiny-moe"]
    cases = {
        "tp": _engine_case(tt_cfg, tiny, dict(tp=2), [PROMPTS[:2]]),
        "options": _options_case(tt_cfg, tiny, str(tmp_path_factory.mktemp("fs"))),
        "tp_int8": _engine_case(tt_cfg, tiny, dict(tp=2), [PROMPTS[:2]],
                                quantize_weights="int8"),
        "tp_fp8": _engine_case(tt_cfg, tiny, dict(tp=2), [PROMPTS[:2]],
                               kv_cache_dtype="fp8"),
        "mla_tp": _engine_case(mla_cfg, mla, dict(tp=2), [[list(range(7, 40))]]),
        "tp_spec_embed": dict(_engine_case(tt_cfg, tiny, dict(tp=2), [ECHO], spec_mode="ngram"),
                              embed=PROMPTS[:2]),
        "tp_sampled": dict(_engine_case(tt_cfg, tiny, dict(tp=2), [PROMPTS[:2]]),
                           temperature=0.8),
        "ep_eplb": _engine_case(moe_cfg, moe, dict(ep=2), [PROMPTS], eplb=EPLB),
        "sp_ring": dict(_engine_case(tt_cfg, tiny, dict(sp=2), RING_PHASES, prefill_chunk=64),
                        max_tokens=4),
        "logits": {"kind": "call", "mesh": MeshConfig(tp=2),
                   "fn": "llmd_tpu_torch.parallel.checks:forward_logits",
                   "kw": dict(model_cfg=tt_cfg, params=tiny, tokens=PROMPTS[2])},
        "logits_int8": {"kind": "call", "mesh": MeshConfig(tp=2),
                        "fn": "llmd_tpu_torch.parallel.checks:forward_logits",
                        "kw": dict(model_cfg=tt_cfg, params=tiny, tokens=PROMPTS[2],
                                   quantize="int8")},
        "logits_moe": {"kind": "call", "mesh": MeshConfig(ep=2),
                       "fn": "llmd_tpu_torch.parallel.checks:forward_logits",
                       "kw": dict(model_cfg=moe_cfg, params=moe, tokens=PROMPTS[2])},
        "dp2_spec_embed": dict(_engine_case(tt_cfg, tiny, dict(dp=2), [ECHO],
                                            spec_mode="ngram"), embed=PROMPTS[:2]),
        "logits_dp2": {"kind": "call", "mesh": MeshConfig(dp=2),
                       "fn": "llmd_tpu_torch.parallel.checks:forward_logits",
                       "kw": dict(model_cfg=tt_cfg, params=tiny, tokens=PROMPTS[2])},
        "logits_moe_sp2": {"kind": "call", "mesh": MeshConfig(sp=2),
                           "fn": "llmd_tpu_torch.parallel.checks:forward_logits",
                           "kw": dict(model_cfg=moe_cfg, params=moe, tokens=PROMPTS[2])},
    }
    for name, (model, mesh, phases, kw) in SPLIT.items():
        _, cfg, _, npp = weights[model]
        cases[name] = _engine_case(cfg, npp, mesh, phases, **kw)
    run = WorldRun(list(cases.values()), 2, str(tmp_path_factory.mktemp("mesh")))
    yield run, list(cases)
    run.reap()


def _result(world, name: str) -> dict:
    run, names = world
    code, res = run.results()
    i = names.index(name)
    assert code == 0 and len(res) == len(names), (code, res, run.log_text())
    assert "error" not in res[i], res[i]
    return res[i]


# ------------------------------------------------------------------ layout


def test_rank_layout_equals_build_mesh():
    """Rank r of the port sits where device r sits in the reference's
    (dp, sp, ep, tp) mesh, and each axis group holds the devices of one
    mesh line, in mesh order."""
    for cfg in (dict(dp=2, ep=4), dict(ep=8), dict(dp=2, ep=2, tp=2), dict(sp=2, tp=2),
                dict(dp=2, sp=2, ep=2)):
        jm = jmesh.build_mesh(jmesh.MeshConfig(**cfg))
        ids = np.vectorize(lambda d: d.id)(jm.devices)  # [dp, sp, ep, tp]
        mc = MeshConfig(**cfg)
        for r in range(mc.num_devices):
            c = tmesh.rank_coords(mc, r)
            assert ids[c["dp"], c["sp"], c["ep"], c["tp"]] == r
            assert tmesh.rank_of(mc, c) == r
            for axis in tmesh.AXES:
                line = [int(ids[tuple(i if a == axis else c[a] for a in tmesh.AXES)])
                        for i in range(getattr(mc, axis))]
                assert tmesh.axis_ranks(mc, r, (axis,)) == line
    assert tmesh.axis_ranks(MeshConfig(dp=2, ep=2, tp=2), 1, ("dp", "sp", "ep")) == [1, 3, 5, 7]


class _FakeMesh(tmesh.RankMesh):
    """A rank's place on the mesh without process groups (sharding only)."""

    def __init__(self, cfg: MeshConfig, rank: int):
        super().__init__(cfg, rank, None, {})


@pytest.mark.parametrize("name,quant", [("tiny", None), ("tiny", "int8"), ("tiny-mla", None),
                                        ("tiny-moe", None), ("tiny-moe", "int8")])
def test_shard_params_equals_shard_pytree(name, quant):
    """Each rank's block of every leaf equals the reference's shard on that
    device under the same logical axes and rules (after int8 quantization
    of the whole weights); fused gate+up leaves hold their gate block and
    their up block, so rank r's gates and ups are the same columns."""
    jcfg, tcfg, jp, npp = _weights(name)
    jaxes = jt.param_logical_axes(jcfg)
    if quant:
        jp, jaxes = jq.quantize_params(jcfg, jp, base_axes=jaxes)
        npp = {k: np.asarray(v) for k, v in jp.items()}
    taxes = tmesh.param_logical_axes(tcfg)
    for k in jaxes:
        assert tuple(taxes[k]) == tuple(jaxes[k]), k
    mc = MeshConfig(dp=2, ep=2, tp=2)
    jm = jmesh.build_mesh(jmesh.MeshConfig(dp=2, ep=2, tp=2))
    sharded = jmesh.shard_pytree(jp, jm, jaxes)
    halves = {}
    for k in jaxes:
        if k.removesuffix("_q").removesuffix("_scale") in tmesh.FUSED_GATE_UP:
            g, u = np.split(npp[k], 2, axis=-1)
            halves[k] = jmesh.shard_pytree({"g": jnp.asarray(g), "u": jnp.asarray(u)}, jm,
                                           {"g": jaxes[k], "u": jaxes[k]})

    def on(leaf, r):
        return np.asarray(next(s for s in leaf.addressable_shards if s.device.id == r).data,
                          np.float32)

    tparams = tt.params_from_numpy(tcfg, npp)
    for r in range(mc.num_devices):
        mine = tmesh.shard_params(tparams, _FakeMesh(mc, r), taxes)
        for k, leaf in sharded.items():
            got = mine[k].float().numpy()
            if k in tmesh.WHOLE:  # routing runs on the whole router on every rank
                want = np.asarray(npp[k], np.float32)
            elif k in halves:  # the gate block and the up block of rank r
                want = np.concatenate([on(halves[k]["g"], r), on(halves[k]["u"], r)], -1)
                if "mlp" in jaxes[k][-1]:  # the trap: a contiguous block is not that
                    assert not np.array_equal(on(leaf, r), want), k
            else:
                want = on(leaf, r)
            np.testing.assert_array_equal(got, want, err_msg=f"{k} rank {r}")


def test_shard_block_refuses_an_axis_that_does_not_divide():
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.shard_block("wq", torch.zeros((2, 8, 3, 4)), (None, None, "tp", None),
                          _FakeMesh(MeshConfig(tp=2), 0))


def test_world_needs_its_devices():
    from llmd_tpu_torch.parallel.launch import World

    with pytest.raises(ValueError, match="need 2 devices"):
        World.start(2, "cuda")
    with pytest.raises(ValueError, match="at least 2 ranks"):
        World.start(1, "cpu")


# ----------------------------------------------------------------- engines


@pytest.mark.parametrize("case,kw", [("tp", {}), ("tp_int8", dict(quantize_weights="int8")),
                                     ("tp_fp8", dict(kv_cache_dtype="fp8"))])
def test_tp2_tokens_equal_the_meshed_reference(weights, world, case, kw):
    jcfg, _, jp, _ = weights["tiny"]
    want, _ = _jax_tokens(jcfg, jp, dict(tp=2), PROMPTS[:2], **kw)
    res = _result(world, case)
    assert res["tokens"] == [want] and res["agree"], res
    assert res["stats"]["kv_cache_dtype"] == ("fp8" if "kv_cache_dtype" in kw else "float32")


def test_tp2_verify_and_embed_programs_equal_the_meshed_reference(weights, world):
    """The verify program (ngram speculation on prompts that hold most of
    the vocabulary: drafts proposed, acceptance as the random weights
    decide) and the embed program
    under tp=2: tokens, drafted / accepted / verify-step counts and the
    embeddings equal the JAX engine's under the same mesh."""
    jcfg, _, jp, _ = weights["tiny"]
    je = JaxEngine(jcfg, JaxEngineConfig(**BASE, mesh=jmesh.MeshConfig(tp=2),
                                         spec_mode="ngram"), params=jp)
    out = je.generate(ECHO, JaxSamplingParams(max_tokens=6, temperature=0.0))
    want = [out[f"req-{i}"] for i in range(len(ECHO))]
    want_embed = [je.embed(p) for p in PROMPTS[:2]]
    res = _result(world, "tp_spec_embed")
    st, jst = res["stats"], je.stats
    assert res["tokens"] == [want] and res["agree"], res
    assert (st["spec_drafted"], st["spec_accepted"], st["n_spec_verify_steps"]) == (
        jst.spec_drafted, jst.spec_accepted, jst.n_spec_verify_steps)
    assert st["spec_drafted"] > 0 and st["n_spec_verify_steps"] > 0  # verify ran
    np.testing.assert_allclose(np.asarray(res["embeds"]), np.asarray(want_embed),
                               rtol=0, atol=1e-5)


def test_tp2_sampled_requests_draw_alike_on_every_rank(world):
    """temperature > 0: each rank samples from the same all-gathered logits
    with its own generator of the engine's seed, in the unified sampler and
    in the decode chain, so every rank's tokens equal rank 0's (a rank that
    drew otherwise would feed the next forward other tokens)."""
    res = _result(world, "tp_sampled")
    assert res["agree"] and [len(t) for t in res["tokens"][0]] == [6, 6]


def test_mesh_refusals_name_item_6c(world):
    """What a meshed engine once refused naming ROADMAP item 6c (the offload
    and FS tiers, LoRA and a connector at construction; logit_bias, a
    grammar and an adapter's requests) now constructs and serves on the
    world: tokens equal the one-card twin's, every rank's ops gave rank 0's
    tokens, and no message of the port names item 6c."""
    import pathlib

    res = _result(world, "options")
    run, twin = res["mesh"][1], res["twin"][1]
    assert res["agree"] and run == twin, (run, twin)
    assert {rid for rid, _, _, _ in SERVED} == set(run)
    assert run["adapter"][0] != run["plain"][0]
    root = pathlib.Path(__file__).resolve().parent.parent / "llmd_tpu_torch"
    hits = [str(p) for p in root.rglob("*.py")
            if "item 6c" in p.read_text() or "item 6d" in p.read_text()]
    assert not hits, hits  # nor the row split's item, done too
    assert "item 6c" not in world[0].log_text()


def test_mla_tp2_with_replicated_latent_pool(weights, world):
    """tests/test_mla.py::test_tp2_parity_with_replicated_latent_pool on
    the port: heads over tp, the single-plane latent pool whole on each rank."""
    jcfg, _, jp, _ = weights["tiny-mla"]
    want, _ = _jax_tokens(jcfg, jp, dict(tp=2), [list(range(7, 40))])
    res = _result(world, "mla_tp")
    assert res["tokens"] == [want] and res["agree"], res


def test_sp2_ring_prefill_equals_the_meshed_reference(weights, world):
    """tests/test_ring_attention.py's engine cases on the port at sp=2:
    ``ring_zigzag(sp=2)``, ring steps 1, 2 (a continuation chunk stays
    paged) and 2 (a two-sequence step stays paged), tokens phase by phase
    equal to the JAX engine's under the same mesh."""
    jcfg, _, jp, _ = weights["tiny"]
    je = JaxEngine(jcfg, JaxEngineConfig(**BASE | dict(prefill_chunk=64),
                                         mesh=jmesh.MeshConfig(sp=2)), params=jp)
    want, steps = [], []
    for n, phase in enumerate(RING_PHASES):
        for i, p in enumerate(phase):
            je.add_request(f"r{n}-{i}", p, JaxSamplingParams(max_tokens=4, temperature=0.0))
        got: dict = {}
        while je.has_work():
            for o in je.step():
                got.setdefault(o.request_id, []).extend(o.new_token_ids)
        want.append([got[f"r{n}-{i}"] for i in range(len(phase))])
        steps.append(je.stats.n_ring_prefill_steps)
    res = _result(world, "sp_ring")
    assert res["stats"]["sp_attn_backend"] == je.sp_attn_backend == "ring_zigzag(sp=2)"
    assert res["tokens"] == want and res["agree"], res
    assert res["ring_steps"] == steps == [1, 2, 2]


def test_moe_ep2_eplb_equals_the_meshed_reference(weights, world):
    """tests/test_quant.py::test_eplb_regather_carries_scales's mesh on the
    port in float32: the EP exchange over 2 ranks, EPLB's slots rounded to
    ep and regathered on each rank; tokens, drops and rebalances equal."""
    jcfg, _, jp, _ = weights["tiny-moe"]
    want, jst = _jax_tokens(jcfg, jp, dict(ep=2), PROMPTS, eplb=EPLB)
    res = _result(world, "ep_eplb")
    st = res["stats"]
    assert res["tokens"] == [want] and res["agree"], res
    assert st["moe_dispatch"] == "sorted" and res["fallback"] is None
    assert (st["moe_dropped_tokens"], st["eplb_rebalances"]) == (
        jst.moe_dropped_tokens, jst.eplb_rebalances)
    assert st["eplb_rebalances"] >= 2


@pytest.mark.parametrize("case,name,quant", [("logits", "tiny", None),
                                             ("logits_int8", "tiny", "int8"),
                                             ("logits_moe", "tiny-moe", None),
                                             ("logits_dp2", "tiny", None),
                                             ("logits_moe_sp2", "tiny-moe", None)])
def test_meshed_prefill_logits_within_1e4(weights, world, case, name, quant):
    """One 30-token prefill on the shards (vocab-parallel embed and logits,
    column / row parallel products, the EP exchange; at dp=2 and sp=2 each
    rank runs its 15 rows, the K/V of all 30 gathered into its pool before
    attention, the logits gathered) against the reference forward on the
    whole weights: max |diff| <= 1e-4, same argmax, and every rank holds the
    same logits."""
    jcfg, _, jp, _ = weights[name]
    if quant:
        jp, _ = jq.quantize_params(jcfg, jp)
    toks = np.asarray(PROMPTS[2], np.int32)
    N, ps = len(toks), 8
    pages = -(-N // ps)
    pt = np.full((1, pages + 1), -1, np.int32)
    pt[0, :pages] = np.arange(pages)
    hj, _, _, _ = jt.forward_core(
        jcfg, jp, jt.init_cache(jcfg, pages + 1, ps), jnp.asarray(toks),
        jnp.arange(N, dtype=jnp.int32), jnp.zeros(N, jnp.int32), jnp.asarray(pt),
        jnp.array([N], jnp.int32),
        moe_dispatch_impl=jmd.make_sorted_dispatch() if jcfg.is_moe else None)
    want = np.asarray(jt.unembed(jcfg, jp, hj), np.float32)
    res = _result(world, case)
    got = res["result"]
    assert res["agree"]
    assert got.shape == want.shape and np.abs(got - want).max() <= 1e-4
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_int8_scales_span_the_whole_contracted_axis():
    """Quantize first, then shard: a row-parallel weight's scale (wo over
    heads) is the whole weight's, the same on both tp ranks."""
    _, tcfg, _, npp = _weights("tiny")
    p = tq.quantize_params(tcfg, tt.params_from_numpy(tcfg, npp))
    axes = tmesh.param_logical_axes(tcfg)
    a, b = (tmesh.shard_params(p, _FakeMesh(MeshConfig(tp=2), r), axes) for r in (0, 1))
    assert torch.equal(a["wo_scale"], p["wo_scale"]) and torch.equal(b["wo_scale"], p["wo_scale"])
    assert a["wo_q"].shape[1] == tcfg.num_heads // 2
    own = tq.quantize_one(p["wo_q"][:, :2].float() * p["wo_scale"][:, None, None], (1, 2))[1]
    assert not torch.equal(own, p["wo_scale"])  # a shard's own scale would differ


def test_a_dead_rank_fails_the_world_within_its_timeout(tmp_path):
    """Rank 1 killed: rank 0's next command raises (not a hang), the world
    script exits non-zero, and no rank process outlives it."""
    run = WorldRun([{"kind": "kill", "mesh": MeshConfig(sp=2)}], 2, str(tmp_path),
                   deadline_s=120, timeout_s=20)
    code, res = run.results()
    assert code != 0 and res, run.log_text()
    assert res[0]["error_raised"] and "rank 1" in res[0]["error_raised"]
    assert res[0]["seconds"] < 20


@pytest.mark.parametrize("case", list(SPLIT))
def test_split_rows_equal_the_meshed_reference(weights, world, case):
    """A step's rows split over (dp, sp), each rank running its own: at dp=2
    mixed prompts through the pipelined defaults and a second phase of
    prefix hits, and prompt A reloaded from the CPU tier; at sp=2 three
    prompts on the plain unified program; tiny-moe at dp=2 on the einsum
    dispatch (capacity positions from the gathered routing) with EPLB.
    Tokens phase by phase, offload loads, dropped copies and rebalances
    equal the JAX engine's under the same mesh."""
    model, mesh, phases, kw = SPLIT[case]
    jcfg, _, jp, _ = weights[model]
    want, je = _jax_phases(jcfg, jp, mesh, phases, **kw)
    res = _result(world, case)
    st, jst = res["stats"], je.stats
    assert res["tokens"] == want and res["agree"], res
    assert (st["total_offload_loads"], st["moe_dropped_tokens"], st["eplb_rebalances"]) == (
        jst.total_offload_loads, jst.moe_dropped_tokens, jst.eplb_rebalances)
    if case == "dp2_offload":
        assert st["total_offload_loads"] > 0 and want[2] == want[0]
    if case == "dp2_einsum":
        assert st["moe_dropped_tokens"] > 0 and st["eplb_rebalances"] >= 1
    assert res["ring_steps"][-1] == jst.n_ring_prefill_steps
    if case == "sp2":  # three prompts a step: the plain unified program, split over sp
        assert res["ring_steps"] == [0] and st["sp_attn_backend"] == "ring_zigzag(sp=2)"


def test_dp2_verify_and_embed_programs_equal_the_meshed_reference(weights, world):
    """ngram speculation and the embed program with their rows split over
    dp=2: tokens, drafted / accepted / verify-step counts and the
    embeddings (each rank's partial sum all-reduced) equal the JAX engine's
    under the same mesh."""
    jcfg, _, jp, _ = weights["tiny"]
    je = JaxEngine(jcfg, JaxEngineConfig(**BASE, mesh=jmesh.MeshConfig(dp=2),
                                         spec_mode="ngram"), params=jp)
    out = je.generate(ECHO, JaxSamplingParams(max_tokens=6, temperature=0.0))
    want_embed = [je.embed(p) for p in PROMPTS[:2]]
    res = _result(world, "dp2_spec_embed")
    st, jst = res["stats"], je.stats
    assert res["tokens"] == [[out[f"req-{i}"] for i in range(len(ECHO))]] and res["agree"]
    assert (st["spec_drafted"], st["spec_accepted"], st["n_spec_verify_steps"]) == (
        jst.spec_drafted, jst.spec_accepted, jst.n_spec_verify_steps)
    assert st["n_spec_verify_steps"] > 0
    np.testing.assert_allclose(np.asarray(res["embeds"]), np.asarray(want_embed),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", ENGINE_CASES)
def test_every_rank_ran_its_rows_and_holds_the_same_pool(world, case):
    """Each rank's row log: every op ran, on every rank, the rows the
    reference's binding gives it (the flat programs' near-equal (dp, sp)
    slices summing to the step, the decode programs' dp block, the ring's
    sp share); after serving, every rank's pool pages hold the bytes of its
    tp peer on rank 0."""
    res = _result(world, case)
    mesh = _ENGINE_MESH[case]
    assert rows_as_planned(res, mesh) == []
    split = mesh.dp * mesh.sp > 1
    assert any(e[2] < e[1] for e in res["row_logs"][0]) == split
    assert res["pools_equal"]


_ENGINE_MESH = {"tp": MeshConfig(tp=2), "tp_int8": MeshConfig(tp=2), "tp_fp8": MeshConfig(tp=2),
                "mla_tp": MeshConfig(tp=2), "tp_spec_embed": MeshConfig(tp=2),
                "tp_sampled": MeshConfig(tp=2), "ep_eplb": MeshConfig(ep=2),
                "sp_ring": MeshConfig(sp=2), "dp2_spec_embed": MeshConfig(dp=2),
                **{name: MeshConfig(**mesh) for name, (_, mesh, _, _) in SPLIT.items()}}
