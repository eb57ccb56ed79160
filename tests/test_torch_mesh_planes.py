"""LoRA, media rows, the KV data plane and the masked programs on a meshed
port engine, against the JAX engine under the same ``MeshConfig`` on the CPU.

One gloo world of 2 CPU rank processes (``tests/torch_mesh_worker.py``)
runs every port case of this file in the background while the JAX engines
run here. Weights are the reference's float32 ``init_params`` and adapters
its ``make_adapter_weights``, bridged through numpy; media rows are numpy
arrays drawn from a seed. In f32, tiny at tp=2 unless stated:

- two adapters and the base model in one batch, an adapter unloaded (its
  slot zero on every rank) and another loaded after the decode program
  first ran: tokens equal the JAX engine's;
- ``logit_bias``, ``guided_choice`` and a JSON schema through
  ``decode_masked``, and with ngram speculation through ``verify_masked``
  (tokens and drafted / accepted / verify-step counts equal); tiny-moe at
  ep=2 through ``decode_masked``: tokens and dropped copies equal;
- tiny-vl with ``mm_items``: tokens equal, and the repeated media request
  hits the prefix cache as the reference's does;
- the CPU and FS offload tiers over an fp8 pool: tokens, offload counters
  and KV events (``medium`` included) equal; an FS tier written at tp=2
  reloads into a one-card port engine, and the reverse; the durable tier:
  tokens, blocks flushed and the store's keys equal the JAX tp=2 engine's;
  an in-memory connector filled at tp=2 serves a one-card engine: tokens
  and saved / loaded blocks equal a JAX pair's;
- P/D at head_dim 128: a tp=2 P to a one-card D, a one-card P to a tp=2 D and
  a tp=2 P to a JAX D give the JAX pair's tokens; the tp=2 P's KVT1 payload is
  its ranks' pool planes in rank order, byte for byte, in f32 and fp8, and a
  tp=2 D that injected a one-card P's blocks exports the same bytes.

The adapters with the masked requests, the masked verify and the media
rows also run at dp=2, each step's rows split over dp (``parallel/rows``),
and at sp=2, prefill on the ring: tokens and spec counts equal the JAX
engine's under ``MeshConfig(dp=2)`` and ``MeshConfig(sp=2)``.

Every meshed case's rank ops gave rank 0's tokens.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from llmd_tpu.core.request import SamplingParams as JaxSamplingParams
from llmd_tpu.disagg import transfer as jtr
from llmd_tpu.engine import EngineConfig as JaxEngineConfig
from llmd_tpu.engine import LLMEngine as JaxEngine
from llmd_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from llmd_tpu.kv import connector_api as jconn
from llmd_tpu.kv.remote_store import RemoteKVStoreServer as JaxKVStoreServer
from llmd_tpu.models import get_model_config as jax_model_config
from llmd_tpu.models import lora as jl
from llmd_tpu.models import transformer as jt
from llmd_tpu.parallel import mesh as jmesh
from llmd_tpu_torch.engine.config import EngineConfig, MeshConfig
from llmd_tpu_torch.engine.tokenizer import ByteTokenizer
from llmd_tpu_torch.kv.remote_store import RemoteKVStoreServer
from llmd_tpu_torch.models import get_model_config
from llmd_tpu_torch.models.lora import LoRAConfig
from llmd_tpu_torch.parallel import mesh as tmesh
from torch_mesh_worker import WorldRun

TOK = ByteTokenizer()
EOS = TOK.eos_id
Z = TOK.encode("z")[0]
BASE = dict(page_size=8, num_pages=64, max_model_len=256, max_batch_size=4,
            prefill_chunk=32, decode_steps=2)
LCFG = dict(max_adapters=2, rank=4)
G = dict(max_tokens=8, temperature=0.0)
SCHEMA = {"type": "object", "properties": {"count": {"enum": [0, 1, 2, 3]},
                                           "ok": {"type": "boolean"}},
          "required": ["count", "ok"]}
MASKED = [("bias", TOK.encode("say"), dict(G, logit_bias={Z: 100.0}), {}),
          ("choice", TOK.encode("pick a color"),
           dict(G, max_tokens=16, guided_choice=["red", "green", "blue"], stop_token_ids=(EOS,)),
           {}),
          ("schema", TOK.encode("json:"),
           dict(G, max_tokens=32, stop_token_ids=(EOS,),
                response_format={"type": "json_schema", "json_schema": {"schema": SCHEMA}}),
           {}),
          ("plain", list(range(9, 40)), G, {})]
LORA_RUN1 = [("base", list(range(3, 40)), G, {}), ("a", list(range(3, 40)), G, {"lora_id": "a"}),
             ("b", list(range(5, 33)), dict(G, max_tokens=11), {"lora_id": "b"}),
             ("a2", list(range(20, 50)), G, {"lora_id": "a"})]
LORA_RUN2 = [("c", list(range(3, 40)), G, {"lora_id": "c"}), ("base2", list(range(9, 60)), G, {}),
             ("ca", TOK.encode("pick"), dict(G, max_tokens=16, guided_choice=["red", "blue"],
                                             stop_token_ids=(EOS,)), {"lora_id": "a"})]
# a forced, repetitive pattern: the constrained rows draft from their own output
SPEC = [("regex", list(range(60, 72)), dict(G, max_tokens=24, guided_regex=r"(abc){6}",
                                            stop_token_ids=(EOS,)), {}),
        ("echo", [7, 8, 9] * 8, dict(G, max_tokens=16), {}),
        ("bias", [7, 8, 9] * 8, dict(G, max_tokens=12, logit_bias={Z: -100.0}), {}),
        ("schema", TOK.encode('[{"s":"on"},{"s":"on"},{"s":"on"},'),
         dict(G, max_tokens=48, stop_token_ids=(EOS,), response_format={
             "type": "json_schema", "json_schema": {"schema": {
                 "type": "array", "minItems": 6, "maxItems": 6,
                 "items": {"type": "object", "properties": {"s": {"enum": ["on"]}},
                           "required": ["s"]}}}}), {})]
SPEC_STATS = ("spec_drafted", "spec_accepted", "n_spec_verify_steps", "spec_drafted_constrained",
              "spec_accepted_constrained", "structured_violations")
# offload pressure: a 12-page pool, prompts of 5 pages, each prompt again later
OFF_KW = dict(num_pages=12, max_batch_size=2, cpu_offload_pages=2)
OFF_RUNS = [[(f"o{i}", p, dict(G, max_tokens=6), {})]
            for i, p in enumerate([list(range(3, 40)), list(range(100, 140)),
                                   list(range(200, 240)), list(range(3, 40)) + [7],
                                   list(range(100, 140)) + [9]])]
OFF_STATS = ("total_offload_loads", "total_prefill_tokens")
PD_PROMPT = list(range(40, 73))  # 4 whole blocks at page size 8
PD_HEAD_DIM = 128  # the reference pads head_dim to 128 lanes: no padding here


def _weights(name: str, head_dim=None):
    over = {"dtype": "float32"} | ({"head_dim": head_dim} if head_dim else {})
    jcfg = dataclasses.replace(jax_model_config(name), **over)
    tcfg = dataclasses.replace(get_model_config(name), **over)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, {k: np.asarray(v) for k, v in jp.items()}


@functools.cache
def _adapter(seed: int) -> dict:
    jcfg = _weights("tiny")[0]
    w = jl.make_adapter_weights(jcfg, jl.LoRAConfig(**LCFG), jax.random.PRNGKey(seed))
    return {k: np.asarray(v, np.float32) for k, v in w.items()}


def _media(cfg, salt: int):
    """One media item: (identity, [mm_tokens, hidden] float32 rows)."""
    rng = np.random.default_rng(salt)
    return (f"image-{salt}".encode(),
            (rng.standard_normal((cfg.mm_tokens, cfg.hidden_size)) * 0.5).astype(np.float32))


def _vl_runs(cfg):
    k, ph = cfg.mm_tokens, cfg.mm_placeholder_id
    media = list(range(10, 18)) + [ph] * k + list(range(30, 40))
    items = [_media(cfg, 1)]
    run1 = [("media", media, dict(G, ignore_eos=True), {"mm_items": items}),
            ("text", list(range(50, 71)), G, {})]
    run2 = [("again", media, dict(G, ignore_eos=True), {"mm_items": items})]
    return run1, run2


def _lora_actions():
    return [("load", "a", _adapter(1)), ("load", "b", _adapter(2)), ("run", LORA_RUN1),
            ("slot", 2), ("unload", "b"), ("slot", 2),
            ("load", "c", _adapter(3)), ("run", LORA_RUN2), ("run", MASKED),
            ("stats", ("structured_chain_stages", "structured_violations")), ("programs",)]


def _script(tcfg, npp, mesh, actions, twin=False, tokenizer=False, env=None, **kw):
    ecfg = EngineConfig(**BASE | kw, mesh=mesh or MeshConfig())
    return {"kind": "script", "mesh": mesh, "model_cfg": tcfg, "engine_cfg": ecfg,
            "params": npp, "actions": actions, "twin": twin, "tokenizer": tokenizer,
            "env": env or {}}


@pytest.fixture(scope="module")
def store():
    srv = RemoteKVStoreServer(port=0)
    srv.start()
    yield srv
    srv.stop()


@pytest.fixture(scope="module")
def weights():
    return {"tiny": _weights("tiny"), "tiny-moe": _weights("tiny-moe"),
            "tiny-vl": _weights("tiny-vl"), "pd": _weights("tiny", PD_HEAD_DIM)}


@pytest.fixture(scope="module")
def world(weights, store, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("planes")
    fs = {n: str(tmp / n) for n in ("fs_mesh", "fs_one")}
    _, tiny, _, npp = weights["tiny"]
    _, moe, _, moe_p = weights["tiny-moe"]
    _, vl, _, vl_p = weights["tiny-vl"]
    _, pd, _, pd_p = weights["pd"]
    tp2, fp8 = MeshConfig(tp=2), dict(kv_cache_dtype="fp8")
    lora = dict(lora=LoRAConfig(**LCFG))
    off = [("run", r) for r in OFF_RUNS] + [("stats", OFF_STATS)]
    again = [("run", OFF_RUNS[0]), ("stats", OFF_STATS)]
    cases = {
        "lora": _script(tiny, npp, tp2, _lora_actions(), tokenizer=True, **lora),
        "spec": _script(tiny, npp, tp2, [("run", SPEC), ("stats", SPEC_STATS), ("programs",)],
                        tokenizer=True, spec_mode="ngram", spec_tokens=4),
        "moe": _script(moe, moe_p, MeshConfig(ep=2),
                       [("run", MASKED), ("stats", ("moe_dropped_tokens",)), ("programs",)],
                       tokenizer=True),
        "vl": _script(vl, vl_p, tp2, [("run", r) for r in _vl_runs(vl)]),
        "lora_dp2": _script(tiny, npp, MeshConfig(dp=2), _lora_actions(), tokenizer=True,
                            **lora),
        "spec_dp2": _script(tiny, npp, MeshConfig(dp=2), [("run", SPEC), ("stats", SPEC_STATS),
                                                         ("programs",)],
                            tokenizer=True, spec_mode="ngram", spec_tokens=4),
        "vl_dp2": _script(vl, vl_p, MeshConfig(dp=2), [("run", r) for r in _vl_runs(vl)]),
        "lora_sp2": _script(tiny, npp, MeshConfig(sp=2), _lora_actions(), tokenizer=True,
                            **lora),
        "spec_sp2": _script(tiny, npp, MeshConfig(sp=2), [("run", SPEC), ("stats", SPEC_STATS),
                                                         ("programs",)],
                            tokenizer=True, spec_mode="ngram", spec_tokens=4),
        "vl_sp2": _script(vl, vl_p, MeshConfig(sp=2), [("run", r) for r in _vl_runs(vl)]),
        "offload": _script(tiny, npp, tp2, off, **OFF_KW, **fp8, offload_fs_path=fs["fs_mesh"]),
        "fs_to_one": _script(tiny, npp, None, again, **OFF_KW, **fp8,
                             offload_fs_path=fs["fs_mesh"]),
        "fs_one": _script(tiny, npp, None, off, **OFF_KW, **fp8, offload_fs_path=fs["fs_one"]),
        "fs_to_mesh": _script(tiny, npp, tp2, again, **OFF_KW, **fp8,
                              offload_fs_path=fs["fs_one"]),
        "durable": _script(tiny, npp, tp2, [("run", r) for r in OFF_RUNS[:3]]
                           + [("flush",), ("stats", OFF_STATS)], twin=True,
                           env={"LLMD_KV_DURABLE_STORE": f"127.0.0.1:{store.port}"},
                           **dict(OFF_KW, cpu_offload_pages=0)),
        "conn_mesh": _script(tiny, npp, tp2, [("run", OFF_RUNS[0]), ("stats", OFF_STATS)],
                             kv_connector="shared"),
        "conn_one": _script(tiny, npp, None, [("run", OFF_RUNS[0]), ("stats", OFF_STATS)],
                            kv_connector="shared"),
        "pd_p": _script(pd, pd_p, tp2, [("run", [("p", PD_PROMPT, dict(G, max_tokens=1), {})]),
                                        ("export", "x", PD_PROMPT)], twin=True),
        "pd_p_fp8": _script(tiny, npp, tp2, [("run", [("p", PD_PROMPT, dict(G, max_tokens=1),
                                                        {})]),
                                             ("export", "x", PD_PROMPT)], twin=True, **fp8),
    }
    names = list(cases)
    pd_run = [("run", [("d", PD_PROMPT, G, {})])]
    cases |= {
        "pd_mesh_to_one": _script(pd, pd_p, None, [
            ("inject", names.index("pd_p"), "mesh", 1, PD_PROMPT)] + pd_run),
        "pd_one_to_mesh": _script(pd, pd_p, tp2, [
            ("inject", names.index("pd_p"), "twin", 1, PD_PROMPT)] + pd_run
            + [("export", "y", PD_PROMPT)]),
        "pd_fp8_one_to_mesh": _script(tiny, npp, tp2, [
            ("inject", names.index("pd_p_fp8"), "twin", 1, PD_PROMPT),
            ("export", "y", PD_PROMPT)], **fp8),
    }
    run = WorldRun(list(cases.values()), 2, str(tmp), deadline_s=300)
    yield run, list(cases)
    run.reap()


def _result(world, name: str) -> dict:
    run, names = world
    code, res = run.results()
    i = names.index(name)
    assert code == 0 and len(res) == len(names), (code, res[-1:], run.log_text())
    assert "error" not in res[i], res[i]
    return res[i]


# ------------------------------------------------------------------- JAX side


def _jax(mesh, weights, sink=None, **kw):
    jcfg, _, jp, _ = weights
    mcfg = jmesh.MeshConfig(**mesh) if mesh else jmesh.MeshConfig()
    return JaxEngine(jcfg, JaxEngineConfig(**BASE | kw, mesh=mcfg), params=jp,
                     tokenizer=JaxByteTokenizer(), event_sink=sink)


def _jax_run(eng, reqs) -> dict:
    got = {}
    for rid, prompt, skw, akw in reqs:
        eng.add_request(rid, list(prompt), JaxSamplingParams(**skw), **akw)
        got[rid] = ([], None, 0)
    while eng.has_work():
        for o in eng.step():
            toks, _, _ = got[o.request_id]
            got[o.request_id] = (toks + list(o.new_token_ids), o.finish_reason,
                                 o.num_cached_prompt_tokens)
    return got


def _tokens(got: dict) -> dict:
    return {rid: v[0] for rid, v in got.items()}


# ---------------------------------------------------------------------- LoRA


def test_adapter_bank_axes_are_the_references():
    """The copied ``lora_param_logical_axes`` equals the reference's; the
    port's bank layout transposes A and keeps wo's A by heads (each rank
    its heads' rows); a rank's adapter blocks equal the bank's blocks."""
    jcfg, tcfg, _, _ = _weights("tiny")
    assert tmesh.lora_param_logical_axes(tcfg) == {
        k: tuple(v) for k, v in jl.lora_param_logical_axes(jcfg).items()}
    axes = tmesh.lora_bank_axes()
    assert axes["lora_A_wq"] == ("layers", "embed", "lora_slots", None)
    assert axes["lora_A_wo"] == ("layers", "heads", "lora_slots", None)
    assert axes["lora_B_wk"] == ("layers", "lora_slots", None, "heads")

    class Rank(tmesh.RankMesh):
        def __init__(self, r):
            super().__init__(MeshConfig(tp=2), r, None, {})

    w = {k: torch.from_numpy(v.copy()) for k, v in _adapter(1).items()}
    for r in (0, 1):
        b = {k: tmesh.lora_adapter_block(k, v, Rank(r)) for k, v in w.items()}
        half = tcfg.num_heads * tcfg.head_dim // 2
        assert torch.equal(b["lora_A_wo"], w["lora_A_wo"][:, r * half:(r + 1) * half])
        assert torch.equal(b["lora_B_wq"], w["lora_B_wq"][..., r * half:(r + 1) * half])
        assert torch.equal(b["lora_A_wq"], w["lora_A_wq"])
        assert torch.equal(b["lora_B_wo"], w["lora_B_wo"])


def test_lora_under_tp2_equals_the_meshed_reference(weights, world):
    """Adapters a and b beside the base model in one batch; b unloaded (its
    slot zero on every rank, nonzero before); c loaded after the decode
    program ran; then the masked requests, one under an adapter."""
    je = _jax(dict(tp=2), weights["tiny"], lora=jl.LoRAConfig(**LCFG))
    want = []
    for act in _lora_actions():
        if act[0] == "load":
            je.load_lora_adapter(act[1], act[2])
        elif act[0] == "unload":
            je.unload_lora_adapter(act[1])
        elif act[0] == "run":
            want.append(_jax_run(je, act[1]))
    res = _result(world, "lora")
    got = [res["mesh"][i] for i in (2, 7, 8)]  # the runs
    assert res["mesh"][:2] == [1, 2]  # a and b's slots
    assert [_tokens(g) for g in got] == [_tokens(w) for w in want] and res["agree"], got
    assert got[0]["a"][0] != got[0]["base"][0] != got[0]["b"][0]
    before, after = res["mesh"][3], res["mesh"][5]
    for sums in (before[0], *before[1]):  # b's slot, on rank 0 and rank 1
        assert all(v > 0 for v in sums.values()), sums
    for sums in (after[0], *after[1]):
        assert all(v == 0 for v in sums.values()), sums
    stats, counts = res["mesh"][-2], res["mesh"][-1]
    assert stats["structured_chain_stages"] > 0 and stats["structured_violations"] == 0
    assert counts["decode_masked"][0] > 0


# -------------------------------------------------------------- masked programs


def test_verify_masked_under_tp2_equals_the_meshed_reference(weights, world):
    je = _jax(dict(tp=2), weights["tiny"], spec_mode="ngram", spec_tokens=4)
    want = _jax_run(je, SPEC)
    res = _result(world, "spec")
    run, stats, counts = res["mesh"]
    assert _tokens(run) == _tokens(want) and res["agree"], run
    assert stats == {k: getattr(je.stats, k) for k in SPEC_STATS}, stats
    assert stats["spec_drafted_constrained"] > 0 and counts["verify_masked"][0] > 0


def test_decode_masked_moe_ep2_equals_the_meshed_reference(weights, world):
    """The EP exchange inside the masked decode chain: tokens and dropped
    copies equal."""
    je = _jax(dict(ep=2), weights["tiny-moe"])
    want = _jax_run(je, MASKED)
    res = _result(world, "moe")
    run, stats, counts = res["mesh"]
    assert _tokens(run) == _tokens(want) and res["agree"], run
    assert stats["moe_dropped_tokens"] == je.stats.moe_dropped_tokens
    assert counts["decode_masked"][0] > 0


# ---------------------------------------------------------------- media rows


def test_media_rows_under_tp2_equal_the_meshed_reference(weights, world):
    je = _jax(dict(tp=2), weights["tiny-vl"])
    want = [_jax_run(je, r) for r in _vl_runs(weights["tiny-vl"][1])]
    res = _result(world, "vl")
    assert res["mesh"] == want and res["agree"], res["mesh"]
    assert want[1]["again"][2] > 0  # the prefix cache served the media prefix


# ------------------------------------------------------------ KV data plane


def test_offload_tiers_fp8_under_tp2_equal_the_meshed_reference(weights, world, tmp_path):
    """tests/test_kv_fp8.py's offload tier at tp=2 with an FS tier behind the
    CPU tier: tokens, offload counters and KV events equal."""
    events: list = []
    je = _jax(dict(tp=2), weights["tiny"], kv_cache_dtype="fp8",
              offload_fs_path=str(tmp_path), sink=events.extend, **OFF_KW)
    want = [_jax_run(je, r) for r in OFF_RUNS]
    res = _result(world, "offload")
    *runs, stats = res["mesh"]
    assert runs == want and res["agree"], runs
    store = je.offload.store
    assert stats["offload"] == (store.saves, store.loads, store.demotions)
    assert stats["total_offload_loads"] == je.stats.total_offload_loads > 0
    assert store.demotions > 0  # the FS tier took blocks
    assert res["mesh_events"] == [
        (type(e).__name__, list(getattr(e, "block_hashes", [])),
         getattr(e, "parent_block_hash", None), getattr(e, "medium", None),
         getattr(e, "lora_id", None)) for e in events]


@pytest.mark.parametrize("writer,reader", [("offload", "fs_to_one"), ("fs_one", "fs_to_mesh")])
def test_fs_tier_crosses_between_meshed_and_one_card(world, writer, reader):
    """A tier a tp=2 engine wrote reloads into a one-card engine, and the
    reverse: the reader's first prompt reloads from the FS files with the
    writer's tokens."""
    w, r = _result(world, writer), _result(world, reader)
    wrun = [x for x in w["mesh"] if isinstance(x, dict) and "o0" in x][0]
    rrun, stats = r["mesh"]
    assert _tokens(rrun) == _tokens(wrun)
    assert stats["total_offload_loads"] > 0 and rrun["o0"][2] > 0


def test_durable_tier_and_connector_under_tp2(weights, world, store, monkeypatch):
    """The durable tier: the meshed engine's tokens, blocks flushed, counts
    and the store's keys equal the JAX tp=2 engine's over a store of its
    own (and the port's one-card twin's). A connector filled by a tp=2
    engine serves a one-card engine's prefix: tokens, counts and saved /
    loaded blocks equal a JAX pair's, a JAX tp=2 engine filling an
    ``InMemoryKVConnector`` that a one-card JAX engine reads."""
    jstore = JaxKVStoreServer(port=0)
    jstore.start()
    try:
        monkeypatch.setenv("LLMD_KV_DURABLE_STORE", f"127.0.0.1:{jstore.port}")
        je = _jax(dict(tp=2), weights["tiny"], **dict(OFF_KW, cpu_offload_pages=0))
        monkeypatch.delenv("LLMD_KV_DURABLE_STORE")
        want = [_jax_run(je, r) for r in OFF_RUNS[:3]]
        je.writeback.flush_for_drain(10.0)
        je.writeback.stop()
        want += [dict(je.writeback.counts), {k: getattr(je.stats, k) for k in OFF_STATS}]
        jkeys = sorted(jstore._blocks)
    finally:
        jstore.stop()
    d = _result(world, "durable")
    assert d["mesh"] == want and d["agree"], (d["mesh"], want)
    assert d["mesh"] == d["twin"]
    assert want[3]["ok"] > 0 and want[3]["error"] == 0
    assert sorted(store._blocks) == jkeys and store.stats["puts"] > 0

    shared = jconn.InMemoryKVConnector()
    jconn.register_kv_connector("mesh-planes-shared", lambda params: shared)
    jwant = []
    for mesh in (dict(tp=2), None):
        jeng = _jax(mesh, weights["tiny"], kv_connector="mesh-planes-shared")
        got = _jax_run(jeng, OFF_RUNS[0])
        jeng._connector_pool.submit(lambda: None).result()  # retire-time saves are async
        jwant.append([got, {k: getattr(jeng.stats, k) for k in OFF_STATS}
                      | {"connector": dict(shared.stats)}])
    cm, co = _result(world, "conn_mesh"), _result(world, "conn_one")
    assert [cm["mesh"], co["mesh"]] == jwant and cm["agree"], ([cm["mesh"], co["mesh"]], jwant)
    assert jwant[0][1]["connector"]["saved_blocks"] > 0
    assert jwant[1][1]["connector"]["loaded_blocks"] > 0
    assert co["mesh"][0]["o0"][2] > 0  # the connector's blocks were the prefix


# ------------------------------------------------------------------------ P/D


def _jax_pair(weights_pd):
    """A JAX tp=2 P exports PD_PROMPT's blocks to a one-card JAX D."""
    p = _jax(dict(tp=2), weights_pd)
    d = _jax(None, weights_pd)
    _jax_run(p, [("p", PD_PROMPT, dict(G, max_tokens=1), {})])
    src = jtr.KVTransferSource(host="127.0.0.1")
    src.start()
    try:
        jtr.export_from_engine(p, src, "x", PD_PROMPT)
        pulled = jtr.KVTransferClient(timeout_s=10).pull("127.0.0.1", src.port, "x")
    finally:
        src.stop()
    jtr.inject_into_engine(d, pulled, PD_PROMPT)
    return _jax_run(d, [("d", PD_PROMPT, G, {})])


def _shards(export) -> bytes:
    """The export's pages read from each rank's own pool, planes in rank order."""
    hdr, payload, planes = export
    assert len(planes) == 2
    return np.concatenate(planes, axis=3).tobytes()


def test_pd_pairings_give_the_jax_pairs_tokens(weights, world):
    """tp=2 P -> one-card D, one-card P -> tp=2 D, and tp=2 P -> JAX D: the
    D's tokens equal the JAX pair's, with the prompt's whole blocks pulled."""
    want = _jax_pair(weights["pd"])
    p = _result(world, "pd_p")
    hdr, payload, _ = p["mesh"][1]
    assert hdr["block_shape"] == [2, 8, 4, PD_HEAD_DIM] and p["agree"]
    jd = _jax(None, weights["pd"])
    pulled = jtr.KVTransferClient._decode(hdr, payload)
    assert jtr.inject_into_engine(jd, pulled, PD_PROMPT) == 4
    assert _jax_run(jd, [("d", PD_PROMPT, G, {})]) == want
    for name in ("pd_mesh_to_one", "pd_one_to_mesh"):
        d = _result(world, name)
        assert d["mesh"][0] == 4 and d["mesh"][1] == want, (name, d["mesh"])


@pytest.mark.parametrize("p,d", [("pd_p", "pd_one_to_mesh"), ("pd_p_fp8", "pd_fp8_one_to_mesh")],
                         ids=["f32", "fp8"])
def test_meshed_kvt1_bytes_are_the_one_card_layout(world, p, d):
    """A tp=2 P's KVT1 payload is its ranks' pool planes concatenated in
    rank order (K0, V0, K1, V1, ... across ranks), byte for byte; a tp=2 D
    that injected a one-card P's blocks exports exactly that P's bytes; the
    headers equal the one-card P's. (Two engines that each computed the
    prompt agree to rounding, not bytes, in f32: tp=2 sums wo's partial
    products over ranks.)"""
    pm = _result(world, p)
    mesh_export, twin_export = pm["mesh"][1], pm["twin"][1]
    assert mesh_export[1] == _shards(mesh_export)
    assert mesh_export[0] == twin_export[0]
    back = _result(world, d)["mesh"][-1]
    assert back[1] == twin_export[1] and back[0]["block_shape"] == twin_export[0]["block_shape"]
    a = np.frombuffer(mesh_export[1], np.uint8)
    assert a.size == np.frombuffer(twin_export[1], np.uint8).size > 0


@pytest.mark.parametrize("case", ["lora_dp2", "spec_dp2", "vl_dp2",
                                  "lora_sp2", "spec_sp2", "vl_sp2"])
def test_planes_with_rows_split_over_dp2_equal_the_meshed_reference(weights, world, case):
    """Each step's rows split over dp=2 (the unified and verify programs'
    flat rows, the decode programs' slot blocks, with their adapter slots,
    media rows, table bases and entry states), and the same scripts at sp=2
    (the ring program with LoRA, the masked verify, media rows): the adapter
    script with the masked requests, the masked verify with ngram, the media
    requests and their prefix hit give the JAX engine's tokens under the same
    mesh (and its spec counts); every rank's ops gave rank 0's tokens."""
    plane, axis = case.split("_")
    mesh = {axis[:2]: 2}
    res = _result(world, case)
    if plane == "lora":
        je = _jax(mesh, weights["tiny"], lora=jl.LoRAConfig(**LCFG))
        want = []
        for act in _lora_actions():
            if act[0] == "load":
                je.load_lora_adapter(act[1], act[2])
            elif act[0] == "unload":
                je.unload_lora_adapter(act[1])
            elif act[0] == "run":
                want.append(_tokens(_jax_run(je, act[1])))
        assert [_tokens(res["mesh"][i]) for i in (2, 7, 8)] == want and res["agree"]
        assert res["mesh"][-1]["decode_masked"][0] > 0
    elif plane == "spec":
        je = _jax(mesh, weights["tiny"], spec_mode="ngram", spec_tokens=4)
        want = _jax_run(je, SPEC)
        run, stats, counts = res["mesh"]
        assert _tokens(run) == _tokens(want) and res["agree"], run
        assert stats == {k: getattr(je.stats, k) for k in SPEC_STATS}, stats
        assert counts["verify_masked"][0] > 0
    else:
        je = _jax(mesh, weights["tiny-vl"])
        want = [_jax_run(je, r) for r in _vl_runs(weights["tiny-vl"][1])]
        assert res["mesh"] == want and res["agree"], res["mesh"]
