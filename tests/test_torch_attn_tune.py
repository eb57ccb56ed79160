"""K1's launch-config table (``llmd_tpu_torch/ops/attn_tune.py``, a copy of
``llmd_tpu/ops/attn_tune.py``) and the kernel-selection modes, on the CPU.

- The copy against the original on the same files, both directions of write
  and load (entries, hash, lookups); malformed entries dropped one by one;
  entries not tuned on an NVIDIA card skipped by the port and counted.
- What an entry means to K1's mma plan: ``_plan`` under any override stays
  inside the kernel's limits (hypothesis), an entry whose ``bq`` is not the
  instance's tile leaves the policy, and the torch emulation of the mma
  instance's items and split merge (``tests/test_torch_paged_attention.py``)
  under tuned splits matches the plain version.
- The engine reads the table at construction (stats, ``tune`` label, the
  bench's JSON); ``attn_impl`` / ``moe_matmul`` modes give the JAX engine's
  modes' tokens; ``pallas`` is refused on the CPU and with int8 weights.

The kernel under tuned plans runs on the card (``tests/test_torch_kernel_gpu.py
-k tuned``).
"""

import dataclasses
import json
import logging

import jax
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from llmd_tpu.core.request import SamplingParams as JaxSamplingParams
from llmd_tpu.engine import EngineConfig as JaxEngineConfig
from llmd_tpu.engine import LLMEngine as JaxEngine
from llmd_tpu.models import get_model_config as jax_model_config
from llmd_tpu.models.transformer import init_params as jax_init_params
from llmd_tpu.ops import attn_tune as ref_tune
from llmd_tpu_torch.core.request import SamplingParams
from llmd_tpu_torch.engine import EngineConfig, LLMEngine
from llmd_tpu_torch.models import get_model_config
from llmd_tpu_torch.models.transformer import params_from_numpy
from llmd_tpu_torch.ops import attn_tune
from llmd_tpu_torch.ops import paged_attention as pa
from llmd_tpu_torch.ops.paged_attention import paged_attention_ref
from tests.test_torch_paged_attention import _emulate, _ragged

H100 = "NVIDIA H100 80GB HBM3"
BASE = dict(page_size=8, num_pages=64, max_model_len=256, max_batch_size=4,
            prefill_chunk=32, decode_steps=2)


def _entry(batch=64, ps=16, pps=64, layout="h32x64kv16", bkv=16, bq=16, on=H100, **kw):
    return {"batch": batch, "page_size": ps, "pages_per_seq": pps, "head_layout": layout,
            "bkv": bkv, "bq": bq, "tuned_on": on, **kw}


@pytest.fixture(autouse=True)
def no_active_table(monkeypatch):
    """No table from the environment or an earlier activate(); torch on one
    thread (the tiny engines are thousands of small ops)."""
    monkeypatch.delenv("LLMD_ATTN_TUNE_FILE", raising=False)
    attn_tune.activate(None)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    attn_tune.activate(None)


_entries = st.lists(st.builds(
    _entry, batch=st.sampled_from([8, 32, 64]), ps=st.sampled_from([8, 16]),
    pps=st.integers(1, 256), layout=st.sampled_from(["h32x64kv16", "h16x64kv8"]),
    bkv=st.integers(1, 256), bq=st.sampled_from([8, 16, 32]),
    us_per_call=st.floats(1, 1e3)), min_size=1, max_size=6)


@settings(max_examples=25, deadline=None)
@given(new=_entries, old=_entries, probe=st.tuples(
    st.sampled_from([8, 32, 64]), st.sampled_from([8, 16]), st.integers(1, 300),
    st.sampled_from(["h32x64kv16", "h16x64kv8", None])))
def test_files_written_by_either_package_load_in_the_other(tmp_path_factory, new, old, probe):
    """NVIDIA-tuned entries: a merge by either package loads in both with the
    same entries, hash and lookups."""
    for writer in (ref_tune, attn_tune):
        path = str(tmp_path_factory.mktemp("t") / "tune.json")
        writer.merge_and_save(path, old)
        written = writer.merge_and_save(path, new)
        ours, theirs = attn_tune.load_table(path), ref_tune.load_table(path)
        assert ours.entries == theirs.entries and ours.sha == theirs.sha == written.sha
        assert ours.dropped == theirs.dropped == 0
        assert ours.lookup(*probe) == theirs.lookup(*probe)


def test_bad_entries_dropped_one_by_one(tmp_path, caplog):
    bad = [{"batch": 64}, _entry(bkv=0), _entry(bq=True), _entry(layout=""), "x",
           _entry(pps="8")]
    good = [_entry(), _entry(batch=32, bkv=4)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"version": 1, "entries": bad[:3] + good + bad[3:]}))
    with caplog.at_level(logging.WARNING):
        ours = attn_tune.load_table(str(path))
    theirs = ref_tune.load_table(str(path))
    assert ours.entries == theirs.entries and len(ours.entries) == 2
    assert ours.dropped == theirs.dropped == len(bad) and ours.sha == theirs.sha
    assert "dropped 6 malformed" in caplog.text
    with pytest.raises(ValueError, match="malformed"):
        attn_tune.merge_and_save(str(tmp_path / "n.json"), [_entry(bkv=-1)])


def test_foreign_entries_skipped_and_counted(tmp_path, caplog):
    """Entries whose ``tuned_on`` names no NVIDIA card (a TPU's block sizes,
    or none given) are skipped by the port and counted in ``dropped``; the
    reference keeps them; a port merge keeps them in the file."""
    path = str(tmp_path / "t.json")
    ref_tune.merge_and_save(path, [_entry(on="TPU v5e"), _entry(batch=8, on="cpu"),
                                   _entry(batch=32)])
    raw = [dict(e) for e in json.load(open(path))["entries"]]
    raw[0].pop("tuned_on")  # no provenance: not NVIDIA either
    json.dump({"version": 1, "entries": raw}, open(path, "w"))
    with caplog.at_level(logging.WARNING):
        ours = attn_tune.load_table(path)
    assert [e["batch"] for e in ours.entries] == [32] and ours.dropped == 2
    assert "not tuned on an NVIDIA card" in caplog.text
    assert len(ref_tune.load_table(path).entries) == 3
    assert ours.lookup(8, 16, 64, "h32x64kv16") is None
    merged = attn_tune.merge_and_save(path, [_entry(batch=16)])
    assert len(json.load(open(path))["entries"]) == 4
    assert merged.entries == attn_tune.load_table(path).entries
    assert merged.sha == attn_tune.load_table(path).sha


def test_missing_or_corrupt_file_is_the_policy(tmp_path, caplog):
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    schema = tmp_path / "schema.json"
    schema.write_text(json.dumps({"version": 2, "entries": []}))
    with caplog.at_level(logging.WARNING):
        for p in (tmp_path / "none.json", bad, schema):
            assert attn_tune.load_table(str(p)) is None
    assert caplog.text.count("launch-plan policy") == 3


def test_active_table_follows_the_environment(tmp_path, monkeypatch):
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    ta = attn_tune.merge_and_save(a, [_entry()])
    tb = attn_tune.merge_and_save(b, [_entry(bkv=8)])
    assert attn_tune.active_table() is None
    monkeypatch.setenv("LLMD_ATTN_TUNE_FILE", a)
    assert attn_tune.active_hash() == ta.sha
    monkeypatch.setenv("LLMD_ATTN_TUNE_FILE", b)
    assert attn_tune.active_hash() == tb.sha
    attn_tune.activate(ta)  # pinned beats the environment
    assert attn_tune.active_hash() == ta.sha
    attn_tune.activate(None)
    assert attn_tune.active_hash() == tb.sha


# ------------------------------------------------------------- K1's mma plan


@settings(max_examples=200, deadline=None)
@example(n=1, b=1, maxp=129, ps=8, qpk=1, kvh=1, bkv=1, bq=64)  # capped: 17 splits -> 9
@given(n=st.integers(1, 4096), b=st.integers(1, 256), maxp=st.integers(0, 2048),
       ps=st.sampled_from([8, 16, 32, 64, 128]), qpk=st.sampled_from([1, 2, 4, 8, 16]),
       kvh=st.integers(1, 16), bkv=st.integers(1, 4096), bq=st.sampled_from([4, 8, 16, 32, 64]))
def test_plan_under_an_override_stays_inside_the_kernel(n, b, maxp, ps, qpk, kvh, bkv, bq):
    """The kernel's own checks (``csrc/paged_attention.cu`` ``dispatch_mma``):
    the tile times the group is MMA_ROWS, 1 <= splits <= MAX_SPLITS, the
    splits cover the table with no empty trailing split, and with more than
    one split each is a whole number of stages and pages. An entry whose
    ``bq`` is not the tile leaves the policy's plan."""
    policy = pa._plan(n, b, maxp, ps, qpk, kvh)
    plan = pa._plan(n, b, maxp, ps, qpk, kvh, override=(bkv, bq))
    keys = maxp * ps
    assert plan.tq * qpk == pa.MMA_ROWS and (plan.tq, plan.slots) == (policy.tq, policy.slots)
    assert 1 <= plan.splits <= pa.MAX_SPLITS
    assert plan.splits * plan.split_keys >= keys
    if plan.splits > 1:
        assert plan.split_keys % pa.STAGE_KEYS == 0 and plan.split_keys % ps == 0
        assert (plan.splits - 1) * plan.split_keys < keys
    if bq != policy.tq:
        assert plan == policy
    elif plan.splits > 1:
        # bkv pages rounded up to whole stages and pages; past MAX_SPLITS
        # splits of those, the fewest such keys that MAX_SPLITS splits cover
        step = int(np.lcm(pa.STAGE_KEYS, ps))
        per = -(-bkv * ps // step) * step
        if -(-keys // per) > pa.MAX_SPLITS:
            per = -(-(-(-keys // pa.MAX_SPLITS)) // step) * step
        assert plan.split_keys == per


def test_tuned_split_keys_by_hand():
    # the bench's decode shape: 64 pages of 16 -> bkv 64 / 32 / 16 / 8 / 4
    assert [pa.tuned_split_keys(k, 1024, 16) for k in (64, 32, 16, 8, 4)] == [
        (1, 1024), (2, 512), (4, 256), (8, 128), (16, 64)]
    assert pa.tuned_split_keys(1, 32768, 16) == (16, 2048)  # capped, then grown
    assert pa.tuned_split_keys(3, 100, 8) == (2, 64)  # rounded up to a stage


@pytest.mark.parametrize("bkv", [1, 4, 16])
def test_emulated_mma_under_tuned_splits_matches_plain(bkv):
    """f32, valid rows, atol 1e-5: the mma instance's items and split merge
    (``_emulate``) under the plan a table entry gives, against the plain
    version; padding rows are zeros."""
    H, Hk, D, ps, q_lens, kv_lens = 8, 2, 32, 16, [49, 1, 17, 2], [1100, 2048, 1500, 530]
    c = _ragged(np.random.default_rng(bkv), H, Hk, D, ps, q_lens, kv_lens)
    N, B, maxp = c["q"].shape[0], c["pts"].shape[0], c["pts"].shape[1]
    table = attn_tune.AttnTuneTable(entries=(_entry(
        batch=N, ps=ps, pps=maxp, layout=attn_tune.head_layout_key(H, D, 2 * Hk), bkv=bkv,
        bq=pa.MMA_ROWS // (H // Hk)),))
    override = pa.plan_override(table, N, ps, maxp, H, D, 2 * Hk)
    plan = pa._plan(N, B, maxp, ps, H // Hk, Hk, override=override)
    assert override == (bkv, 16) and plan.splits > 1
    assert (plan.splits, plan.split_keys) == pa.tuned_split_keys(bkv, maxp * ps, ps)
    t = torch.from_numpy
    got = _emulate(t(c["q"]), t(c["pool"]), t(c["pts"]), c["lens"], c["cu"], c["nb"],
                   c["scale"], plan)
    ref = paged_attention_ref(t(c["q"]), t(c["pool"]), t(c["pts"]), t(c["pos"]),
                              t(c["sids"]), t(c["lens"]), scale=c["scale"])
    v = c["valid"]
    np.testing.assert_allclose(got[:v].numpy(), ref[:v].numpy(), atol=1e-5)
    assert not got[v:].any()


# ------------------------------------------------------------------ engines


@pytest.fixture(scope="module")
def weights():
    out = {}
    for name in ("tiny", "tiny-moe"):
        jcfg = dataclasses.replace(jax_model_config(name), dtype="float32")
        jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
        out[name] = (jcfg, jp, {k: np.asarray(v) for k, v in jp.items()})
    return out


def _port(weights, name, **kw):
    _, _, npp = weights[name]
    cfg = dataclasses.replace(get_model_config(name), dtype="float32")
    return LLMEngine(cfg, EngineConfig(**{**BASE, **kw}), params=params_from_numpy(cfg, npp),
                     device="cpu")


PROMPTS = [list(range(5, 40)), list(range(50, 61)), list(range(3, 90, 2))]


@pytest.mark.parametrize("name,port_kw,jax_kw", [
    ("tiny", {"attn_impl": "reference"}, {"attn_impl": "reference"}),
    ("tiny", {"attn_impl": "auto"}, {"attn_impl": "auto"}),
    ("tiny-moe", {"moe_matmul": "einsum"}, {"moe_matmul": "einsum", "attn_impl": "reference"}),
])
def test_modes_give_the_jax_modes_tokens(weights, name, port_kw, jax_kw):
    jcfg, jp, _ = weights[name]
    je = JaxEngine(jcfg, JaxEngineConfig(**BASE, **jax_kw), params=jp)
    want = je.generate(PROMPTS, JaxSamplingParams(max_tokens=8, temperature=0.0))
    te = _port(weights, name, **port_kw)
    assert te.generate(PROMPTS, SamplingParams(max_tokens=8, temperature=0.0)) == want
    # the reference's provenance on the CPU: "auto" falls back, "reference" is chosen
    auto = port_kw.get("attn_impl", "auto") == "auto"
    assert te.stats.attn_fallback_reason == ("device=cpu" if auto else None)
    assert (je.attn_fallback_reason is not None) == (jax_kw["attn_impl"] == "auto")
    if name == "tiny-moe":
        assert te.moe_backend == "torch_reference" and te.stats.moe_dropped_tokens == 0


def test_pallas_refused_on_the_cpu_and_with_int8(weights):
    with pytest.raises(ValueError, match="attn_impl='pallas'.*CUDA"):
        _port(weights, "tiny", attn_impl="pallas")
    with pytest.raises(ValueError, match="moe_matmul='pallas'.*CUDA"):
        _port(weights, "tiny-moe", moe_matmul="pallas")
    # the reference's words, on MoE models only (a dense model has no experts)
    with pytest.raises(ValueError, match=r"moe_matmul='pallas' \(grouped GEMM, bf16-only\) "
                                         "is incompatible with quantize_weights='int8'"):
        _port(weights, "tiny-moe", moe_matmul="pallas", quantize_weights="int8")
    with pytest.raises(ValueError, match="attn_impl must be"):
        _port(weights, "tiny", attn_impl="xla")


def test_engine_reads_the_table_at_construction(weights, tmp_path, monkeypatch):
    """``attn_tune_file``, else ``LLMD_ATTN_TUNE_FILE``: the hash in the stats
    and the ``tune`` label of ``llmd_tpu:engine_attn_backend``; an engine
    without one keeps "none"."""
    path = str(tmp_path / "t.json")
    table = attn_tune.merge_and_save(path, [_entry(batch=4, ps=8, pps=32,
                                                   layout="h4x16kv4")])
    plain = _port(weights, "tiny")
    assert plain.stats.attn_tune_hash is None and plain.attn_tune_table is None
    assert 'tune="none"' in plain.registry.expose()
    eng = _port(weights, "tiny", attn_tune_file=path)
    assert eng.stats.attn_tune_hash == eng.attn_tune_hash == table.sha
    assert f'tune="{table.sha}"' in eng.registry.expose()
    monkeypatch.setenv("LLMD_ATTN_TUNE_FILE", path)
    assert _port(weights, "tiny").attn_tune_hash == table.sha
    # the table never changes what the CPU computes
    p = [list(range(5, 40))]
    sp = SamplingParams(max_tokens=6, temperature=0.0)
    assert eng.generate(p, sp) == plain.generate(p, sp)


def test_bench_serves_modes_and_the_table(tmp_path, capsys):
    """The port bench at ``--tiny --cpu`` with ``--attn-impl reference`` and a
    table: the JSON carries the table's hash and no fallback reason."""
    from llmd_tpu_torch.tools import bench

    path = str(tmp_path / "t.json")
    table = attn_tune.merge_and_save(path, [_entry()])
    assert bench.main(["--tiny", "--cpu", "--attn-impl", "reference",
                       "--attn-tune-file", path]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["attn_tune_hash"] == table.sha and row["attn_fallback_reason"] is None
    assert row["attn_impl"] == "reference" and row["attn_backend"] == "torch_reference"
