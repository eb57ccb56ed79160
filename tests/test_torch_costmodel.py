"""The port's cost model and utilization ledger (``llmd_tpu_torch/obs/costmodel.py``)
against the reference's (``llmd_tpu/obs/costmodel.py``), on the CPU.

Every function of the analytic model equals the reference's on every
registry config; the ledger's arithmetic equals the reference ledger's on the
same records (fake clock); the peak table holds the H100 under its
``torch.cuda.get_device_name()`` and nothing else, with the
``LLMD_UTIL_PEAKS_FILE`` overlay; and the goodput classes the port's engine
records over a run equal those the reference engine records over the same
run (float32 ``tiny``, prefix-cache hits and preemption by recompute), the
unified program's padding apart: the reference runs that program on its
padded token budget (``batched_tokens`` slots a step), the port on exactly
its real tokens, so the port's unified padding is 0 and the reference's is
the budget minus the real tokens of each step.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest

from llmd_tpu.core.request import SamplingParams as JaxSamplingParams
from llmd_tpu.engine import EngineConfig as JaxEngineConfig
from llmd_tpu.engine import LLMEngine as JaxEngine
from llmd_tpu.models import get_model_config as jax_model_config
from llmd_tpu.models import transformer as jt
from llmd_tpu.obs import costmodel as jcm
from llmd_tpu_torch.core.request import SamplingParams
from llmd_tpu_torch.engine import EngineConfig, LLMEngine
from llmd_tpu_torch.models import MODEL_REGISTRY, get_model_config
from llmd_tpu_torch.models import transformer as tt
from llmd_tpu_torch.obs import costmodel as tcm

H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("name", sorted(MODEL_REGISTRY))
def test_analytic_model_matches_reference(name):
    tcfg, jcfg = get_model_config(name), jax_model_config(name)
    for fn in ("param_count", "active_param_count", "flops_per_token",
               "moe_comm_bytes_per_token"):
        assert getattr(tcm, fn)(tcfg) == getattr(jcm, fn)(jcfg), fn
    for q in (None, "int8"):
        assert tcm.bytes_per_param(tcfg, q) == jcm.bytes_per_param(jcfg, q)
        assert tcm.weight_bytes(tcfg, q) == jcm.weight_bytes(jcfg, q)
    for kv in (None, "fp8"):
        assert tcm.kv_bytes_per_token(tcfg, kv) == jcm.kv_bytes_per_token(jcfg, kv)
    for kw in (dict(slot_tokens=64), dict(slot_tokens=256, weight_passes=8,
                                          kv_read_tokens=4096, kv_write_tokens=32),
               dict(slot_tokens=7, kv_read_tokens=-3, quantize_weights="int8",
                    kv_cache_dtype="fp8")):
        assert (dataclasses.asdict(tcm.dispatch_cost(tcfg, **kw))
                == dataclasses.asdict(jcm.dispatch_cost(jcfg, **kw))), kw
    assert tcm.GOODPUT_KINDS == jcm.GOODPUT_KINDS


def test_chip_peaks_table_and_overlay(tmp_path, monkeypatch):
    monkeypatch.delenv("LLMD_UTIL_PEAKS_FILE", raising=False)
    assert tcm.chip_peaks(H100) == (989.0, 3350.0)
    # an unknown device gives no peak, never a guessed one
    for kind in ("cpu", "", "NVIDIA A100-SXM4-80GB", "TPU v5 lite"):
        assert tcm.chip_peaks(kind) == (None, None)
    assert tcm.chip_peaks("cpu", default=(1.0, 2.0)) == (1.0, 2.0)
    f = tmp_path / "peaks.json"
    f.write_text(json.dumps({"NVIDIA H200": [989.0, 4800.0], H100: [900, 3000]}))
    monkeypatch.setenv("LLMD_UTIL_PEAKS_FILE", str(f))
    assert tcm.chip_peaks("NVIDIA H200") == (989.0, 4800.0)
    assert tcm.chip_peaks(H100) == (900.0, 3000.0)
    f.write_text("{not json")  # a malformed file keeps the builtin table
    assert tcm.chip_peaks(H100) == (989.0, 3350.0)
    f.write_text(json.dumps({"x": "bad"}))
    assert tcm.chip_peaks(H100) == (989.0, 3350.0)


def test_ledger_matches_reference_ledger():
    """The same records, a fake clock, explicit peaks: every reading equal to
    the reference ledger's, captures counted as compiles."""
    cfg_t, cfg_j = get_model_config("tiny-moe"), jax_model_config("tiny-moe")
    clock = {"t": 100.0}
    now = lambda: clock["t"]  # noqa: E731
    kw = dict(quantize_weights="int8", window_s=30.0, peaks=(989.0, 3350.0), now=now)
    lt, lj = tcm.UtilLedger(cfg_t, **kw), jcm.UtilLedger(cfg_j, **kw)
    records = [
        ("unified", dict(slot_tokens=256, kv_read_tokens=300, kv_write_tokens=200),
         0.02, dict(committed=180, preempted_recompute=20, prefix_saved=64), {"decode": 0}),
        ("decode", dict(slot_tokens=32, weight_passes=4, kv_read_tokens=900,
                        kv_write_tokens=30), 0.01, dict(committed=30), {"decode": 1}),
        ("decode", dict(slot_tokens=32, weight_passes=4), 0.01, dict(committed=40),
         {"decode": 1}),  # more than the slots: padding clamps at 0
        ("decode", dict(slot_tokens=32, weight_passes=4), 0.01, dict(committed=3),
         {"decode": 3}),  # two captures more
    ]
    for prog, cost_kw, dur, tokens, compiles in records:
        clock["t"] += 5.0
        for led in (lt, lj):
            led.record(prog, led.cost(prog, **cost_kw), dur, compile_counts=compiles,
                       **tokens)
    clock["t"] += 1.0
    assert lt.totals() == lj.totals()
    assert lt.programs() == lj.programs()
    for prog in ("unified", "decode", "absent"):
        assert lt.fractions(prog) == pytest.approx(lj.fractions(prog))
        assert lt.padding_efficiency(prog) == lj.padding_efficiency(prog)
        assert lt.achieved(prog) == pytest.approx(lj.achieved(prog))
        assert lt.mfu(prog) == pytest.approx(lj.mfu(prog))
        assert lt.mbu(prog) == pytest.approx(lj.mbu(prog))
    assert lt.moe_comm_total() == lj.moe_comm_total() > 0
    assert lt.compiles() == dict(lj.compiles()) == {"decode": 3}
    assert lt.recompiles() == lj.recompiles() == 2
    clock["t"] += 60.0  # past the window: no achieved rate
    assert lt.achieved("decode") == lj.achieved("decode") == (None, None)
    nopeak = tcm.UtilLedger(cfg_t, peaks=(None, None))
    nopeak.record("decode", nopeak.cost("decode", slot_tokens=8), 0.01, committed=8)
    assert nopeak.mfu("decode") is None and nopeak.mbu("decode") is None


def test_ledger_switch(monkeypatch):
    for v, on in (("0", False), ("off", False), ("false", False), ("", False),
                  ("1", True), ("yes", True)):
        monkeypatch.setenv("LLMD_UTIL_LEDGER", v)
        assert tcm.util_ledger_enabled() is on is jcm.util_ledger_enabled()
    monkeypatch.setenv("LLMD_UTIL_LEDGER", "off")
    eng = LLMEngine(get_model_config("tiny"), EngineConfig(), device="cpu")
    assert eng.util is None
    eng.generate([[1, 2, 3]], SamplingParams(max_tokens=3, temperature=0.0))
    monkeypatch.delenv("LLMD_UTIL_LEDGER")
    assert LLMEngine(get_model_config("tiny"), EngineConfig(), device="cpu").util is not None


BASE = dict(page_size=8, max_model_len=256, max_batch_size=2, prefill_chunk=32,
            decode_steps=4)


@pytest.mark.parametrize("case", ["prefix", "preempt"])
def test_goodput_totals_match_reference_engine(case):
    """The same requests through both engines: every goodput class of the
    decode program equal, and of the unified program committed, preempted
    recompute and prefix-saved equal; the unified padding is the port's 0
    against the reference's padded budget."""
    jcfg = dataclasses.replace(jax_model_config("tiny"), dtype="float32")
    tcfg = dataclasses.replace(get_model_config("tiny"), dtype="float32")
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    kw = dict(BASE, num_pages=64, enable_prefix_caching=True) if case == "prefix" else \
        dict(BASE, num_pages=10, enable_prefix_caching=False)
    je = JaxEngine(jcfg, JaxEngineConfig(**kw, attn_impl="reference"), params=jp)
    te = LLMEngine(tcfg, EngineConfig(**kw),
                   params=tt.params_from_numpy(tcfg, {k: np.asarray(v) for k, v in jp.items()}),
                   device="cpu")
    if case == "prefix":
        shared = list(range(1, 41))  # 5 full pages of 8
        waves = [[shared + [60, 61]], [shared + [70], shared + [71, 72, 73]]]
        n = 6
    else:
        waves = [[list(range(1, 30)), list(range(60, 95))]]
        n = 16
    for eng, sp in ((je, JaxSamplingParams), (te, SamplingParams)):
        for prompts in waves:  # the second wave hits the first's cached pages
            eng.generate(prompts, sp(max_tokens=n, temperature=0.0))
    rt, rj = te.util.totals(), je.util.totals()
    assert set(rt) == {"unified", "decode"} and set(rj) >= set(rt)
    assert rt["decode"] == rj["decode"]
    for kind in ("committed", "spec_rejected", "preempted_recompute", "prefix_saved"):
        assert rt["unified"][kind] == rj["unified"][kind], kind
    assert rt["unified"]["padding"] == 0
    budget = je.cfg.batched_tokens * je.stats.n_unified_steps
    assert rj["unified"]["padding"] == budget - rj["unified"]["committed"] - rj[
        "unified"]["preempted_recompute"]
    if case == "prefix":
        assert rt["unified"]["prefix_saved"] == 2 * 40
    else:
        assert te.stats.total_preemptions > 0 and rt["unified"]["preempted_recompute"] > 0
    assert te.util.recompiles() == 0 and te.util.compiles() == {}  # the CPU captures nothing
