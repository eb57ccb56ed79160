"""The KV offload tiers in the port against the JAX reference, on the CPU
(``llmd_tpu_torch/kv/{fs_backend,offload}.py`` against ``llmd_tpu/kv/``; the
reference's ``tests/test_kv_offload.py`` is the template).

- the FS tier: round trips, the directory as the index, the evictor, and
  **files cross-readable both ways** in f32, bf16 and fp8 (a JAX pod and a
  port pod share an ``offload_fs_path``), byte-equal files;
- the CPU store: LRU demotion to FS with the reference's KV events;
- the engine: prompt A evicted to the CPU (then FS) tier under pool pressure
  and rerun, on tiny and tiny-mla, with the FS tier, and over an fp8 pool,
  against the JAX engine under the same ``EngineConfig``: greedy tokens,
  ``total_offload_loads``, prefill tokens, the offload counters and metric
  families, and the KV-event stream (``medium`` included) all equal; the
  reload writes the pool in place (``data_ptr`` unchanged).
"""

import dataclasses
import functools
import os
import time

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from llmd_tpu.core.request import SamplingParams as JaxSamplingParams
from llmd_tpu.engine import EngineConfig as JaxEngineConfig
from llmd_tpu.engine import LLMEngine as JaxEngine
from llmd_tpu.kv.fs_backend import FSKVBackend as JaxFS
from llmd_tpu.models import get_model_config as jax_model_config
from llmd_tpu.models import transformer as jt
from llmd_tpu_torch.core.kv_events import MEDIUM_CPU, MEDIUM_FS
from llmd_tpu_torch.core.request import SamplingParams
from llmd_tpu_torch.engine import EngineConfig, LLMEngine
from llmd_tpu_torch.kv.fs_backend import FSKVBackend
from llmd_tpu_torch.kv.offload import CPUOffloadStore
from llmd_tpu_torch.models import get_model_config
from llmd_tpu_torch.models import transformer as tt

FP8 = torch.float8_e4m3fn
_NP = {torch.float32: np.float32, torch.bfloat16: ml_dtypes.bfloat16,
       FP8: ml_dtypes.float8_e4m3fn}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- FS backend


def test_fs_backend_roundtrip_and_scan(tmp_path):
    fs = FSKVBackend(str(tmp_path))
    arr = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    fs.put(-12345, arr)
    fs.put(99, arr * 2)
    assert torch.equal(fs.get(-12345), arr)
    assert fs.contains(99) and not fs.contains(7)
    assert sorted(fs.scan()) == [-12345, 99]
    assert fs.get(7) is None
    fs.close()


def _block(dtype):
    x = torch.randn(2, 4, 2, 5, generator=torch.Generator().manual_seed(1)) * 100
    return x.clamp(-448, 448).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, FP8], ids=str)
def test_fs_files_cross_readable(tmp_path, dtype):
    block = _block(dtype)
    raw = block.view(torch.uint8).numpy().view(_NP[dtype])
    ours, theirs = FSKVBackend(str(tmp_path / "a")), JaxFS(str(tmp_path / "b"))
    ours.put(7, block)
    theirs.put(7, raw)
    with open(ours._path(7), "rb") as f, open(theirs._path(7), "rb") as g:
        assert f.read() == g.read()  # the same file, byte for byte
    # each side reads the other's file
    got_ref = JaxFS(str(tmp_path / "a")).get(7)
    assert got_ref.dtype == raw.dtype and got_ref.tobytes() == raw.tobytes()
    got_port = FSKVBackend(str(tmp_path / "b")).get(7)
    assert got_port.dtype == dtype
    assert torch.equal(got_port.view(torch.uint8), block.view(torch.uint8))


def test_fs_backend_evictor(tmp_path):
    fs = FSKVBackend(str(tmp_path))
    for i in range(6):
        fs.put(i, torch.zeros(1000))
        # mtime-ordered eviction needs distinct mtimes
        os.utime(fs._path(i), (time.time() - 100 + i, time.time() - 100 + i))
    per_block = fs.total_bytes() // 6
    evicted = fs.evict_to_bytes(3 * per_block)
    assert sorted(evicted) == [0, 1, 2]  # oldest first
    assert sorted(fs.scan()) == [3, 4, 5]
    fs.close()


# ---------------------------------------------------------------- CPU store


def test_cpu_store_lru_demotes_to_fs(tmp_path):
    events = []
    fs = FSKVBackend(str(tmp_path))
    store = CPUOffloadStore(capacity_blocks=2, fs_backend=fs,
                            event_sink=lambda evs: events.extend(evs))
    a = torch.ones(4)
    for h in (1, 2, 3):
        store.put(h, a * h)
    assert len(store) == 2
    assert torch.equal(store.get(1), a)  # demoted to FS, still reachable
    assert store.contains(1) and store.demotions == 1 and store.loads == 1
    kinds = [(type(e).__name__, e.block_hashes, getattr(e, "medium", None)) for e in events]
    assert kinds == [("BlockStored", [1], MEDIUM_CPU), ("BlockStored", [2], MEDIUM_CPU),
                     ("BlockStored", [3], MEDIUM_CPU), ("BlockRemoved", [1], MEDIUM_CPU),
                     ("BlockStored", [1], MEDIUM_FS)]
    fs.close()


# ---------------------------------------------------------------- engine tiering


@functools.cache
def _weights(model: str):
    jcfg = dataclasses.replace(jax_model_config(model), dtype="float32")
    tcfg = dataclasses.replace(get_model_config(model), dtype="float32")
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, {k: np.asarray(v) for k, v in jp.items()}


def _event_key(e):
    return (type(e).__name__, list(e.block_hashes), getattr(e, "parent_block_hash", None),
            list(getattr(e, "token_ids", [])), getattr(e, "block_size", None), e.medium)


def _scenario(eng, jax_side: bool, max_tokens: int):
    """Prompt A cold, prompt B (pressure: A's pages leave HBM), A again."""
    sp = (JaxSamplingParams if jax_side else SamplingParams)(max_tokens=max_tokens,
                                                             temperature=0.0)
    a, b = list(range(1, 49)), list(range(100, 170))
    out = {"cold": eng.generate([a], sp)["req-0"]}
    eng.generate([b], sp)
    prefill_before = eng.stats.total_prefill_tokens
    eng.add_request("again", a, sp)
    got = []
    while eng.has_work():
        for o in eng.step():
            if o.request_id == "again":
                got.extend(o.new_token_ids)
    st = eng.offload.store
    out.update(again=got, loads=eng.stats.total_offload_loads,
               reprefill=eng.stats.total_prefill_tokens - prefill_before,
               store=(st.saves, st.loads, st.demotions, len(st)))
    return out


_METRICS = ("llmd_tpu:offload_hits_total", "llmd_tpu:offload_misses_total",
            "llmd_tpu:offload_evictions_total", "llmd_tpu:offload_saves_total",
            "llmd_tpu:offload_loads_total", "llmd_tpu:offload_demotions_total",
            "llmd_tpu:offload_cpu_blocks", "llmd_tpu:offload_transfer_bytes_count")


def _offload_metrics(registry) -> dict:
    return {(n, lab): v for n, lab, v in registry.collect() if n in _METRICS}


@pytest.mark.parametrize("case", ["tiny", "tiny-mla", "tiny-fs", "tiny-fp8"])
def test_engine_offload_reload_matches_reference(case, tmp_path):
    """Evict prompt A's KV to the CPU tier under pressure (FS below a 1-block
    CPU tier in ``tiny-fs``); rerunning A reloads rather than recomputes and
    gives the cold greedy tokens, and everything the two engines count and
    announce is equal."""
    model = "tiny-mla" if case == "tiny-mla" else "tiny"
    jcfg, tcfg, jp, npp = _weights(model)
    kw = dict(page_size=8, num_pages=12, max_model_len=256, max_batch_size=2,
              prefill_chunk=32, cpu_offload_pages=64)
    if case == "tiny-fs":
        kw.update(cpu_offload_pages=1)
    if case == "tiny-fp8":
        kw.update(kv_cache_dtype="fp8")
    jev, tev = [], []
    je = JaxEngine(jcfg, JaxEngineConfig(
        **kw, attn_impl="reference",
        offload_fs_path=str(tmp_path / "jax") if case == "tiny-fs" else None),
        params=jp, event_sink=jev.extend)
    te = LLMEngine(tcfg, EngineConfig(
        **kw, offload_fs_path=str(tmp_path / "port") if case == "tiny-fs" else None),
        params=tt.params_from_numpy(tcfg, npp), event_sink=tev.extend, device="cpu")
    ptr = te.cache.data_ptr()
    ref = _scenario(je, True, 6)
    got = _scenario(te, False, 6)
    assert got["again"] == got["cold"], "reloaded KV must reproduce the cold greedy output"
    assert got == ref
    assert got["loads"] > 0 and got["reprefill"] < 48
    if case == "tiny-fs":
        assert got["store"][2] > 0, "a 1-block CPU tier must demote to FS"
    assert _offload_metrics(te.registry) == _offload_metrics(je.registry)
    assert [_event_key(e) for e in tev] == [_event_key(e) for e in jev]
    assert {MEDIUM_CPU} <= {e.medium for e in tev}
    assert te.cache.data_ptr() == ptr  # every reload wrote the pool in place


def test_config_serves_the_kv_plane_fields(tmp_path):
    """The data plane's EngineConfig fields are served (each read at the
    reference's site); ``role`` is a tag the engine never reads, checked
    against the reference's three values."""
    cfg = EngineConfig(cpu_offload_pages=8, offload_fs_path=str(tmp_path),
                       offload_staging_blocks=4, offload_watermark_pages=2,
                       kv_connector="in-memory", kv_connector_params={"x": 1}, role="prefill")
    cfg.check_served()
    _, tcfg, _, npp = _weights("tiny")
    eng = LLMEngine(tcfg, dataclasses.replace(cfg, page_size=8, num_pages=16, max_model_len=128),
                    params=tt.params_from_numpy(tcfg, npp), device="cpu")
    assert eng.offload.store.capacity == 8 and eng.offload.staging_blocks == 4
    assert eng.offload.store.fs.root == str(tmp_path)
    assert eng.kv_connector.params == {"x": 1} and eng.durable is None
    with pytest.raises(ValueError, match="role"):
        EngineConfig(role="sidecar").check_served()
