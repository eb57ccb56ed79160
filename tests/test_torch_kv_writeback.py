"""The durable tier, the remote store and the connector seam in the port
against the JAX reference, on the CPU (``llmd_tpu_torch/kv/{writeback,
remote_store,connector_api}.py``; the reference's ``tests/test_kv_writeback.py``,
``test_remote_store.py`` and ``test_kv_connector.py`` are the templates).

- ``DurableStoreConfig.from_env`` (the same ``LLMD_KV_DURABLE_*`` names),
  ``verify_crc_prefix`` equal to the reference's, dtype names;
- the KVS1 frames **both ways across packages**: the port's client against
  the reference's store and the reference's client against the port's,
  f32, bf16 and fp8 blocks byte-equal; the port's store as a standalone
  process (no jax, no ml_dtypes) taking bf16 puts;
- the client's breaker (open, skip, half-open recovery, the rate path),
  jittered retries, the store's fault knobs, the queue's drop-oldest and
  its drain budget (flushed, abandoned on a hung store);
- the connector registry, save on retire with cross-engine reuse (greedy
  tokens equal to the JAX engine's with the same connector), the suffix
  after the local tiers, a failing connector never failing serving, and the
  ``remote-store`` connector across engines over TCP;
- the server: ``/drain`` flushes the resident prefix to the durable store
  and a second engine's ``do_prefix_pull`` at the durable tier injects it,
  text, ``cached_tokens`` and the durable and transfer metric families
  equal to the reference's servers after the same script.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import socket
import subprocess
import sys
import threading
import time
import zlib

import aiohttp
import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from llmd_tpu.core.request import SamplingParams as JaxSamplingParams
from llmd_tpu.engine import EngineConfig as JaxEngineConfig
from llmd_tpu.engine import LLMEngine as JaxEngine
from llmd_tpu.engine.server import EngineServer as JaxEngineServer
from llmd_tpu.kv import connector_api as jca
from llmd_tpu.kv import remote_store as jrs
from llmd_tpu.kv import writeback as jwb
from llmd_tpu.models import get_model_config as jax_model_config
from llmd_tpu.models import transformer as jt
from llmd_tpu_torch.core.kv_events import block_keys_for_tokens
from llmd_tpu_torch.core.request import SamplingParams
from llmd_tpu_torch.engine import EngineConfig, LLMEngine
from llmd_tpu_torch.engine.server import EngineServer
from llmd_tpu_torch.kv.connector_api import (
    InMemoryKVConnector,
    KVConnectorBase,
    build_kv_connector,
    register_kv_connector,
)
from llmd_tpu_torch.kv.remote_store import (
    RemoteKVConnector,
    RemoteKVStoreServer,
    StoreFaults,
    resolve_dtype,
    verify_crc_prefix,
)
from llmd_tpu_torch.kv.writeback import DurableStoreClient, DurableStoreConfig, WritebackQueue
from llmd_tpu_torch.models import get_model_config
from llmd_tpu_torch.models import transformer as tt
from tests.conftest import run_async

FP8 = torch.float8_e4m3fn
_NP = {torch.float32: np.float32, torch.bfloat16: ml_dtypes.bfloat16,
       FP8: ml_dtypes.float8_e4m3fn}
KW = dict(page_size=8, num_pages=64, max_model_len=256, max_batch_size=4, prefill_chunk=32)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blocks(n: int, seed: int = 0, dtype=torch.float32) -> torch.Tensor:
    x = torch.randn(n, 4, 8, generator=torch.Generator().manual_seed(seed)) * 50
    return x.clamp(-448, 448).to(dtype)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.uint8).numpy().view(_NP[t.dtype])


def _client(port: int, **kw) -> DurableStoreClient:
    cfg = DurableStoreConfig(host="127.0.0.1", port=port,
                             op_timeout_s=kw.pop("op_timeout_s", 1.0),
                             probe_timeout_s=kw.pop("probe_timeout_s", 0.5),
                             retries=kw.pop("retries", 0),
                             backoff_ms=1.0, backoff_max_ms=5.0, **kw)
    return DurableStoreClient(cfg)


def _dead_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ---------------------------------------------------------------- config, crc, dtypes


def test_config_from_env(monkeypatch):
    monkeypatch.delenv("LLMD_KV_DURABLE_STORE", raising=False)
    assert not DurableStoreConfig.from_env().enabled
    monkeypatch.setenv("LLMD_KV_DURABLE_STORE", "10.0.0.5:7777")
    monkeypatch.setenv("LLMD_KV_DURABLE_RETRIES", "5")
    monkeypatch.setenv("LLMD_KV_DURABLE_DRAIN_BUDGET_S", "1.5")
    monkeypatch.setenv("LLMD_KV_DURABLE_QUEUE_BLOCKS", "0")
    cfg = DurableStoreConfig.from_env()
    assert cfg.enabled and (cfg.host, cfg.port) == ("10.0.0.5", 7777)
    assert cfg.retries == 5 and cfg.drain_budget_s == 1.5 and cfg.queue_blocks == 1
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jwb.DurableStoreConfig.from_env())
    monkeypatch.setenv("LLMD_KV_DURABLE_STORE", ":7777")  # bare port: loopback
    assert DurableStoreConfig.from_env().host == "127.0.0.1"
    monkeypatch.setenv("LLMD_KV_DURABLE_STORE", "garbage")  # disabled, never a crash
    assert not DurableStoreConfig.from_env().enabled


def test_verify_crc_prefix_matches_reference():
    body = b"aaaabbbbcccc"
    crcs = [zlib.crc32(body[i:i + 4]) for i in (0, 4, 8)]
    assert verify_crc_prefix(body, 3, crcs) == 3
    assert verify_crc_prefix(body, 3, [crcs[0], 0, crcs[2]]) == 1
    assert verify_crc_prefix(body, 3, [0, crcs[1], crcs[2]]) == 0
    assert verify_crc_prefix(body, 3, None) == 3  # a store without crcs: unverified
    rng = np.random.default_rng(0)
    for _ in range(50):
        n = int(rng.integers(0, 5))
        body = rng.integers(0, 256, 4 * n, dtype=np.uint8).tobytes()
        good = [zlib.crc32(body[i * 4:(i + 1) * 4]) for i in range(n)]
        crcs = [c ^ int(rng.integers(0, 2)) for c in good]
        assert verify_crc_prefix(body, n, crcs) == jrs.verify_crc_prefix(body, n, crcs)


def test_resolve_dtype_names():
    assert resolve_dtype("float32") == torch.float32
    assert resolve_dtype("bfloat16") == torch.bfloat16
    assert resolve_dtype("float8_e4m3fn") == FP8
    with pytest.raises(TypeError):
        resolve_dtype("not_a_dtype")


# ---------------------------------------------------------------- KVS1 across packages


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, FP8], ids=str)
@pytest.mark.parametrize("way", ["port_client", "reference_client"])
def test_store_frames_compatible_both_ways(way, dtype):
    blocks = _blocks(3, dtype=dtype)
    if way == "port_client":
        srv = jrs.RemoteKVStoreServer()
        srv.start()
        cli = _client(srv.port)
        try:
            assert cli.put([1, 2, 3], blocks) == "ok"
            assert cli.probe([1, 2, 3, 99]) == 3
            n, got, outcome = cli.get([1, 2, 3])
            assert (n, outcome) == (3, "ok") and got.dtype == dtype
            assert torch.equal(got.view(torch.uint8), blocks.view(torch.uint8))
            assert srv._blocks[1][1] == str(_np(blocks).dtype)  # the reference's name
        finally:
            srv.stop()
    else:
        srv = RemoteKVStoreServer()
        srv.start()
        cli = jwb.DurableStoreClient(jwb.DurableStoreConfig(
            host="127.0.0.1", port=srv.port, op_timeout_s=1.0, retries=0))
        try:
            assert cli.put([1, 2, 3], _np(blocks)) == "ok"
            assert cli.probe([1, 2, 3, 99]) == 3
            n, got, outcome = cli.get([1, 2, 3])
            assert (n, outcome) == (3, "ok") and got.dtype == _np(blocks).dtype
            assert got.tobytes() == _np(blocks).tobytes()
        finally:
            srv.stop()


def test_standalone_store_takes_bf16_without_ml_dtypes():
    """The port's store CLI as its own process: no jax, no ml_dtypes import."""
    port = _dead_port()
    code = ("import sys\n"
            "class B:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('jax', 'jaxlib', 'ml_dtypes', 'llmd_tpu'):\n"
            "            raise ImportError(name)\n"
            "sys.meta_path.insert(0, B())\n"
            "from llmd_tpu_torch.kv.remote_store import main\n"
            f"sys.argv = ['x', '--host', '127.0.0.1', '--port', '{port}']\n"
            "main()\n")
    proc = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        assert "remote KV store" in proc.stdout.readline()
        cli = _client(port, op_timeout_s=5.0)
        arr = _blocks(3, dtype=torch.bfloat16)
        assert cli.put([1, 2, 3], arr) == "ok"
        n, got, outcome = cli.get([1, 2, 3])
        assert (n, outcome) == (3, "ok") and torch.equal(got, arr)
    finally:
        proc.kill()
        proc.wait(10)


# ---------------------------------------------------------------- the client


def test_client_crc_truncates_to_verified_prefix():
    srv = RemoteKVStoreServer()
    srv.start()
    try:
        cli = _client(srv.port)
        assert cli.put([1, 2, 3], _blocks(3)) == "ok"
        blob, d, sh, crc = srv._blocks[2]
        srv._blocks[2] = (blob, d, sh, crc ^ 1)
        n, got, outcome = cli.get([1, 2, 3])
        assert (n, outcome) == (1, "corrupt")
        assert torch.equal(got, _blocks(3)[:1]) and cli.stats["corrupt"] == 1
    finally:
        srv.stop()


def test_breaker_opens_skips_and_recovers():
    srv = RemoteKVStoreServer()
    srv.start()
    dead = _dead_port()
    try:
        cli = _client(dead, breaker_failures=2, breaker_cooldown_s=0.2)
        assert cli.probe([1]) == 0
        assert cli.probe([1]) == 0  # the second consecutive failure trips
        assert cli.breaker_state() == 1.0 and cli.stats["breaker_trips"] == 1
        assert cli.get([1]) == (0, None, "breaker_open")
        assert cli.put([1], _blocks(1)) == "breaker_open"
        assert cli.stats["breaker_skips"] >= 2
        time.sleep(0.25)  # cooldown: a half-open trial against a live store closes
        cli.cfg.port = srv.port
        assert cli.probe([1]) == 0
        assert cli.breaker_state() == 0.0
        cli.cfg.port = dead
        cli.probe([1])
        cli.probe([1])
        assert cli.breaker_state() == 1.0
        time.sleep(0.25)
        cli.probe([1])  # a failing half-open trial re-opens at once
        assert cli.breaker_state() == 1.0
    finally:
        srv.stop()


def test_breaker_rate_path_and_jittered_retries():
    cli = _client(1, breaker_failures=1000, breaker_window=10,
                  breaker_failure_rate=0.5, breaker_min_volume=4)
    for ok in (True, True, False):
        cli._record(ok)
    assert cli.breaker_state() == 0.0  # below min volume
    cli._record(False)
    assert cli.breaker_state() == 1.0
    cli = _client(_dead_port(), retries=2, breaker_failures=100)
    t0 = time.monotonic()
    assert cli.get([1]) == (0, None, "error")
    assert time.monotonic() - t0 < 2.0 and cli.stats["errors"] == 3
    for attempt in range(6):
        assert 0.0 <= cli._jitter_s(attempt) <= 0.005


def test_store_fault_knobs():
    srv = RemoteKVStoreServer()
    srv.start()
    try:
        cli = _client(srv.port, breaker_failures=100)
        assert cli.put([7, 8], _blocks(2, seed=1)) == "ok"
        with pytest.raises(AttributeError):
            srv.set_faults(not_a_knob=1.0)
        srv.set_faults(error_rate=1.0)
        assert cli.put([9], _blocks(1)) == "error"
        assert cli.get([7]) == (0, None, "error")
        srv.set_faults(error_rate=0.0, connect_refuse=True)
        assert cli.probe([7]) == 0
        srv.set_faults(connect_refuse=False, hangup_rate=1.0)
        assert cli.get([7, 8])[2] == "error"  # payload cut mid-frame
        srv.set_faults(hangup_rate=0.0, corrupt_payload=True)
        assert cli.get([7, 8]) == (0, None, "corrupt")
        srv.set_faults(corrupt_payload=False, first_byte_delay_s=0.02)
        n, got, outcome = cli.get([7, 8])
        assert (n, outcome) == (2, "ok") and torch.equal(got, _blocks(2, seed=1))
        assert all(srv.fault_counts[k] >= 1
                   for k in ("errors", "refused", "hangups", "corrupted"))
        assert StoreFaults().error_rate == 0.0  # defaults inert
    finally:
        srv.stop()


# ---------------------------------------------------------------- the queue


class _StubClient:
    """Duck-typed store client: records puts, optional gate and outcome."""

    def __init__(self, outcome="ok"):
        self.cfg = DurableStoreConfig(host="x", port=1, op_timeout_s=0.2)
        self.puts = []
        self.outcome = outcome
        self.gate = None
        self.started = threading.Event()

    def put(self, hashes, blocks, timeout=None, retries=None):
        self.started.set()
        if self.gate is not None:
            self.gate.wait(5.0)
        self.puts.append((list(hashes), timeout, retries))
        return self.outcome(timeout) if callable(self.outcome) else self.outcome


def test_queue_flushes_async_and_drops_oldest():
    cli = _StubClient()
    cli.gate = threading.Event()
    events = []
    q = WritebackQueue(cli, max_blocks=4, on_flush=lambda o, n: events.append((o, n)))
    try:
        arr = _blocks(2)
        q.offer([1, 2], arr)
        assert cli.started.wait(2.0)  # the worker holds [1, 2]
        for hs in ([3, 4], [5, 6], [7, 8]):
            q.offer(hs, arr)  # depth 6 > 4: the oldest queued entry drops
        assert q.counts["dropped"] == 2 and q.depth() == 4 and ("dropped", 2) in events
        cli.gate.set()
        deadline = time.monotonic() + 5.0
        while q.counts["ok"] < 6 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert q.counts["ok"] == 6 and q.counts["error"] == 0
        assert sorted(h for hs, _t, _r in cli.puts for h in hs) == [1, 2, 5, 6, 7, 8]
    finally:
        cli.gate.set()
        q.stop()


@pytest.mark.parametrize("store", ["live", "hung"])
def test_flush_for_drain_budget(store):
    hung = store == "hung"
    cli = _StubClient(outcome=(lambda t: (time.sleep(min(t or 0.2, 2.0)), "error")[1])
                      if hung else "ok")
    events = []
    q = WritebackQueue(cli, max_blocks=64, on_flush=lambda o, n: events.append((o, n)))
    try:
        cli.gate = threading.Event()
        q.offer([99], _blocks(1))  # parked in the worker, not the queue
        assert cli.started.wait(2.0)
        gate, cli.gate = cli.gate, None
        for i in range(6 if hung else 2):
            q.offer([10 + 2 * i, 11 + 2 * i], _blocks(2))
        t0 = time.monotonic()
        flushed, abandoned = q.flush_for_drain(0.5 if hung else 5.0)
        elapsed = time.monotonic() - t0
        gate.set()
        if hung:  # the budget holds: every block that did not land is abandoned
            assert (flushed, abandoned) == (0, 12) and q.counts["abandoned"] == 12
            assert elapsed < 1.5 and q.depth() == 0
            assert ("abandoned", 12) in events
        else:
            assert (flushed, abandoned) == (4, 0)
            assert all(r == 0 and t is not None and t <= 5.0 for _h, t, r in cli.puts[-2:])
    finally:
        q.stop()
    assert q.offer([1], _blocks(1)) is False  # a stopped queue refuses offers


# ---------------------------------------------------------------- connectors


@functools.cache
def _weights(model: str = "tiny"):
    jcfg = dataclasses.replace(jax_model_config(model), dtype="float32")
    tcfg = dataclasses.replace(get_model_config(model), dtype="float32")
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, {k: np.asarray(v) for k, v in jp.items()}


def _eng(**kw) -> LLMEngine:
    _, tcfg, _, npp = _weights()
    return LLMEngine(tcfg, EngineConfig(**KW, **kw), params=tt.params_from_numpy(tcfg, npp),
                     device="cpu")


def _jax_eng(**kw) -> JaxEngine:
    jcfg, _, jp, _ = _weights()
    return JaxEngine(jcfg, JaxEngineConfig(**KW, **kw, attn_impl="reference"), params=jp)


def _run(eng, rid, prompt, n=4):
    sp = (JaxSamplingParams if isinstance(eng, JaxEngine) else SamplingParams)(
        max_tokens=n, temperature=0.0, ignore_eos=True)
    eng.add_request(rid, list(prompt), sp)
    out = []
    while eng.has_work():
        for o in eng.step():
            if o.request_id == rid:
                out.extend(o.new_token_ids)
    if eng._connector_pool is not None:  # barrier: retire-time saves are async
        eng._connector_pool.submit(lambda: None).result()
    return out


def test_registry_unknown_name():
    with pytest.raises(KeyError):
        build_kv_connector("no-such-engine")
    assert isinstance(build_kv_connector("remote-store", {"port": 1}), RemoteKVConnector)


def test_save_on_retire_and_cross_engine_reuse():
    prompt = list(range(40, 40 + 33))  # 4 full blocks at page size 8
    eng1 = _eng(kv_connector="in-memory")
    ptr = eng1.cache.data_ptr()
    out1 = _run(eng1, "a", prompt)
    conn: InMemoryKVConnector = eng1.kv_connector
    assert conn.stats["saved_blocks"] >= 4
    eng2 = _eng(kv_connector="in-memory")  # fresh pool, the same external store
    eng2.kv_connector = conn
    prefill0 = eng2.stats.total_prefill_tokens
    out2 = _run(eng2, "b", prompt)
    assert conn.stats["loaded_blocks"] >= 4
    assert eng2.stats.total_prefill_tokens - prefill0 == 1  # only the last token
    assert out2 == out1 and eng1.cache.data_ptr() == ptr
    # the JAX engine through its own in-memory connector: the same tokens
    j1 = _jax_eng(kv_connector="in-memory")
    assert _run(j1, "a", prompt) == out1
    j2 = _jax_eng(kv_connector="in-memory")
    j2.kv_connector = j1.kv_connector
    assert _run(j2, "b", prompt) == out2
    assert j1.kv_connector.stats == conn.stats


def test_connector_covers_suffix_after_local_tiers():
    class CountingConnector(KVConnectorBase):
        def __init__(self, params=None):
            super().__init__(params)
            self.asked: list[int] = []
            self.inner = InMemoryKVConnector()

        def get_num_matched_blocks(self, hashes):
            self.asked.append(len(hashes))
            return self.inner.get_num_matched_blocks(hashes)

        def load_blocks(self, *a, **kw):
            return self.inner.load_blocks(*a, **kw)

        def save_blocks(self, *a, **kw):
            return self.inner.save_blocks(*a, **kw)

    register_kv_connector("counting", CountingConnector)
    eng = _eng(kv_connector="counting")
    prompt = list(range(10, 10 + 33))
    _run(eng, "a", prompt)
    asked_first = list(eng.kv_connector.asked)
    _run(eng, "b", prompt)  # HBM covers the reusable blocks now
    later = eng.kv_connector.asked[len(asked_first):]
    assert not later or max(later) <= max(asked_first)


def test_connector_failure_never_fails_serving():
    class ExplodingConnector(KVConnectorBase):
        def get_num_matched_blocks(self, hashes):
            return 0

        def save_blocks(self, *a, **kw):
            raise RuntimeError("external engine down")

    register_kv_connector("exploding", ExplodingConnector)
    jca.register_kv_connector("exploding", lambda p=None: _JaxExploding(p))
    prompt = list(range(50, 80))
    out = _run(_eng(kv_connector="exploding"), "a", prompt)
    assert len(out) == 4
    assert out == _run(_jax_eng(kv_connector="exploding"), "a", prompt)


class _JaxExploding(jca.KVConnectorBase):
    def get_num_matched_blocks(self, hashes):
        return 0

    def save_blocks(self, *a, **kw):
        raise RuntimeError("external engine down")


def test_remote_store_connector_across_engines():
    """KV computed by one port engine feeds another's admission through the
    reference's store; a dead store never fails serving."""
    srv = jrs.RemoteKVStoreServer()
    srv.start()
    try:
        params = {"host": srv.host, "port": srv.port}
        prompt = list(range(40, 40 + 33))
        out1 = _run(_eng(kv_connector="remote-store", kv_connector_params=params), "a", prompt)
        assert srv.stats["puts"] >= 1
        out2 = _run(_eng(kv_connector="remote-store", kv_connector_params=params), "b", prompt)
        assert srv.stats["hit_blocks"] >= 4 and out2 == out1
    finally:
        srv.stop()
    dead = {"host": "127.0.0.1", "port": _dead_port(), "timeout_s": 0.2,
            "probe_timeout_s": 0.2}
    assert _run(_eng(kv_connector="remote-store", kv_connector_params=dead), "c",
                prompt) == out1


# ---------------------------------------------------------------- the server's durable rung


_FAMILIES = ("llmd_tpu:kv_durable_flush_total", "llmd_tpu:kv_durable_get_total",
             "llmd_tpu:kv_durable_queue_depth", "llmd_tpu:kv_durable_breaker_state",
             "llmd_tpu:kv_transfer_injected_blocks_total",
             "llmd_tpu:kv_transfer_pull_failures_total",
             "llmd_tpu:kv_transfer_prefix_pulls_total",
             "llmd_tpu:kv_transfer_prefix_pull_blocks_total",
             "llmd_tpu:kv_transfer_prefix_pull_seconds_count",
             "llmd_tpu:kv_transfer_registrations")


def _families(text: str) -> dict:
    out = {}
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        name, _, value = line.rpartition(" ")
        if name.split("{")[0] in _FAMILIES:
            out[name] = float(value)
    return out


async def _durable_script(make) -> dict:
    """Engine 1 serves a prompt and drains (its prefix goes to the store);
    engine 2 pulls that prefix from the durable tier before its prefill."""
    prompt = "the durable tier keeps a prefix alive after its replica retires, twice over"
    body = {"prompt": prompt, "max_tokens": 6, "temperature": 0.0, "ignore_eos": True}
    one, two = make(), make()
    for s in (one, two):
        await s.start() if isinstance(s, JaxEngineServer) else s.start()
    out: dict = {}
    try:
        async with aiohttp.ClientSession() as sess:
            async with sess.post(f"http://{one.address}/v1/completions", json=body) as r:
                out["first"] = (await r.json())["choices"][0]["text"]
            async with sess.post(f"http://{one.address}/drain?timeout_s=5", json={}) as r:
                out["drain"] = r.status
            hashes = block_keys_for_tokens(list(prompt.encode()), 8)
            async with sess.post(f"http://{two.address}/v1/completions", json={
                    **body, "kv_transfer_params": {"do_prefix_pull": True, "tier": "durable",
                                                   "block_hashes": hashes}}) as r:
                got = await r.json()
            out["second"] = got["choices"][0]["text"]
            out["cached"] = got["usage"]["cached_tokens"]
            for name, s in (("one", one), ("two", two)):
                async with sess.get(f"http://{s.address}/metrics") as r:
                    out[name] = _families(await r.text())
    finally:
        for s in (one, two):
            await s.stop() if isinstance(s, JaxEngineServer) else s.stop()
    return out


def test_drain_flush_and_durable_prefix_pull_match_reference(monkeypatch):
    srv = RemoteKVStoreServer()
    srv.start()
    jsrv = jrs.RemoteKVStoreServer()
    jsrv.start()
    jcfg, tcfg, jp, npp = _weights()
    try:
        monkeypatch.setenv("LLMD_KV_DURABLE_STORE", f"127.0.0.1:{srv.port}")
        port = run_async(_durable_script(lambda: EngineServer(
            tcfg, EngineConfig(**KW), model_name="m", host="127.0.0.1", port=0,
            params=tt.params_from_numpy(tcfg, npp), device="cpu")))
        monkeypatch.setenv("LLMD_KV_DURABLE_STORE", f"127.0.0.1:{jsrv.port}")
        ref = run_async(_durable_script(lambda: JaxEngineServer(
            jcfg, JaxEngineConfig(**KW, attn_impl="reference"), model_name="m",
            host="127.0.0.1", port=0, params=jp)))
    finally:
        srv.stop()
        jsrv.stop()
    assert port["drain"] == 200 and port["first"] == port["second"]
    assert port["cached"] == 9 * 8  # the durable rung served the reusable prefix
    assert port["one"]['llmd_tpu:kv_durable_flush_total{outcome="ok"}'] > 0
    assert port["two"]['llmd_tpu:kv_durable_get_total{outcome="ok"}'] == 1
    for key in ("first", "second", "cached", "drain", "one", "two"):
        assert port[key] == ref[key], key
