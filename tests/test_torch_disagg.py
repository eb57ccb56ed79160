"""P/D disaggregation in the port against the JAX reference, on the CPU
(``llmd_tpu_torch/disagg/transfer.py`` against ``llmd_tpu/disagg/transfer.py``;
the reference's ``tests/test_disagg.py`` is the template).

- extract / insert: block-major, in place (the pool's ``data_ptr`` does not
  move), the scratch row never read nor written, f32 / bf16 / fp8 pools;
- the KVT1 wire on both transports, and **both ways across packages**: the
  port's source pulled by the reference's client and the reference's source
  pulled by the port's, headers and payloads byte-equal in f32, bf16, fp8;
- two-phase export equal to the synchronous one, an export surviving engine
  steps that recycle its pages, a stale transfer rejected;
- P/D end to end: two port ``EngineServer`` s behind the reference's
  ``RoutingSidecar`` and behind the port's (``disagg/sidecar.py``) on tiny and
  tiny-mla, text equal to an aggregated port engine and to the reference's own
  P/D pair on the same weights, with ``cached_tokens``, ``injected_blocks``,
  notifies, streaming, the dead prefiller fallback, the sidecar's ``stats``
  and the transfer metric families; the port's sidecar gives what the
  reference's gave in front of the same port engines;
- cross-package P/D at a tiny config with ``head_dim=128`` (where the
  reference's 128-lane padding is no padding): a JAX prefill engine to a
  port decode engine and back, greedy tokens equal to the JAX pair's; at
  ``head_dim=32`` the port refuses the reference's padded blocks, as the
  reference refuses a shape mismatch.
"""

import dataclasses
import functools
import json
import time

import aiohttp
import jax
import numpy as np
import pytest
import torch

from llmd_tpu.core.request import HDR_PREFILLER_HOST_PORT
from llmd_tpu.core.request import SamplingParams as JaxSamplingParams
from llmd_tpu.disagg import transfer as jtr
from llmd_tpu.disagg.sidecar import RoutingSidecar
from llmd_tpu.engine import LLMEngine as JaxEngine
from llmd_tpu.engine.config import EngineConfig as JaxEngineConfig
from llmd_tpu.engine.server import EngineServer as JaxEngineServer
from llmd_tpu.models import get_model_config as jax_model_config
from llmd_tpu.models import transformer as jt
from llmd_tpu_torch.core.kv_events import block_keys_for_tokens
from llmd_tpu_torch.core.request import SamplingParams
from llmd_tpu_torch.disagg import transfer as ttr
from llmd_tpu_torch.disagg.sidecar import RoutingSidecar as PortSidecar
from llmd_tpu_torch.engine import EngineConfig, LLMEngine
from llmd_tpu_torch.engine.server import EngineServer
from llmd_tpu_torch.models import get_model_config
from llmd_tpu_torch.models import transformer as tt
from tests.conftest import run_async

KW = dict(page_size=8, num_pages=64, max_model_len=256, max_batch_size=4, prefill_chunk=32)
PROMPT = "the quick brown fox jumps over the lazy dog and keeps on running far"
FP8 = torch.float8_e4m3fn


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _weights(model: str, head_dim: "int | None" = None):
    over = {"dtype": "float32"} | ({"head_dim": head_dim} if head_dim else {})
    jcfg = dataclasses.replace(jax_model_config(model), **over)
    tcfg = dataclasses.replace(get_model_config(model), **over)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, {k: np.asarray(v) for k, v in jp.items()}


def _port_server(model, head_dim=None, **kw) -> EngineServer:
    _, tcfg, _, npp = _weights(model, head_dim)
    return EngineServer(tcfg, EngineConfig(**KW), model_name="m", host="127.0.0.1", port=0,
                        params=tt.params_from_numpy(tcfg, npp), device="cpu", **kw)


def _jax_server(model, head_dim=None, **kw) -> JaxEngineServer:
    jcfg, _, jp, _ = _weights(model, head_dim)
    return JaxEngineServer(jcfg, JaxEngineConfig(**KW, attn_impl="reference"), model_name="m",
                           host="127.0.0.1", port=0, params=jp, **kw)


async def _start(server):
    if isinstance(server, JaxEngineServer):
        await server.start()
    else:
        server.start()


async def _stop(server):
    if isinstance(server, JaxEngineServer):
        await server.stop()
    else:
        server.stop()


# ---------------------------------------------------------------- staging


def _pool(dtype):
    """A flat pool L=2, P=6 plus the scratch row: [13, 4, 2, 3]."""
    vals = torch.arange(13 * 4 * 2 * 3, dtype=torch.float32).reshape(13, 4, 2, 3) / 7 - 20
    return vals.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, FP8], ids=str)
def test_extract_insert_roundtrip_in_place(dtype):
    cache = _pool(dtype)
    blocks = ttr.extract_blocks(cache, [1, 4], pages_per_layer=6)
    assert blocks.shape == (2, 2, 4, 2, 3) and blocks.dtype == dtype  # [n, L, ps, 2Hk, D]
    target = torch.zeros_like(cache)
    target[12].view(torch.uint8).fill_(0x5A)  # the scratch row
    ptr = target.data_ptr()
    out = ttr.insert_blocks(target, [0, 5], blocks, pages_per_layer=6)
    assert out is target and target.data_ptr() == ptr
    b = lambda t: t.view(torch.uint8)  # noqa: E731 — byte view
    for l in range(2):
        assert torch.equal(b(target[l * 6 + 0]), b(cache[l * 6 + 1]))
        assert torch.equal(b(target[l * 6 + 5]), b(cache[l * 6 + 4]))
        assert (b(target[l * 6 + 2]) == 0).all()
    assert (b(target[12]) == 0x5A).all()  # no page write reaches the scratch row
    # page id -1 (padding) goes to the scratch row and nowhere else
    ttr.insert_blocks(target, [-1], blocks[:1], pages_per_layer=6)
    assert torch.equal(b(out[:12]), b(target[:12]))
    # and the reference's layout is the same: [n, L, ...] from [L*P, ...]
    ref = jtr.extract_blocks(np.asarray(cache[:12].float()), [1, 4], pages_per_layer=6)
    np.testing.assert_array_equal(ref, blocks.float().numpy())


def test_insert_wider_blocks_into_fp8_pool_clamps():
    cache = torch.zeros(13, 4, 2, 3, dtype=FP8)
    blocks = torch.full((1, 2, 4, 2, 3), 1000.0)
    blocks[0, 0, 0, 0, 0] = -1e6
    ttr.insert_blocks(cache, [3], blocks, pages_per_layer=6)
    assert cache[3].float().max() == 448 and cache[3].float().min() == -448
    assert not torch.isnan(cache.float()).any()


# ---------------------------------------------------------------- the wire


def _native_or_skip():
    from llmd_tpu_torch.native.build import BuildError, load_host

    try:
        load_host("kv_transfer")
    except BuildError as e:
        pytest.skip(f"g++ build unavailable: {e}")


@pytest.mark.parametrize("transport", ["python", "native"])
def test_transfer_pull_and_notify(transport):
    if transport == "native":
        _native_or_skip()
    src = ttr.KVTransferSource(host="127.0.0.1", transport=transport)
    src.start()
    try:
        blocks = torch.arange(2 * 3 * 2 * 4 * 2 * 3, dtype=torch.float32).reshape(2, 3, 2, 4, 2, 3)
        src.register("req-1", [11, 22], [[1, 2], [3, 4]], blocks)
        cli = ttr.KVTransferClient(timeout_s=5)
        pulled = cli.pull("127.0.0.1", src.port, "req-1")
        assert pulled.block_hashes == [11, 22] and pulled.token_chunks == [[1, 2], [3, 4]]
        assert torch.equal(pulled.blocks, blocks)
        assert cli.pull("127.0.0.1", src.port, "nope") is None  # a miss, not an error
        assert cli.notify("127.0.0.1", src.port, "req-1")
        assert len(src) == 0
        assert src.stats["pulls"] == 1 and src.stats["notifies"] == 1
        assert src.stats["misses"] == 1 and src.stats["exports"] == 1
        assert (src.native is not None) == (transport == "native")
    finally:
        src.stop()


@pytest.mark.parametrize("transport", ["python", "native"])
def test_ttl_reaper_frees_abandoned_exports(transport):
    if transport == "native":
        _native_or_skip()
    src = ttr.KVTransferSource(host="127.0.0.1", transport=transport, ttl_s=0.2)
    src.start()
    try:
        src.register("gone", [1], [[1]], torch.zeros(1, 2, 2))
        deadline = time.monotonic() + 5.0
        while len(src) and time.monotonic() < deadline:
            time.sleep(0.02)
        assert len(src) == 0 and src.stats["expired"] == 1
    finally:
        src.stop()


@pytest.mark.parametrize("transport", ["python", "native"])
def test_concurrent_pulls_and_notifies(transport):
    """More pulling threads than cores, a short switch interval: every export
    pulled and released exactly once, the counters consistent."""
    import sys
    import threading

    if transport == "native":
        _native_or_skip()
    src = ttr.KVTransferSource(host="127.0.0.1", transport=transport)
    src.start()
    n = 48
    blocks = [torch.full((1, 2, 4, 2, 3), float(i)) for i in range(n)]
    for i in range(n):
        src.register(f"r{i}", [i], [[i]], blocks[i])
    bad: list = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def worker(ids):
            cli = ttr.KVTransferClient(timeout_s=10)
            for i in ids:
                got = cli.pull("127.0.0.1", src.port, f"r{i}")
                if got is None or not torch.equal(got.blocks, blocks[i]):
                    bad.append(i)
                cli.notify("127.0.0.1", src.port, f"r{i}")

        threads = [threading.Thread(target=worker, args=(range(k, n, 16),)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert not bad
        assert src.stats["pulls"] == n and src.stats["notifies"] == n
        assert src.stats["misses"] == 0 and len(src) == 0
    finally:
        sys.setswitchinterval(old)
        src.stop()


def test_native_source_is_the_reference_copy():
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    assert ((root / "llmd_tpu_torch" / "csrc" / "kv_transfer.cpp").read_bytes()
            == (root / "csrc" / "kv_transfer.cpp").read_bytes())


def test_native_transport_raises_without_build(monkeypatch):
    from llmd_tpu_torch.native import build

    def fail(name):
        raise build.BuildError("no compiler")

    monkeypatch.setattr(build, "load_host", fail)
    with pytest.raises(RuntimeError, match="native kv_transfer transport unavailable"):
        ttr.KVTransferSource(host="127.0.0.1", transport="native").start()
    src = ttr.KVTransferSource(host="127.0.0.1", transport="auto")  # auto falls back
    src.start()
    try:
        assert src.native is None
    finally:
        src.stop()


def _payload(dtype):
    g = torch.Generator().manual_seed(3)
    x = torch.randn(3, 2, 4, 2, 5, generator=g) * 300
    return x.clamp(-448, 448).to(dtype)


def _np(t: torch.Tensor) -> np.ndarray:
    """The reference's host array for the same bytes (ml_dtypes for bf16/fp8)."""
    import ml_dtypes

    kind = {torch.float32: np.float32, torch.bfloat16: ml_dtypes.bfloat16,
            FP8: ml_dtypes.float8_e4m3fn}[t.dtype]
    return t.contiguous().view(torch.uint8).numpy().view(kind)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, FP8], ids=str)
@pytest.mark.parametrize("way", ["port_source", "reference_source"])
def test_wire_compatible_both_ways(way, dtype):
    blocks = _payload(dtype)
    hashes, chunks = [5, -6, 7], [[1], [2], [3]]
    if way == "port_source":
        src = ttr.KVTransferSource(host="127.0.0.1")
        src.start()
        src.register("r", hashes, chunks, blocks)
        got = jtr.KVTransferClient(timeout_s=5).pull("127.0.0.1", src.port, "r")
        assert got.blocks.dtype == _np(blocks).dtype
        assert got.blocks.tobytes() == _np(blocks).tobytes()
    else:
        src = jtr.KVTransferSource(host="127.0.0.1")
        src.start()
        src.register("r", hashes, chunks, _np(blocks))
        got = ttr.KVTransferClient(timeout_s=5).pull("127.0.0.1", src.port, "r")
        assert got.blocks.dtype == dtype
        assert torch.equal(got.blocks.view(torch.uint8), blocks.view(torch.uint8))
    try:
        assert got.block_hashes == hashes and got.token_chunks == chunks
        assert got.blocks.shape == blocks.shape
        # one header composer on each side, the same bytes
        assert (ttr._pull_header(hashes, chunks, ttr.dtype_name(dtype), blocks.shape[1:], 9)
                == jtr._pull_header(hashes, chunks, str(_np(blocks).dtype),
                                    _np(blocks).shape[1:], 9))
    finally:
        src.stop()


# ---------------------------------------------------------------- engine export


def _staged_engine():
    _, tcfg, _, npp = _weights("tiny")
    eng = LLMEngine(tcfg, EngineConfig(**KW), params=tt.params_from_numpy(tcfg, npp),
                    device="cpu")
    prompt = list(range(40, 40 + 24))  # 3 full pages at page_size 8
    eng.generate([prompt], SamplingParams(max_tokens=2, temperature=0.0, ignore_eos=True))
    return eng, prompt


def test_export_two_phase_matches_sync():
    eng, prompt = _staged_engine()
    sync_src, async_src = ttr.KVTransferSource(host="127.0.0.1"), ttr.KVTransferSource(
        host="127.0.0.1")
    sync_src.start(), async_src.start()
    try:
        p1 = ttr.export_from_engine(eng, sync_src, "sync-1", prompt)
        p2, staged = ttr.export_begin(eng, "async-1", prompt, staging_pages=2)
        assert p2.num_blocks == p1.num_blocks == 3
        assert isinstance(staged, ttr.StagedExport)
        assert len(staged.parts) == 2  # chunked gathers
        ttr.export_finish(staged, async_src)
        cli = ttr.KVTransferClient(timeout_s=5)
        a = cli.pull("127.0.0.1", sync_src.port, "sync-1")
        b = cli.pull("127.0.0.1", async_src.port, "async-1")
        assert a.block_hashes == b.block_hashes
        assert torch.equal(a.blocks, b.blocks)
        # the export is the pages' rows, block-major, and never the scratch row
        L, P = eng.model_cfg.num_layers, eng.cfg.num_pages
        pids = [eng.alloc.cached[h] for h in a.block_hashes]
        for i, pid in enumerate(pids):
            for l in range(L):
                assert torch.equal(a.blocks[i, l], eng.cache[l * P + pid])
        assert a.blocks.shape[1:] == (L, *eng.cache.shape[1:])
    finally:
        sync_src.stop(), async_src.stop()


def test_export_survives_engine_steps():
    """Steps between begin and finish, even ones that recycle the exported
    pages, cannot change the staged export."""
    eng, prompt = _staged_engine()
    src_ref, src = ttr.KVTransferSource(host="127.0.0.1"), ttr.KVTransferSource(host="127.0.0.1")
    src_ref.start(), src.start()
    try:
        ttr.export_from_engine(eng, src_ref, "ref-1", prompt)  # the ground truth now
        pids = [eng.alloc.cached[h] for h in block_keys_for_tokens(prompt, 8)]
        _, staged = ttr.export_begin(eng, "live-1", prompt)
        # churn: enough fresh sequences to recycle every page of the pool
        eng.generate([[(97 + 41 * i + j) % 280 + 1 for j in range(40)] for i in range(20)],
                     SamplingParams(max_tokens=4, temperature=0.0, ignore_eos=True))
        assert not any(eng.alloc.cached.get(h) is not None
                       for h in block_keys_for_tokens(prompt, 8)), "pages were not recycled"
        assert pids  # the exported pages now hold other sequences' KV
        ttr.export_finish(staged, src)
        cli = ttr.KVTransferClient(timeout_s=5)
        a = cli.pull("127.0.0.1", src_ref.port, "ref-1")
        b = cli.pull("127.0.0.1", src.port, "live-1")
        assert a.block_hashes == b.block_hashes
        assert torch.equal(a.blocks, b.blocks)
    finally:
        src_ref.stop(), src.stop()


# ---------------------------------------------------------------- P/D end to end


async def _post(sess, url, body, headers=None):
    async with sess.post(url, json=body, headers=headers) as r:
        if r.headers.get("Content-Type", "").startswith("text/event-stream"):
            text = ""
            async for line in r.content:
                line = line.decode().strip()
                if line.startswith("data: ") and line != "data: [DONE]":
                    text += json.loads(line[6:])["choices"][0]["text"]
            return r.status, text
        return r.status, json.loads(await r.read())


async def _pd(make, model, body, sidecar_cls=RoutingSidecar):
    """Aggregated control, then P/D through the sidecar (plain, streamed, a
    dead prefiller, no prefiller header); what came out."""
    prefill = make(model, kv_transfer_port=0)
    decode = make(model, kv_transfer_port=0)
    control = make(model)
    for s in (prefill, decode, control):
        await _start(s)
    sidecar = sidecar_cls(decode_addr=decode.address, host="127.0.0.1", port=0)
    await sidecar.start()
    out: dict = {}
    try:
        async with aiohttp.ClientSession() as sess:
            _, r = await _post(sess, f"http://{control.address}/v1/completions", body)
            out["control"] = r["choices"][0]["text"]
            st, r = await _post(sess, f"http://{sidecar.address}/v1/completions", body,
                                {HDR_PREFILLER_HOST_PORT: prefill.address})
            assert st == 200, r
            out["pd"], out["usage"] = r["choices"][0]["text"], r["usage"]
            out["injected"] = decode.transfer_stats["injected_blocks"]
            out["left_on_p"] = len(prefill.transfer_source)
            out["notifies"] = prefill.transfer_source.stats["notifies"]
            st, out["stream"] = await _post(
                sess, f"http://{sidecar.address}/v1/completions", {**body, "stream": True},
                {HDR_PREFILLER_HOST_PORT: prefill.address})
            st, r = await _post(sess, f"http://{sidecar.address}/v1/completions", body,
                                {HDR_PREFILLER_HOST_PORT: "127.0.0.1:1"})
            out["fallback"] = r["choices"][0]["text"]
            st, r = await _post(sess, f"http://{sidecar.address}/v1/completions", body)
            out["aggregated"] = r["choices"][0]["text"]
            out["sidecar"] = dict(sidecar.stats)
            async with sess.get(f"http://{sidecar.address}/metrics") as r:
                out["d_metrics"] = _transfer_families(await r.text())
            async with sess.get(f"http://{prefill.address}/metrics") as r:
                out["p_metrics"] = _transfer_families(await r.text())
    finally:
        await sidecar.stop()
        for s in (prefill, decode, control):
            await _stop(s)
    return out


def _transfer_families(text: str) -> dict:
    """The transfer families' samples (the prefix-pull histogram aside)."""
    return {line.rpartition(" ")[0]: float(line.rpartition(" ")[2])
            for line in text.splitlines()
            if line.startswith("llmd_tpu:kv_transfer_") and "prefix_pull_seconds" not in line}


@functools.cache
def _reference_pd(model: str, sidecar: str) -> dict:
    """A P/D run, cached across the parametrized cases: the JAX pair behind
    the reference's sidecar, or port engines behind the reference's sidecar."""
    body = {"prompt": PROMPT, "max_tokens": 8, "temperature": 0.0, "ignore_eos": True}
    return run_async(_pd(_jax_server if sidecar == "jax" else _port_server, model, body))


@pytest.mark.parametrize("model,sidecar", [
    pytest.param("tiny", "reference", id="tiny"),
    pytest.param("tiny-mla", "reference", id="tiny-mla"),
    pytest.param("tiny", "port", id="tiny-port_sidecar"),
    pytest.param("tiny-mla", "port", id="tiny-mla-port_sidecar")])
def test_pd_disaggregation_e2e(model, sidecar):
    body = {"prompt": PROMPT, "max_tokens": 8, "temperature": 0.0, "ignore_eos": True}
    if sidecar == "reference":
        port = _reference_pd(model, "port")
    else:
        port = run_async(_pd(_port_server, model, body, PortSidecar))
        # the port's sidecar in front of port engines = the reference's there
        assert port == _reference_pd(model, "port")
    ref = _reference_pd(model, "jax")
    assert port["pd"] == port["control"] == ref["pd"] == ref["control"]
    assert port["stream"] == port["fallback"] == port["aggregated"] == port["control"]
    n_blocks = len(block_keys_for_tokens(list(PROMPT.encode()), 8))
    n_reusable = min(n_blocks, (len(PROMPT.encode()) - 1) // 8)
    assert port["usage"]["cached_tokens"] == n_reusable * 8
    assert port["injected"] == n_blocks
    assert port["left_on_p"] == 0 and port["notifies"] == 1
    assert port["sidecar"] == {**port["sidecar"], "pd_requests": 2, "prefill_fallbacks": 1,
                               "aggregated_requests": 1}
    # the streamed P/D request finds every block resident already: no inject
    assert port["d_metrics"]["llmd_tpu:kv_transfer_injected_blocks_total"] == n_blocks
    assert port["d_metrics"]["llmd_tpu:kv_transfer_registrations"] == 0
    assert port["p_metrics"]["llmd_tpu:kv_transfer_exports_total"] == 2
    # everything the reference's P/D pair answered and counted, after the same script
    for key in ("pd", "usage", "stream", "fallback", "aggregated", "injected", "left_on_p",
                "notifies", "sidecar", "d_metrics", "p_metrics"):
        assert port[key] == ref[key], key


async def _prefix_pull(make):
    """Engine A serves a prompt; engine B, asked for the same prompt with
    ``do_prefix_pull`` at A's transfer port, pulls A's resident prefix first."""
    body = {"prompt": PROMPT, "max_tokens": 8, "temperature": 0.0, "ignore_eos": True}
    a, b = make("tiny", kv_transfer_port=0), make("tiny", kv_transfer_port=0)
    await _start(a), await _start(b)
    try:
        async with aiohttp.ClientSession() as sess:
            _, r = await _post(sess, f"http://{a.address}/v1/completions", body)
            text_a = r["choices"][0]["text"]
            hashes = block_keys_for_tokens(list(PROMPT.encode()), 8)
            _, r = await _post(sess, f"http://{b.address}/v1/completions", {
                **body, "kv_transfer_params": {
                    "do_prefix_pull": True, "remote_host": "127.0.0.1",
                    "remote_port": a.kv_transfer_port, "remote_request_id": "peer-1",
                    "block_hashes": hashes}})
            return {"a": text_a, "b": r["choices"][0]["text"],
                    "cached": r["usage"]["cached_tokens"],
                    "stats": dict(b.transfer_stats), "left_on_a": len(a.transfer_source),
                    "a_pulls": a.transfer_source.stats["pulls"]}
    finally:
        await _stop(a), await _stop(b)


def test_prefix_pull_from_peer_matches_reference(monkeypatch):
    """The KV plane's peer rung: with ``LLMD_KV_PLANE=precise`` a server
    answers ``pull_prefix`` from its prefix cache (the python transport) and
    a puller injects the verified chain before its prefill; the same script
    through the reference's servers gives the same answer and counts."""
    monkeypatch.setenv("LLMD_KV_PLANE", "precise")
    port = run_async(_prefix_pull(_port_server))
    ref = run_async(_prefix_pull(_jax_server))
    assert port["a"] == port["b"] and port["cached"] == 8 * 8
    assert port["stats"]["prefix_pull_blocks"] == 8 and port["stats"]["prefix_pulls"] == 1
    assert port["left_on_a"] == 0 and port["a_pulls"] == 1
    assert port == ref


def test_stale_transfer_rejected():
    """Hash-chain verification: decode rejects an export of another prompt."""

    async def scenario():
        prefill = _port_server("tiny", kv_transfer_port=0)
        decode = _port_server("tiny", kv_transfer_port=0)
        prefill.start(), decode.start()
        try:
            async with aiohttp.ClientSession() as sess:
                _, r = await _post(sess, f"http://{prefill.address}/v1/completions", {
                    "prompt": PROMPT, "max_tokens": 1, "temperature": 0.0, "ignore_eos": True,
                    "kv_transfer_params": {"do_remote_decode": True}})
                ktp = r["kv_transfer_params"]
                assert ktp["remote_host"] == "127.0.0.1" and ktp["num_blocks"] == 8
                st, r = await _post(sess, f"http://{decode.address}/v1/completions", {
                    "prompt": "a completely different prompt that shares no prefix at all!",
                    "max_tokens": 4, "temperature": 0.0, "ignore_eos": True,
                    "kv_transfer_params": {"do_remote_prefill": True, **ktp}})
                assert st == 200
                assert r["usage"]["cached_tokens"] == 0  # nothing injected
                assert decode.transfer_stats["injected_blocks"] == 0
                assert len(prefill.transfer_source) == 0  # still notified
        finally:
            prefill.stop(), decode.stop()

    run_async(scenario())


# ---------------------------------------------------------------- across packages


@functools.cache
def _jax_pair(head_dim):
    return _cross(_jax_server, _jax_server, head_dim)


def _cross(p_make, d_make, head_dim):
    async def scenario():
        body = {"prompt": PROMPT, "max_tokens": 8, "temperature": 0.0, "ignore_eos": True}
        prefill = p_make("tiny", head_dim, kv_transfer_port=0)
        decode = d_make("tiny", head_dim, kv_transfer_port=0)
        await _start(prefill), await _start(decode)
        try:
            async with aiohttp.ClientSession() as sess:
                _, r = await _post(sess, f"http://{prefill.address}/v1/completions", {
                    **body, "max_tokens": 1, "kv_transfer_params": {"do_remote_decode": True}})
                ktp = r["kv_transfer_params"]
                _, r = await _post(sess, f"http://{decode.address}/v1/completions", {
                    **body, "kv_transfer_params": {"do_remote_prefill": True, **ktp}})
                return (r["choices"][0]["text"], r["usage"]["cached_tokens"],
                        decode.transfer_stats["injected_blocks"],
                        decode.transfer_stats["pull_failures"])
        finally:
            await _stop(prefill), await _stop(decode)

    return run_async(scenario())


@pytest.mark.parametrize("pair", ["jax_to_port", "port_to_jax"])
def test_cross_package_pd_head_dim_128(pair):
    jax_pair = _jax_pair(128)
    got = _cross(*((_jax_server, _port_server) if pair == "jax_to_port"
                   else (_port_server, _jax_server)), 128)
    n_reusable = (len(PROMPT.encode()) - 1) // 8
    assert got == jax_pair
    assert got[1] == n_reusable * 8 and got[2] == 8 and got[3] == 0


def test_cross_package_shape_refused_at_head_dim_32():
    """The reference pads head_dim 32 to 128 lanes, the port does not: the
    port's inject refuses the reference's blocks (and a port decode server
    recomputes, counting a pull failure), as the reference refuses a
    mismatch."""
    jcfg, tcfg, jp, npp = _weights("tiny")
    je = JaxEngine(jcfg, JaxEngineConfig(**KW, attn_impl="reference"), params=jp)
    prompt = list(range(40, 64))
    je.generate([prompt], JaxSamplingParams(max_tokens=1, temperature=0.0, ignore_eos=True))
    src = jtr.KVTransferSource(host="127.0.0.1")
    src.start()
    try:
        jtr.export_from_engine(je, src, "x", prompt)
        pulled = ttr.KVTransferClient(timeout_s=5).pull("127.0.0.1", src.port, "x")
        assert pulled.blocks.shape[1:] == (2, 8, 4, 128)
        te = LLMEngine(tcfg, EngineConfig(**KW), params=tt.params_from_numpy(tcfg, npp),
                       device="cpu")
        free = te.alloc.num_free
        with pytest.raises(ValueError, match="block shape"):
            ttr.inject_into_engine(te, pulled, prompt)
        assert te.alloc.num_free == free  # nothing allocated
        # a port pull served to the reference is refused by its inject alike
        ours = ttr.KVTransferSource(host="127.0.0.1")
        ours.start()
        try:
            te.generate([prompt], SamplingParams(max_tokens=1, temperature=0.0, ignore_eos=True))
            ttr.export_from_engine(te, ours, "y", prompt)
            back = jtr.KVTransferClient(timeout_s=5).pull("127.0.0.1", ours.port, "y")
            with pytest.raises(ValueError, match="block shape"):
                jtr.inject_into_engine(je, back, prompt)
        finally:
            ours.stop()
    finally:
        src.stop()
