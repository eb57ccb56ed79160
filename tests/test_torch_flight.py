"""The port's flight recorder (``llmd_tpu_torch/obs/events.py``) against the
reference's, on the CPU.

- the reference's recorder unit cases (``tests/test_flight_recorder.py``:
  ring, event cap, unknown ids, idempotent finish, filters, tail capture and
  its force-sampled span, the tail bound, the trace filter) run over both
  packages' ``obs.events`` and ``obs.tracing``;
- the catalog equals the reference's, and every name the port emits (a
  literal at a ``record`` / ``record_system`` / ``finish(event=...)`` site,
  scanned as ``tools/llmd_lint/events_contract.py`` scans the reference) is
  in it, the engine-side names the reference emits included;
- per-request event names and order (timings and wall-dependent attributes
  excluded) of the port engine equal the JAX engine's on the same float32
  weights and script: plain, preempt -> re-admit -> retire, abort,
  speculation, structured requests, an offload reload and a KV-plane prefix
  pull between two servers; the system events' names too;
- ``/debug/requests[/{rid}]`` codes and bodies against the reference
  ``EngineServer`` on one script (timing fields excluded).
"""

import dataclasses
import functools
import importlib
import re
import time
from pathlib import Path

import aiohttp
import jax
import numpy as np
import pytest
import torch

from llmd_tpu.core.request import SamplingParams as JaxSamplingParams
from llmd_tpu.engine import EngineConfig as JaxEngineConfig
from llmd_tpu.engine import LLMEngine as JaxEngine
from llmd_tpu.engine.server import EngineServer as JaxEngineServer
from llmd_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from llmd_tpu.models import get_model_config as jax_model_config
from llmd_tpu.models import transformer as jt
from llmd_tpu_torch.core.kv_events import block_keys_for_tokens
from llmd_tpu_torch.core.request import SamplingParams
from llmd_tpu_torch.engine import EngineConfig, LLMEngine
from llmd_tpu_torch.engine.server import EngineServer
from llmd_tpu_torch.engine.tokenizer import ByteTokenizer
from llmd_tpu_torch.models import get_model_config
from llmd_tpu_torch.models import transformer as tt
from tests.conftest import run_async

REPO = Path(__file__).resolve().parent.parent
PACKAGES = ["llmd_tpu", "llmd_tpu_torch"]
BASE = dict(page_size=8, num_pages=64, max_model_len=256, max_batch_size=4, prefill_chunk=32)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _obs(pkg: str):
    return (importlib.import_module(f"{pkg}.obs.events"),
            importlib.import_module(f"{pkg}.obs.tracing"))


# ----------------------------------------------------- the recorder, both packages


@pytest.mark.parametrize("pkg", PACKAGES)
def test_ring_eviction_order_oldest_first(pkg):
    fr = _obs(pkg)[0].FlightRecorder(max_requests=3)
    for i in range(5):
        fr.start(f"r{i}")
    assert len(fr) == 3
    assert [r["request_id"] for r in fr.snapshot()] == ["r4", "r3", "r2"]
    assert fr.get("r0") is None and fr.get("r2") is not None


@pytest.mark.parametrize("pkg", PACKAGES)
def test_per_request_event_cap_counts_drops(pkg):
    fr = _obs(pkg)[0].FlightRecorder(max_events=4)
    fr.start("r")
    for i in range(10):
        fr.record("r", "decode", n=i)
    rec = fr.get("r")
    assert len(rec["events"]) == 4 and rec["events_dropped"] == 6
    fr.finish("r", event="retired", reason="stop")  # the terminal event bypasses the cap
    rec = fr.get("r")
    assert rec["events"][-1]["event"] == "retired"
    assert rec["status"] == "finished" and rec["finish_reason"] == "stop"


@pytest.mark.parametrize("pkg", PACKAGES)
def test_record_unknown_request_is_noop(pkg):
    fr = _obs(pkg)[0].FlightRecorder()
    fr.record("ghost", "decode")
    fr.finish("ghost")
    assert len(fr) == 0


@pytest.mark.parametrize("pkg", PACKAGES)
def test_finish_is_idempotent(pkg):
    fr = _obs(pkg)[0].FlightRecorder()
    fr.start("r")
    fr.finish("r", event="retired", reason="length")
    e2e = fr.get("r")["latency_ms"]
    fr.finish("r", event="aborted", status="aborted", reason="late")
    rec = fr.get("r")
    assert rec["status"] == "finished" and rec["finish_reason"] == "length"
    assert rec["latency_ms"] == e2e


@pytest.mark.parametrize("pkg", PACKAGES)
def test_snapshot_filters_status_model_latency_trace(pkg):
    fr = _obs(pkg)[0].FlightRecorder()
    fr.start("a", model="tiny", trace_id="aaa0")
    fr.start("b", model="tiny-mla", trace_id="bbb1")
    fr.start("c", model="tiny", trace_id="aaa0")
    fr.finish("c", event="retired")
    assert [r["request_id"] for r in fr.snapshot(status="active")] == ["b", "a"]
    assert [r["request_id"] for r in fr.snapshot(model="tiny-mla")] == ["b"]
    assert [r["request_id"] for r in fr.snapshot(status="finished")] == ["c"]
    assert len(fr.snapshot(min_latency_ms=0)) == 3 and fr.snapshot(min_latency_ms=1e9) == []
    assert sorted(r["request_id"] for r in fr.snapshot(trace_id="aaa0")) == ["a", "c"]
    assert fr.snapshot(trace_id="zzzz") == []


@pytest.mark.parametrize("pkg", PACKAGES)
def test_tail_capture_retains_past_eviction_and_force_traces(pkg):
    events, tracing = _obs(pkg)
    tracer = tracing.Tracer(tracing.TracingConfig(enabled=True, sample_ratio=0.0,
                                                  exporter="memory"))
    fr = events.FlightRecorder(max_requests=2, slo_ms=5.0, tail_keep=4, tracer=tracer)
    fr.start("slow", model="tiny", trace_id="f" * 32)
    fr.record("slow", "arrival")
    time.sleep(0.02)
    fr.finish("slow", event="retired", reason="length")
    assert fr.get("slow")["retained"] is True
    for i in range(6):
        fr.start(f"fast{i}")
    assert {r["request_id"] for r in fr.snapshot()} == {"slow", "fast5"} and len(fr) == 2
    names = [s.name for s in tracer.spans]
    span = tracer.spans[names.index("flight.slo_breach")]
    assert span.context.trace_id == "f" * 32 and span.context.sampled
    assert span.attributes["llm_d.request_id"] == "slow"
    assert [e["name"] for e in span.events] == ["arrival", "retired"]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_tail_keep_bounds_retained_records(pkg):
    fr = _obs(pkg)[0].FlightRecorder(max_requests=2, slo_ms=1.0, tail_keep=2)
    for i in range(5):
        fr.start(f"s{i}")
        time.sleep(0.003)
        fr.finish(f"s{i}", event="retired")
    assert len([r for r in fr.snapshot(limit=100) if r["retained"]]) <= 2


@pytest.mark.parametrize("pkg", PACKAGES)
def test_no_tail_capture_when_disabled(pkg):
    fr = _obs(pkg)[0].FlightRecorder(max_requests=2, slo_ms=0.0)
    fr.start("r")
    time.sleep(0.005)
    fr.finish("r", event="retired")
    assert fr.get("r")["retained"] is False


@pytest.mark.parametrize("env", [{}, {"LLMD_FLIGHT_MAX_REQUESTS": "7", "LLMD_FLIGHT_MAX_EVENTS": "9",
                                      "LLMD_FLIGHT_SLO_MS": "250", "LLMD_FLIGHT_TAIL_KEEP": "3"}])
def test_from_env_matches_reference(env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ref, port = (_obs(p)[0].FlightRecorder.from_env() for p in PACKAGES)
    keys = ("max_requests", "max_events", "slo_ms", "tail_keep")
    assert [getattr(port, k) for k in keys] == [getattr(ref, k) for k in keys]


# --------------------------------------------------------------------- catalog

_RECORD = re.compile(r"\.record\(\s*[^,()]+,\s*\"([a-z_]+)\"")
_RECORD_SYSTEM = re.compile(r"\.record_system\(\s*\"([a-z_]+)\"")
_FINISH = re.compile(r"\bevent=\"([a-z_]+)\"")


def _emitted(root: Path, prefixes=("",)) -> set:
    out = set()
    for path in root.rglob("*.py"):
        if path.name == "events.py" and path.parent.name == "obs":
            continue
        if not path.relative_to(REPO).as_posix().startswith(prefixes):
            continue
        text = path.read_text()
        for pat in (_RECORD, _RECORD_SYSTEM, _FINISH):
            out |= set(pat.findall(text))
    return out


def test_catalog_equals_reference_and_covers_every_emit():
    ref_events, port_events = (_obs(p)[0] for p in PACKAGES)
    assert port_events.EVENT_CATALOG == ref_events.EVENT_CATALOG
    port = _emitted(REPO / "llmd_tpu_torch")
    assert port <= set(port_events.EVENT_CATALOG), port - set(port_events.EVENT_CATALOG)
    # every engine-side name the reference emits (engine, KV tiers, device
    # plane) is emitted by the port too; the router and pool planes are not
    # the engine's
    ref_engine = _emitted(REPO / "llmd_tpu", ("llmd_tpu/engine/", "llmd_tpu/kv/",
                                              "llmd_tpu/obs/"))
    assert ref_engine <= port, ref_engine - port


# ------------------------------------------------- engine timelines vs JAX engine


@functools.cache
def _weights(model: str):
    jcfg = dataclasses.replace(jax_model_config(model), dtype="float32")
    tcfg = dataclasses.replace(get_model_config(model), dtype="float32")
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, {k: np.asarray(v) for k, v in jp.items()}


def _engines(model: str, tokenizer: bool = False, **kw):
    jcfg, tcfg, jp, npp = _weights(model)
    cfg = {**BASE, **kw}
    je = JaxEngine(jcfg, JaxEngineConfig(**cfg, attn_impl="reference"), params=jp,
                   tokenizer=JaxByteTokenizer() if tokenizer else None)
    te = LLMEngine(tcfg, EngineConfig(**cfg), params=tt.params_from_numpy(tcfg, npp),
                   device="cpu", tokenizer=ByteTokenizer() if tokenizer else None)
    return je, te


def _drive(eng, requests, abort_after=None) -> list[str]:
    """Add ``requests`` [(rid, prompt, sampling kwargs)], step to the end
    (aborting ``abort_after`` = (rid, steps) on the way); the request ids."""
    jax_side = isinstance(eng, JaxEngine)
    sp = JaxSamplingParams if jax_side else SamplingParams
    for rid, prompt, kw in requests:
        eng.add_request(rid, prompt, sp(**{"temperature": 0.0, **kw}))
    steps = 0
    while eng.has_work():
        eng.step()
        steps += 1
        if abort_after and steps == abort_after[1]:
            eng.abort(abort_after[0])
        assert steps < 2000, "no forward progress"
    return [rid for rid, _, _ in requests]


def _names(flight, rid) -> list[str]:
    return [e["event"] for e in flight.get(rid)["events"]]


def _system(flight) -> list[str]:
    return [e["event"] for e in flight.system_events()]


def _echo(salt: int, n: int = 48, period: int = 3) -> list[int]:
    return [(salt * 7919 + j % period) % 286 + 1 for j in range(n)]


SCRIPTS = {
    "plain": ("tiny", {}, [("a", list(range(3, 40)), dict(max_tokens=6))], None),
    "preempt": ("tiny", dict(num_pages=16, enable_prefix_caching=False),
                [(f"p{i}", list(range(i * 7 + 1, i * 7 + 40)), dict(max_tokens=12))
                 for i in range(4)], None),
    "abort": ("tiny", {}, [("kill-me", list(range(5, 30)), dict(max_tokens=64)),
                           ("keep", list(range(40, 60)), dict(max_tokens=8))], ("kill-me", 2)),
    "spec": ("tiny", dict(spec_mode="ngram", spec_tokens=4),
             [(f"s{i}", _echo(i), dict(max_tokens=24)) for i in range(2)], None),
    "structured": ("tiny", dict(decode_steps=2),
                   [("choice", list(b"pick one color "),
                     dict(max_tokens=16, guided_choice=["red", "green", "blue"],
                          stop_token_ids=(ByteTokenizer().eos_id,))),
                    ("regex", list(b"emit a code "),
                     dict(max_tokens=16, guided_regex=r"[a-c]{3}-[0-9]{2}",
                          stop_token_ids=(ByteTokenizer().eos_id,)))], None),
}


@pytest.mark.parametrize("case", list(SCRIPTS))
def test_engine_timelines_match_reference(case):
    model, kw, requests, abort = SCRIPTS[case]
    je, te = _engines(model, tokenizer=case == "structured", **kw)
    rids = _drive(je, requests, abort)
    _drive(te, requests, abort)
    for rid in rids:
        assert _names(te.flight, rid) == _names(je.flight, rid), rid
        assert te.flight.get(rid)["status"] == je.flight.get(rid)["status"], rid
        assert te.flight.get(rid)["finish_reason"] == je.flight.get(rid)["finish_reason"]
    assert _system(te.flight) == _system(je.flight)
    seen = {n for rid in rids for n in _names(te.flight, rid)}
    want = {"plain": {"arrival", "admitted", "prefill_start", "prefill_end", "first_token",
                      "chain_dispatch", "decode", "retired"},
            "preempt": {"preempted"}, "abort": {"aborted"},
            "spec": {"spec_draft", "spec_verify"},
            "structured": {"structured_compile", "structured_mask"}}[case]
    assert want <= seen, want - seen
    for rid in rids:
        names = _names(te.flight, rid)
        assert names[-1] in ("retired", "aborted"), names
        ts = [e["t_ms"] for e in te.flight.get(rid)["events"]]
        assert ts == sorted(ts)


def _offload_script(eng) -> list[str]:
    """Prompt A cold, prompt B (A's pages leave HBM for the CPU tier), A again
    (its blocks reload)."""
    a, b = list(range(1, 49)), list(range(100, 170))
    return (_drive(eng, [("cold", a, dict(max_tokens=6))])
            + _drive(eng, [("pressure", b, dict(max_tokens=6))])
            + _drive(eng, [("again", a, dict(max_tokens=6))]))


def test_offload_reload_timeline_matches_reference():
    kw = dict(num_pages=12, max_batch_size=2, cpu_offload_pages=64)
    je, te = _engines("tiny", **kw)
    rids = _offload_script(je)
    _offload_script(te)
    for rid in rids:
        assert _names(te.flight, rid) == _names(je.flight, rid), rid
    assert "kv_reload" in _names(te.flight, "again")
    assert _system(te.flight) == _system(je.flight)
    assert "kv_offload" in _system(te.flight)
    reload = next(e for e in te.flight.get("again")["events"] if e["event"] == "kv_reload")
    ref = next(e for e in je.flight.get("again")["events"] if e["event"] == "kv_reload")
    assert reload["n_blocks"] == ref["n_blocks"]
    # the bytes are the port pool's own (the reference pads head_dim to the
    # TPU's 128 lanes): n blocks of [L, ps, planes, D]
    L = te.model_cfg.num_layers
    assert reload["bytes"] == (reload["n_blocks"] * L * te.cache[0].numel()
                               * te.cache.element_size())


# ------------------------------------------------------- servers: kv_pull, /debug

PROMPT = "the quick brown fox jumps over the lazy dog " * 2
SKW = dict(page_size=8, num_pages=64, max_model_len=256, max_batch_size=4, prefill_chunk=32,
           decode_steps=2)


def _port_server(model="tiny", **kw) -> EngineServer:
    _, tcfg, _, npp = _weights(model)
    return EngineServer(tcfg, EngineConfig(**SKW), model_name="m", host="127.0.0.1", port=0,
                        params=tt.params_from_numpy(tcfg, npp), device="cpu", **kw)


def _jax_server(model="tiny", **kw) -> JaxEngineServer:
    jcfg, _, jp, _ = _weights(model)
    return JaxEngineServer(jcfg, JaxEngineConfig(**SKW, attn_impl="reference"), model_name="m",
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


async def _get(sess, url, params=None):
    async with sess.get(url, params=params) as r:
        return r.status, await r.json()


async def _prefix_pull(make) -> dict:
    """Engine A serves a prompt; engine B, asked for it with ``do_prefix_pull``
    at A's transfer port, pulls A's prefix first: B's request timeline."""
    body = {"prompt": PROMPT, "max_tokens": 6, "temperature": 0.0, "ignore_eos": True}
    a, b = make(kv_transfer_port=0), make(kv_transfer_port=0)
    await _start(a), await _start(b)
    try:
        async with aiohttp.ClientSession() as sess:
            async with sess.post(f"http://{a.address}/v1/completions", json=body) as r:
                assert r.status == 200
            hashes = block_keys_for_tokens(list(PROMPT.encode()), 8)
            async with sess.post(f"http://{b.address}/v1/completions", json={
                    **body, "kv_transfer_params": {
                        "do_prefix_pull": True, "remote_host": "127.0.0.1",
                        "remote_port": a.kv_transfer_port, "remote_request_id": "peer-1",
                        "block_hashes": hashes}}) as r:
                assert r.status == 200
            _, listing = await _get(sess, f"http://{b.address}/debug/requests")
            (summary,) = listing["requests"]
            _, rec = await _get(sess, f"http://{b.address}/debug/requests/"
                                      f"{summary['request_id']}")
            return {"names": [e["event"] for e in rec["events"]],
                    "pull": {k: v for k, v in rec["events"][0].items()
                             if k in ("event", "outcome", "blocks", "tier")},
                    "decision": rec.get("decision", {}).get("kv", {}).get("blocks")}
    finally:
        await _stop(a), await _stop(b)


def test_prefix_pull_timeline_matches_reference(monkeypatch):
    """The KV plane's peer pull opens the request's record with ``kv_pull``
    (outcome, blocks, tier), ahead of arrival, as the reference's does; the
    detail's decision ledger carries the pulled blocks."""
    monkeypatch.setenv("LLMD_KV_PLANE", "precise")
    monkeypatch.setenv("LLMD_FABRIC_PROBE_INTERVAL_S", "0")
    port = run_async(_prefix_pull(_port_server))
    ref = run_async(_prefix_pull(_jax_server))
    assert port == ref
    assert port["names"][0] == "kv_pull" and port["pull"]["outcome"] == "hit"


TRACEPARENT = "00-" + "5a" * 16 + "-" + "c3" * 8 + "-01"
# fields that hold a clock reading or a server-minted id
_TIMED = {"request_id", "start_unix", "latency_ms", "t_ms", "wall_ms", "residual_ms",
          "residual_frac", "ttft_ms", "compile_ms"}


def _untimed(obj):
    if isinstance(obj, dict):
        return {k: _untimed(v) for k, v in obj.items() if k not in _TIMED}
    if isinstance(obj, (list, tuple)):
        return [_untimed(v) for v in obj]
    return obj


async def _debug_script(make) -> dict:
    server = make()
    await _start(server)
    try:
        base = f"http://{server.address}"
        out: dict = {}
        async with aiohttp.ClientSession() as sess:
            async with sess.post(f"{base}/v1/completions", json={
                    "prompt": "flight recorder end to end prompt", "max_tokens": 6,
                    "temperature": 0.0, "ignore_eos": True},
                    headers={"traceparent": TRACEPARENT}) as r:
                assert r.status == 200
            out["list"] = await _get(sess, f"{base}/debug/requests")
            rid = out["list"][1]["requests"][0]["request_id"]
            for name, params in (("active", {"status": "active"}),
                                 ("finished", {"status": "finished"}),
                                 ("model", {"model": "no-such-model"}),
                                 ("trace", {"trace": "5a" * 16}),
                                 ("slow", {"min_latency_ms": "1e9"}),
                                 ("bogus", {"min_latency_ms": "bogus"}),
                                 ("limit", {"limit": "x"})):
                out[name] = await _get(sess, f"{base}/debug/requests", params)
            status, rec = await _get(sess, f"{base}/debug/requests/{rid}")
            out["detail"] = (status, rec)
            out["ledger_keys"] = sorted(rec["phase_ledger"])
            out["nope"] = await _get(sess, f"{base}/debug/requests/nope")
        return _untimed(out)
    finally:
        await _stop(server)


def test_debug_requests_match_reference(monkeypatch):
    """The same script through the port server and the reference's: every
    ``/debug/requests`` answer (filters, 400s, the detail with its ledgers,
    the 404) has the same code and, clock readings and minted ids aside, the
    same body; the record carries the ``traceparent``'s trace id."""
    monkeypatch.setenv("LLMD_FABRIC_PROBE_INTERVAL_S", "0")
    port = run_async(_debug_script(_port_server))
    ref = run_async(_debug_script(_jax_server))
    for key in ref:
        if key == "detail":
            continue
        assert port[key] == ref[key], key
    (ps, prec), (rs, rrec) = port["detail"], ref["detail"]
    assert ps == rs == 200
    assert prec["trace_id"] == "5a" * 16 and prec["tenant"] == rrec["tenant"] == "anon"
    assert [e["event"] for e in prec["events"]] == [e["event"] for e in rrec["events"]]
    assert sorted(prec) == sorted(rrec)
    assert prec["phase_ledger"]["plane"] == rrec["phase_ledger"]["plane"] == "engine"
    assert port["bogus"][0] == 400 and port["nope"][0] == 404
