"""Tracing and exemplars in the port (``llmd_tpu_torch/obs/tracing.py`` and
the exemplar slot of ``obs/metrics.py``) against the reference, on the CPU:

- ``traceparent`` parsing and formatting round-trip as the reference's does,
  valid and malformed headers alike, and the parent-based ratio sampler takes
  the reference's decision for every trace id;
- the exposition of the engine's families with exemplars on
  ``step_duration`` is byte-equal to the reference's for the same
  observations (the wall clock fixed), the device plane's families included;
- tail capture force-traces a breach at ratio 0; the JSONL exporter and the
  bounded single-worker OTLP queue behave as the reference's;
- an engine given a sampled trace context emits one ``engine.step`` span a
  step under it, with the reference's names and phases, and its
  ``step_duration`` buckets carry the trace id as their exemplar.
"""

import dataclasses
import functools
import json
import threading
import time

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import llmd_tpu.obs.metrics as ref_metrics
import llmd_tpu.obs.tracing as ref_tracing
import llmd_tpu_torch.obs.metrics as port_metrics
import llmd_tpu_torch.obs.tracing as port_tracing
from llmd_tpu.core.request import SamplingParams as JaxSamplingParams
from llmd_tpu.engine import EngineConfig as JaxEngineConfig
from llmd_tpu.engine import LLMEngine as JaxEngine
from llmd_tpu.models import get_model_config as jax_model_config
from llmd_tpu.models import transformer as jt
from llmd_tpu_torch.core.request import SamplingParams
from llmd_tpu_torch.engine import EngineConfig, LLMEngine
from llmd_tpu_torch.models import get_model_config
from llmd_tpu_torch.models import transformer as tt
from llmd_tpu_torch.obs.events import FlightRecorder


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HEADERS = [
    {"traceparent": "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"},
    {"Traceparent": "00-" + "0f" * 16 + "-" + "12" * 8 + "-00"},
    {"TRACEPARENT": " 00-" + "1" * 32 + "-" + "2" * 16 + "-03 "},
    {"traceparent": "00-" + "0" * 32 + "-" + "cd" * 8 + "-01"},  # zero trace id
    {"traceparent": "00-" + "ab" * 16 + "-" + "0" * 16 + "-01"},  # zero span id
    {"traceparent": "00-abc-def-01"},
    {"traceparent": "00-" + "zz" * 16 + "-" + "cd" * 8 + "-01"},
    {"traceparent": "00-" + "ab" * 16 + "-" + "cd" * 8 + "-xx"},
    {"traceparent": ""},
    {"x-other": "1"},
]


@pytest.mark.parametrize("headers", HEADERS)
def test_traceparent_round_trip_matches_reference(headers):
    ref = ref_tracing.extract_traceparent(headers)
    port = port_tracing.extract_traceparent(headers)
    assert (port is None) == (ref is None)
    if ref is not None:
        assert (port.trace_id, port.span_id, port.sampled) == (
            ref.trace_id, ref.span_id, ref.sampled)
        assert (port_tracing.format_traceparent(port)
                == ref_tracing.format_traceparent(ref))
        again = port_tracing.extract_traceparent(
            {"traceparent": port_tracing.format_traceparent(port)})
        assert (again.trace_id, again.span_id, again.sampled) == (
            port.trace_id, port.span_id, port.sampled)


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 2 ** 128 - 1), st.integers(1, 2 ** 64 - 1), st.booleans(),
       st.sampled_from([0.0, 0.1, 0.5, 1.0]))
def test_sampler_and_child_spans_match_reference(trace, span, sampled, ratio):
    header = {"traceparent": f"00-{trace:032x}-{span:016x}-{'01' if sampled else '00'}"}
    tracers = [m.Tracer(m.TracingConfig(enabled=True, sample_ratio=ratio, exporter="memory"))
               for m in (ref_tracing, port_tracing)]
    assert tracers[1]._sample_root(f"{trace:032x}") == tracers[0]._sample_root(f"{trace:032x}")
    kids = [t.start_span("engine.generate", parent=m.extract_traceparent(header))
            for t, m in zip(tracers, (ref_tracing, port_tracing))]
    assert [(k.context.trace_id, k.context.sampled, k.parent_span_id) for k in kids[1:]] == [
        (kids[0].context.trace_id, kids[0].context.sampled, kids[0].parent_span_id)]


def test_from_env_matches_reference(monkeypatch):
    monkeypatch.setenv("LLMD_OTEL_EXPORTER", "jsonl")
    monkeypatch.setenv("LLMD_OTEL_SAMPLE_RATIO", "0.25")
    monkeypatch.setenv("OTEL_SERVICE_NAME", "svc")
    assert (dataclasses.asdict(port_tracing.TracingConfig.from_env())
            == dataclasses.asdict(ref_tracing.TracingConfig.from_env()))


OBSERVATIONS = [("unified", 0.0031, "aa" * 16), ("decode_dispatch", 0.0007, None),
                ("decode_dispatch", 0.0009, "bb" * 16), ("decode_process", 0.04, "cc" * 16),
                ("attn", 12.0, None), ("decode_process", 0.0002, "dd" * 16)]


@pytest.mark.parametrize("with_device", [False, True])
def test_exposition_with_exemplars_byte_equal(with_device, monkeypatch):
    """Both registries, the engine's families (and the device plane's),
    the same observations and exemplars, the clock fixed: one text."""
    texts = []
    for m in (ref_metrics, port_metrics):
        monkeypatch.setattr(m.time, "time", lambda: 1792000000.123456)
        reg = m.Registry()
        em = m.register_engine_metrics(reg)
        if with_device:
            dm = m.register_device_metrics(reg)
            dm.fabric_alive.set(1)
            dm.fabric_probe_seconds.observe(0.002)
        for phase, v, trace in OBSERVATIONS:
            em.step_duration.labels(phase=phase).observe(
                v, exemplar={"trace_id": trace} if trace else None)
        em.request_phase.labels(phase="decode", tenant="anon", model="tiny").observe(0.5)
        texts.append(reg.expose())
    assert texts[1] == texts[0]
    assert '# {trace_id="' + "cc" * 16 + '"} 0.04 1792000000.123' in texts[1]


def test_tail_capture_force_traces_the_breach():
    tracer = port_tracing.Tracer(port_tracing.TracingConfig(
        enabled=True, sample_ratio=0.0, exporter="memory"))
    fr = FlightRecorder(slo_ms=1.0, tracer=tracer)
    fr.start("r", model="tiny")
    fr.record("r", "arrival")
    time.sleep(0.005)
    fr.finish("r", event="retired", reason="stop")
    (span,) = tracer.spans
    assert span.name == "flight.slo_breach" and span.context.sampled
    assert len(span.context.trace_id) == 32  # a fresh id: the record had none
    assert span.attributes["llm_d.finish_reason"] == "stop"


def test_jsonl_export(tmp_path):
    path = tmp_path / "spans.jsonl"
    tracer = port_tracing.Tracer(port_tracing.TracingConfig(
        enabled=True, sample_ratio=1.0, exporter="jsonl", jsonl_path=str(path)))
    with tracer.start_span("engine.generate", **{"llm_d.model": "m"}) as span:
        span.add_event("kv_plane.pull")
    tracer.close()
    (line,) = path.read_text().splitlines()
    otlp = json.loads(line)
    assert otlp["name"] == "engine.generate" and otlp["events"][0]["name"] == "kv_plane.pull"
    assert {"key": "llm_d.model", "value": {"stringValue": "m"}} in otlp["attributes"]


def test_otlp_single_worker_bounded_queue():
    """The reference's bound: one export worker, a full queue drops spans
    and counts them."""
    tracer = port_tracing.Tracer(port_tracing.TracingConfig(
        enabled=True, sample_ratio=1.0, exporter="otlp", otlp_endpoint="http://127.0.0.1:1"))
    posted, block = [], threading.Event()

    def _slow_post(span):
        block.wait(5.0)
        posted.append(span.name)

    tracer._post_otlp = _slow_post
    before = threading.active_count()
    n = tracer.OTLP_QUEUE_MAX + 50
    for i in range(n):
        with tracer.start_span(f"s{i}"):
            pass
    assert threading.active_count() <= before + 1
    assert 49 <= tracer.spans_dropped < n
    block.set()
    tracer.close()


@functools.cache
def _weights():
    jcfg = dataclasses.replace(jax_model_config("tiny"), dtype="float32")
    tcfg = dataclasses.replace(get_model_config("tiny"), dtype="float32")
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, {k: np.asarray(v) for k, v in jp.items()}


def _traced_run(eng, mod, sampling):
    eng.tracer = mod.Tracer(mod.TracingConfig(enabled=True, sample_ratio=1.0,
                                              exporter="memory"))
    parent = mod.extract_traceparent({"traceparent": "00-" + "7e" * 16 + "-" + "11" * 8 + "-01"})
    eng.add_request("traced", list(range(3, 40)), sampling(max_tokens=8, temperature=0.0),
                    trace_ctx=parent)
    eng.add_request("plain", list(range(50, 70)), sampling(max_tokens=8, temperature=0.0))
    while eng.has_work():
        eng.step()
    return [(s.name, s.parent_span_id, s.context.trace_id, s.attributes["llm_d.phase"],
             s.attributes["llm_d.request_id"]) for s in eng.tracer.spans]


def test_engine_step_spans_and_exemplars_match_reference():
    jcfg, tcfg, jp, npp = _weights()
    kw = dict(page_size=8, num_pages=64, max_model_len=256, max_batch_size=4,
              prefill_chunk=32, decode_steps=2)
    je = JaxEngine(jcfg, JaxEngineConfig(**kw, attn_impl="reference"), params=jp)
    te = LLMEngine(tcfg, EngineConfig(**kw), params=tt.params_from_numpy(tcfg, npp),
                   device="cpu")
    ref = _traced_run(je, ref_tracing, JaxSamplingParams)
    port = _traced_run(te, port_tracing, SamplingParams)
    assert port == ref and port
    assert {p[3] for p in port} == {"unified", "decode"}
    assert te.flight.get("traced")["trace_id"] == "7e" * 16
    lines = [ln for ln in te.registry.expose().splitlines()
             if ln.startswith("llmd_tpu:engine_step_duration_seconds_bucket")
             and "# {" in ln]
    assert lines and all('trace_id="' + "7e" * 16 + '"' in ln for ln in lines)
    phases = {ln.split('phase="')[1].split('"')[0] for ln in lines}
    assert {"unified", "decode_dispatch", "decode_process"} <= phases
