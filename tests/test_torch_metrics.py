"""The port's metric registry, its engine and engine-server families and the
metrics contract (``llmd_tpu_torch/obs/metrics.py``,
``llmd_tpu_torch/core/metrics_contract.py``) against the reference's
(``llmd_tpu/obs/metrics.py``, ``llmd_tpu/core/metrics_contract.py``), and
``flatten_messages`` against the reference's, on the CPU."""

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from llmd_tpu.core import metrics_contract as jmc
from llmd_tpu.core import request as jreq
from llmd_tpu.obs import metrics as jm
from llmd_tpu_torch.core import metrics_contract as tmc
from llmd_tpu_torch.core import request as treq
from llmd_tpu_torch.obs import metrics as tm

REGISTER = ("register_engine_metrics", "register_engine_server_metrics")


def _fresh(mod):
    reg = mod.Registry()
    for fn in REGISTER:
        getattr(mod, fn)(reg)
    return reg


def test_fresh_registry_exposition_is_byte_equal():
    port, ref = _fresh(tm).expose(), _fresh(jm).expose()
    assert port == ref
    assert "vllm:cache_config_info" in port and "llmd_tpu:requests_total 0" in port


@pytest.mark.parametrize("register", REGISTER)
def test_families_match_reference(register):
    """Name, type, help and label names of every family (and a histogram's
    buckets), including those of features the port does not serve yet."""
    ref_reg, port_reg = jm.Registry(), tm.Registry()
    getattr(jm, register)(ref_reg)
    getattr(tm, register)(port_reg)
    assert port_reg.families() == ref_reg.families()
    for name in ref_reg.families():
        r, p = ref_reg.get(name), port_reg.get(name)
        assert (p.typ, p.help, p.labelnames) == (r.typ, r.help, r.labelnames), name
        assert getattr(p, "buckets", None) == getattr(r, "buckets", None), name


def test_moved_families_render_like_reference():
    """The same increments on both registries render the same text: labeled
    counters, info gauges with escaped label values, histograms with their
    cumulative buckets, summaries, scrape-time label callbacks."""
    texts = []
    for mod in (jm, tm):
        reg = mod.Registry()
        m = mod.register_engine_metrics(reg)
        s = mod.register_engine_server_metrics(reg)
        m.cache_config.labels(block_size=16, num_gpu_blocks=2048).set(1)
        m.attn_backend_info.labels(backend='cuda "paged"\\x\n', tune="none").set(1)
        m.program_dispatches.labels(program="decode").inc(3)
        m.program_dispatches.labels(program="unified").inc()
        m.prefill_tokens.inc(1234)
        m.kv_usage.set(0.25)
        m.prefix_hit_ratio.set(1 / 3)
        for v in (0.0004, 0.003, 0.7, 12.0):
            m.step_duration.labels(phase="unified").observe(v)
        m.batch_occupancy.labels(kind="running").observe(5)
        m.spec_acceptance.labels(constrained="no").observe(0.5)
        m.program_mfu.set_labels_function(lambda: [({"program": "decode"}, 0.125)])
        s.requests.inc(7)
        texts.append(reg.expose())
    assert texts[1] == texts[0]


def test_metric_guards_match_reference():
    for mod in (jm, tm):
        reg = mod.Registry()
        c = reg.counter("x_total", "x")
        with pytest.raises(ValueError):
            c.inc(-1)
        with pytest.raises(ValueError):
            reg.gauge("x_total")  # a type mismatch raises
        assert reg.counter("x_total") is c  # registration is idempotent
        with pytest.raises(ValueError):
            reg.counter("y_total", labelnames=("a",)).labels(b=1)


_label = st.text(alphabet=st.characters(codec="utf-8", exclude_categories=("Cs",)),
                 max_size=12)


@settings(max_examples=60, deadline=None)
@given(waiting=st.integers(0, 10_000), usage=st.floats(0, 1),
       block=st.integers(1, 512), blocks=st.integers(1, 10**6), lora=_label,
       extra=st.lists(st.tuples(st.sampled_from(["vllm:foo", "sglang:num_queue_reqs",
                                                 "trtllm_kv_cache_max_blocks"]),
                                st.floats(-1e6, 1e6)), max_size=3))
def test_contract_parse_and_map_agree(waiting, usage, block, blocks, lora, extra):
    reg = tm.Registry()
    m = tm.register_engine_metrics(reg)
    m.requests_waiting.set(waiting)
    m.kv_usage.set(usage)
    m.cache_config.labels(block_size=block, num_gpu_blocks=blocks).set(1)
    m.lora_info.labels(max_lora=2, running_lora_adapters=lora,
                       waiting_lora_adapters="a,b").set(1)
    text = reg.expose() + "".join(f"{n} {v!r}\n" for n, v in extra)
    port, ref = tmc.parse_prometheus(text), jmc.parse_prometheus(text)
    assert port == ref
    for engine in ("vllm", "sglang", "trtllm-serve", "llmd-tpu", "unknown"):
        assert tmc.map_engine_metrics(engine, port) == jmc.map_engine_metrics(engine, ref)
    got = tmc.map_engine_metrics("vllm", port)
    assert (got[tmc.StdMetric.BLOCK_SIZE], got[tmc.StdMetric.NUM_BLOCKS]) == (block, blocks)
    assert tmc.METRIC_MAPPINGS == jmc.METRIC_MAPPINGS


_part = st.one_of(
    st.text(max_size=8),
    st.fixed_dictionaries({"type": st.just("text"), "text": st.text(max_size=8)}),
    st.fixed_dictionaries({"type": st.just("image_url"),
                           "image_url": st.fixed_dictionaries({"url": st.text(max_size=8)})}),
    st.fixed_dictionaries({"type": st.sampled_from(["input_audio", "video_url", "audio_url"])},
                          optional={"input_audio": st.fixed_dictionaries(
                              {"data": st.text(max_size=8)}),
                              "video_url": st.fixed_dictionaries({"url": st.text(max_size=8)})}),
    st.fixed_dictionaries({"type": st.sampled_from(["file", "refusal"])}),
)
_message = st.fixed_dictionaries(
    {}, optional={"role": st.sampled_from(["system", "user", "assistant"]),
                  "content": st.one_of(st.text(max_size=16), st.lists(_part, max_size=4))})


@settings(max_examples=150, deadline=None)
@given(messages=st.lists(_message, max_size=4))
def test_flatten_messages_matches_reference(messages):
    assert treq.flatten_messages(messages) == jreq.flatten_messages(messages)


def test_deadline_header_matches_reference():
    assert treq.HDR_REQUEST_TIMEOUT == jreq.HDR_REQUEST_TIMEOUT
