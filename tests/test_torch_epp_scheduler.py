"""The port's router pieces against the reference's, in process, on the CPU
(no sockets).

- **Config.** Every EPP config the repo carries (the README's
  ``precise.yaml``, which ``chip_smoke.py``'s router phase runs, the
  reference CLI's ``DEFAULT_CONFIG`` and the config
  strings of the reference's router, resilience and contract tests, plus a
  flow-control and a disagg config written here) loads through the port's
  YAML reader as through ``yaml.safe_load``, gives an equal
  ``FrameworkConfig`` and builds an equal plugin graph and profiles. Random
  documents dumped by PyYAML read back equal under hypothesis; what lies
  outside the subset raises ``ConfigError`` with its line.
- **Scheduling.** The same pool attributes and the same seeded draws give the
  same pick, per-profile scores, decision detail and P/D decision, over a
  scripted sequence under hypothesis (time-dependent scorers read one fake
  clock on both sides).
- **KV index.** Both indexes, fed the same ``encode_event_batch`` bytes
  through their subscribers' handlers, give the same hits, and the precise
  producers the same prefix hits.
- **Flow control and resilience.** The same dispatch, reject and evict order
  over a scripted saturation, and the same breaker states over a scripted
  outcome sequence.
- **Parsers and sticky picks.** The openai and passthrough parsers give the
  same request from the same body and headers; conversation ids hash onto
  the same decode-capable pod.
- **Served since the latency plane and the KV plane's router side.** The
  four latency plugin types build as the reference's do; the external index
  backend, a KV plane other than ``off`` and an SLO objective are served; the
  gateway and manifest flags of the CLI are still refused naming their
  ROADMAP item, the HA flags are served.
"""

import asyncio
import dataclasses
import random
import re
from pathlib import Path

import pytest
import yaml
from hypothesis import HealthCheck, example, given, settings
from hypothesis import strategies as st

import llmd_tpu.core.request as ref_request_mod
import llmd_tpu.kv.indexer as ref_indexer_mod
import llmd_tpu.router.flowcontrol as ref_flow_mod
import llmd_tpu.router.resilience as ref_res_mod
import llmd_tpu.router.scorers as ref_scorers_mod
import llmd_tpu_torch.core.request as port_request_mod
import llmd_tpu_torch.kv.indexer as port_indexer_mod
import llmd_tpu_torch.router.flowcontrol as port_flow_mod
import llmd_tpu_torch.router.resilience as port_res_mod
import llmd_tpu_torch.router.scorers as port_scorers_mod
from llmd_tpu.core import config as ref_config
from llmd_tpu.core import endpoint as ref_endpoint
from llmd_tpu.core.request import InferenceRequest as RefRequest
from llmd_tpu.core.request import SamplingParams as RefSampling
from llmd_tpu.kv import plugins as ref_kv_plugins
from llmd_tpu.kv.subscriber import KVEventSubscriberManager as RefSubscriber
from llmd_tpu.router import filters_pickers as _ref_fp  # noqa: F401
from llmd_tpu.router import serve as ref_serve
from llmd_tpu.router.plugins import known_plugin_types as ref_known
from llmd_tpu.router.scheduler import Scheduler as RefScheduler
from llmd_tpu_torch import router as _port_router  # noqa: F401 (registers the plugins)
from llmd_tpu_torch.core import config as port_config
from llmd_tpu_torch.core import endpoint as port_endpoint
from llmd_tpu_torch.core.kv_events import (
    AllBlocksCleared,
    BlockRemoved,
    BlockStored,
    block_keys_for_tokens,
    encode_event_batch,
)
from llmd_tpu_torch.core.metrics_contract import StdMetric
from llmd_tpu_torch.core.request import InferenceRequest as PortRequest
from llmd_tpu_torch.core.request import SamplingParams as PortSampling
from llmd_tpu_torch.kv import plugins as port_kv_plugins
from llmd_tpu_torch.kv.index_backends import build_index
from llmd_tpu_torch.kv.subscriber import KVEventSubscriberManager as PortSubscriber
from llmd_tpu_torch.router import serve as port_serve
from llmd_tpu_torch.router.plugins import build_plugin
from llmd_tpu_torch.router.plugins import known_plugin_types as port_known
from llmd_tpu_torch.router.scheduler import Scheduler as PortScheduler
import chip_smoke
from tests import test_core_contracts, test_resilience, test_router
from tests.conftest import run_async

REPO = Path(__file__).resolve().parent.parent


def _readme_config() -> str:
    text = (REPO / "README.md").read_text()
    m = re.search(r"cat > precise\.yaml <<'YAML'\n(.*?)\nYAML\n", text, re.S)
    assert m, "README's precise.yaml block"
    return m.group(1)


FLOW_CFG = """
plugins:
  - {name: queue, type: queue-depth-scorer}
flowControl:
  enabled: true
  saturationDetector: concurrency-detector
  bands:
    - {priority: 0, name: standard, maxRequests: 4, ttl: 0.5}
    - priority: 10
      name: premium
      maxBytes: 4096
      fairnessPolicy: global-strict
      orderingPolicy: edf
featureGates: {flowControl: true}
parser: passthrough-parser
"""
DISAGG_CFG = """
# P/D: decode first, the uncached-suffix decider, then prefill
plugins:
  - {name: prefix-producer, type: approx-prefix-cache-producer, params: {blockSize: 4}}
  - {name: prefill-filter, type: prefill-endpoints-filter}
  - {name: decode-filter, type: decode-endpoints-filter}
  - {name: prefix, type: prefix-cache-scorer}
  - {name: queue, type: queue-depth-scorer}
  - {name: kv, type: kv-cache-utilization-scorer}
  - {name: picker, type: max-score-picker}
profileHandler: disagg-profile-handler
disaggregation: {uncachedSuffixThreshold: 8}
schedulingProfiles:
  - name: prefill
    plugins: [{pluginRef: prefill-filter}, {pluginRef: queue, weight: 1.5}, {pluginRef: picker}]
  - name: decode
    plugins:
      - {pluginRef: decode-filter}
      - {pluginRef: prefix, weight: 3}
      - {pluginRef: kv, weight: 1}
      - {pluginRef: picker}
"""
# every other plugin type, and the draws of each picker and the affinity filter
WIDE_CFG = """
plugins:
  - {name: prefix-producer, type: approx-prefix-cache-producer, params: {blockSize: 4}}
  - {name: inflight, type: inflight-load-producer}
  - {name: affinity, type: prefix-cache-affinity-filter, params: {epsilon: 0.3, queue_gate: 12}}
  - {name: labels, type: label-selector-filter, params: {zone: a}}
  - {name: prefix, type: prefix-cache-scorer}
  - {name: queue, type: queue-depth-scorer}
  - {name: kv, type: kv-cache-utilization-scorer}
  - {name: running, type: running-requests-scorer}
  - {name: tokens, type: token-load-scorer}
  - {name: session, type: session-affinity-scorer}
  - {name: lora, type: lora-affinity-scorer}
  - {name: no-hit-lru-scorer, type: no-hit-lru-scorer}
  - {name: weighted, type: weighted-random-picker}
  - {name: rand, type: random-picker}
schedulingProfiles:
  - name: default
    plugins:
      - {pluginRef: affinity}
      - {pluginRef: prefix, weight: 3}
      - {pluginRef: queue, weight: 2}
      - {pluginRef: kv, weight: 1}
      - {pluginRef: running, weight: 1}
      - {pluginRef: tokens, weight: 1}
      - {pluginRef: session, weight: 0.5}
      - {pluginRef: lora, weight: 1}
      - {pluginRef: no-hit-lru-scorer, weight: 2}
      - {pluginRef: weighted}
  - name: zoned
    plugins: [{pluginRef: labels}, {pluginRef: queue}, {pluginRef: rand}]
"""
CONFIGS = {
    "readme precise.yaml": _readme_config(),
    "chip_smoke ROUTER_CFG": chip_smoke.ROUTER_CFG,
    "serve DEFAULT_CONFIG": ref_serve.DEFAULT_CONFIG,
    "test_router CFG": test_router.CFG,
    "test_router RR_CFG": test_router.RR_CFG,
    "test_resilience CFG": test_resilience.CFG,
    "test_resilience CFG + flowControl": test_resilience.CFG + "\nflowControl: {enabled: true}\n",
    "test_core_contracts CFG": test_core_contracts.CFG,
    "flow control": FLOW_CFG,
    "disagg": DISAGG_CFG,
    "wide": WIDE_CFG,
}


class Clock:
    """One fake monotonic clock for both packages' time-dependent modules."""

    def __init__(self) -> None:
        self.t = 1000.0

    def monotonic(self) -> float:
        return self.t

    def time(self) -> float:
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    for mod in (ref_scorers_mod, port_scorers_mod, ref_indexer_mod, port_indexer_mod,
                ref_flow_mod, port_flow_mod, ref_res_mod, port_res_mod,
                ref_request_mod, port_request_mod, ref_endpoint, port_endpoint):
        monkeypatch.setattr(mod, "time", c)
    return c


def _graph(sched) -> dict:
    """A scheduler's plugin graph: instances by name with type and state, and
    each profile's filters, weighted scorers and picker (by plugin name)."""
    names = {id(p): n for n, p in sched.plugins.items()}
    plugins = {}
    for n, p in sched.plugins.items():
        # scalars; the reference's render timeout is an aiohttp.ClientTimeout
        state = {k: getattr(v, "total", v) for k, v in vars(p).items()
                 if isinstance(getattr(v, "total", v), (int, float, str, bool, type(None)))}
        plugins[n] = (type(p).__name__, p.plugin_type, state)
    profiles = {
        name: ([names[id(f)] for f in prof.filters],
               [(names[id(s)], w) for s, w in prof.scorers],
               names[id(prof.picker)] if prof.picker else None)
        for name, prof in sched.profiles.items()}
    return {"plugins": plugins, "profiles": profiles, "handler": sched.handler,
            "producers": sorted(names[id(p)] for p in sched.producers),
            "pd_threshold": sched.pd_threshold_tokens}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_graph_matches_reference(name):
    text = CONFIGS[name]
    if name == "chip_smoke ROUTER_CFG":  # the card's router phase runs the README's config
        assert text.strip() == CONFIGS["readme precise.yaml"].strip()
    assert port_config.load_yaml(text) == yaml.safe_load(text)
    ref = ref_config.FrameworkConfig.from_yaml(text, known_types=ref_known())
    port = port_config.FrameworkConfig.from_yaml(text, known_types=port_known())
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    try:
        ref_graph = _graph(RefScheduler(ref, ref_endpoint.EndpointPool()))
    except TypeError as e:  # a config that parses but names params a plugin lacks
        with pytest.raises(TypeError, match=re.escape(str(e).split("(")[-1])):
            PortScheduler(port, port_endpoint.EndpointPool())
        return
    port_graph = _graph(PortScheduler(port, port_endpoint.EndpointPool()))
    assert port_graph == ref_graph
    assert ref_graph["profiles"]


# -- the YAML subset ---------------------------------------------------------
_word = st.text(alphabet="abcdefghijklmnopqrstuvwxyz-_./ 0123456789:#'\"", min_size=0,
                max_size=12)
_scalar = st.one_of(st.none(), st.booleans(), st.integers(-10**6, 10**6),
                    st.floats(allow_nan=False, width=32), _word)
_key = st.one_of(st.text(alphabet="abcdefghijklmnopqrstuvwxyzA-Z_", min_size=1,
                         max_size=8), st.integers(0, 99))
_doc = st.recursive(_scalar, lambda inner: st.one_of(
    st.lists(inner, max_size=4), st.dictionaries(_key, inner, max_size=4)), max_leaves=16)


@settings(max_examples=150, deadline=None)
@given(doc=st.dictionaries(_key, _doc, max_size=5), flow=st.sampled_from([False, None, True]),
       indent=st.sampled_from([2, 4]))
@example(doc={"AA": ["' "], "A": None}, flow=None, indent=2)  # '' inside a flow '...'
def test_yaml_subset_reads_what_pyyaml_writes(doc, flow, indent):
    text = yaml.safe_dump(doc, default_flow_style=flow, width=10**6, indent=indent,
                          sort_keys=False)
    assert port_config.load_yaml(text) == yaml.safe_load(text), text


@pytest.mark.parametrize("text,line", [
    ("a: 1\nb: &anchor 2\n", 2), ("a: *alias\n", 1), ("a: !!str 1\n", 1),
    ("a: |\n  block\n", 1), ("a: plain\n  continued\n", 2), ("when: 2024-01-02\n", 1),
    ("t: 1:30\n", 1), ("---\na: 1\n---\nb: 2\n", 3), ("? complex\n: key\n", 1),
    ("a: [1, 2\n", 1), ("a:\n\t- 1\n", 2), ("%YAML 1.1\na: 1\n", 1),
    ("plugins:\n  - {name: a, type: b}\n   - {name: c}\n", 3),
])
def test_yaml_outside_the_subset_is_refused_with_its_line(text, line):
    with pytest.raises(port_config.ConfigError, match=rf"^line {line}:"):
        port_config.load_yaml(text)


# -- scheduling ----------------------------------------------------------------
PREFIXES = ["alpha beta gamma delta ", "the quick brown fox jumps ", "zz "]


def _pools(endpoints):
    """The same endpoints in a reference and a port pool."""
    ref, port = ref_endpoint.EndpointPool(), port_endpoint.EndpointPool()
    for i, (role, labels) in enumerate(endpoints):
        ref.upsert(ref_endpoint.Endpoint(address=f"10.0.0.{i}:8000", labels=dict(labels),
                                         role=ref_endpoint.EndpointRole(role)))
        port.upsert(port_endpoint.Endpoint(address=f"10.0.0.{i}:8000", labels=dict(labels),
                                           role=port_endpoint.EndpointRole(role)))
    return ref, port


def _set_attrs(pools, attrs):
    for pool in pools:
        for ep, (queue, kv, running, lora) in zip(pool.list(), attrs):
            ep.attrs.put(StdMetric.QUEUED_REQUESTS, queue)
            ep.attrs.put(StdMetric.KV_UTILIZATION, kv)
            ep.attrs.put(StdMetric.RUNNING_REQUESTS, running)
            ep.attrs.put(StdMetric.LORA_INFO, lora)


def _result(res) -> dict:
    def addr(ep):
        return ep.address if ep is not None else None

    profiles = {}
    for name, run in res.profiles.items():
        det = run.detail
        if det is not None:
            det = {**det, "scorers": [(n, w, {e.address: s for e, s in m.items()})
                                      for n, w, m in det["scorers"]]}
        profiles[name] = (addr(run.endpoint), {e.address: s for e, s in run.scores.items()},
                          det)
    return {"endpoint": addr(res.endpoint), "prefill": addr(res.prefill_endpoint),
            "profiles": profiles, "rejected": res.rejected, "pre_drops": res.pre_drops,
            "pd": res.pd}


_attrs = st.tuples(st.sampled_from([0.0, 0.0, 2.0, 7.0, 15.0]),
                   st.sampled_from([0.0, 0.25, 0.5, 0.97]),
                   st.sampled_from([0.0, 1.0, 4.0]),
                   st.sampled_from([None, {"running": ["a"], "waiting": [], "max_lora": 2},
                                    {"running": [], "waiting": ["b"], "max_lora": 1}]))
_step = st.tuples(st.integers(0, len(PREFIXES) - 1), st.text("abcxyz ", max_size=12),
                  st.sampled_from([None, "a", "b"]), st.sampled_from(["", "t1", "t2"]),
                  st.integers(1, 64), st.booleans(), st.booleans(),
                  st.lists(_attrs, min_size=4, max_size=4))


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(cfg_name=st.sampled_from(["wide", "disagg", "test_router CFG", "test_router RR_CFG"]),
       endpoints=st.lists(st.tuples(st.sampled_from(["both", "prefill", "decode"]),
                                    st.sampled_from([{}, {"zone": "a"}])),
                          min_size=1, max_size=4),
       seed=st.integers(0, 2**32 - 1), steps=st.lists(_step, min_size=1, max_size=10),
       exclude_first=st.booleans())
def test_scheduling_matches_reference(clock, cfg_name, endpoints, seed, steps, exclude_first):
    text = CONFIGS[cfg_name]
    ref_pool, port_pool = _pools(endpoints)
    ref = RefScheduler(ref_config.FrameworkConfig.from_yaml(text), ref_pool)
    port = PortScheduler(port_config.FrameworkConfig.from_yaml(text), port_pool, seed=seed)
    random.seed(seed)  # the reference draws from the global random
    for n, (pfx, suffix, lora, fid, max_tokens, post, chat, attrs) in enumerate(steps):
        clock.t += 1.0
        _set_attrs((ref_pool, port_pool), attrs)
        prompt = PREFIXES[pfx] + suffix
        kw = dict(request_id=f"r{n}", model="m", lora_adapter=lora, fairness_id=fid)
        if chat:
            kw["messages"] = [{"role": "user", "content": prompt}]
        else:
            kw["prompt"] = prompt
        rreq = RefRequest(sampling=RefSampling(max_tokens=max_tokens), **kw)
        preq = PortRequest(sampling=PortSampling(max_tokens=max_tokens), **kw)
        exclude = {"10.0.0.0:8000"} if exclude_first and n % 3 == 2 else None
        want = ref.schedule(rreq, exclude)
        got = port.schedule(preq, exclude)
        assert _result(got) == _result(want), n
        assert preq.state == rreq.state, n
        if post and want.endpoint is not None:
            ref.post_response(rreq, want.endpoint, {"status": 200})
            port.post_response(preq, got.endpoint, {"status": 200})
    assert port.metrics == ref.metrics
    assert port.ctx.keys() == ref.ctx.keys()
    for key in ("inflight_requests", "inflight_tokens", "no_hit_lru"):
        assert port.ctx.get(key) == ref.ctx.get(key)


# -- the KV index ------------------------------------------------------------
_tokens = st.lists(st.integers(0, 50), min_size=4, max_size=40)
_event = st.one_of(
    st.tuples(st.just("store"), _tokens, st.sampled_from(["gpu", "cpu", "fs"]),
              st.sampled_from([None, "ad@1f"])),
    st.tuples(st.just("remove"), _tokens, st.sampled_from(["gpu", "cpu"]), st.none()),
    st.tuples(st.just("clear"), st.just([]), st.just("gpu"), st.none()))


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(batches=st.lists(st.tuples(st.integers(0, 2), st.lists(_event, max_size=4)),
                        min_size=1, max_size=8),
       queries=st.lists(st.tuples(_tokens, st.sampled_from([None, "ad"])), min_size=1,
                        max_size=5),
       backend=st.sampled_from(["in-memory", "cost-aware"]), seq_skip=st.integers(0, 2))
def test_kv_index_from_event_bytes_matches_reference(clock, batches, queries, backend,
                                                     seq_skip):
    from llmd_tpu.kv.index_backends import build_index as ref_build

    params = {"max_bytes": 4000} if backend == "cost-aware" else {"max_keys": 40}
    ref_idx, port_idx = ref_build(backend, **params), build_index(backend, **params)
    ref_sub, port_sub = RefSubscriber(ref_idx), PortSubscriber(port_idx)
    bs = 4
    for seq, (pod, events) in enumerate(batches):
        evs = []
        for kind, toks, medium, lora in events:
            keys = block_keys_for_tokens(toks, bs, lora)
            if kind == "store":
                evs.append(BlockStored(block_hashes=keys, parent_block_hash=None,
                                       token_ids=toks[:len(keys) * bs], block_size=bs,
                                       lora_id=lora, medium=medium))
            elif kind == "remove":
                evs.append(BlockRemoved(block_hashes=keys, medium=medium))
            else:
                evs.append(AllBlocksCleared())
        data = encode_event_batch(evs, seq=seq * (1 + seq_skip))
        topic = f"kv@10.0.0.{pod}:8000@m".encode()
        ref_sub._handle(topic, data)
        port_sub._handle(topic, data)
    assert (port_sub.seq_gaps, port_sub.batches_received) == (ref_sub.seq_gaps,
                                                              ref_sub.batches_received)
    pods = [f"10.0.0.{i}:8000" for i in range(3)]
    for toks, lora in queries:
        keys = block_keys_for_tokens(toks, bs, port_idx.resolve_lora_key(lora))
        assert (ref_idx.resolve_lora_key(lora) == port_idx.resolve_lora_key(lora))
        want, got = ref_idx.lookup(keys, pods), port_idx.lookup(keys, pods)
        assert {p: dataclasses.astuple(m) for p, m in got.items()} == \
               {p: dataclasses.astuple(m) for p, m in want.items()}
    # the precise producers read the same hits off the two indexes; a pick's
    # speculative insert expires on the fake clock alike
    ref_prod = ref_kv_plugins.PrecisePrefixCacheProducer({"kv_index": ref_idx}, blockSize=bs)
    port_prod = port_kv_plugins.PrecisePrefixCacheProducer({"kv_index": port_idx},
                                                           blockSize=bs)
    ref_eps = [ref_endpoint.Endpoint(address=p) for p in pods]
    port_eps = [port_endpoint.Endpoint(address=p) for p in pods]
    for toks, lora in queries:
        rreq = RefRequest(request_id="q", token_ids=toks, lora_adapter=lora)
        preq = PortRequest(request_id="q", token_ids=toks, lora_adapter=lora)
        rreq.state["token_ids"] = preq.state["token_ids"] = list(toks)
        ref_prod.produce(rreq, ref_eps)
        port_prod.produce(preq, port_eps)
        assert preq.state == rreq.state
        ref_prod.pre_request(rreq, ref_eps[0])
        port_prod.pre_request(preq, port_eps[0])
        clock.t += 1.5
    assert len(port_idx) == len(ref_idx)
    assert dataclasses.astuple(port_idx.stats) == dataclasses.astuple(ref_idx.stats)


# -- flow control ------------------------------------------------------------
class Flight:
    """Stands in for the flight recorder: the flow events, in order."""

    def __init__(self) -> None:
        self.events = []

    def record(self, request_id, event, **attrs):
        self.events.append((request_id, event, tuple(sorted(attrs.items()))))


class Gate:
    """The saturation detector, scripted; counts the dispatch loop's passes."""

    def __init__(self) -> None:
        self.saturated_now = True
        self.calls = 0

    def saturated(self, pool) -> bool:
        self.calls += 1
        return self.saturated_now


async def _flow_script(pkg, clock, script):
    flow_mod = ref_flow_mod if pkg == "ref" else port_flow_mod
    config = ref_config if pkg == "ref" else port_config
    Request = RefRequest if pkg == "ref" else PortRequest
    spec = config.FlowControlSpec(enabled=True, bands=[
        config.PriorityBandSpec(priority=0, name="standard", max_requests=4, ttl_s=5.0),
        config.PriorityBandSpec(priority=5, name="fair", max_requests=6, max_bytes=5000,
                                ttl_s=3.0, fairness_policy="round-robin",
                                ordering_policy="edf"),
        config.PriorityBandSpec(priority=10, name="strict", max_requests=3, ttl_s=9.0,
                                fairness_policy="global-strict", ordering_policy="edf"),
    ])
    pool = (ref_endpoint if pkg == "ref" else port_endpoint).EndpointPool()
    fc = flow_mod.FlowController(spec, pool)
    fc.flight = Flight()
    gate = fc.detector = Gate()
    await fc.start()
    outcomes = {}

    async def submit(req):
        outcomes[req.request_id] = (await fc.enqueue_and_wait(req)).value

    async def passes(n=2):
        start = gate.calls
        for _ in range(2000):
            # n passes of the loop, or nothing queued (the loop then sleeps)
            if gate.calls >= start + n or fc._total_queued() == 0:
                return
            await asyncio.sleep(0.001)
        raise AssertionError("the dispatch loop did not go round")

    tasks = []
    try:
        for i, (prio, fid, size, slo, timeout, advance) in enumerate(script):
            req = Request(request_id=f"r{i}", priority=prio, fairness_id=fid, byte_size=size,
                          slo_ttft_ms=slo, timeout_s=timeout, arrival_time=clock.t)
            tasks.append(asyncio.ensure_future(submit(req)))
            await asyncio.sleep(0)
            if advance:
                clock.t += advance
                await passes()
        await passes()
        gate.saturated_now = False
        await asyncio.wait_for(asyncio.gather(*tasks), 10)
    finally:
        await fc.stop()
    return fc.flight.events, outcomes, dict(fc.metrics)


_flow_step = st.tuples(st.sampled_from([0, 0, 5, 7, 10, 12]), st.sampled_from(["", "a", "b"]),
                       st.sampled_from([0, 700, 2000]), st.sampled_from([None, 50.0, 900.0]),
                       st.sampled_from([None, None, 2.5]),
                       st.sampled_from([0.0, 0.0, 0.0, 1.0, 3.5]))


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(script=st.lists(_flow_step, min_size=1, max_size=14))
def test_flow_control_matches_reference(clock, script):
    clock.t = 1000.0
    want = run_async(_flow_script("ref", clock, script))
    clock.t = 1000.0
    got = run_async(_flow_script("port", clock, script))
    assert got == want


# -- resilience ----------------------------------------------------------------
_res_op = st.tuples(st.sampled_from(["fail", "ok", "allow", "filter", "scrape", "drain",
                                     "undrain", "forget", "advance"]),
                    st.integers(0, 2), st.sampled_from([0.5, 2.0, 6.0]))


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(ops=st.lists(_res_op, min_size=1, max_size=40), attempt=st.integers(1, 6))
def test_breaker_states_match_reference(clock, ops, attempt):
    kw = dict(breaker_consecutive_failures=3, breaker_min_volume=4, breaker_window=6,
              breaker_cooldown_s=5.0, breaker_half_open_successes=2)
    ref = ref_res_mod.ResilienceManager(ref_res_mod.ResilienceConfig(**kw))
    port = port_res_mod.ResilienceManager(port_res_mod.ResilienceConfig(**kw))
    addrs = [f"10.0.0.{i}:8000" for i in range(3)]
    for op, i, dt in ops:
        a = addrs[i]
        outs = []
        for m, ep_mod in ((ref, ref_endpoint), (port, port_endpoint)):
            if op == "fail":
                outs.append(m.on_failure(a, reason="http 503"))
            elif op == "ok":
                outs.append(m.on_success(a))
            elif op == "allow":
                outs.append(m.allow(a))
            elif op == "filter":
                outs.append([e.address for e in m.filter_endpoints(
                    [ep_mod.Endpoint(address=x) for x in addrs])])
            elif op == "scrape":
                outs.append(m.note_scrape_error(a))
            elif op == "drain":
                outs.append(m.set_draining(a))
            elif op == "undrain":
                outs.append(m.set_draining(a, False))
            elif op == "forget":
                outs.append(m.forget(a))
        if op == "advance":
            clock.t += dt
        assert outs[1:] == outs[:1], op
        assert port.snapshot() == ref.snapshot()
        assert port.open_endpoints() == ref.open_endpoints()
        assert port.attempt_states(addrs) == ref.attempt_states(addrs)
        assert [port.healthy(x) for x in addrs] == [ref.healthy(x) for x in addrs]
    assert port.backoff_s(attempt) == ref.backoff_s(attempt)  # both seed their own Random


# -- what was refused until the latency and KV planes came ----------------------
@pytest.mark.parametrize("ptype", ["predicted-latency-producer", "latency-scorer",
                                   "slo-headroom-tier-filter", "latency-slo-admitter"])
def test_latency_plugins_are_refused_by_item(ptype):
    """The latency plugin types (once refused by name, ROADMAP Queue A item
    10) build in a scheduler, as the reference's, with the same plugin graph."""
    text = f"plugins: [{{name: x, type: {ptype}}}]"
    cfg = port_config.FrameworkConfig.from_yaml(text, known_types=port_known())
    port = PortScheduler(cfg, port_endpoint.EndpointPool())
    ref = RefScheduler(ref_config.FrameworkConfig.from_yaml(text, known_types=ref_known()),
                       ref_endpoint.EndpointPool())
    assert _graph(port) == _graph(ref)
    assert type(build_plugin(ptype, {}, {})).__name__ == type(ref.plugins["x"]).__name__


def test_external_index_and_planes_are_refused_by_item(monkeypatch):
    """The external index, ``LLMD_KV_PLANE`` and ``LLMD_SLO_*`` (once refused,
    item 12 and item 10) are served: a router builds with each; so are the
    gateway and manifest flags (once refused, item 14): the CLI parses each
    with the reference's defaults and refuses nothing by name."""
    from llmd_tpu_torch.kv.index_backends import ExternalKVBlockIndex
    from llmd_tpu_torch.kvplane import KVPlaneProducer
    from llmd_tpu_torch.router.server import RouterServer

    assert isinstance(build_index("external", host="127.0.0.1", port=9), ExternalKVBlockIndex)
    cfg = port_config.FrameworkConfig.from_yaml(
        "plugins: [{name: q, type: queue-depth-scorer}]\nkvEvents: {indexBackend: external, "
        "indexParams: {port: 9, timeout_s: 0.1}}\n")
    servers = [RouterServer(cfg, port_endpoint.EndpointPool(), port=0)]
    assert isinstance(servers[0].kv_index, ExternalKVBlockIndex)
    prefix = port_config.FrameworkConfig.from_yaml(
        "plugins: [{name: p, type: approx-prefix-cache-producer}, "
        "{name: s, type: prefix-cache-scorer}]\n"
        "schedulingProfiles: [{name: default, plugins: [{pluginRef: s}]}]")
    monkeypatch.setenv("LLMD_KV_PLANE", "precise")
    servers.append(RouterServer(prefix, port_endpoint.EndpointPool(), port=0))
    assert servers[-1].kvplane.active
    assert isinstance(servers[-1].scheduler.plugins["p"], KVPlaneProducer)
    monkeypatch.setenv("LLMD_KV_PLANE", "off")
    monkeypatch.setenv("LLMD_SLO_TTFT_MS", "250")
    servers.append(RouterServer(prefix, port_endpoint.EndpointPool(), port=0))
    assert servers[-1].slo.enabled and servers[-1].slo.default.ttft_ms == 250.0
    assert not servers[-1].kvplane.active and servers[-1].kvplane.swaps == []
    for server in servers:
        server._sched_executor.shutdown(wait=False)
    assert not hasattr(port_serve, "REFUSED_FLAGS")
    gateway = port_serve.build_parser().parse_args([
        "--extproc-port", "9002", "--extproc-failure-mode", "FailOpen", "--vllmgrpc-port",
        "9003", "--manifests", "m.yaml", "--k8s-discovery"])
    assert (gateway.extproc_port, gateway.extproc_failure_mode, gateway.vllmgrpc_port,
            gateway.manifests, gateway.k8s_discovery) == (9002, "FailOpen", 9003, "m.yaml",
                                                          True)
    defaults = port_serve.build_parser().parse_args([])
    assert (defaults.extproc_port, defaults.extproc_failure_mode, defaults.vllmgrpc_port,
            defaults.manifests, defaults.k8s_discovery) == (None, None, None, None, False)
    with pytest.raises(SystemExit):
        port_serve.build_parser().parse_args(["--extproc-failure-mode", "Explode"])
    args = port_serve.build_parser().parse_args(["--ha-lease-file", "lease-file"])
    assert args.ha_lease_file == "lease-file" and args.ha_k8s_lease is None
    with pytest.raises(SystemExit):
        port_serve.main(["--ha-lease-file", "a", "--ha-k8s-lease", "b"])


# -- the request parsers and the sticky conversation pick ---------------------
BODIES = [
    ("/v1/completions", {"model": "m", "prompt": "hello", "max_tokens": 5, "stream": True}),
    ("/v1/chat/completions", {"model": "m", "messages": [
        {"role": "user", "content": [{"type": "text", "text": "a"},
                                     {"type": "image_url", "image_url": {"url": "http://x/i.png"}}]}],
        "temperature": 0.2, "guided_choice": ["a", "b"]}),
    ("/v1/embeddings", {"model": "m", "input": [[1, 2], [3]]}),
    ("/v1/responses", {"model": "m", "input": [{"role": "user", "content": "hi"}],
                       "max_output_tokens": 7}),
    ("/v1/responses", {"model": "m", "input": "plain", "lora_adapter": "ad"}),
    ("/v1/completions", {"model": "m", "prompt": "x", "response_format": {"type": "json_object"},
                         "logit_bias": {"5": -100}}),
]
HEADERS = {"x-llm-d-inference-objective": "gold", "X-LLM-D-Inference-Fairness-Id": "t",
           "x-llm-d-tenant": "acme", "x-llm-d-slo-ttft-ms": "250", "x-request-timeout": "9",
           "x-model": "passthrough-model"}


def _parsed(req) -> dict:
    d = {k: v for k, v in vars(req).items() if k not in ("arrival_time", "request_id",
                                                         "sampling", "mm_hashes")}
    d["sampling"] = dataclasses.asdict(req.sampling)
    d["mm_hashes"] = [bytes(h) for h in req.mm_hashes]
    return d


@pytest.mark.parametrize("parser", ["openai-parser", "passthrough-parser"])
def test_request_parsers_match_reference(parser):
    from llmd_tpu.router import server as ref_server
    from llmd_tpu_torch.router import server as port_server

    for path, body in BODIES:
        want = ref_server.PARSERS[parser](path, dict(body), dict(HEADERS))
        got = port_server.PARSERS[parser](path, dict(body), dict(HEADERS))
        assert _parsed(got) == _parsed(want), (path, body)
    bad = {"model": "m", "prompt": "x", "guided_regex": "("}
    with pytest.raises(ValueError):
        ref_server.parse_openai_request("/v1/completions", bad, {})
    with pytest.raises(ValueError):
        port_server.parse_openai_request("/v1/completions", bad, {})


def test_sticky_conversation_pick_matches_reference():
    """Rendezvous hashing of conversation ids over the decode-capable pods:
    the same pod on both routers for the same pool."""
    from llmd_tpu.router.server import RouterServer as RefRouterServer
    from llmd_tpu_torch.router.server import RouterServer as PortRouterServer

    endpoints = [("both", {}), ("prefill", {}), ("decode", {}), ("both", {})]
    ref_pool, port_pool = _pools(endpoints)
    text = "plugins: [{name: q, type: queue-depth-scorer}]"
    ref = RefRouterServer(ref_config.FrameworkConfig.from_yaml(text), ref_pool, port=0)
    port = PortRouterServer(port_config.FrameworkConfig.from_yaml(text), port_pool, port=0)
    try:
        picks = [(ref._sticky_endpoint(f"conv_{i}").address,
                  port._sticky_endpoint(f"conv_{i}").address) for i in range(64)]
        assert all(a == b for a, b in picks)
        assert len({a for a, _ in picks}) == 3  # never the prefill-only pod
    finally:
        ref._sched_executor.shutdown(wait=False)
        port._sched_executor.shutdown(wait=False)
