"""The KV plane's router side, the external index and HA in the port against
the reference's, on the CPU.

- **RESP store.** The port's ``testing/resp_server.py`` answers every command
  of the index's subset with the reference store's bytes.
- **External index.** ``ExternalKVBlockIndex`` over the port's store and the
  reference's over its own, fed the same event script (stores with tiers and
  adapters, removals, clears, speculative inserts that expire on one fake
  clock): the same hits, pods per block, adapter keys, sizes and stats; two
  replicas over one store converge; an unreachable store degrades to no hits
  (``tests/test_index_backends.py``'s external cases).
- **The plane.** ``KVPlane`` modes on a built router (``off`` keeps the
  config's instances, ``precise`` swaps the approx pair and forces the event
  feed, ``approx`` swaps back), the degraded producer, and ``plan_pull``'s
  stamps (peer threshold, side channel, degraded hits, the durable rung)
  against the reference's under hypothesis.
- **HA.** ``FileLease`` hand-over; two port routers over one flock lease:
  the standby's 503, the ``/health`` role, ``llm_d_epp_leader*`` and the
  failover; ``K8sLease`` acquire, renew, takeover and release against a fake
  coordination API on the standard library, with the reference's lease
  client against the same fake.

No test sleeps out a TTL: a lease's age is set by writing its ``renewTime``
and a speculative entry's by the fake clock.
"""

import asyncio
import calendar
import dataclasses
import json
import socket
import time as _time

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import llmd_tpu.kv.index_backends as ref_ib
import llmd_tpu_torch.kv.index_backends as port_ib
from llmd_tpu.core import endpoint as ref_endpoint
from llmd_tpu.core.kv_events import BlockStored as RefBlockStored
from llmd_tpu.core.request import InferenceRequest as RefRequest
from llmd_tpu.kvplane import plane as ref_plane
from llmd_tpu.router.ha import K8sLease as RefK8sLease
from llmd_tpu.testing.fake_server import FakeModelServer, FakeServerConfig
from llmd_tpu.testing.resp_server import RespStoreServer as RefRespStore
from llmd_tpu_torch.core import config as port_config
from llmd_tpu_torch.core import endpoint as port_endpoint
from llmd_tpu_torch.core.kv_events import (
    AllBlocksCleared,
    BlockRemoved,
    BlockStored,
    block_keys_for_tokens,
)
from llmd_tpu_torch.core.request import InferenceRequest as PortRequest
from llmd_tpu_torch.kvplane import plane as port_plane
from llmd_tpu_torch.router.ha import FileLease, K8sLease, LeaderElector, attach_ha
from llmd_tpu_torch.router.http import HTTPClient, HTTPServer, Request, json_response
from llmd_tpu_torch.router.plugins import known_plugin_types
from llmd_tpu_torch.router.scorers import (
    STATE_BLOCK_KEYS,
    STATE_PREFIX_HITS,
    ApproxPrefixCacheProducer,
    PrefixCacheScorer,
)
from llmd_tpu_torch.kv.plugins import PrecisePrefixCacheProducer, PrecisePrefixCacheScorer
from llmd_tpu_torch.router.server import RouterServer
from llmd_tpu_torch.testing.resp_server import RespStoreServer
from tests.conftest import run_async


class Clock:
    def __init__(self) -> None:
        self.t = 1_700_000_000.0

    def time(self) -> float:
        return self.t

    def monotonic(self) -> float:
        return self.t


@pytest.fixture(scope="module")
def stores():
    port, ref = RespStoreServer(), RefRespStore()
    port.start(), ref.start()
    yield port, ref
    port.stop(), ref.stop()


# -- the RESP store ---------------------------------------------------------------
def _resp(*parts: bytes) -> bytes:
    return b"*%d\r\n" % len(parts) + b"".join(b"$%d\r\n%s\r\n" % (len(p), p) for p in parts)


def test_resp_store_answers_as_the_reference(stores):
    script = [(b"PING",), (b"HSET", b"h", b"a", b"1", b"b", b"2"), (b"HSET", b"h", b"a", b"3"),
              (b"HGET", b"h", b"a"), (b"HGET", b"h", b"zz"), (b"HGETALL", b"h"),
              (b"HGETALL", b"none"), (b"SADD", b"s", b"x", b"y", b"x"), (b"SADD", b"s", b"y"),
              (b"SMEMBERS", b"s"), (b"DBSIZE",), (b"SREM", b"s", b"x", b"q"),
              (b"HDEL", b"h", b"a", b"b", b"c"), (b"DEL", b"s", b"h", b"gone"),
              (b"DBSIZE",), (b"nosuch", b"x"), (b"HSET", b"k", b"f", b"v"), (b"FLUSHALL",),
              (b"DBSIZE",)]
    wire = b"".join(_resp(*c) for c in script)
    answers = []
    for srv in stores:
        with socket.create_connection(("127.0.0.1", srv.port), timeout=5) as s:
            s.sendall(wire)
            buf = b""
            s.settimeout(0.5)
            try:
                while True:
                    chunk = s.recv(65536)
                    if not chunk:
                        break
                    buf += chunk
                    if buf.endswith(b":0\r\n") and buf.count(b"+OK") == 1:
                        break
            except TimeoutError:
                pass
        answers.append(buf)
    assert answers[0] == answers[1] and answers[0].startswith(b"+PONG\r\n:2\r\n:0\r\n$1\r\n3")


# -- the external index -------------------------------------------------------------
_tokens = st.lists(st.integers(0, 30), min_size=4, max_size=24)
_event = st.one_of(
    st.tuples(st.just("store"), _tokens, st.sampled_from(["gpu", "cpu"]),
              st.sampled_from([None, "ad@3"])),
    st.tuples(st.just("remove"), _tokens, st.sampled_from(["gpu", "cpu"]), st.none()),
    st.tuples(st.just("spec"), _tokens, st.sampled_from(["gpu", "cpu"]), st.none()),
    st.tuples(st.just("clear"), st.just([]), st.just("gpu"), st.none()),
    st.tuples(st.just("tick"), st.just([]), st.just("gpu"), st.none()))


@settings(max_examples=12, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(events=st.lists(st.tuples(st.integers(0, 2), _event), min_size=1, max_size=12),
       queries=st.lists(st.tuples(_tokens, st.sampled_from([None, "ad", "other"])),
                        min_size=1, max_size=4))
def test_external_index_matches_reference(stores, monkeypatch, events, queries):
    clock = Clock()
    monkeypatch.setattr(ref_ib, "time", clock)
    monkeypatch.setattr(port_ib, "time", clock)
    port_store, ref_store = stores
    for s in stores:
        s._hashes.clear(), s._sets.clear()
    port = port_ib.build_index("external", host="127.0.0.1", port=port_store.port,
                               speculative_ttl_s=2.0)
    ref = ref_ib.build_index("external", host="127.0.0.1", port=ref_store.port,
                             speculative_ttl_s=2.0)
    bs = 4
    try:
        for pod_i, (kind, toks, medium, lora) in events:
            pod = f"10.0.0.{pod_i}:8000"
            keys = block_keys_for_tokens(toks, bs, lora)
            for idx in (port, ref):
                mod = port_ib if idx is port else ref_ib
                if kind == "store":
                    idx.apply(pod, mod.BlockStored(block_hashes=keys, parent_block_hash=None,
                                                   token_ids=toks[:len(keys) * bs],
                                                   block_size=bs, lora_id=lora, medium=medium))
                elif kind == "remove":
                    idx.apply(pod, mod.BlockRemoved(block_hashes=keys, medium=medium))
                elif kind == "spec":
                    idx.add_speculative(pod, keys, tier=medium)
                elif kind == "clear":
                    idx.apply(pod, mod.AllBlocksCleared())
            if kind == "tick":
                clock.t += 1.5
        pods = [f"10.0.0.{i}:8000" for i in range(3)]
        for toks, lora in queries:
            assert port.resolve_lora_key(lora) == ref.resolve_lora_key(lora)
            keys = block_keys_for_tokens(toks, bs, port.resolve_lora_key(lora))
            got, want = port.lookup(keys, pods), ref.lookup(keys, pods)
            assert {p: dataclasses.astuple(m) for p, m in got.items()} == \
                   {p: dataclasses.astuple(m) for p, m in want.items()}
            for k in keys[:3]:
                assert port.pods_for_block(k) == ref.pods_for_block(k)
        assert len(port) == len(ref)
        assert dataclasses.asdict(port.stats) == dataclasses.asdict(ref.stats)
        assert port_store._hashes == ref_store._hashes and port_store._sets == ref_store._sets
        for pod in pods:
            port.remove_pod(pod), ref.remove_pod(pod)
        assert len(port) == len(ref)
    finally:
        port.client.close(), ref.client.close()


def test_external_index_shared_across_replicas_and_outage(stores):
    """tests/test_index_backends.py's external cases on the port's backend."""
    srv = stores[0]
    a = port_ib.ExternalKVBlockIndex(host="127.0.0.1", port=srv.port)
    b = port_ib.ExternalKVBlockIndex(host="127.0.0.1", port=srv.port)
    stored = BlockStored(block_hashes=[1, 2, 3], parent_block_hash=None, token_ids=[],
                         block_size=16)
    a.apply("pod-x", stored)
    assert b.lookup([1, 2, 3], ["pod-x"])["pod-x"].blocks == 3
    b.apply("pod-x", AllBlocksCleared())
    assert a.lookup([1], ["pod-x"])["pod-x"].blocks == 0
    a.apply("pod-x", BlockStored(block_hashes=[7], parent_block_hash=None, token_ids=[],
                                 block_size=16, lora_id="ad@9"))
    assert b.resolve_lora_key("ad") == "ad@9"
    b.apply("pod-x", BlockRemoved(block_hashes=[7]))
    assert a.lookup([7], ["pod-x"])["pod-x"].blocks == 0
    a.client.close(), b.client.close()
    dead = port_ib.ExternalKVBlockIndex(host="127.0.0.1", port=9, timeout_s=0.2)
    dead.apply("pod-a", stored)  # swallowed
    dead.add_speculative("pod-a", [1])
    assert dead.lookup([1], ["pod-a"])["pod-a"].blocks == 0
    assert dead.resolve_lora_key("x") == "x" and dead.pods_for_block(1) == {}
    assert len(dead) == 0


# -- the plane -------------------------------------------------------------------
APPROX_CFG = """
plugins:
  - {name: prefix, type: approx-prefix-cache-producer}
  - {name: prefix-score, type: prefix-cache-scorer}
schedulingProfiles:
  - name: default
    plugins:
      - {pluginRef: prefix-score, weight: 1}
"""
PRECISE_CFG = """
plugins:
  - {name: prefix, type: precise-prefix-cache-producer}
  - {name: prefix-score, type: precise-prefix-cache-scorer}
schedulingProfiles:
  - name: default
    plugins:
      - {pluginRef: prefix-score, weight: 1}
"""


def _router(text: str) -> RouterServer:
    cfg = port_config.FrameworkConfig.from_yaml(text, known_types=known_plugin_types())
    return RouterServer(cfg, port_endpoint.EndpointPool(), port=0, poll_interval_s=3600)


def test_plane_modes_on_a_router(monkeypatch):
    """``off``: the config's instances, no feed, no stamp; ``precise``: the
    approx pair swapped, the feed forced on, the profiles re-derived;
    ``approx``: the precise pair swapped back, no pulls."""
    monkeypatch.delenv("LLMD_KV_PLANE", raising=False)
    routers = [_router(APPROX_CFG)]
    r = routers[0]
    assert not r.kvplane.active and r.kvplane.swaps == [] and r.kv_subscriber is None
    assert type(r.scheduler.plugins["prefix"]) is ApproxPrefixCacheProducer
    req, body = PortRequest(model="m", prompt="x" * 64), {"prompt": "x" * 64}
    r._stamp_kv_pull(req, port_endpoint.Endpoint(address="10.0.0.1:80"), body)
    assert "kv_transfer_params" not in body and "kv_plane_stamped" not in req.state
    monkeypatch.setenv("LLMD_KV_PLANE", "precise")
    routers.append(_router(APPROX_CFG))
    r = routers[-1]
    plugs = r.scheduler.plugins
    assert isinstance(plugs["prefix"], port_plane.KVPlaneProducer)
    assert type(plugs["prefix-score"]) is PrecisePrefixCacheScorer
    assert r.kv_subscriber is not None and r.kvplane.subscriber is r.kv_subscriber
    assert plugs["prefix"] in r.scheduler.producers
    assert any(p is plugs["prefix-score"] for p, _ in r.scheduler.profiles["default"].scorers)
    assert r.kvplane.swaps == ["prefix: approx-producer->kv-plane-producer",
                               "prefix-score: prefix-scorer->precise-scorer"]
    monkeypatch.setenv("LLMD_KV_PLANE", "approx")
    routers.append(_router(PRECISE_CFG))
    r = routers[-1]
    assert type(r.scheduler.plugins["prefix"]) is ApproxPrefixCacheProducer
    assert type(r.scheduler.plugins["prefix-score"]) is PrefixCacheScorer
    req.state[port_plane.STATE_KV_PLANE] = "precise"
    assert not r.kvplane.active and r.kvplane.plan_pull(req, "10.0.0.1:80") is None
    monkeypatch.setenv("LLMD_KV_PLANE", "precise")
    routers.append(_router(PRECISE_CFG))
    assert routers[-1].kvplane.swaps == ["prefix: precise-producer->kv-plane-producer"]
    assert isinstance(routers[-1].scheduler.plugins["prefix"].precise,
                      PrecisePrefixCacheProducer)
    for r in routers:
        r._sched_executor.shutdown(wait=False)


def test_plane_producer_degrades_when_cold_or_stale(monkeypatch):
    clock = Clock()
    outs = []
    for mod, ep_mod, req_cls, stored in (
            (ref_plane, ref_endpoint, RefRequest, RefBlockStored),
            (port_plane, port_endpoint, PortRequest, BlockStored)):
        monkeypatch.setattr(mod, "time", clock)
        ctx: dict = {}
        plane = mod.KVPlane("precise", ctx, ep_mod.EndpointPool(), stale_s=5.0)
        prod = mod.KVPlaneProducer(ctx, plane, blockSize=8)

        class Feed:
            batches_received = 0

        plane.subscriber = Feed()
        eps = [ep_mod.Endpoint(address="10.0.0.1:80")]
        path = []
        for step in range(6):
            req = req_cls(model="m", prompt="w" * 64)
            prod.produce(req, eps)
            prod.pre_request(req, eps[0])
            path.append((req.state[mod.STATE_KV_PLANE], plane.feed_age_s()))
            if step == 1:  # warm the index
                ctx["kv_index"].apply("10.0.0.1:80", stored(
                    block_hashes=[1], parent_block_hash=None, token_ids=[0] * 8,
                    block_size=8))
                Feed.batches_received += 1
            clock.t += 3.0  # stale after two quiet steps
        outs.append((path, dict(plane.stats)))
    assert outs[1] == outs[0]
    assert [p for p, _ in outs[1][0]][:4] == ["degraded", "degraded", "precise", "precise"]
    assert outs[1][0][-1][0] == "degraded"


@settings(max_examples=60, deadline=None)
@given(hits=st.dictionaries(st.sampled_from(["10.0.0.1:80", "10.0.0.2:80", "10.0.0.3:80"]),
                            st.integers(0, 80), max_size=3),
       n_keys=st.integers(0, 10), threshold=st.integers(1, 4),
       path=st.sampled_from(["precise", "degraded", None]),
       labels=st.sampled_from([{}, {"kv_transfer_port": "7000"},
                               {"kv_transfer_address": "10.9.9.9:7100"},
                               {"kv_transfer_port": "bad"}]),
       durable=st.sampled_from([None, 0, 2, 6, 10]))
def test_plan_pull_stamps_match_reference(hits, n_keys, threshold, path, labels, durable):
    outs = []
    for mod, ep_mod, req_cls in ((ref_plane, ref_endpoint, RefRequest),
                                 (port_plane, port_endpoint, PortRequest)):
        pool = ep_mod.EndpointPool()
        for a in ("10.0.0.1:80", "10.0.0.2:80", "10.0.0.3:80"):
            pool.upsert(ep_mod.Endpoint(address=a, labels=dict(labels)))
        plane = mod.KVPlane("precise", {}, pool, pull_threshold_blocks=threshold)
        plane.block_size = 8
        if durable is not None:
            class Probe:
                def probe(self, keys, found=durable):
                    return min(found, len(keys))

            plane.durable_probe = Probe()
        req = req_cls(request_id="r1", model="m", prompt="z" * 64)
        if path:
            req.state[mod.STATE_KV_PLANE] = path
        req.state[STATE_BLOCK_KEYS] = list(range(100, 100 + n_keys))
        req.state[STATE_PREFIX_HITS] = dict(hits)
        outs.append((plane.plan_pull(req, "10.0.0.1:80"), dict(plane.stats),
                     [mod.transfer_address(e) for e in pool.list()]))
    assert outs[1] == outs[0]


def test_router_stamps_a_pull_and_keeps_client_params(monkeypatch):
    """The router's stamp: a peer holding 6 more blocks is stamped onto the
    body (``peer`` and the estimate stay in the flight record), a re-pick
    re-plans, client-owned transfer params are left alone."""
    monkeypatch.setenv("LLMD_KV_PLANE", "precise")
    r = _router(APPROX_CFG)
    r.pool.upsert(port_endpoint.Endpoint(address="10.0.0.9:8000",
                                         labels={"kv_transfer_port": "7000"}))
    r.kvplane.block_size = 8
    req = PortRequest(request_id="rq", model="m", prompt="z" * 64)
    req.state.update({port_plane.STATE_KV_PLANE: "precise",
                      STATE_BLOCK_KEYS: list(range(8)),
                      STATE_PREFIX_HITS: {"10.0.0.9:8000": 48, "10.0.0.1:80": 0}})
    body: dict = {}
    r._stamp_kv_pull(req, port_endpoint.Endpoint(address="10.0.0.1:80"), body)
    assert body["kv_transfer_params"] == {
        "do_prefix_pull": True, "remote_host": "10.0.0.9", "remote_port": 7000,
        "remote_request_id": "rq", "num_blocks": 6, "block_hashes": list(range(6))}
    r._stamp_kv_pull(req, port_endpoint.Endpoint(address="10.0.0.9:8000"), body)
    assert "kv_transfer_params" not in body and not req.state["kv_plane_stamped"]
    own = {"kv_transfer_params": {"do_remote_prefill": True}}
    r._stamp_kv_pull(req, port_endpoint.Endpoint(address="10.0.0.1:80"), own)
    assert own == {"kv_transfer_params": {"do_remote_prefill": True}}
    assert r.kvplane.stats["pulls_planned"] == 1
    r._sched_executor.shutdown(wait=False)


# -- HA ----------------------------------------------------------------------------
def test_file_lease_single_holder(tmp_path):
    a = FileLease(str(tmp_path / "lease"), identity="a")
    b = FileLease(str(tmp_path / "lease"), identity="b")
    assert a.try_acquire() and a.renew() and a.try_acquire()
    assert not b.try_acquire() and not b.renew()
    assert a.holder() == "a"
    a.release()
    assert b.try_acquire() and b.holder() == "b"
    b.release()
    assert FileLease(str(tmp_path / "absent" / "x")).holder() is None


HA_CFG = """
plugins:
  - {name: queue, type: queue-depth-scorer}
  - {name: inflight, type: inflight-load-producer}
schedulingProfiles:
  - name: default
    plugins:
      - {pluginRef: queue, weight: 2}
"""


def test_active_passive_failover(tmp_path):
    """Two port routers over one flock lease: the leader serves, the standby
    answers 503 and reports its role; the leader stops, the standby's next
    election tick takes the lease and serves."""
    lease_path = str(tmp_path / "lease")

    async def main():
        fake = FakeModelServer(FakeServerConfig())
        await fake.start()
        routers, electors = [], []
        for ident in ("r1", "r2"):
            pool = port_endpoint.EndpointPool()
            pool.upsert(port_endpoint.Endpoint(address=fake.address))
            cfg = port_config.FrameworkConfig.from_yaml(HA_CFG, known_types=known_plugin_types())
            router = RouterServer(cfg, pool, port=0, poll_interval_s=3600)
            elector = LeaderElector(FileLease(lease_path, identity=ident), interval_s=3600)
            attach_ha(router, elector)
            routers.append(router), electors.append(elector)
        client = HTTPClient()
        out = []

        async def call(method, router, path, body=None):
            r = await client.request(method, f"http://{router.address}{path}", json_body=body)
            data = await r.read()
            out.append((path, r.status))
            return data

        try:
            for router in routers:
                await router.start()
            for e in electors:
                await e.start()
            assert electors[0].is_leader and not electors[1].is_leader
            body = {"model": "fake/model", "prompt": "x", "max_tokens": 2}
            await call("POST", routers[0], "/v1/completions", body)
            msg = json.loads(await call("POST", routers[1], "/v1/completions", body))
            assert "standby" in msg["error"]["message"]
            health = json.loads(await call("GET", routers[1], "/health"))
            assert health == {"status": "ok", "endpoints": 1, "role": "standby"}
            text = (await call("GET", routers[1], "/metrics")).decode()
            assert "llm_d_epp_leader 0\nllm_d_epp_leader_transitions_total 0\n" in text
            await electors[0].stop()
            await electors[1]._tick()  # the next election interval
            assert electors[1].is_leader and electors[1].transitions == 1
            await call("POST", routers[1], "/v1/completions", body)
            text = (await call("GET", routers[1], "/metrics")).decode()
            assert "llm_d_epp_leader 1\n" in text
            assert json.loads(await call("GET", routers[1], "/health"))["role"] == "leader"
        finally:
            await client.close()
            await electors[1].stop()
            for router in routers:
                await router.stop()
            await fake.stop()
        return out

    out = run_async(main())
    assert [s for _, s in out] == [200, 503, 200, 200, 200, 200, 200]


class FakeLeaseAPI:
    """The coordination.k8s.io Lease subset with resourceVersion conflicts
    (``tests/test_ha.py``'s fake, on the standard library)."""

    def __init__(self) -> None:
        self.lease = None
        self.rv = 0
        self.conflicts = 0
        self.tokens: list = []
        self.front = HTTPServer()
        base = "/apis/coordination.k8s.io/v1/namespaces/{ns}/leases"
        self.front.add_route("*", base, self._col)
        self.front.add_route("*", base + "/{name}", self._item)

    async def start(self) -> None:
        await self.front.start("127.0.0.1", 0)

    @property
    def base(self) -> str:
        return f"http://127.0.0.1:{self.front.port}"

    def age(self, seconds: float) -> None:
        """Backdate the holder's last renew by ``seconds``."""
        stamp = _time.gmtime(_time.time() - seconds)
        self.lease["spec"]["renewTime"] = _time.strftime("%Y-%m-%dT%H:%M:%S.000000Z", stamp)

    async def _col(self, request: Request):
        self.tokens.append(request.headers.get("authorization"))
        if request.method == "POST":
            if self.lease is not None:
                return json_response({}, status=409)
            self.lease = await request.json()
            self.rv += 1
            self.lease["metadata"]["resourceVersion"] = str(self.rv)
            return json_response(self.lease, status=201)
        return json_response({}, status=405)

    async def _item(self, request: Request):
        self.tokens.append(request.headers.get("authorization"))
        if request.method == "GET":
            if self.lease is None:
                return json_response({}, status=404)
            return json_response(self.lease)
        if request.method == "PUT":
            body = await request.json()
            want = body.get("metadata", {}).get("resourceVersion")
            have = self.lease["metadata"]["resourceVersion"] if self.lease else None
            if self.lease is not None and want != have:
                self.conflicts += 1
                return json_response({}, status=409)
            self.rv += 1
            body["metadata"]["resourceVersion"] = str(self.rv)
            self.lease = body
            return json_response(body)
        return json_response({}, status=405)


@pytest.mark.parametrize("client", ["port", "reference"])
def test_k8s_lease_acquire_renew_takeover(client):
    """Create, hold against a peer, renew, take over a lapsed lease, lose a
    resourceVersion race, release: the port's lease client, and the
    reference's against the same fake for the same answers."""
    cls = K8sLease if client == "port" else RefK8sLease

    async def main():
        api = FakeLeaseAPI()
        await api.start()
        a = cls("epp", identity="a", lease_seconds=5.0, api_base=api.base, token="t")
        b = cls("epp", identity="b", lease_seconds=5.0, api_base=api.base, token="t")
        try:
            seen = [await a.try_acquire(), await b.try_acquire(), await a.renew()]
            renew = api.lease["spec"]["renewTime"]
            seen.append(abs(calendar.timegm(_time.strptime(renew.split(".")[0],
                                                           "%Y-%m-%dT%H:%M:%S"))
                            - _time.time()) < 5)
            api.age(6.0)  # a stopped renewing one lease duration ago
            seen += [await b.try_acquire(), api.lease["spec"]["holderIdentity"],
                     await a.try_acquire()]
            api.lease["spec"]["renewTime"] = "garbage"  # unparseable: stale
            api.lease["metadata"]["resourceVersion"] = "999"
            api.rv = 999
            seen.append(await a.try_acquire())
            await b.release()  # b no longer holds it: no write
            seen.append(api.lease["spec"]["holderIdentity"])
            await a.release()
            seen += [api.lease["spec"]["holderIdentity"], api.conflicts,
                     set(api.tokens)]
        finally:
            await a.release()
            await b.release()
            await api.front.stop()
        return seen

    assert run_async(main()) == [True, False, True, True, True, "b", False, True, "a", "",
                                 0, {"Bearer t"}]


def test_k8s_lease_unreachable_api_and_in_cluster_defaults(monkeypatch):
    monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "10.1.2.3")
    monkeypatch.setenv("KUBERNETES_SERVICE_PORT", "6443")
    lease = K8sLease("epp", token=None)
    assert lease.api_base == "https://10.1.2.3:6443"
    assert lease._url == ("https://10.1.2.3:6443/apis/coordination.k8s.io/v1/namespaces/"
                          "default/leases/epp")
    dead = K8sLease("epp", identity="x", api_base="http://127.0.0.1:9", token="")
    assert run_async(dead.try_acquire()) is False
    assert "Authorization" not in dead._headers()
