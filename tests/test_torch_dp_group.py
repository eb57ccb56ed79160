"""DP rank frontends over port engines on the CPU (``engine/dp_group.py`` and
the engine's ``dp_ranks``): the cases of ``tests/test_wide_ep_group.py`` and
the DP cases of ``tests/test_wide_ep.py`` against port engines.

- One engine, R ranks: per-rank queues, slot ranges and page partitions, the
  rank refusals, no cross-rank head-of-line blocking, per-rank prefix caches,
  f32 tokens equal to one rank's; the ``WideEPEngineGroup``'s rank ports over
  one step loop, each publishing its own allocator's KV events.
- The coordinator's wave protocol and register barrier, a ``DPEngineGroup``
  on rank ports, hybrid LB through the balancer, a solo rank serving while
  its peer is absent, the port limit; and the cross-process regime: the
  leader here, rank 1 a process (``tests/torch_dp_rank_worker.py``), waves
  equal to the steps both loops took.

Here every engine is one device (DP frontends over one card, a port
addition); the mesh cases (``MeshConfig(dp=2, ep=2, tp=2)``, world rank 0
holding every rank frontend) are ``tests/test_torch_wide_ep_mesh.py``'s.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import pytest
import torch

from llmd_tpu_torch.core.request import SamplingParams
from llmd_tpu_torch.engine.config import EngineConfig
from llmd_tpu_torch.engine.dp_group import (
    DPCoordinator, DPEngineGroup, DPGroupConfig, DPWorkerSync, WideEPEngineGroup)
from llmd_tpu_torch.engine.engine import LLMEngine
from llmd_tpu_torch.models import get_model_config

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _moe_cfg():
    return dataclasses.replace(get_model_config("tiny-moe"), moe_dbo=True)


def _engine(R=2, **kw):
    base = dict(page_size=8, num_pages=32 * R, max_model_len=96, max_batch_size=2 * R,
                prefill_chunk=16, decode_steps=2, dp_ranks=R)
    base.update(kw)
    return LLMEngine(_moe_cfg(), EngineConfig(**base), device="cpu")


def _drain(eng) -> dict:
    done: dict = {}
    while eng.has_work():
        for out in eng.step():
            done.setdefault(out.request_id, []).extend(out.new_token_ids)
    return done


def _post(ep: str, body: dict, timeout: float = 60) -> tuple[int, dict]:
    req = urllib.request.Request(f"http://{ep}/v1/completions", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


# ------------------------------------------------------------ one engine


def test_rank_queues_and_slot_ranges():
    eng = _engine(R=2)
    sp = SamplingParams(max_tokens=3, temperature=0.0, ignore_eos=True)
    eng.add_request("a", list(range(3, 20)), sp, rank=0)
    eng.add_request("b", list(range(30, 50)), sp, rank=1)
    eng.step()
    sa, sb = eng.seqs["a"], eng.seqs["b"]
    assert 0 <= sa.slot < 2 and 2 <= sb.slot < 4  # rank slot ranges
    assert all(p < 32 for p in sa.pages)  # rank page partitions
    assert all(32 <= p < 64 for p in sb.pages)
    done = _drain(eng)
    assert len(done["a"]) == 3 and len(done["b"]) == 3


def test_rank_out_of_range_rejected():
    eng = _engine(R=2)
    with pytest.raises(ValueError, match="rank"):
        eng.add_request("x", [1, 2], rank=2)


def test_no_cross_rank_head_of_line_blocking():
    """Rank 0 saturated (its queue backs up) does not delay rank 1."""
    eng = _engine(R=2, num_pages=16, max_model_len=64)
    sp = SamplingParams(max_tokens=2, temperature=0.0, ignore_eos=True)
    for i in range(4):  # enough to exhaust rank 0's 8-page partition
        eng.add_request(f"a{i}", list(range(3, 35)), sp, rank=0)
    eng.add_request("b", list(range(40, 60)), sp, rank=1)
    eng.step()
    assert eng.seqs["b"].slot >= 2  # admitted at once into rank 1's range


def test_dp_ranks_divisibility_validated():
    with pytest.raises(ValueError, match="divide"):
        _engine(R=3, max_batch_size=4, num_pages=64)
    with pytest.raises(ValueError, match="not yet"):
        _engine(R=2, cpu_offload_pages=8)


def test_rank_isolation_of_prefix_cache():
    """Identical prompts on different ranks each compute their own KV (the
    pools are disjoint); a repeat on the SAME rank hits that rank's cache."""
    eng = _engine(R=2)
    sp = SamplingParams(max_tokens=2, temperature=0.0, ignore_eos=True)
    p = list(range(3, 30))
    cached: dict = {}
    for rid, rank in (("x0", 0), ("y1", 1), ("x0b", 0)):
        eng.add_request(rid, p, sp, rank=rank)
        while eng.has_work():
            for out in eng.step():
                cached[out.request_id] = out.num_cached_prompt_tokens
    assert cached["x0"] == 0 and cached["y1"] == 0 and cached["x0b"] > 0


def test_rank_tokens_equal_one_rank_and_rank_aware_preemption():
    """float32 greedy tokens of 2 ranks (each with half the token budget)
    equal one rank's; a tight rank preempts its own sequences only."""
    prompts = [list(range(3 + i, 40 + 3 * i)) for i in range(4)]
    sp = SamplingParams(max_tokens=6, temperature=0.0, ignore_eos=True)
    one = _engine(R=1, num_pages=64, max_batch_size=4)
    for i, p in enumerate(prompts):
        one.add_request(f"r{i}", p, sp)
    want = _drain(one)
    two = _engine(R=2, num_pages=64)
    for i, p in enumerate(prompts):
        two.add_request(f"r{i}", p, sp, rank=i % 2)
    assert _drain(two) == want
    tight = _engine(R=2, num_pages=24, max_model_len=96)  # 12 pages a rank
    sp = SamplingParams(max_tokens=12, temperature=0.0, ignore_eos=True)
    for i in range(2):  # 45 + 12 tokens: 8 pages each, 16 > 12
        tight.add_request(f"t{i}", [(3 + 50 * i + j) % 250 + 3 for j in range(45)], sp,
                          rank=0)
    tight.add_request("u", list(range(50, 70)), sp, rank=1)
    done = _drain(tight)
    assert tight.stats.total_preemptions > 0 and all(len(v) == 12 for v in done.values())
    events = [e for rid in ("t0", "t1", "u") for e in tight.flight.get(rid)["events"]
              if e["event"] == "preempted"]
    assert events and all(e["rank"] == 0 for e in events)


def _rank_script(eng, sp_cls) -> tuple:
    """Arrivals on both ranks of a tight pool (12 pages a rank): two long
    prompts on rank 0 outgrow its partition, rank 1 serves a prompt and then
    one sharing its first two pages, and rank 0 the same two pages (a hit on
    rank 1's cache only). After every step, each live sequence's slot, rank
    and page ids; the tokens; the ranks of the flight records' preemptions;
    the cached prompt tokens."""
    trace: list = []
    toks: dict = {}
    cached: dict = {}

    def step() -> None:
        for out in eng.step():
            toks.setdefault(out.request_id, []).extend(out.new_token_ids)
            cached[out.request_id] = out.num_cached_prompt_tokens
        trace.append({rid: (s.slot, s.rank, tuple(s.pages))
                      for rid, s in sorted(eng.seqs.items())})

    def sp(n: int):
        return sp_cls(max_tokens=n, temperature=0.0, ignore_eos=True)

    for i in range(2):  # 45 + 12 tokens: 8 pages each, 16 > 12
        eng.add_request(f"t{i}", [(3 + 50 * i + j) % 250 + 3 for j in range(45)], sp(12),
                        rank=0)
    eng.add_request("u", list(range(50, 70)), sp(12), rank=1)
    step()
    step()
    eng.add_request("v", list(range(50, 66)) + [7, 8, 9], sp(5), rank=1)
    eng.add_request("w", list(range(50, 66)) + [9, 8], sp(3), rank=0)
    while eng.has_work():
        step()
    pre = {rid: [e["rank"] for e in eng.flight.get(rid)["events"] if e["event"] == "preempted"]
           for rid in toks}
    return toks, trace, pre, cached, eng.stats.total_preemptions


def test_rank_scheduling_equals_the_jax_engines():
    """The same arrival script through the JAX engine and the port's, both
    with ``dp_ranks=2`` and the same float32 weights: equal tokens, equal
    slots and page ids of every sequence after every step (per-rank slot
    ranges, page partitions, budgets and ``_try_admit_rank``), equal
    preemptions with their flight records' ranks, equal per-rank prefix
    hits."""
    import jax
    import numpy as np

    from llmd_tpu.core.request import SamplingParams as JaxSamplingParams
    from llmd_tpu.engine import EngineConfig as JaxEngineConfig
    from llmd_tpu.engine import LLMEngine as JaxEngine
    from llmd_tpu.models import get_model_config as jax_model_config
    from llmd_tpu.models.transformer import init_params as jax_init_params
    from llmd_tpu_torch.models.transformer import params_from_numpy

    kw = dict(page_size=8, num_pages=24, max_model_len=96, max_batch_size=4,
              prefill_chunk=16, decode_steps=2, dp_ranks=2)
    jcfg = dataclasses.replace(jax_model_config("tiny"), dtype="float32")
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    want = _rank_script(JaxEngine(jcfg, JaxEngineConfig(**kw, attn_impl="reference"),
                                  params=jp), JaxSamplingParams)
    tcfg = dataclasses.replace(get_model_config("tiny"), dtype="float32")
    got = _rank_script(LLMEngine(tcfg, EngineConfig(**kw), device="cpu", params=params_from_numpy(
        tcfg, {k: np.asarray(v) for k, v in jp.items()})), SamplingParams)
    toks, trace, pre, cached, preemptions = got
    assert toks == want[0] and all(len(v) for v in toks.values())
    assert trace == want[1]
    assert pre == want[2] and preemptions == want[4] > 0
    assert pre["t0"] + pre["t1"] and not pre["u"] + pre["v"] + pre["w"]
    assert cached == want[3] and cached["v"] > 0 and cached["w"] == 0
    # the script reached both ranks' slot ranges and page partitions
    rows = [r for snap in trace for r in snap.values() if r[0] >= 0]
    assert {(r[1], r[0] // 2) for r in rows} == {(0, 0), (1, 1)}
    assert all(all(12 * rank <= p < 12 * (rank + 1) for p in pages) for _, rank, pages in rows)


def test_wide_ep_group_http_endpoints_and_rank_kv_events():
    """R rank frontends over one engine: distinct ports, both serve, one
    shared loop; each rank's KV events carry its own blocks only."""
    from llmd_tpu_torch.core.kv_events import BlockStored

    group = WideEPEngineGroup(
        _moe_cfg(), EngineConfig(page_size=8, num_pages=64, max_model_len=96,
                                 max_batch_size=4, prefill_chunk=16, decode_steps=2,
                                 dp_ranks=2),
        model_name="llmd-tpu/tiny-moe", device="cpu", kv_events_port_base=0)
    seen: list = [[], []]
    for r, srv in enumerate(group.servers):
        alloc = group.engine.allocs[r]
        # each rank's allocator publishes through its own server's publisher
        assert srv.rank == r and alloc.event_sink == srv.publisher.sink
        alloc.event_sink = lambda evs, pub=alloc.event_sink, r=r: (seen[r].extend(evs),
                                                                    pub(evs))
    group.start()
    try:
        eps = group.endpoints()
        assert len(eps) == 2 and len(set(eps)) == 2
        assert all(srv.async_engine is group.async_engine for srv in group.servers)
        for i, ep in enumerate(eps):
            status, body = _post(ep, {"model": "llmd-tpu/tiny-moe",
                                      "prompt": f"rank {i}: hello " * 3, "max_tokens": 3,
                                      "temperature": 0})
            assert status == 200 and body["usage"]["completion_tokens"] == 3
        assert group.engine.stats.total_decode_tokens >= 4
    finally:
        group.stop()
    stored = [{h for e in s if isinstance(e, BlockStored) for h in e.block_hashes}
              for s in seen]
    assert stored[0] and stored[1] and not stored[0] & stored[1]
    assert group.engine.cache is None  # the group's stop closed its engine


def test_group_rank_count_mismatch_rejected():
    with pytest.raises(ValueError, match="dp_ranks"):
        WideEPEngineGroup(_moe_cfg(), EngineConfig(page_size=8, num_pages=64,
                                                   max_batch_size=4, dp_ranks=4),
                          ranks=2, device="cpu")


# ------------------------------------------------------------ the DP plane


def test_dp_coordinator_wave_protocol():
    coord = DPCoordinator(dp_size=2, host="127.0.0.1")
    coord.start()
    try:
        w0 = DPWorkerSync(0, "127.0.0.1", coord.port)
        w1 = DPWorkerSync(1, "127.0.0.1", coord.port)
        w0._rpc({"cmd": "register", "rank": 0})
        assert w1._rpc({"cmd": "register", "rank": 1})["registered"] == 2
        assert w0.report(False) is False and w1.report(False) is False  # nobody steps
        assert w1.report(True) is True and w0.report(False) is True  # a wave: both step
        assert w1.report(False) is False and w0.report(False) is False  # drained
        assert w0._rpc({"cmd": "nope"}) == {"error": "unknown cmd 'nope'"}
        w0.close()
        w1.close()
        assert coord.waves >= 2
    finally:
        coord.stop()


def test_dp_worker_register_barrier_times_out():
    coord = DPCoordinator(dp_size=2, host="127.0.0.1")
    coord.start()
    try:
        w = DPWorkerSync(0, "127.0.0.1", coord.port)
        with pytest.raises(TimeoutError):
            w.register(barrier_timeout_s=0.3)
        w.close()
    finally:
        coord.stop()


def _tiny_group(**dp):
    return DPEngineGroup(
        get_model_config("tiny"), EngineConfig(page_size=8, num_pages=32, max_model_len=64,
                                               max_batch_size=2, prefill_chunk=16),
        DPGroupConfig(dp_rpc_port=0, port_base=0, **dp), model_name="llmd-tpu/tiny",
        device="cpu")


def test_dp_engine_group_serves_on_rank_ports():
    group = _tiny_group(dp_size=2, dp_size_local=2)
    group.start()
    try:
        eps = group.endpoints()
        assert len(eps) == 2  # one endpoint per DP rank port
        for ep in eps:
            status, body = _post(ep, {"model": "llmd-tpu/tiny", "prompt": "hello dp",
                                      "max_tokens": 4, "temperature": 0.0})
            assert status == 200 and body["choices"][0]["text"] is not None
        assert all(srv.async_engine.steps > 0 for srv in group.servers)  # waves engaged
        assert group.coordinator.waves > 0
    finally:
        group.stop()


def test_dp_group_hybrid_lb_balances_local_ranks():
    group = _tiny_group(dp_size=2, dp_size_local=2, hybrid_lb=True)
    group.start()
    try:
        eps = group.endpoints()
        assert len(eps) == 1  # hybrid LB: one endpoint per node
        for _ in range(4):
            status, body = _post(eps[0], {"model": "llmd-tpu/tiny", "prompt": "hi",
                                          "max_tokens": 2, "temperature": 0.0})
            assert status == 200 and body["usage"]["completion_tokens"] == 2
        assert all(srv.server_metrics.requests.value > 0 for srv in group.servers)
    finally:
        group.stop()


def test_dp_rank_serves_solo_when_peer_missing():
    """With a peer rank absent the barrier never completes, but the rank
    serves its local work anyway (and keeps retrying)."""
    group = _tiny_group(dp_size=2, dp_size_local=1)
    group.start()
    try:
        group.servers[0].async_engine.register_attempt_timeout_s = 0.2
        status, _ = _post(group.servers[0].address, {
            "model": "llmd-tpu/tiny", "prompt": "solo", "max_tokens": 2, "temperature": 0.0})
        assert status == 200
        ae = group.servers[0].async_engine
        assert not ae.registered and ae.register_failures > 0
    finally:
        group.stop()


def test_dp_group_config_validates_port_limit():
    with pytest.raises(ValueError):
        DPGroupConfig(dp_size=16, dp_size_local=16)  # > 8 targetPorts, no hybrid LB
    DPGroupConfig(dp_size=16, dp_size_local=16, hybrid_lb=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_dp_ranks_across_processes(tmp_path):
    """The multi-node regime over real TCP: the leader (rank 0, hosting the
    coordinator) here, rank 1 its own process. Both register, both serve,
    and the coordinator's waves equal the steps the two loops took."""
    rpc_port = _free_port()
    out = tmp_path / "rank1.out"
    proc = subprocess.Popen([sys.executable, os.path.join(HERE, "torch_dp_rank_worker.py"),
                             "--rank", "1", "--dp-size", "2", "--rpc-port", str(rpc_port),
                             "--cpu"],
                            stdout=open(out, "w"), stderr=subprocess.STDOUT,
                            env={**os.environ, "OMP_NUM_THREADS": "1"},
                            start_new_session=True)
    group = DPEngineGroup(
        get_model_config("tiny"), EngineConfig(page_size=8, num_pages=64, max_model_len=128,
                                               max_batch_size=4, prefill_chunk=32),
        DPGroupConfig(dp_size=2, dp_size_local=1, dp_start_rank=0, dp_rpc_port=rpc_port,
                      port_base=0), model_name="llmd-tpu/tiny", device="cpu")
    group.start()
    ae = group.servers[0].async_engine
    ae.register_retry_interval_s = 0.2
    try:
        deadline = time.monotonic() + 120
        while "ENDPOINT" not in out.read_text():
            assert proc.poll() is None and time.monotonic() < deadline, out.read_text()
            time.sleep(0.1)
        ep1 = out.read_text().split("ENDPOINT", 1)[1].split()[0]
        while not (ae.registered and group.coordinator.registered == {0, 1}):
            assert time.monotonic() < deadline, "ranks never registered"
            time.sleep(0.05)
        time.sleep(0.5)  # rank 1's loop out of its register call
        res: list = []
        threads = [threading.Thread(target=lambda ep=ep: res.append(_post(ep, {
            "model": "llmd-tpu/tiny", "prompt": "cross process", "max_tokens": 2,
            "temperature": 0}))) for ep in (group.servers[0].address, ep1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert [s for s, b in res] == [200, 200]
        assert all(b["usage"]["completion_tokens"] == 2 for _, b in res)
        time.sleep(0.2)
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        waves, steps0 = group.coordinator.waves, ae.steps
        group.stop()
    steps1, _, registered = (int(x) for x in out.read_text().split("STEPS", 1)[1].split()[:3])
    assert registered == 1 and waves > 0 and waves == steps0 + steps1
