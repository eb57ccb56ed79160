"""The port's device plane (``llmd_tpu_torch/obs/device.py``) behind a port
server, on the CPU (the reference's ``tests/test_device_obs.py`` cases):

- a wedged step loop turns into ``engine_stalled`` (flight event, gauge,
  counter) and a structured 503 ``/health`` within ``LLMD_WATCHDOG_STALL_S``;
  the reference's ``PoolController`` health sweep and the port's
  (``llmd_tpu_torch/pool``) each retire the port replica with that reason; the loop resuming gives ``engine_recovered`` and 200;
- ``/debug/profile`` writes a non-empty ``torch.profiler`` trace taken while
  decode runs, whose ranges include the engine's ``llmd.*`` phases (entered
  on the engine thread while the window is open), 400 for a non-numeric
  ``seconds``, 409 while another capture runs;
- no HBM series on the CPU; a liveness op that hangs past its timeout gives
  ``fabric_dead`` and a 503, and its return ``fabric_recovered``.
"""

import asyncio
import json
import threading
import time
from pathlib import Path

import aiohttp
import pytest
import torch

from llmd_tpu.core.endpoint import Endpoint, EndpointPool
from llmd_tpu.obs.events import FlightRecorder as JaxFlightRecorder
from llmd_tpu.pool.controller import PoolConfig, PoolController
from llmd_tpu.pool.launcher import ReplicaHandle, ReplicaLauncher
from llmd_tpu_torch.core import endpoint as port_endpoint
from llmd_tpu_torch.engine import EngineConfig
from llmd_tpu_torch.engine.server import EngineServer
from llmd_tpu_torch.models import get_model_config
from llmd_tpu_torch.obs.device import DeviceMonitor, ProfileBusy, capture_open
from llmd_tpu_torch.obs.events import FlightRecorder
from llmd_tpu_torch.obs.metrics import Registry
from llmd_tpu_torch.pool import controller as port_controller
from llmd_tpu_torch.pool import launcher as port_launcher
from llmd_tpu_torch.router.http import HTTPClient
from tests.conftest import run_async

KW = dict(page_size=8, num_pages=64, max_model_len=256, max_batch_size=4, prefill_chunk=32,
          decode_steps=2)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _NullLauncher(ReplicaLauncher):
    """Health-sweep-only stub: the test registers its replica itself."""

    async def launch(self):  # pragma: no cover - the sweep never launches
        raise NotImplementedError

    async def kill(self, handle):
        pass


class _PortNullLauncher(port_launcher.ReplicaLauncher):
    """The same stub for the port's controller."""

    async def launch(self):  # pragma: no cover - the sweep never launches
        raise NotImplementedError

    async def kill(self, handle):
        pass


def _server() -> EngineServer:
    return EngineServer(get_model_config("tiny"), EngineConfig(**KW), model_name="test/tiny",
                        host="127.0.0.1", port=0, device="cpu")


async def _wait_health(sess, base, want_status, timeout_s=10.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        async with sess.get(f"{base}/health") as r:
            if r.status == want_status:
                return await r.json()
        await asyncio.sleep(0.05)
    raise AssertionError(f"/health never reached {want_status}")


def test_stall_watchdog_503_pool_retirement_and_recovery(monkeypatch, tmp_path):
    monkeypatch.setenv("LLMD_WATCHDOG_STALL_S", "0.5")
    monkeypatch.setenv("LLMD_FABRIC_PROBE_INTERVAL_S", "0")
    monkeypatch.setenv("LLMD_PROFILE_DIR", str(tmp_path / "profiles"))
    server = _server()
    server.start()

    async def scenario():
        base = f"http://{server.address}"
        engine = server.engine
        async with aiohttp.ClientSession() as sess:
            await _wait_health(sess, base, 200)
            # wedge the step loop: the engine thread blocks inside step()
            # holding the engine lock, as a hung device op would, while work
            # is pending
            gate = threading.Event()
            orig_step, orig_has_work = engine.step, engine.has_work

            def _wedged_step():
                gate.wait()
                return []

            engine.step = _wedged_step
            engine.has_work = lambda: True
            engine.seqs["synthetic-stall"] = object()

            body = await _wait_health(sess, base, 503)
            assert body["status"] == "unhealthy" and body["reason"] == "engine_stalled", body
            assert body["heartbeat_age_s"] >= 0.5 and body["stall_s"] == 0.5
            async with sess.get(f"{base}/metrics") as r:
                text = await r.text()
            assert "llmd_tpu:engine_stalled 1" in text
            assert "llmd_tpu:engine_stalls_total 1" in text
            assert "engine_stalled" in [e["event"] for e in engine.flight.system_events()]

            # the reference pool controller's sweep retires the port replica
            # with the watchdog's reason
            flight = JaxFlightRecorder()
            pool = EndpointPool()
            pool.upsert(Endpoint(address=server.address))
            ctl = PoolController(PoolConfig(min_replicas=0), _NullLauncher(), pool=pool,
                                 flight=flight)
            ctl.replicas[server.address] = ReplicaHandle(address=server.address)
            ctl._session = aiohttp.ClientSession()
            try:
                await ctl._health_sweep()
            finally:
                await ctl._session.close()
            assert server.address not in ctl.replicas and pool.list() == []
            (retire,) = [e for e in flight.system_events() if e["event"] == "pool_scale_down"]
            assert retire["reason"] == "replica_dead" and retire["detail"] == "engine_stalled"

            # and so does the port's controller, with the same event
            port_flight = FlightRecorder()
            port_pool = port_endpoint.EndpointPool()
            port_pool.upsert(port_endpoint.Endpoint(address=server.address))
            port_ctl = port_controller.PoolController(
                port_controller.PoolConfig(min_replicas=0), _PortNullLauncher(),
                pool=port_pool, flight=port_flight)
            port_ctl.replicas[server.address] = port_launcher.ReplicaHandle(
                address=server.address)
            port_ctl._session = HTTPClient()
            try:
                await port_ctl._health_sweep()
            finally:
                await port_ctl._session.close()
            assert server.address not in port_ctl.replicas and port_pool.list() == []
            (port_retire,) = [e for e in port_flight.system_events()
                              if e["event"] == "pool_scale_down"]
            assert {k: v for k, v in port_retire.items() if k != "t_unix"} == \
                {k: v for k, v in retire.items() if k != "t_unix"}

            # the loop resumes: the watchdog clears, health recovers
            engine.step, engine.has_work = orig_step, orig_has_work
            del engine.seqs["synthetic-stall"]
            gate.set()
            await _wait_health(sess, base, 200)
            assert "engine_recovered" in [e["event"] for e in engine.flight.system_events()]

    try:
        run_async(scenario())
    finally:
        server.stop()
    assert server.engine.monitor is None  # the server stopped the monitor it built


def test_debug_profile_captures_artifact(monkeypatch, tmp_path):
    monkeypatch.setenv("LLMD_WATCHDOG_STALL_S", "0")
    monkeypatch.setenv("LLMD_FABRIC_PROBE_INTERVAL_S", "0")
    monkeypatch.setenv("LLMD_PROFILE_DIR", str(tmp_path / "profiles"))
    server = _server()
    server.start()

    async def scenario():
        base = f"http://{server.address}"
        async with aiohttp.ClientSession() as sess:
            async with sess.get(f"{base}/debug/profile", params={"seconds": "nope"}) as r:
                assert r.status == 400
            # decode traffic inside the window, so the annotated phases run
            work = asyncio.ensure_future(sess.post(f"{base}/v1/completions", json={
                "prompt": "profile me while I decode some tokens", "max_tokens": 200,
                "temperature": 0.0, "ignore_eos": True}))
            while not server.engine.seqs:  # the request is in: decode is about to run
                await asyncio.sleep(0.002)
            first = asyncio.ensure_future(sess.get(f"{base}/debug/profile",
                                                   params={"seconds": "0.5"}))
            for _ in range(100):  # wait for the first window to open
                if capture_open():
                    break
                await asyncio.sleep(0.01)
            async with sess.get(f"{base}/debug/profile", params={"seconds": "0.2"}) as r:
                assert r.status == 409, await r.text()
            async with await first as r:
                assert r.status == 200, await r.text()
                result = await r.json()
            assert result["files"] == ["trace.json"] and result["bytes"] > 0
            cap = Path(result["dir"])
            assert cap.is_dir() and cap.parent == tmp_path / "profiles"
            names = {e.get("name") for e in json.loads((cap / "trace.json").read_text())
                     ["traceEvents"]}
            assert {"llmd.decode_dispatch", "llmd.decode_process"} <= names, sorted(
                n for n in names if n and n.startswith("llmd"))
            r2 = await work
            assert r2.status == 200
            async with sess.get(f"{base}/metrics") as r:
                text = await r.text()
            assert "llmd_tpu:profile_captures_total 1" in text
            assert "llmd_tpu:device_hbm_bytes_in_use{" not in text  # no series on the CPU
            assert "profile_capture" in [e["event"]
                                         for e in server.engine.flight.system_events()]

    try:
        run_async(scenario())
    finally:
        server.stop()
    assert not capture_open()


def test_liveness_probe_dead_then_recovered():
    """A liveness op that hangs past its timeout: fabric_dead, the gauge at
    0, /health's reason; once it returns, fabric_recovered."""
    release = threading.Event()
    calls = []

    def op():
        calls.append(1)
        if len(calls) == 2:
            release.wait(5.0)

    flight = FlightRecorder()
    reg = Registry()
    mon = DeviceMonitor(reg, flight=flight, devices=[], probe_op=op, stall_s=0,
                        probe_interval_s=0.05, probe_timeout_s=0.2, poll_s=0.05)
    mon.start()
    try:
        deadline = time.monotonic() + 5.0
        while "fabric_dead" not in [e["event"] for e in flight.system_events()]:
            assert time.monotonic() < deadline, "the hung probe was never declared dead"
            time.sleep(0.02)
        assert mon.unhealthy_reason() == {"reason": "fabric_dead", "probe_timeout_s": 0.2}
        assert "llmd_tpu:device_fabric_alive 0" in reg.expose()
        release.set()
        while "fabric_recovered" not in [e["event"] for e in flight.system_events()]:
            assert time.monotonic() < deadline, "never recovered"
            time.sleep(0.02)
        assert mon.unhealthy_reason() is None
    finally:
        release.set()
        mon.stop()
    assert not [ln for ln in reg.expose().splitlines()
                if ln.startswith("llmd_tpu:device_hbm_")]


def test_profile_busy_is_one_window_at_a_time(tmp_path):
    mon = DeviceMonitor(Registry(), devices=[], stall_s=0, probe_interval_s=0,
                        profile_dir=str(tmp_path))
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("r", mon.capture_profile(0.3)))
    t.start()
    while not capture_open():
        time.sleep(0.005)
    with pytest.raises(ProfileBusy):
        mon.capture_profile(0.1)
    t.join()
    assert out["r"]["seconds"] == 0.3 and out["r"]["bytes"] > 0


def test_profile_toggles_with_the_step_loop_paused(monkeypatch, tmp_path):
    """A server's monitor starts and stops the tracer inside the engine
    loop's lock, then the capture lock (the order a capture inside a step
    takes them in): stopping the tracer while the engine thread replays a
    CUDA graph can deadlock the two threads."""
    from torch.profiler import profile

    from llmd_tpu_torch.engine.cuda_graph import CAPTURE_LOCK

    monkeypatch.setenv("LLMD_WATCHDOG_STALL_S", "0")
    monkeypatch.setenv("LLMD_FABRIC_PROBE_INTERVAL_S", "0")
    monkeypatch.setenv("LLMD_PROFILE_DIR", str(tmp_path / "profiles"))
    server = _server()
    server.start()
    held = []
    for name in ("start", "stop"):
        def wrapped(self, _orig=getattr(profile, name), _name=name):
            held.append((_name, server.async_engine._lock.locked(), CAPTURE_LOCK.locked()))
            return _orig(self)
        monkeypatch.setattr(profile, name, wrapped)
    try:
        result = server.monitor.capture_profile(0.1)
    finally:
        server.stop()
    assert held == [("start", True, True), ("stop", True, True)]
    assert result["bytes"] > 0
    assert not server.async_engine._lock.locked() and not CAPTURE_LOCK.locked()


def test_failed_monitor_start_unbinds_and_stop_returns(monkeypatch):
    """A monitor that cannot start fails ``start()`` with the port unbound
    and no monitor attached; ``stop()`` then returns at once (it must not
    wait on a serve loop that never ran)."""
    import llmd_tpu_torch.engine.server as server_mod

    def refuse(self):
        raise RuntimeError("no tracer")

    monkeypatch.setattr(server_mod.DeviceMonitor, "start", refuse)
    server = _server()
    with pytest.raises(RuntimeError, match="no tracer"):
        server.start()
    assert server._httpd is None and server.engine.monitor is None
    done = threading.Event()
    t = threading.Thread(target=lambda: (server.stop(), done.set()), daemon=True)
    t.start()
    assert done.wait(10.0), "stop() after a failed start() hung"
