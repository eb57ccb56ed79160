"""Device-plane observability gate (port of ``tools/device_obs_check.py``:
the same checks, timings and printed lines; ``ci_gate`` stage
``device-obs``).

Exercises the port's ``obs/device.DeviceMonitor`` end to end with synthetic
hooks (the wedged probe sleeps 1 s, not the reference's 5: either is well past
the 0.15 s timeout) — no engine build, so the stage stays seconds-fast:

1. monitor starts and the device gauges scrape through Registry.expose()
   (the stall and heartbeat gauges; the HBM gauges from a synthetic poll)
2. the step watchdog trips on a synthetic stall (pending work, frozen
   heartbeat) and recovers when the heartbeat resumes
3. the fabric probe timeout path flips the alive gauge + failure counter
   without hanging the scheduler, and a healthy probe flips it back
4. ``capture_profile`` produces a non-empty ``torch.profiler`` artifact (on
   the card the trace holds the work's device kernels)
5. with ``--cpu``: a CPU device exports no HBM series and never crashes. On
   the card this turns around: the HBM series of ``cuda:N`` is present and
   carries the caching allocator's bytes (``torch.cuda.memory_allocated``).

Run: python -m llmd_tpu_torch.tools.device_obs_check [--cpu]  (the card
unless ``--cpu``; exit 0 = all checks pass)
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import threading
import time

import torch

from llmd_tpu_torch.engine.engine import resolve_device
from llmd_tpu_torch.obs.device import DeviceMonitor, ProfileBusy
from llmd_tpu_torch.obs.events import FlightRecorder
from llmd_tpu_torch.obs.metrics import Registry


def _wait_for(cond, timeout_s: float = 5.0, tick_s: float = 0.01) -> bool:
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        if cond():
            return True
        time.sleep(tick_s)
    return False


def _metric(reg: Registry, name: str) -> float:
    fam = reg.get(name)
    assert fam is not None, f"family {name} not registered"
    return fam.value


def check_watchdog() -> None:
    reg = Registry()
    flight = FlightRecorder()
    pending = {"v": False}
    mon = DeviceMonitor(
        reg, flight=flight, devices=[],
        pending_fn=lambda: pending["v"],
        stall_s=0.2, probe_interval_s=0, poll_s=0.05)
    mon.start()
    try:
        text = reg.expose()
        assert "llmd_tpu:engine_stalled 0" in text, "stall gauge missing"
        assert "llmd_tpu:engine_heartbeat_age_seconds" in text
        # pending work + frozen heartbeat → stall within stall_s (+ slack)
        pending["v"] = True
        assert _wait_for(lambda: mon.unhealthy_reason() is not None,
                         timeout_s=3.0), "watchdog never tripped"
        reason = mon.unhealthy_reason()
        assert reason["reason"] == "engine_stalled", reason
        assert reason["heartbeat_age_s"] >= 0.2, reason
        assert _metric(reg, "llmd_tpu:engine_stalled") == 1
        assert _metric(reg, "llmd_tpu:engine_stalls_total") >= 1
        events = [e["event"] for e in flight.system_events()]
        assert "engine_stalled" in events, events
        # heartbeat resumes → health recovers
        stamper = {"run": True}

        def _stamp():
            while stamper["run"]:
                mon.heartbeat()
                time.sleep(0.02)

        t = threading.Thread(target=_stamp, daemon=True)
        t.start()
        try:
            assert _wait_for(lambda: mon.unhealthy_reason() is None,
                             timeout_s=3.0), "watchdog never recovered"
        finally:
            stamper["run"] = False
            t.join(timeout=1.0)
        assert _metric(reg, "llmd_tpu:engine_stalled") == 0
        events = [e["event"] for e in flight.system_events()]
        assert "engine_recovered" in events, events
    finally:
        mon.stop()
    print("device-obs: watchdog stall/recover OK")


def check_fabric_probe() -> None:
    reg = Registry()
    flight = FlightRecorder()
    wedged = {"v": True}

    def probe_op():
        if wedged["v"]:
            time.sleep(1.0)  # well past the 0.15s timeout (the reference's 5 s)

    mon = DeviceMonitor(
        reg, flight=flight, devices=[], probe_op=probe_op,
        stall_s=0, probe_interval_s=0.1, probe_timeout_s=0.15, poll_s=0.05)
    mon.start()
    try:
        assert _wait_for(
            lambda: _metric(reg, "llmd_tpu:device_fabric_alive") == 0,
            timeout_s=5.0), "probe timeout never flipped the gauge"
        assert _metric(
            reg, "llmd_tpu:device_fabric_probe_failures_total") >= 1
        reason = mon.unhealthy_reason()
        assert reason is not None and reason["reason"] == "fabric_dead", reason
        events = [e["event"] for e in flight.system_events()]
        assert "fabric_dead" in events, events
        # fabric comes back → next probe succeeds → gauge recovers
        wedged["v"] = False
        assert _wait_for(
            lambda: _metric(reg, "llmd_tpu:device_fabric_alive") == 1,
            timeout_s=10.0), "probe never recovered"
        assert mon.unhealthy_reason() is None
        events = [e["event"] for e in flight.system_events()]
        assert "fabric_recovered" in events, events
    finally:
        mon.stop()
    print("device-obs: fabric probe timeout/recover OK")


def check_hbm_quiet_on_cpu() -> None:
    reg = Registry()
    mon = DeviceMonitor(reg, devices=[torch.device("cpu")],
                        stall_s=0, probe_interval_s=0, poll_s=0.05)
    mon.start()
    try:
        time.sleep(0.2)  # let one poll run
        text = reg.expose()
        # the CPU has no allocator stats → families declared, no labeled series
        assert "llmd_tpu:device_hbm_bytes_in_use{" not in text
        assert "# TYPE llmd_tpu:device_hbm_bytes_in_use gauge" in text
    finally:
        mon.stop()
    print("device-obs: CPU memory_stats-absent path quiet OK")


def check_hbm_on_card(device: torch.device) -> dict:
    """The card's HBM series: present for ``device`` and equal to the caching
    allocator's bytes with a 64 MiB buffer held."""
    name = f"cuda:{device.index or 0}"
    held = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    want = torch.cuda.memory_allocated(device)
    reg = Registry()
    mon = DeviceMonitor(reg, devices=[device], stall_s=0, probe_interval_s=0,
                        poll_s=0.05)
    mon.start()
    try:
        def value(fam: str) -> "float | None":
            prefix = f'llmd_tpu:device_hbm_{fam}{{device="{name}"}} '
            for ln in reg.expose().splitlines():
                if ln.startswith(prefix):
                    return float(ln[len(prefix):])
            return None

        assert _wait_for(lambda: value("bytes_in_use") == want, timeout_s=3.0), (
            f"HBM in use {value('bytes_in_use')}, the allocator's {want}")
        limit = torch.cuda.get_device_properties(device).total_memory
        assert value("limit_bytes") == limit, (value("limit_bytes"), limit)
        assert value("peak_bytes") >= want, (value("peak_bytes"), want)
    finally:
        mon.stop()
        del held
    print(f"device-obs: HBM series of {name} carries the allocator's bytes "
          f"({want} in use of {limit}) on {torch.cuda.get_device_name(device)}")
    return {"hbm_bytes_in_use": want, "hbm_limit_bytes": limit}


def check_hbm_synthetic() -> None:
    """The scrape path of the HBM gauges from a synthetic poll (the
    reference's fake device with ``memory_stats``)."""
    class FakePoll(DeviceMonitor):
        def _poll_hbm(self) -> None:
            with self._lock:
                self._hbm = {"cuda:0": (1024.0, 2048.0, 4096.0)}

    reg = Registry()
    mon = FakePoll(reg, devices=[], stall_s=0, probe_interval_s=0, poll_s=0.05)
    mon.start()
    try:
        assert _wait_for(
            lambda: 'device="cuda:0"' in reg.expose(), timeout_s=3.0)
        text = reg.expose()
        assert 'llmd_tpu:device_hbm_bytes_in_use{device="cuda:0"} 1024' in text
        assert 'llmd_tpu:device_hbm_peak_bytes{device="cuda:0"} 2048' in text
        assert 'llmd_tpu:device_hbm_limit_bytes{device="cuda:0"} 4096' in text
    finally:
        mon.stop()
    print("device-obs: HBM gauges scrape OK")


def check_profile_capture(device: torch.device) -> dict:
    reg = Registry()
    flight = FlightRecorder()
    tmp = tempfile.mkdtemp(prefix="llmd-devobs-profile-")
    on_card = device.type == "cuda"
    mon = DeviceMonitor(reg, flight=flight, devices=[device] if on_card else [],
                        stall_s=0, probe_interval_s=0, poll_s=1.0,
                        profile_dir=tmp)
    mon.start()
    try:
        def _work():
            for _ in range(20):
                (torch.ones((32, 32), device=device) * 3.0).sum().item()
                time.sleep(0.01)

        t = threading.Thread(target=_work, daemon=True)
        t.start()
        result = mon.capture_profile(0.3)
        t.join(timeout=5.0)
        assert result["files"], f"empty capture: {result}"
        assert result["bytes"] > 0, result
        assert _metric(reg, "llmd_tpu:profile_captures_total") == 1
        events = [e["event"] for e in flight.system_events()]
        assert "profile_capture" in events, events
        kernels = 0
        if on_card:
            with open(os.path.join(result["dir"], "trace.json")) as f:
                trace = json.load(f)
            kernels = sum(1 for e in trace.get("traceEvents", ())
                          if e.get("cat") == "kernel")
            assert kernels > 0, "the card's window recorded no device kernel"
        # single-capture guard: a concurrent window must 409 at the server —
        # here the busy flag raises
        with mon._lock:
            mon._profiling = True
        try:
            mon.capture_profile(0.1)
            raise AssertionError("ProfileBusy not raised")
        except ProfileBusy:
            pass
        finally:
            with mon._lock:
                mon._profiling = False
    finally:
        mon.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    print("device-obs: profiler capture OK"
          + (f" ({kernels} device kernels in the window)" if on_card else ""))
    return {"profile_bytes": result["bytes"], "profile_kernels": kernels}


def check(device: "torch.device | str") -> dict:
    """The five checks on ``device`` (the card, or the CPU); raises
    AssertionError on a failed one, else returns the card's numbers."""
    device = torch.device(device)
    out: dict = {}
    check_watchdog()
    check_fabric_probe()
    check_hbm_synthetic()
    if device.type == "cuda":
        out |= check_hbm_on_card(device)
    else:
        check_hbm_quiet_on_cpu()
    out |= check_profile_capture(device)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (no HBM series); default the card")
    args = ap.parse_args(argv)
    t0 = time.monotonic()
    check(resolve_device("cpu" if args.cpu else None))
    print(f"device-obs: ALL OK ({time.monotonic() - t0:.1f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
