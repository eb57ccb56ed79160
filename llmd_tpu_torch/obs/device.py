"""Device-plane observability on a CUDA card: HBM telemetry, liveness, the
step watchdog and on-demand profiler capture (port of
``llmd_tpu/obs/device.py``: the same contract, threads, lock discipline,
metric families and flight events, with the card in place of the TPU).

The host plane (metrics, flight recorder, tracing) sees everything around
the card but nothing inside it, and the pool controller's ``/health`` sweep
cannot see an engine whose HTTP threads are alive while its card is hung
mid-step. ``DeviceMonitor`` closes that gap with four parts:

* **HBM telemetry**: ``torch.cuda.memory_stats(d)`` (``allocated_bytes.all.
  current`` / ``.peak``) and ``get_device_properties(d).total_memory`` read on
  a poll thread every ``LLMD_DEVICE_POLL_S`` and exported as
  ``llmd_tpu:device_hbm_bytes_in_use|peak_bytes|limit_bytes{device="cuda:N"}``
  through scrape-time callbacks. A CPU engine exports no series.
* **Liveness**: a tiny op (a one-element multiply and
  ``torch.cuda.synchronize``) on the engine's device and the monitor's own
  stream, run on a worker thread every ``LLMD_FABRIC_PROBE_INTERVAL_S`` under
  ``LLMD_FABRIC_PROBE_TIMEOUT_S``. A wedged card parks the worker, not the
  caller: the poll thread times out, sets ``llmd_tpu:device_fabric_alive`` to
  0, counts the failure and records ``fabric_dead``; the worker finishing
  later records ``fabric_recovered``. The op holds the CUDA-graph capture
  lock (``engine/cuda_graph.CAPTURE_LOCK``): a device-wide synchronize from
  another thread would invalidate a capture in progress.
* **Step watchdog**: the engine loop stamps ``heartbeat()`` once per
  iteration before it takes the engine lock (a bare monotonic write). A
  watchdog thread that sees pending work and no heartbeat for
  ``LLMD_WATCHDOG_STALL_S`` records ``engine_stalled``, sets the stall gauge
  and makes ``unhealthy_reason()`` non-None; the server answers ``/health``
  with 503, which the pool controller's sweep and the router's breakers
  already act on.
* **Profiler capture**: ``capture_profile(seconds)`` opens one
  ``torch.profiler`` window (CPU and, on the card, CUDA activity, every
  thread) and writes it as a Chrome trace under ``LLMD_PROFILE_DIR/<UTC
  stamp>/``; one at a time (``ProfileBusy``; the server answers 409).
  ``start()``, called from the thread that imported torch, initialises the
  device tracer there once a process (a first window opened from an HTTP
  handler's thread would otherwise record nothing on the card). The tracer
  starts and stops only while no other thread is inside a CUDA call it
  could collide with: under the capture lock, and inside ``pause_fn`` (the
  server's ``AsyncLLMEngine.run_locked``, which holds the step loop between
  steps) since stopping it while the engine thread replays a CUDA graph
  can deadlock the two threads. The
  engine's step phases enter ``torch.profiler.record_function`` under the
  reference's names (``llmd.unified``, ``llmd.decode_dispatch``,
  ``llmd.decode_process``, ``llmd.spec_verify``, ``llmd.mask_build``,
  ``llmd.chain_stage``) only while a window is open (``capture_open()``), so
  serving pays one flag read a phase otherwise.

Threading: the watchdog and poll threads never take the engine lock (a hung
step holds it). Pending work is read through ``pending_fn`` (a GIL-atomic
dict truthiness check) and the heartbeat is a bare attribute. Metric writes
and flight records happen outside ``self._lock``: the registry has its own
lock and scrapes read the HBM cache through it.

``fabric_alive_subprocess`` probes from a throwaway process, for a harness
whose own process may be the one a wedged card would hang.
"""

from __future__ import annotations

import datetime
import functools
import os
import subprocess
import sys
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from llmd_tpu_torch.obs.metrics import Registry, register_device_metrics

__all__ = ["DeviceMonitor", "ProfileBusy", "fabric_alive_subprocess", "make_probe_op",
           "capture_open", "profile_phase"]

# the number of profiler windows open in this process (0 or 1 per monitor)
_OPEN_CAPTURES = 0
# set once the device tracer has been initialised in this process
_TRACER_READY = False


class ProfileBusy(RuntimeError):
    """A profiler capture is already in progress (one window at a time)."""


def capture_open() -> bool:
    """True while a ``capture_profile`` window is open in this process."""
    return _OPEN_CAPTURES > 0


def profile_phase(name: str):
    """Decorator: run a step-loop phase inside
    ``torch.profiler.record_function(name)`` while a capture is open, so a
    ``/debug/profile`` trace attributes host and device time to the phase
    names ``step_duration`` exports; outside a capture, one flag read."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if not _OPEN_CAPTURES:
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return wrapped
    return deco


def fabric_alive_subprocess(timeout_s: float = 90.0, cwd: Optional[str] = None) -> bool:
    """Probe the card from a throwaway subprocess (``torch.cuda.device_count()``
    > 0): runtime initialisation can hang or kill the process when the card
    is wedged, so a probe issued after something already timed out must not
    run in-process."""
    cmd = [sys.executable, "-c", "import torch; print(torch.cuda.device_count())"]
    try:
        p = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=timeout_s)
    except (subprocess.TimeoutExpired, OSError):
        return False
    out = p.stdout.strip()
    return p.returncode == 0 and out.isdigit() and int(out) > 0


def make_probe_op(device: "torch.device | None") -> Callable[[], None]:
    """The in-process liveness op on ``device``: a one-element multiply
    forced to completion, on its own stream on the card (dispatch, execute,
    synchronize: the path a wedged card hangs)."""
    device = torch.device(device) if device is not None else torch.device("cpu")
    if device.type != "cuda":
        def cpu_op() -> None:
            (torch.ones(1) * 2.0).item()
        return cpu_op
    from llmd_tpu_torch.engine.cuda_graph import CAPTURE_LOCK

    state: dict = {}

    def op() -> None:
        with CAPTURE_LOCK:  # no device-wide synchronize inside a graph capture
            if not state:
                state["stream"] = torch.cuda.Stream(device)
                with torch.cuda.stream(state["stream"]):
                    state["x"] = torch.ones(1, device=device)
            with torch.cuda.stream(state["stream"]):
                state["x"].mul_(1.0)
            torch.cuda.synchronize(device)
    return op


def _env_f(name: str, default: str) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return float(default)


class DeviceMonitor:
    """Per-replica device-plane monitor, owned by the server that built the
    engine (``engine.monitor``)."""

    def __init__(self, registry: Registry,
                 flight=None,
                 devices: "list[torch.device] | None" = None,
                 probe_op: Optional[Callable[[], None]] = None,
                 pending_fn: Optional[Callable[[], bool]] = None,
                 stall_s: Optional[float] = None,
                 probe_interval_s: Optional[float] = None,
                 probe_timeout_s: Optional[float] = None,
                 poll_s: Optional[float] = None,
                 profile_dir: Optional[str] = None,
                 pause_fn: Optional[Callable[[Callable], object]] = None) -> None:
        self.metrics = register_device_metrics(registry)
        self.flight = flight
        # pause_fn(fn) runs fn while the engine issues no CUDA call (the
        # server's AsyncLLMEngine.run_locked); None: nothing to pause
        self._pause_fn = pause_fn or (lambda fn: fn())
        # the cards whose HBM is polled; None: every visible card at start()
        self._devices = devices
        self._probe_op = probe_op
        self._pending_fn = pending_fn
        self.stall_s = (float(stall_s) if stall_s is not None
                        else _env_f("LLMD_WATCHDOG_STALL_S", "120"))
        self.probe_interval_s = (float(probe_interval_s) if probe_interval_s is not None
                                 else _env_f("LLMD_FABRIC_PROBE_INTERVAL_S", "30"))
        self.probe_timeout_s = (float(probe_timeout_s) if probe_timeout_s is not None
                                else _env_f("LLMD_FABRIC_PROBE_TIMEOUT_S", "20"))
        self.poll_s = max(0.05, float(poll_s) if poll_s is not None
                          else _env_f("LLMD_DEVICE_POLL_S", "10"))
        self.profile_dir = (profile_dir or os.environ.get("LLMD_PROFILE_DIR")
                            or os.path.join(tempfile.gettempdir(), "llmd-profiles"))
        self._lock = threading.Lock()
        # heartbeat: a bare monotonic stamp, written lock-free by the engine
        # loop and read lock-free by the watchdog (a hung step holds the
        # engine lock, so nothing here may wait on one)
        self._beat = time.monotonic()
        self._stalled = False            # guarded by _lock
        self._stall_age_s = 0.0          # guarded by _lock
        self._fabric_alive = True        # guarded by _lock
        self._hbm: Dict[str, Tuple[float, float, float]] = {}  # guarded by _lock
        self._profiling = False          # guarded by _lock
        self._probe_busy = False  # worker-owned; the poll thread reads it
        self._probe_result: Tuple[bool, float] = (True, 0.0)
        self._probe_req = threading.Event()
        self._probe_done = threading.Event()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._started = False

    # ---------------------------------------------------------- lifecycle
    def start(self) -> None:
        if self._started:
            return
        self._started = True
        if self._devices is None:
            self._devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                             if torch.cuda.is_available() else [])
        if self._probe_op is None:
            self._probe_op = make_probe_op(self._devices[0] if self._devices else None)
        if self._devices:
            _init_profiler()
        m = self.metrics
        m.fabric_alive.set(1)
        m.engine_stalled.set(0)
        m.heartbeat_age.set_function(lambda: max(0.0, time.monotonic() - self._beat))
        m.hbm_bytes_in_use.set_labels_function(lambda: self._hbm_field(0))
        m.hbm_peak_bytes.set_labels_function(lambda: self._hbm_field(1))
        m.hbm_limit_bytes.set_labels_function(lambda: self._hbm_field(2))
        targets = [(self._telemetry_loop, "llmd-device-telemetry")]
        if self.stall_s > 0:
            targets.insert(0, (self._watchdog_loop, "llmd-watchdog"))
        if self.probe_interval_s > 0:
            targets.append((self._probe_worker, "llmd-fabric-probe"))
        for target, name in targets:
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        # the probe worker may be wedged inside the device op (the scenario
        # being monitored), so joins are bounded
        for t in self._threads:
            t.join(timeout=1.0)
        self._threads = []
        # the liveness op's tensor and stream go with it: the monitor sits in
        # its registry's callbacks until the cycle collector runs
        self._probe_op = None

    # ---------------------------------------------------------- heartbeat
    def heartbeat(self) -> None:
        """Stamped by the engine loop once per iteration, before it takes the
        engine lock. A bare attribute write: stays lock-free."""
        self._beat = time.monotonic()

    def unhealthy_reason(self) -> Optional[dict]:
        """The ``/health`` verdict: None when fine, else a structured reason
        the pool controller's sweep logs."""
        with self._lock:
            if self._stalled:
                return {"reason": "engine_stalled",
                        "heartbeat_age_s": round(self._stall_age_s, 3),
                        "stall_s": self.stall_s}
            if not self._fabric_alive:
                return {"reason": "fabric_dead", "probe_timeout_s": self.probe_timeout_s}
        return None

    # ----------------------------------------------------------- watchdog
    def _watchdog_loop(self) -> None:
        tick = min(1.0, max(0.05, self.stall_s / 4.0))
        while not self._stop.wait(tick):
            age = time.monotonic() - self._beat
            try:
                pending = bool(self._pending_fn()) if self._pending_fn else False
            except Exception:  # noqa: BLE001 — a racing dict read counts as idle
                pending = False
            stalled = pending and age >= self.stall_s
            with self._lock:
                was = self._stalled
                self._stalled = stalled
                if stalled:
                    self._stall_age_s = age
            if stalled and not was:
                self.metrics.engine_stalled.set(1)
                self.metrics.engine_stalls.inc()
                if self.flight is not None:
                    self.flight.record_system("engine_stalled", heartbeat_age_s=round(age, 3),
                                              stall_s=self.stall_s)
            elif was and not stalled:
                self.metrics.engine_stalled.set(0)
                if self.flight is not None:
                    self.flight.record_system("engine_recovered",
                                              heartbeat_age_s=round(age, 3))

    # -------------------------------------------------- telemetry + probe
    def _telemetry_loop(self) -> None:
        last_probe = -float("inf")  # probe at once on startup
        while not self._stop.is_set():
            self._poll_hbm()
            now = time.monotonic()
            if self.probe_interval_s > 0 and now - last_probe >= self.probe_interval_s:
                last_probe = now
                self._run_probe_cycle()
            self._stop.wait(self.poll_s)

    def _poll_hbm(self) -> None:
        samples: Dict[str, Tuple[float, float, float]] = {}
        for d in self._devices or ():
            if d.type != "cuda":
                continue  # the CPU has no allocator stats: no series
            try:
                stats = torch.cuda.memory_stats(d)
                limit = torch.cuda.get_device_properties(d).total_memory
            except Exception:  # noqa: BLE001 — telemetry never takes down serving
                continue
            samples[f"cuda:{d.index or 0}"] = (
                float(stats.get("allocated_bytes.all.current", 0)),
                float(stats.get("allocated_bytes.all.peak", 0)),
                float(limit))
        with self._lock:
            self._hbm = samples

    def _hbm_field(self, idx: int) -> List[Tuple[dict, float]]:
        """Scrape-time callback body of the per-device HBM gauges."""
        with self._lock:
            snap = dict(self._hbm)
        return [({"device": dev}, vals[idx]) for dev, vals in snap.items()]

    def _probe_worker(self) -> None:
        """The persistent worker that runs the device op; a wedged card parks
        this thread, never the poll thread that timed out waiting on it."""
        while not self._stop.is_set():
            if not self._probe_req.wait(timeout=0.1):
                continue
            self._probe_req.clear()
            self._probe_busy = True
            t0 = time.monotonic()
            try:
                self._probe_op()
                ok = True
            except Exception:  # noqa: BLE001 — a raising op is a failed probe
                ok = False
            self._probe_result = (ok, time.monotonic() - t0)
            self._probe_busy = False
            self._probe_done.set()

    def _run_probe_cycle(self) -> None:
        if self._probe_busy:
            # the previous probe is still inside the device op: count the
            # cycle failed rather than stack requests
            self._apply_probe(False, None)
            return
        self._probe_done.clear()
        self._probe_req.set()
        if self._probe_done.wait(timeout=self.probe_timeout_s):
            self._apply_probe(*self._probe_result)
        else:
            self._apply_probe(False, None)

    def _apply_probe(self, ok: bool, dt: Optional[float]) -> None:
        with self._lock:
            was = self._fabric_alive
            self._fabric_alive = ok
        if ok:
            self.metrics.fabric_alive.set(1)
            if dt is not None:
                self.metrics.fabric_probe_seconds.observe(dt)
            if not was and self.flight is not None:
                self.flight.record_system("fabric_recovered")
        else:
            self.metrics.fabric_alive.set(0)
            self.metrics.fabric_probe_failures.inc()
            if was and self.flight is not None:
                self.flight.record_system("fabric_dead", probe_timeout_s=self.probe_timeout_s)

    # ------------------------------------------------------------ profile
    def capture_profile(self, seconds: float) -> dict:
        """Capture one ``torch.profiler`` window into ``profile_dir`` and
        write it as a Chrome trace. Blocking (the server calls it off its
        handler's lock); one capture at a time, a concurrent call raises
        :class:`ProfileBusy`. Returns ``{dir, files, bytes, seconds}``."""
        global _OPEN_CAPTURES
        from torch.profiler import ProfilerActivity, profile

        seconds = max(0.1, min(float(seconds), 60.0))
        with self._lock:
            if self._profiling:
                raise ProfileBusy("a profiler capture is already in progress")
            self._profiling = True
        try:
            stamp = datetime.datetime.now(datetime.timezone.utc).strftime("%Y%m%d-%H%M%S-%f")
            out_dir = os.path.join(self.profile_dir, stamp)
            os.makedirs(out_dir, exist_ok=True)
            activities = [ProfilerActivity.CPU]
            if any(d.type == "cuda" for d in self._devices or ()):
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities, **_all_threads())
            self._quiesced(prof.start)
            _OPEN_CAPTURES += 1
            try:
                time.sleep(seconds)
            finally:
                _OPEN_CAPTURES -= 1
                self._quiesced(prof.stop)
            prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
            files: List[str] = []
            total = 0
            for root, _dirs, names in os.walk(out_dir):
                for name in names:
                    path = os.path.join(root, name)
                    files.append(os.path.relpath(path, out_dir))
                    total += os.path.getsize(path)
            self.metrics.profile_captures.inc()
            if self.flight is not None:
                self.flight.record_system("profile_capture", seconds=seconds, dir=out_dir,
                                          files=len(files), bytes=total)
            return {"dir": out_dir, "files": sorted(files), "bytes": total,
                    "seconds": seconds}
        finally:
            with self._lock:
                self._profiling = False

    def _quiesced(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` (the tracer's start or stop) with the engine's step
        loop paused and no graph capture or liveness op running: the engine
        lock first, then the capture lock, the order a capture inside a step
        takes them in."""
        from llmd_tpu_torch.engine.cuda_graph import CAPTURE_LOCK

        def locked() -> None:
            with CAPTURE_LOCK:
                fn()
        self._pause_fn(locked)


def _init_profiler() -> None:
    """Initialise the profiler's device tracing in the calling thread, which
    must be the one that imported torch (the server's ``start``): the tracer
    library runs its client's set-up only in that thread, and a first window
    opened from another thread (an HTTP handler's) records nothing on the
    card. One empty window; later windows may open from any thread."""
    global _TRACER_READY
    from torch.profiler import ProfilerActivity, profile

    if _TRACER_READY or threading.current_thread() is not threading.main_thread():
        return
    from llmd_tpu_torch.engine.cuda_graph import CAPTURE_LOCK

    with CAPTURE_LOCK, profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        pass
    _TRACER_READY = True


def _all_threads() -> dict:
    """``torch.profiler.profile`` keywords that record the operators and
    ``record_function`` ranges of every thread (the engine loop's, not only
    the capturing thread's); empty on a torch without the option."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return {"experimental_config": _ExperimentalConfig(profile_all_threads=True)}
    except (ImportError, TypeError):
        return {}
