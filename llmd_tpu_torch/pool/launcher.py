"""Replica launchers: the pool controller's process-lifecycle backends (copy
of ``llmd_tpu/pool/launcher.py``; the readiness poll on ``router/http.py``'s
client, where the reference uses aiohttp).

Two implementations of one contract:

- :class:`FakeReplicaLauncher` — in-process ``FakeModelServer`` replicas for
  CI and the SLO gate. A configurable ``engine_build_s`` sleep simulates the
  cold engine build; a snapshot hit (``PoolSnapshotStore``) skips it, which
  is exactly the warm-start contract the engine path honors for real.
- :class:`ProcessReplicaLauncher` — subprocess replicas (``testing/
  fake_server.py`` CLI or ``engine/serve.py`` via :func:`engine_argv`),
  readiness-gated on ``/health``.

``kill`` is deliberately part of the contract: chaos tooling
(``tools/slo_check.py``) needs to take a replica down *without* the drain
handshake, so the controller's health probe and the router's breakers — not
the launcher — have to notice.

One departure, on purpose: :func:`engine_argv` passes a registry model name
through as ``--model <name>`` (the port's serve CLI draws random weights
from ``--seed``), where the reference writes a small transformers checkpoint
into the snapshot and serves that. The snapshot layout, the fingerprint and
the ``--compile-cache-dir`` under it are the reference's.
"""

from __future__ import annotations

import asyncio
import copy
import os
import socket
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from llmd_tpu_torch.pool.snapshot import PoolSnapshotStore, config_fingerprint
from llmd_tpu_torch.router.http import HTTPClient


@dataclass
class ReplicaHandle:
    """One launched replica, as the controller tracks it."""

    address: str  # "host:port" the replica serves on
    name: str = ""
    warm: bool = False  # launched from a snapshot (skipped cold build)
    launched_at: float = field(default_factory=time.monotonic)
    server: Any = None  # in-process FakeModelServer (fake launcher)
    proc: Any = None  # subprocess.Popen (process launcher)
    role: str = "both"  # prefill | decode | both — copied onto the Endpoint
    sidecar: Any = None  # RoutingSidecar fronting a decode replica

    def __post_init__(self) -> None:
        if not self.name:
            self.name = self.address


class ReplicaLauncher:
    """Lifecycle contract the controller drives. All methods are async so
    process launchers can await readiness without blocking the loop."""

    async def launch(self) -> ReplicaHandle:
        raise NotImplementedError

    async def stop(self, handle: ReplicaHandle) -> None:
        """Graceful stop (the controller drains via the router first)."""
        raise NotImplementedError

    async def kill(self, handle: ReplicaHandle) -> None:
        """Abrupt stop: no drain, in-flight requests die. Chaos only."""
        await self.stop(handle)

    def alive(self, handle: ReplicaHandle) -> bool:
        raise NotImplementedError


class FakeReplicaLauncher(ReplicaLauncher):
    """In-process fake replicas with a simulated cold engine build.

    ``engine_config`` is fingerprinted exactly like the engine launcher's;
    the first launch pays ``engine_build_s`` and commits a snapshot, every
    later launch of the same config is warm (pays only ``restore_s``).
    """

    def __init__(self, server_config=None,
                 snapshots: Optional[PoolSnapshotStore] = None,
                 engine_config: Optional[dict] = None,
                 engine_build_s: float = 0.0,
                 restore_s: float = 0.0,
                 durable_store: bool = False,
                 role: str = "both",
                 with_sidecar: bool = False) -> None:
        from llmd_tpu_torch.testing.fake_server import FakeServerConfig

        self.server_config = server_config or FakeServerConfig()
        self.snapshots = snapshots
        self.engine_config = engine_config if engine_config is not None else {
            "model": self.server_config.model,
            "block_size": self.server_config.block_size,
            "num_blocks": self.server_config.num_blocks,
        }
        self.engine_build_s = engine_build_s
        self.restore_s = restore_s
        # Durable prefix tier stand-in: a graceful stop — the controller only
        # calls stop() after the drain handshake — writes the replica's
        # simulated block set back here, and a warm launch restores it, so a
        # 0→1 warm start recovers the prefix working set, not just the
        # compile cache. kill() deliberately skips the write-back (no drain,
        # no flush). Off by default: only opted-in harnesses
        # (tools/slo_check.py) should see restored prefixes.
        self.durable_store = durable_store
        self.durable_blocks: set[int] = set()
        # P/D disaggregation: role is stamped on the replica config and the
        # handle so the controller can label the Endpoint; with_sidecar
        # fronts decode replicas with a RoutingSidecar that executes the
        # x-prefiller-host-port split the router decides.
        self.role = role
        self.with_sidecar = with_sidecar
        self._seq = 0

    async def launch(self) -> ReplicaHandle:
        from llmd_tpu_torch.testing.fake_server import FakeModelServer

        fp = config_fingerprint(self.engine_config)
        warm = self.snapshots is not None and self.snapshots.has(fp)
        if warm:
            if self.restore_s > 0:
                await asyncio.sleep(self.restore_s)
        else:
            if self.engine_build_s > 0:
                await asyncio.sleep(self.engine_build_s)  # simulated build
            if self.snapshots is not None:
                self.snapshots.save(fp, {"kind": "fake",
                                         "engine_config": self.engine_config})
        cfg = copy.deepcopy(self.server_config)
        if self.role != "both":
            cfg.role = self.role
        server = FakeModelServer(cfg)
        if self.durable_store and self.durable_blocks:
            # restore the written-back prefix working set into the simulated
            # paged cache: repeats hit these blocks, so prefill (∝ uncached
            # tokens) — and therefore TTFT — recovers along with the build
            now = time.monotonic()
            for h in self.durable_blocks:
                server.blocks[h] = now
        await server.start()
        self._seq += 1
        sidecar = None
        address = server.address
        if self.with_sidecar:
            from llmd_tpu_torch.disagg.sidecar import RoutingSidecar

            sidecar = RoutingSidecar(decode_addr=server.address,
                                     prefill_timeout_s=2.0)
            await sidecar.start()
            address = sidecar.address  # traffic enters through the sidecar
        return ReplicaHandle(address=address,
                             name=f"fake-{self._seq}", warm=warm,
                             server=server, role=self.role, sidecar=sidecar)

    async def stop(self, handle: ReplicaHandle) -> None:
        if handle.sidecar is not None:
            sidecar, handle.sidecar = handle.sidecar, None
            await sidecar.stop()
        if handle.server is not None:
            if self.durable_store:
                # drain-time write-back: the controller drained before this
                self.durable_blocks.update(handle.server.blocks.keys())
            await handle.server.stop()
            handle.server = None

    async def kill(self, handle: ReplicaHandle) -> None:
        # stopping the front cancels in-flight handlers: clients see the
        # connection go, which is the abrupt-death signal the chaos gate
        # wants. No durable write-back: an abrupt death never ran the drain
        # flush.
        if handle.sidecar is not None:
            sidecar, handle.sidecar = handle.sidecar, None
            await sidecar.stop()
        if handle.server is not None:
            server, handle.server = handle.server, None
            await server.stop()

    def alive(self, handle: ReplicaHandle) -> bool:
        return handle.server is not None and handle.server.serving


def _free_port(host: str = "127.0.0.1") -> int:
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def fake_argv(port: int, *, model: str = "fake/model", block_size: int = 16,
              num_blocks: int = 512, max_running: int = 8,
              decode_us_per_token: float = 500.0,
              role: str = "both") -> list[str]:
    """argv for a subprocess FakeModelServer (testing/fake_server.py CLI)."""
    argv = [sys.executable, "-m", "llmd_tpu_torch.testing.fake_server",
            "--port", str(port), "--model", model,
            "--block-size", str(block_size), "--num-blocks", str(num_blocks),
            "--max-running", str(max_running),
            "--decode-us-per-token", str(decode_us_per_token)]
    if role != "both":
        argv += ["--role", role]
    return argv


def engine_argv(model: str, port: int,
                snapshots: Optional[PoolSnapshotStore] = None,
                engine_config: Optional[dict] = None,
                extra: Optional[list[str]] = None) -> tuple[list[str], bool]:
    """argv for an ``engine/serve.py`` replica, warm-start aware.

    With a snapshot store, the kernel libraries' compile cache lives under
    the config fingerprint: the first launch builds them there and every
    relaunch loads them (``--compile-cache-dir``) instead of running nvcc.
    ``model`` is passed through: a registry name serves random weights from
    the serve CLI's ``--seed``, an HF directory its own weights. Returns
    ``(argv, warm)``.
    """
    cfg = dict(engine_config or {})
    cfg.setdefault("model", model)
    argv = [sys.executable, "-m", "llmd_tpu_torch.engine.serve",
            "--model", model, "--port", str(port)]
    warm = False
    if snapshots is not None:
        fp = config_fingerprint(cfg)
        warm = snapshots.has(fp)
        # launches gathered by one reconcile share this directory: each build
        # writes a temporary file and renames it into place
        # (native/build.py), so concurrent builders race benignly
        cache_dir = snapshots.path(fp, "compile_cache")
        argv += ["--compile-cache-dir", cache_dir]
        if not warm:
            snapshots.save(fp, {"kind": "engine", "engine_config": cfg})
    argv += list(extra or [])
    return argv, warm


class ProcessReplicaLauncher(ReplicaLauncher):
    """Subprocess replicas readiness-gated on ``/health``.

    ``argv_fn(port) -> (argv, warm)`` (or ``argv`` alone, treated as cold)
    decouples the launcher from what it launches: ``fake_argv`` for CI,
    ``engine_argv`` for on-device pools. ``log_dir`` (port only) keeps each
    replica's stdout and stderr in ``<log_dir>/<name>.log``; without it they
    are discarded, as the reference discards them.
    """

    def __init__(self, argv_fn: Callable[[int], Any], host: str = "127.0.0.1",
                 ready_timeout_s: float = 60.0,
                 env: Optional[dict[str, str]] = None,
                 log_dir: Optional[str] = None) -> None:
        self.argv_fn = argv_fn
        self.host = host
        self.ready_timeout_s = ready_timeout_s
        self.env = env
        self.log_dir = log_dir
        self._seq = 0
        self._spawned = 0

    def _output(self):
        if self.log_dir is None:
            return subprocess.DEVNULL
        self._spawned += 1
        os.makedirs(self.log_dir, exist_ok=True)
        return open(os.path.join(self.log_dir, f"replica-{self._spawned}.log"), "w")

    async def launch(self) -> ReplicaHandle:
        port = _free_port(self.host)
        built = self.argv_fn(port)
        argv, warm = built if isinstance(built, tuple) else (built, False)
        env = dict(os.environ, **(self.env or {}))
        out = self._output()
        try:
            proc = subprocess.Popen(argv, env=env, stdout=out,
                                    stderr=subprocess.STDOUT if self.log_dir else out)
        finally:
            if out is not subprocess.DEVNULL:
                out.close()  # the child holds its own descriptor
        address = f"{self.host}:{port}"
        deadline = time.monotonic() + self.ready_timeout_s
        client = HTTPClient()
        try:
            while time.monotonic() < deadline:
                if proc.poll() is not None:
                    raise RuntimeError(
                        f"replica process exited rc={proc.returncode} "
                        f"before becoming ready ({' '.join(argv[:4])}…)")
                try:
                    r = await client.request("GET", f"http://{address}/health",
                                             timeout=1.0)
                    await r.read()
                    if r.status == 200:
                        self._seq += 1
                        return ReplicaHandle(address=address,
                                             name=f"proc-{self._seq}",
                                             warm=warm, proc=proc)
                except Exception:
                    pass
                await asyncio.sleep(0.05)
            raise TimeoutError(
                f"replica at {address} not ready within {self.ready_timeout_s}s")
        except BaseException:
            # not ready, timed out, or cancelled (a controller stopped
            # mid-launch): the process is nobody's to stop later (port only;
            # the reference kills it on the timeout alone)
            proc.kill()
            proc.wait()
            raise
        finally:
            await client.close()

    async def stop(self, handle: ReplicaHandle) -> None:
        if handle.proc is None:
            return
        handle.proc.terminate()
        try:
            await asyncio.to_thread(handle.proc.wait, 5.0)
        except Exception:
            handle.proc.kill()
        handle.proc = None

    async def kill(self, handle: ReplicaHandle) -> None:
        if handle.proc is not None:
            handle.proc.kill()
            await asyncio.to_thread(handle.proc.wait)
            handle.proc = None

    def alive(self, handle: ReplicaHandle) -> bool:
        return handle.proc is not None and handle.proc.poll() is None
