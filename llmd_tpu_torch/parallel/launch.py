"""Start and drive a world of rank processes (rank 0 is the caller).

:meth:`World.start` spawns ranks 1..N-1 as ``python -m
llmd_tpu_torch.parallel.worker`` processes (rank r on ``cuda:r``, or on the
CPU), joins them in one ``torch.distributed`` process group (NCCL on cards,
gloo on the CPU; ``tcp://127.0.0.1`` on a free port) with a timeout, and
opens one command socket to each. Rank 0 holds the scheduler, the KV
manager and the server; the workers hold their shards and run what rank 0
sends them, in order:

- ``("mesh", MeshConfig)``: build the ``RankMesh`` (its process groups);
- ``("engine", spec)``: build this rank's ``LLMEngine`` shard;
- ``("op", name, kwargs)``: run the engine's device op ``_op_<name>`` with
  the host arrays rank 0 packed (``engine/engine.py``);
- ``("call", "module:function", kwargs)``: run a function of the port on
  every rank (``fn(mesh, **kwargs)``; the kernel and collective checks);
- ``("engine_call", "module:function", kwargs)``: ``fn(engine, **kwargs)``
  on every rank's engine shard (``parallel/checks``' shard reads);
- ``("close",)``, ``("exit",)``.

Commands are length-prefixed pickles over the sockets: host arrays, as the
reference's single controller hands them to its programs. A worker joins
with a random token rank 0 hands it on its stdin, so no other local process
can take a rank's socket (answers are unpickled on rank 0). ``mesh``,
``engine``, ``call`` and ``engine_call`` wait for every worker's answer (its
result, or its error text, which raises :class:`WorldError` on rank 0).

Failure never hangs: the process group has a timeout; a monitor thread on
rank 0 notices a worker that exits non-zero, kills the others and closes
the sockets, so rank 0's next command or collective raises; a worker exits
when its command socket closes or its parent process dies.
"""

from __future__ import annotations

import datetime
import hmac
import os
import pickle
import secrets
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Any, Optional

import torch
import torch.distributed as dist

from llmd_tpu_torch.parallel.mesh import MeshConfig, RankMesh

# the process group's timeout (and the start and answer waits) of a world
# started without one
DEFAULT_TIMEOUT_S = 300.0
_HEADER = struct.Struct("!Q")
TOKEN_BYTES = 16


class WorldError(RuntimeError):
    """A rank failed: it exited, raised, or stopped answering."""


def send_msg(sock: socket.socket, data: bytes) -> None:
    sock.sendall(_HEADER.pack(len(data)) + data)


def recv_msg(sock: socket.socket) -> Optional[bytes]:
    """One message, or None when the peer closed the socket."""
    head = _recv_exact(sock, _HEADER.size)
    if head is None:
        return None
    body = _recv_exact(sock, _HEADER.unpack(head)[0])
    if body is None:
        return None
    return body


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def backend_for(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


class World:
    """Rank 0's handle on a running world (see the module docstring)."""

    def __init__(self, size: int, device: torch.device, procs: list[subprocess.Popen],
                 socks: list[socket.socket], timeout_s: float) -> None:
        self.size = size
        self.device = device
        self.procs = procs
        self.socks = socks  # socks[i] talks to rank i + 1
        self.timeout_s = timeout_s
        self.failed: Optional[str] = None
        # engines built on this world keep each device op's tokens on every
        # rank (``oplogs``): the rank agreement checks
        self.record_ops = False
        self.mesh_cfg: Optional[MeshConfig] = None
        self.rank_mesh: Optional[RankMesh] = None
        self._closing = False
        self._lock = threading.Lock()
        self._monitor = threading.Thread(target=self._watch, name="world-monitor", daemon=True)
        self._monitor.start()

    @property
    def pids(self) -> list[int]:
        """The worker processes' pids, rank 1 first."""
        return [p.pid for p in self.procs]

    @classmethod
    def start(cls, size: int, device_type: str = "cuda",
              timeout_s: Optional[float] = None) -> "World":
        """Spawn ranks 1..size-1 and join the process group as rank 0.
        Raises ValueError when a CUDA world has fewer cards than ranks."""
        if timeout_s is None:
            timeout_s = DEFAULT_TIMEOUT_S
        if size < 2:
            raise ValueError(f"a world needs at least 2 ranks, got {size}")
        if device_type == "cuda":
            have = torch.cuda.device_count()
            if have < size:
                raise ValueError(f"need {size} devices for a world of {size} ranks, "
                                 f"have {have}")
            device = torch.device("cuda", 0)
            torch.cuda.set_device(device)
        elif device_type == "cpu":
            device = torch.device("cpu")
        else:
            raise ValueError(f"device_type must be cuda|cpu, got {device_type!r}")
        if dist.is_initialized():
            raise RuntimeError("this process already belongs to a process group")
        init = f"tcp://127.0.0.1:{_free_port()}"
        lsock = socket.socket()
        lsock.bind(("127.0.0.1", 0))
        lsock.listen(size)
        lsock.settimeout(timeout_s)
        env = dict(os.environ)
        root = str(Path(__file__).resolve().parents[2])
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (root, env.get("PYTHONPATH", "")) if p)
        token = secrets.token_bytes(TOKEN_BYTES)
        procs: list[subprocess.Popen] = []
        socks: list[Optional[socket.socket]] = [None] * (size - 1)
        try:
            for r in range(1, size):
                proc = subprocess.Popen(
                    [sys.executable, "-m", "llmd_tpu_torch.parallel.worker",
                     "--rank", str(r), "--world-size", str(size), "--init", init,
                     "--commands", "%s:%d" % lsock.getsockname(), "--device", device_type,
                     "--timeout", str(timeout_s)],
                    env=env, stdin=subprocess.PIPE, stdout=2, start_new_session=True)
                procs.append(proc)
                proc.stdin.write(token.hex().encode() + b"\n")
                proc.stdin.close()
            deadline = time.monotonic() + timeout_s
            while any(s is None for s in socks):
                lsock.settimeout(max(0.1, deadline - time.monotonic()))
                conn, _ = lsock.accept()
                conn.settimeout(max(0.1, deadline - time.monotonic()))
                hello = _recv_exact(conn, 4 + TOKEN_BYTES)
                rank = struct.unpack("!I", hello[:4])[0] if hello else 0
                if (hello is None or not hmac.compare_digest(hello[4:], token)
                        or not 0 < rank < size or socks[rank - 1] is not None):
                    conn.close()  # not one of this world's ranks
                    continue
                conn.settimeout(None)
                socks[rank - 1] = conn
            dist.init_process_group(backend_for(device_type), init_method=init, rank=0,
                                    world_size=size,
                                    timeout=datetime.timedelta(seconds=timeout_s))
        except BaseException:
            _kill(procs)
            for s in socks:
                if s is not None:
                    s.close()
            raise
        finally:
            lsock.close()
        return cls(size, device, procs, socks, timeout_s)

    # ------------------------------------------------------------ commands
    def send(self, msg: tuple) -> None:
        """Send one command to every worker (no answer awaited)."""
        self._check()
        data = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
        try:
            for s in self.socks:
                send_msg(s, data)
        except OSError as e:
            self._check()
            raise WorldError(f"a rank stopped taking commands: {e}") from e

    def answers(self) -> list[Any]:
        """Every worker's answer to the last command that waits for one,
        rank 1 first; a worker's error raises WorldError."""
        out = []
        for r, s in enumerate(self.socks, start=1):
            s.settimeout(self.timeout_s)
            try:
                data = recv_msg(s)
            except (OSError, socket.timeout) as e:
                self._check()
                raise WorldError(f"rank {r} did not answer: {e}") from e
            finally:
                s.settimeout(None)
            if data is None:
                self._check()
                raise WorldError(f"rank {r} closed its command socket")
            ok, value = pickle.loads(data)
            if not ok:
                raise WorldError(f"rank {r} failed: {value}")
            out.append(value)
        return out

    def mesh(self, cfg: MeshConfig) -> RankMesh:
        """Build the rank mesh ``cfg`` on every rank (its process groups)."""
        if cfg.num_devices != self.size:
            raise ValueError(f"need {cfg.num_devices} devices for {cfg}, "
                             f"the world has {self.size}")
        if cfg == self.mesh_cfg:
            return self.rank_mesh
        self.send(("mesh", cfg))
        self.rank_mesh = RankMesh.build(cfg, self.device, world=self)
        self.answers()
        self.mesh_cfg = cfg
        return self.rank_mesh

    def call(self, fn: str, **kw) -> tuple[Any, list[Any]]:
        """Run ``fn(mesh, **kw)`` (``"llmd_tpu_torch.<module>:<function>"``)
        on every rank: (rank 0's result, the workers' results)."""
        self.send(("call", fn, kw))
        mine = self.local(resolve(fn), self.rank_mesh, **kw)
        return mine, self.answers()

    def engine_call(self, fn: str, engine, **kw) -> tuple[Any, list[Any]]:
        """Run ``fn(engine_shard, **kw)`` on every rank (rank 0's shard is
        ``engine``): (rank 0's result, the workers' results)."""
        self.send(("engine_call", fn, kw))
        mine = self.local(resolve(fn), engine, **kw)
        return mine, self.answers()

    def local(self, fn, *args, **kw):
        """Rank 0's side of a command: ``fn(*args, **kw)``. A collective that
        fails because a rank died raises WorldError naming that rank."""
        try:
            return fn(*args, **kw)
        except RuntimeError as e:
            deadline = time.monotonic() + 2.0
            while self.failed is None and time.monotonic() < deadline:
                time.sleep(0.05)  # the monitor names the rank that went
            if self.failed is None:
                raise
            raise WorldError(f"{self.failed} ({type(e).__name__}: {e})") from e

    def oplogs(self) -> list[list]:
        """Each worker's engine's op log (``record_ops``), rank 1 first."""
        self.send(("oplog",))
        return self.answers()

    def close(self) -> None:
        """Stop every worker and leave the process group."""
        with self._lock:
            if self._closing:
                return
            self._closing = True
        try:
            if self.failed is None:
                try:
                    self.send(("exit",))
                except WorldError:
                    pass
            deadline = time.monotonic() + 30.0
            for p in self.procs:
                try:
                    p.wait(timeout=max(0.1, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    pass
        finally:
            _kill(self.procs)
            for s in self.socks:
                s.close()
            if dist.is_initialized():
                dist.destroy_process_group()

    # ------------------------------------------------------------ failure
    def _check(self) -> None:
        if self.failed is not None:
            raise WorldError(self.failed)

    def _is_closing(self) -> bool:
        with self._lock:
            return self._closing

    def _watch(self) -> None:
        while not self._is_closing():
            for r, p in enumerate(self.procs, start=1):
                code = p.poll()
                if code is not None and code != 0 and not self._is_closing():
                    self.failed = f"rank {r} exited with code {code}"
                    _kill(self.procs)
                    for s in self.socks:
                        try:
                            s.shutdown(socket.SHUT_RDWR)
                        except OSError:
                            pass
                    return
            time.sleep(0.2)


def _kill(procs: list[subprocess.Popen]) -> None:
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
            p.wait()


def resolve(fn: str):
    """The function ``"llmd_tpu_torch.<module>:<name>"`` (only the port's)."""
    import importlib

    mod, _, name = fn.partition(":")
    if not mod.startswith("llmd_tpu_torch.") or not name:
        raise ValueError(f"not a function of the port: {fn!r}")
    return getattr(importlib.import_module(mod), name)
