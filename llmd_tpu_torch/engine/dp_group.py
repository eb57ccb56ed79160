"""Data-parallel rank groups over port engines (copy of
``llmd_tpu/engine/dp_group.py``): the wide-EP orchestration layer.

The reference's DP launcher flags (``--data-parallel-size``,
``--data-parallel-size-local``, ``--data-parallel-address`` /
``--data-parallel-rpc-port``, ``--data-parallel-start-rank``,
``--data-parallel-hybrid-lb``) map onto :class:`DPGroupConfig`. Pieces:

- :class:`DPCoordinator`: the leader's rank registry and wave clock, JSON
  lines over TCP. Ranks register at start (a barrier) and report
  ``has_work`` every loop tick; the answer is the wave: if ANY rank has work,
  ALL ranks step (an expert-parallel all-to-all is a collective every rank
  must enter together; an idle rank contributes an empty batch).
- :class:`DPWorkerSync`: the blocking client, used from a rank's step-loop
  thread.
- :class:`DPAsyncEngine`: the port's ``AsyncLLMEngine`` whose loop steps on
  wave decisions, serving solo while the coordinator is unreachable.
- :class:`DPLocalBalancer`: the node-local round-robin proxy of hybrid-LB
  mode, on ``http.server.ThreadingHTTPServer`` and ``http.client`` (the
  reference's runs on aiohttp), streaming each answer through.
- :class:`WideEPEngineGroup`: R rank frontends (``EngineServer(engine=,
  async_engine=, rank=)``) over ONE engine with ``dp_ranks=R``: each rank a
  router-visible port, its own queue, slot range, page partition and token
  budget; one step loop and one pool. Over a mesh of several devices
  (``MeshConfig(dp=2, ep=2, tp=2)``, the reference's wide-EP layout) R is
  ``mesh.dp``: the engine is world rank 0 (``parallel/launch.py``), so every
  rank frontend lives on rank 0 and the workers hold the shards; on a
  one-device mesh ``dp_ranks`` gives R (a port addition: DP frontends on one
  card). Port addition:
  ``kv_events_port_base`` (``serve --data-parallel-size N --kv-events-port
  P``) has each rank publish its allocator's KV events (rank r on P + r; 0
  picks free ports), for a router's precise-prefix index over the rank
  ports.
- :class:`DPEngineGroup`: ``dp_size_local`` rank servers, each with its own
  engine and a :class:`DPAsyncEngine`, under the leader's coordinator, plus
  the balancer in hybrid-LB mode.

The reference's servers run on asyncio and its groups' ``start`` / ``stop``
are coroutines; the port's servers are threads, so these are plain methods
of the same names.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import socket
import socketserver
import threading
import time
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from llmd_tpu_torch.engine.async_engine import AsyncLLMEngine
from llmd_tpu_torch.engine.config import EngineConfig
from llmd_tpu_torch.engine.engine import LLMEngine
from llmd_tpu_torch.engine.server import EngineServer
from llmd_tpu_torch.models.config import ModelConfig

MAX_TARGET_PORTS = 8  # InferencePool targetPorts limit


@dataclass
class DPGroupConfig:
    dp_size: int = 1          # total ranks across all hosts
    dp_size_local: int = 1    # ranks served by this process/host
    dp_address: str = "127.0.0.1"  # leader coordination host
    dp_rpc_port: int = 5555   # leader coordination port (0 = ephemeral)
    dp_start_rank: int = 0    # first global rank on this host
    hybrid_lb: bool = False   # expose one balanced endpoint per node
    port_base: int = 8000     # local rank i serves on port_base + i (0 = ephemeral)
    lb_port: int = 0          # hybrid-LB listen port (0 = ephemeral)

    def __post_init__(self) -> None:
        if self.dp_size_local > self.dp_size:
            raise ValueError("dp_size_local > dp_size")
        if not self.hybrid_lb and self.dp_size_local > MAX_TARGET_PORTS:
            raise ValueError(
                f"{self.dp_size_local} rank ports exceed InferencePool's "
                f"{MAX_TARGET_PORTS}-port limit; use hybrid_lb")

    @property
    def is_leader(self) -> bool:
        return self.dp_start_rank == 0


class _CoordinatorServer(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True


class DPCoordinator:
    """Leader-side rank registry and wave clock (JSON-lines TCP server)."""

    def __init__(self, dp_size: int, host: str = "0.0.0.0", port: int = 0) -> None:
        self.dp_size = dp_size
        self.host, self.port = host, port
        self.registered: set[int] = set()
        self.has_work: dict[int, bool] = {}
        self.waves = 0  # wave ticks answered with step=True
        self._lock = threading.Lock()  # guards registered, has_work, waves
        self._server: Optional[_CoordinatorServer] = None
        self._thread: Optional[threading.Thread] = None
        self._conns: set[socket.socket] = set()

    def start(self) -> None:
        coord = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self) -> None:
                coord._conns.add(self.connection)
                try:
                    for line in self.rfile:
                        try:
                            msg = json.loads(line)
                        except json.JSONDecodeError:
                            self.wfile.write(b'{"error": "bad json"}\n')
                            continue
                        self.wfile.write((json.dumps(coord._dispatch(msg)) + "\n").encode())
                        self.wfile.flush()
                except (ConnectionResetError, BrokenPipeError, OSError):
                    pass
                finally:
                    coord._conns.discard(self.connection)

        self._server = _CoordinatorServer((self.host, self.port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="dp-coordinator", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._server is None:
            return
        self._server.shutdown()
        # live worker connections end too: a handler blocked reading an
        # open connection would outlive the group
        for conn in list(self._conns):
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        self._server.server_close()
        self._server = None

    def _dispatch(self, msg: dict) -> dict:
        cmd = msg.get("cmd")
        with self._lock:
            if cmd == "register":
                rank = int(msg["rank"])
                self.registered.add(rank)
                self.has_work.setdefault(rank, False)
                return {"ok": True, "dp_size": self.dp_size,
                        "registered": len(self.registered)}
            if cmd == "report":
                self.has_work[int(msg["rank"])] = bool(msg.get("has_work"))
                step = any(self.has_work.values())
                if step:
                    self.waves += 1
                return {"step": step}
            if cmd == "status":
                return {"registered": sorted(self.registered), "dp_size": self.dp_size,
                        "wave": any(self.has_work.values()), "waves": self.waves}
        return {"error": f"unknown cmd {cmd!r}"}


class DPWorkerSync:
    """Blocking JSON-lines client for the engine loop thread (one conn per rank)."""

    def __init__(self, rank: int, host: str, port: int, timeout_s: float = 5.0) -> None:
        self.rank = rank
        self.host, self.port = host, port
        self.timeout_s = timeout_s
        self._sock: Optional[socket.socket] = None
        self._file = None

    def _connect(self) -> None:
        self._sock = socket.create_connection((self.host, self.port), timeout=self.timeout_s)
        self._file = self._sock.makefile("rwb")

    def _rpc(self, msg: dict) -> dict:
        if self._sock is None:
            self._connect()
        self._file.write((json.dumps(msg) + "\n").encode())
        self._file.flush()
        line = self._file.readline()
        if not line:
            raise ConnectionError("coordinator closed connection")
        return json.loads(line)

    def register(self, barrier_timeout_s: float = 30.0) -> None:
        """Register and block until every rank in the group has registered."""
        deadline = time.monotonic() + barrier_timeout_s
        resp = self._rpc({"cmd": "register", "rank": self.rank})
        dp_size = resp["dp_size"]
        while resp.get("registered", 0) < dp_size:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"rank {self.rank}: {resp.get('registered')}/{dp_size} ranks "
                    f"registered after {barrier_timeout_s}s")
            time.sleep(0.05)
            resp = self._rpc({"cmd": "register", "rank": self.rank})

    def report(self, has_work: bool) -> bool:
        """The wave decision. Raises OSError / ConnectionError /
        JSONDecodeError on a coordinator outage or an error answer: the
        caller drops to solo serving and re-registers on its paced
        schedule."""
        try:
            resp = self._rpc({"cmd": "report", "rank": self.rank, "has_work": has_work})
        except (OSError, json.JSONDecodeError):
            self.close()
            raise
        if "step" not in resp:
            self.close()
            raise ConnectionError(f"coordinator error response: {resp!r}")
        return bool(resp["step"])

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None


class DPAsyncEngine(AsyncLLMEngine):
    """Engine loop that enters steps on the group wave, not on local work
    alone. If the coordination plane is unreachable (a peer that never
    started, a dead leader), the rank serves solo, stepping on local work,
    and retries registration between steps: the loop never dies while its
    server accepts requests."""

    def __init__(self, engine: LLMEngine, worker: DPWorkerSync,
                 idle_sleep_s: float = 0.002,
                 register_attempt_timeout_s: float = 2.0,
                 register_retry_interval_s: float = 5.0) -> None:
        super().__init__(engine, idle_sleep_s=idle_sleep_s)
        self.worker = worker
        self.steps = 0
        self.empty_steps = 0  # wave-joined steps with no local work
        self.register_attempt_timeout_s = register_attempt_timeout_s
        self.register_retry_interval_s = register_retry_interval_s
        self.register_failures = 0
        self.registered = False
        self._next_register = 0.0

    def _try_register(self) -> None:
        # paced: a blocked attempt costs up to attempt_timeout once per retry
        # interval; solo serving keeps its rate in between
        if time.monotonic() < self._next_register:
            return
        try:
            self.worker.register(barrier_timeout_s=self.register_attempt_timeout_s)
            self.registered = True
        except Exception:  # noqa: BLE001 — any failure: serve solo, retry later
            self.register_failures += 1
            self.worker.close()
            self._next_register = time.monotonic() + self.register_retry_interval_s

    def _run(self) -> None:  # overrides the base loop
        while not self._stop.is_set():
            if not self.registered:
                self._try_register()
            mon = self.engine.monitor
            if mon is not None:
                mon.heartbeat()
            with self._lock:
                has_work = self.engine.has_work()
            if self.registered:
                try:
                    step = self.worker.report(has_work)
                except (OSError, ConnectionError, json.JSONDecodeError):
                    # coordinator outage: solo at full rate, re-register later
                    self.registered = False
                    self.register_failures += 1
                    self._next_register = time.monotonic() + self.register_retry_interval_s
                    step = has_work
            else:
                step = has_work
            if not step:
                time.sleep(self._idle_sleep)
                continue
            try:
                with self._lock:
                    outputs = self.engine.step()
            except Exception as e:  # noqa: BLE001 — the loop boundary: report, fail requests
                self._fail(e)
                break
            self.steps += 1
            if not has_work:
                # joined the wave with an empty batch: a no-op here, so pace
                # the loop (across hosts the collective itself would block)
                self.empty_steps += 1
                time.sleep(self._idle_sleep)
            self._deliver(outputs)
        self.worker.close()


_HOP_HEADERS = ("host", "content-length", "transfer-encoding", "connection")


class DPLocalBalancer:
    """Node-local round-robin reverse proxy for hybrid-LB mode."""

    def __init__(self, targets: list[str], host: str = "127.0.0.1", port: int = 0) -> None:
        self.targets = targets
        self.host, self.port = host, port
        self._i = 0
        self._lock = threading.Lock()  # guards _i
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def _next(self) -> str:
        with self._lock:
            target = self.targets[self._i % len(self.targets)]
            self._i += 1
        return target

    def start(self) -> None:
        lb = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args) -> None:
                pass

            def _proxy(self) -> None:
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n) if n else None
                host, _, port = lb._next().rpartition(":")
                conn = http.client.HTTPConnection(host, int(port), timeout=600)
                try:
                    conn.request(self.command, self.path, body=body, headers={
                        k: v for k, v in self.headers.items()
                        if k.lower() not in _HOP_HEADERS})
                    resp = conn.getresponse()
                    self.send_response(resp.status)
                    for k, v in resp.getheaders():
                        if k.lower() not in _HOP_HEADERS:
                            self.send_header(k, v)
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    while True:  # stream the answer through, SSE included
                        chunk = resp.read1(65536)
                        if not chunk:
                            break
                        self.wfile.write(b"%x\r\n%s\r\n" % (len(chunk), chunk))
                        self.wfile.flush()
                    self.wfile.write(b"0\r\n\r\n")
                finally:
                    conn.close()

            do_GET = do_POST = do_DELETE = _proxy

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="dp-balancer", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None


class WideEPEngineGroup:
    """DP rank frontends over ONE engine (the reference's wide-EP topology,
    ``decode.yaml:85-121``; over a mesh, or on one device): each rank owns a router-visible
    HTTP port, its own queue, batch-slot range, KV page partition and token
    budget, and every rank's rows run in the same step programs of the one
    shared step loop (wave lockstep is inherent: an idle rank contributes no
    rows). ``device``, ``seed``, ``rank_mesh``: the engine's (``rank_mesh``:
    run on that world's rank 0 instead of starting one).
    ``kv_events_port_base``: rank r publishes its KV events on ``base + r``
    (0: free ports; None: none, as the reference's group)."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        engine_cfg: EngineConfig,
        ranks: Optional[int] = None,
        model_name: str = "llmd-tpu/model",
        host: str = "127.0.0.1",
        port_base: int = 0,
        tokenizer=None,
        params=None,
        device=None,
        seed: int = 0,
        kv_events_port_base: Optional[int] = None,
        rank_mesh=None,
    ) -> None:
        # the reference takes the rank count from mesh.dp; a one-device mesh
        # takes it from dp_ranks (frontends over one card)
        mesh = engine_cfg.mesh
        self.ranks = (ranks if ranks is not None
                      else max(1, mesh.dp) if mesh.num_devices > 1
                      else max(1, engine_cfg.dp_ranks))
        if engine_cfg.dp_ranks == 1 and self.ranks > 1:
            engine_cfg = dataclasses.replace(engine_cfg, dp_ranks=self.ranks)
        if engine_cfg.dp_ranks != self.ranks:
            raise ValueError(f"dp_ranks={engine_cfg.dp_ranks} != ranks={self.ranks}")
        if self.ranks > MAX_TARGET_PORTS:
            raise ValueError(f"{self.ranks} rank ports exceed InferencePool's "
                             f"{MAX_TARGET_PORTS}-port limit")
        self.engine = LLMEngine(model_cfg, engine_cfg, params=params, device=device,
                                seed=seed, tokenizer=tokenizer, rank_mesh=rank_mesh)
        self.async_engine = AsyncLLMEngine(self.engine)
        kve = kv_events_port_base
        self.servers: list[EngineServer] = [
            EngineServer(model_cfg, engine_cfg, model_name=model_name, host=host,
                         port=port_base + r if port_base else 0, tokenizer=tokenizer,
                         engine=self.engine, async_engine=self.async_engine, rank=r,
                         kv_events_port=None if kve is None else (kve + r if kve else 0))
            for r in range(self.ranks)]

    def start(self) -> None:
        for srv in self.servers:
            srv.start()

    def stop(self) -> None:
        """Stop the shared loop, then every frontend, then close the engine
        (its device memory back now)."""
        self.async_engine.stop()
        for srv in self.servers:
            srv.stop()
        self.engine.close()

    def endpoints(self) -> list[str]:
        """One router-visible address per DP rank."""
        return [s.address for s in self.servers]


class DPEngineGroup:
    """``dp_size_local`` rank servers, each with its own engine and wave-synced
    loop, plus the coordinator (on the leader) and, in hybrid-LB mode, the
    node balancer. ``device``, ``seed``: every rank engine's."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        engine_cfg: EngineConfig,
        dp_cfg: DPGroupConfig,
        model_name: str = "llmd-tpu/model",
        host: str = "127.0.0.1",
        tokenizer=None,
        params=None,
        device=None,
        seed: int = 0,
    ) -> None:
        self.dp_cfg = dp_cfg
        self.coordinator = (DPCoordinator(dp_cfg.dp_size, port=dp_cfg.dp_rpc_port)
                            if dp_cfg.is_leader else None)
        self.servers: list[EngineServer] = []
        self.balancer: Optional[DPLocalBalancer] = None
        self._model_cfg, self._engine_cfg = model_cfg, engine_cfg
        self._model_name, self._host = model_name, host
        self._tokenizer, self._params = tokenizer, params
        self._device, self._seed = device, seed

    def start(self) -> None:
        if self.coordinator is not None:
            self.coordinator.start()
        rpc_host, rpc_port = self.dp_cfg.dp_address, (
            self.coordinator.port if self.coordinator is not None
            else self.dp_cfg.dp_rpc_port)
        for i in range(self.dp_cfg.dp_size_local):
            rank = self.dp_cfg.dp_start_rank + i
            port = self.dp_cfg.port_base + i if self.dp_cfg.port_base else 0
            srv = EngineServer(
                self._model_cfg, self._engine_cfg, model_name=self._model_name,
                host=self._host, port=port, tokenizer=self._tokenizer,
                params=self._params, device=self._device, seed=self._seed)
            # the wave-synced loop in place of the server's before it starts
            srv.async_engine = DPAsyncEngine(srv.engine, DPWorkerSync(rank, rpc_host, rpc_port))
            self.servers.append(srv)
            srv.start()
        if self.dp_cfg.hybrid_lb:
            self.balancer = DPLocalBalancer([s.address for s in self.servers],
                                            host=self._host, port=self.dp_cfg.lb_port)
            self.balancer.start()

    def stop(self) -> None:
        for srv in self.servers:
            srv.stop()
        if self.balancer is not None:
            self.balancer.stop()
        if self.coordinator is not None:
            self.coordinator.stop()

    def endpoints(self) -> list[str]:
        """The addresses the router lists: one per rank port, or the node
        balancer in hybrid-LB mode."""
        if self.dp_cfg.hybrid_lb:
            assert self.balancer is not None, "group not started"
            return [self.balancer.address]
        return [s.address for s in self.servers]
