"""KV-event subscription manager: the ZMQ SUB side of the KV plane (copy of
``llmd_tpu/kv/subscriber.py``; batches decode with the port's hand-written
``core/kv_events.decode_event_batch``, and pyzmq is imported when the manager
starts, not with the module). Two delivery modes:

- **pod-discovery** (default, active-active HA): each engine pod binds a PUB socket;
  every router replica subscribes to every pod it discovers in the endpoint pool, so
  replicas converge independently (no leader needed).
- **centralized**: the router binds one SUB socket and engines connect their PUBs to it
  (EPP binds :5557 in the reference).

Topic format ``kv@<pod_addr>@<model>``;
``topic_filter`` subscribes a prefix. Sequence-number gaps are counted (events are
fire-and-forget PUB/SUB; a gap means missed events and only costs routing precision).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from llmd_tpu_torch.core.endpoint import Endpoint, EndpointPool
from llmd_tpu_torch.core.kv_events import decode_event_batch
from llmd_tpu_torch.kv.indexer import KVBlockIndex

log = logging.getLogger(__name__)

LABEL_KV_EVENTS_ADDR = "kv_events_address"  # full "host:port" override label
LABEL_KV_EVENTS_PORT = "kv_events_port"  # port-only label (host = endpoint host)


class KVEventSubscriberManager:
    """Maintains one SUB socket per discovered pod, feeding the shared index."""

    def __init__(
        self,
        index: KVBlockIndex,
        pool: Optional[EndpointPool] = None,
        topic_filter: str = "kv@",
        default_events_port: Optional[int] = None,
        bind_port: Optional[int] = None,  # centralized mode: bind instead of connect
    ) -> None:
        self.index = index
        self.pool = pool
        self.topic_filter = topic_filter
        self.default_events_port = default_events_port
        self.bind_port = bind_port
        self._zctx = None  # zmq.asyncio.Context once started
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._tasks: dict[str, asyncio.Task] = {}
        self._central_task: Optional[asyncio.Task] = None
        self._last_seq: dict[str, int] = {}
        self._stopping = False
        self.seq_gaps = 0
        self.batches_received = 0

    # ---------------------------------------------------------------- lifecycle
    async def start(self) -> None:
        import zmq.asyncio

        self._zctx = zmq.asyncio.Context()
        self._loop = asyncio.get_running_loop()
        if self.bind_port is not None:
            self._central_task = self._loop.create_task(self._run_central())
            return
        if self.pool is not None:
            self.pool.subscribe(self._on_pool_event)
            for ep in self.pool.list():
                self._maybe_subscribe(ep)

    async def stop(self) -> None:
        self._stopping = True
        if self.pool is not None:
            self.pool.unsubscribe(self._on_pool_event)
        for t in list(self._tasks.values()) + ([self._central_task] if self._central_task else []):
            t.cancel()
        for t in list(self._tasks.values()) + ([self._central_task] if self._central_task else []):
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        self._tasks.clear()
        self._loop = None
        if self._zctx is not None:
            self._zctx.term()
            self._zctx = None

    # ---------------------------------------------------------------- discovery
    def _events_address(self, ep: Endpoint) -> Optional[str]:
        addr = ep.labels.get(LABEL_KV_EVENTS_ADDR)
        if addr:
            return addr
        port = ep.labels.get(LABEL_KV_EVENTS_PORT) or self.default_events_port
        if port:
            return f"{ep.host}:{port}"
        return None

    def _on_pool_event(self, event: str, ep: Endpoint) -> None:
        if event == "added":
            self._maybe_subscribe(ep)
        elif event == "removed":
            task = self._tasks.pop(ep.address, None)
            if task:
                task.cancel()
            self.index.remove_pod(ep.address)

    def _maybe_subscribe(self, ep: Endpoint) -> None:
        if ep.address in self._tasks or self._loop is None:
            return
        zaddr = self._events_address(ep)
        if zaddr is None:
            return
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if running is self._loop:
            self._tasks[ep.address] = self._loop.create_task(self._run_pod(ep.address, zaddr))
        else:
            # pool callbacks may fire from a discovery thread (k8s watch); hop onto
            # the subscriber's loop — create_task is not thread-safe.
            loop = self._loop

            def _spawn(address: str = ep.address, z: str = zaddr) -> None:
                # guard against stop() racing the hop: _stopping flips before
                # tasks are cancelled, so nothing spawns after that point
                if address not in self._tasks and not self._stopping and self._zctx is not None:
                    self._tasks[address] = loop.create_task(self._run_pod(address, z))

            loop.call_soon_threadsafe(_spawn)

    def subscribe_pod(self, pod_address: str, zmq_address: str) -> None:
        """Explicit subscription (tests / static wiring)."""
        if pod_address in self._tasks:
            return
        self._tasks[pod_address] = asyncio.get_running_loop().create_task(
            self._run_pod(pod_address, zmq_address)
        )

    # ---------------------------------------------------------------- receive
    def _handle(self, topic: bytes, payload: bytes) -> None:
        # topic kv@<pod_addr>@<model> — the pod address inside the topic is
        # authoritative (centralized mode has no per-socket pod identity).
        parts = topic.decode(errors="replace").split("@")
        pod = parts[1] if len(parts) >= 2 else "?"
        seq, events = decode_event_batch(payload)
        last = self._last_seq.get(pod)
        if last is not None and seq > last + 1:
            self.seq_gaps += seq - last - 1
        self._last_seq[pod] = seq
        self.index.apply_batch(pod, events)
        self.batches_received += 1

    async def _run_pod(self, pod_address: str, zmq_address: str) -> None:
        import zmq

        sock = None
        try:
            sock = self._zctx.socket(zmq.SUB)
            sock.setsockopt(zmq.SUBSCRIBE, self.topic_filter.encode())
            sock.connect(f"tcp://{zmq_address}")
            while True:
                topic, payload = await sock.recv_multipart()
                try:
                    self._handle(topic, payload)
                except Exception:
                    log.exception("bad KV event batch from %s", pod_address)
        except asyncio.CancelledError:
            raise
        except Exception:
            log.exception("KV subscription to %s (%s) failed", pod_address, zmq_address)
        finally:
            if sock is not None:
                sock.close(0)

    async def _run_central(self) -> None:
        import zmq

        sock = None
        try:
            sock = self._zctx.socket(zmq.SUB)
            sock.setsockopt(zmq.SUBSCRIBE, self.topic_filter.encode())
            if self.bind_port == 0:
                self.bind_port = sock.bind_to_random_port("tcp://0.0.0.0")
            else:
                sock.bind(f"tcp://0.0.0.0:{self.bind_port}")
            while True:
                topic, payload = await sock.recv_multipart()
                try:
                    self._handle(topic, payload)
                except Exception:
                    log.exception("bad KV event batch (centralized)")
        except asyncio.CancelledError:
            raise
        except Exception:
            log.exception("centralized KV subscription on :%s failed", self.bind_port)
        finally:
            if sock is not None:
                sock.close(0)
