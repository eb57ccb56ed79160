"""KV-event publication over ZMQ PUB (the reference server's KV flush loop,
``llmd_tpu/engine/server.py`` ``_kv_flush_loop``, as a thread).

The engine's page allocator calls :meth:`KVEventPublisher.sink` from the engine
loop; the events are buffered under a lock and flushed every 10 ms, one
multipart message ``[topic, encode_event_batch(events, seq)]`` per non-empty
batch, ``seq`` rising by one per batch. The topic is
``kv@<server address>@<model>``. PUB semantics are the reference's: a batch
sent while no subscriber is connected is dropped.

``pyzmq`` is imported when a publisher starts, never when this module is
imported: an engine served without ``kv_events_port`` needs no ZMQ.
"""

from __future__ import annotations

import threading
from typing import Optional

from llmd_tpu_torch.core.kv_events import KVEvent, encode_event_batch

FLUSH_INTERVAL_S = 0.01  # the reference's flush period


class KVEventPublisher:
    def __init__(self, port: int, host: str = "0.0.0.0") -> None:
        """``port`` 0 binds a random free port (read ``port`` after start)."""
        self.port = port
        self.host = host
        self.seq = 0
        self._topic = b""
        self._lock = threading.Lock()
        self._pending: list[KVEvent] = []  # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._ctx = None
        self._pub = None

    def sink(self, events: list[KVEvent]) -> None:
        """The engine's event sink (engine-loop thread)."""
        with self._lock:
            self._pending.extend(events)

    def start(self, topic: str) -> None:
        """Bind the PUB socket and start flushing under ``topic``. Raises if
        ZMQ is missing or the port cannot be bound: a server asked to publish
        never runs silently without publishing."""
        import zmq

        self._topic = topic.encode()
        self._ctx = zmq.Context()
        try:
            self._pub = self._ctx.socket(zmq.PUB)
            if self.port == 0:
                self.port = self._pub.bind_to_random_port(f"tcp://{self.host}")
            else:
                self._pub.bind(f"tcp://{self.host}:{self.port}")
        except zmq.ZMQError:
            self._close()
            raise
        self._stop.clear()
        # the socket is used only by the flush thread from here on, and closed
        # by stop() after that thread has ended
        self._thread = threading.Thread(target=self._run, name="kv-event-publisher",
                                        daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(FLUSH_INTERVAL_S):
            self._flush()
        self._flush()

    def _flush(self) -> None:
        """Send the buffered events as one batch (a no-op when none)."""
        import zmq

        with self._lock:
            events, self._pending = self._pending, []
        if not events or self._pub is None:
            return
        self.seq += 1
        try:
            self._pub.send_multipart([self._topic, encode_event_batch(events, self.seq)],
                                     flags=zmq.NOBLOCK)
        except zmq.Again:
            pass  # high-water mark reached: dropped, as PUB drops

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        self._close()

    def _close(self) -> None:
        if self._pub is not None:
            self._pub.close(0)
            self._pub = None
        if self._ctx is not None:
            self._ctx.term()
            self._ctx = None
