"""Endpoint discovery sources feeding the ``EndpointPool`` (copy of the file
source of ``llmd_tpu/router/discovery.py``).

``FileSource`` is the ``file-discovery`` plugin of the no-Kubernetes mode: it
loads an endpoints file (JSON, or lines ``addr[,role[,key=value...]]``) and
re-scans it when its mtime changes, so edits apply without a restart. The
Kubernetes watch source waits for ROADMAP Queue A item 14.
"""

from __future__ import annotations

import asyncio
import logging
import os
from typing import Optional

from llmd_tpu_torch.core.endpoint import EndpointPool
from llmd_tpu_torch.router.datalayer import load_endpoints_file

log = logging.getLogger("llmd_tpu_torch.discovery")


class EndpointSource:
    """Discovery source interface: populate/maintain an EndpointPool."""

    def __init__(self, pool: EndpointPool) -> None:
        self.pool = pool

    async def start(self) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    async def stop(self) -> None:  # pragma: no cover - interface
        raise NotImplementedError


class FileSource(EndpointSource):
    """file-discovery with live re-scan: edits to the endpoints file (add /
    remove lines) apply without a restart (mtime-polled)."""

    def __init__(self, pool: EndpointPool, path: str,
                 rescan_interval_s: float = 2.0) -> None:
        super().__init__(pool)
        self.path = path
        self.interval = rescan_interval_s
        self._task: Optional[asyncio.Task] = None
        self._mtime = 0.0
        self._known: set[str] = set()
        self.last_error: Optional[Exception] = None

    def _scan(self) -> None:
        staging = EndpointPool()
        load_endpoints_file(staging, self.path)
        now = {e.address for e in staging.list()}
        for e in staging.list():
            self.pool.upsert(e)
        for gone in self._known - now:
            self.pool.remove(gone)
        self._known = now

    async def start(self) -> None:
        self._scan()
        self._mtime = os.path.getmtime(self.path)
        self._task = asyncio.get_running_loop().create_task(self._loop())

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.interval)
            try:
                m = os.path.getmtime(self.path)
                if m != self._mtime:
                    self._mtime = m
                    self._scan()
                    self.last_error = None
            except OSError:
                pass  # file briefly absent mid-rewrite
            except Exception as e:  # malformed content must not kill live reload
                if str(e) != str(self.last_error or ""):
                    log.warning("endpoints file %s re-scan failed: %s", self.path, e)
                self.last_error = e

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
