"""Endpoint discovery sources feeding the ``EndpointPool`` (copy of
``llmd_tpu/router/discovery.py``; the Kubernetes watch speaks HTTP through
``router/http.HTTPClient``, where the reference uses aiohttp).

``FileSource`` is the ``file-discovery`` plugin of the no-Kubernetes mode: it
loads an endpoints file (JSON, or lines ``addr[,role[,key=value...]]``) and
re-scans it when its mtime changes, so edits apply without a restart.
``K8sWatchSource`` is the ``k8s-notification-source``: a pod watch keyed by
the InferencePool's selector over the plain Kubernetes API (list + watch with
resourceVersion resume, bookmark tolerance, backoff re-list); in a cluster it
reads the service account's token and trusts its CA. Both feed one
``EndpointPool``, so the scheduler never knows which discovery mode runs.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import ssl
from typing import Optional

from llmd_tpu_torch.core.endpoint import Endpoint, EndpointPool, EndpointRole
from llmd_tpu_torch.router import ha
from llmd_tpu_torch.router.datalayer import load_endpoints_file
from llmd_tpu_torch.router.http import HTTPClient, HTTPProtocolError

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


def _pod_to_endpoint(pod: dict, port: int) -> Optional[Endpoint]:
    """Running+ready pod -> Endpoint; None when it should not be routed."""
    status = pod.get("status", {})
    if status.get("phase") != "Running" or not status.get("podIP"):
        return None
    conds = {c.get("type"): c.get("status") for c in status.get("conditions", [])}
    if conds.get("Ready") != "True":
        return None
    labels = pod.get("metadata", {}).get("labels", {})
    role = labels.get("llm-d.ai/role", "both")
    try:
        role_e = EndpointRole(role)
    except ValueError:
        role_e = EndpointRole.BOTH
    return Endpoint(
        address=f"{status['podIP']}:{port}",
        name=pod.get("metadata", {}).get("name", ""),
        role=role_e,
        labels=labels,
        engine_type=labels.get("llm-d.ai/engine-type", "llmd-tpu"),
    )


# a watch event is one JSON line per pod object; a real pod's line (its
# managedFields) runs to tens of kB, the reference reads lines up to this
MAX_EVENT_LINE = 4 * 1024 * 1024
# no byte on an open watch for this long: the connection is dead, re-list
WATCH_READ_TIMEOUT_S = 330.0


class K8sWatchSource(EndpointSource):
    """Kubernetes pod watch keyed by the InferencePool's selector.

    list -> seed pool (+resourceVersion) -> watch stream (ADDED/MODIFIED map to
    upsert-or-remove on readiness, DELETED removes); an ERROR event (410 Gone)
    or the stream's end -> re-list after the backoff. Multi-port pools (DP rank
    engines, targetPorts <= 8) surface one endpoint per podIP:port.
    """

    _in_cluster_base = staticmethod(ha._in_cluster_base)
    _in_cluster_token = staticmethod(ha._in_cluster_token)

    def __init__(
        self,
        pool: EndpointPool,
        selector: dict[str, str],
        ports: list[int],
        namespace: str = "default",
        api_base: Optional[str] = None,
        token: Optional[str] = None,
        rebackoff_s: float = 1.0,
    ) -> None:
        super().__init__(pool)
        self.selector = selector
        self.ports = ports[:8]  # targetPorts limit (inferencepool.md)
        self.namespace = namespace
        self.api_base = api_base or self._in_cluster_base()
        self.token = token if token is not None else self._in_cluster_token()
        self.backoff = rebackoff_s
        self._task: Optional[asyncio.Task] = None
        self._addresses: dict[str, set[str]] = {}  # pod uid -> addresses
        self.relists = 0
        self.events_seen = 0
        self.last_error: Optional[Exception] = None

    @property
    def _label_selector(self) -> str:
        return ",".join(f"{k}={v}" for k, v in sorted(self.selector.items()))

    def _headers(self) -> dict[str, str]:
        return {"Authorization": f"Bearer {self.token}"} if self.token else {}

    def _apply(self, pod: dict, deleted: bool) -> None:
        uid = pod.get("metadata", {}).get("uid") or pod.get("metadata", {}).get("name", "")
        old = self._addresses.pop(uid, set())
        new: set[str] = set()
        if not deleted:
            for port in self.ports:
                ep = _pod_to_endpoint(pod, port)
                if ep is not None:
                    self.pool.upsert(ep)
                    new.add(ep.address)
        for addr in old - new:
            self.pool.remove(addr)
        if new:
            self._addresses[uid] = new

    def _url(self, query: str) -> str:
        return (f"{self.api_base}/api/v1/namespaces/{self.namespace}/pods"
                f"?labelSelector={self._label_selector}{query}")

    async def _list(self, client: HTTPClient) -> str:
        resp = await client.request("GET", self._url(""), headers=self._headers())
        if resp.status >= 400:
            resp.close()
            raise HTTPProtocolError(f"pod list answered {resp.status}")
        data = await resp.json()
        self.relists += 1
        seen_uids = set()
        for pod in data.get("items", []):
            self._apply(pod, deleted=False)
            meta = pod.get("metadata", {})
            # same key fallback as _apply, or uid-less pods would be swept
            seen_uids.add(meta.get("uid") or meta.get("name", ""))
        for uid in list(self._addresses):
            if uid not in seen_uids:
                self._apply({"metadata": {"uid": uid}}, deleted=True)
        return data.get("metadata", {}).get("resourceVersion", "")

    async def _watch(self, client: HTTPClient, rv: str) -> None:
        resp = await client.request(
            "GET", self._url(f"&watch=1&resourceVersion={rv}&allowWatchBookmarks=true"),
            headers=self._headers(), timeout=None)
        try:
            if resp.status >= 400:
                raise HTTPProtocolError(f"pod watch answered {resp.status}")
            chunks = resp.iter_chunks().__aiter__()
            buf = b""
            while True:
                try:
                    chunk = await asyncio.wait_for(chunks.__anext__(), WATCH_READ_TIMEOUT_S)
                except StopAsyncIteration:
                    return  # the stream ended: the caller re-lists
                buf += chunk
                *lines, buf = buf.split(b"\n")
                if len(buf) > MAX_EVENT_LINE:
                    raise ValueError(f"a watch event line over {MAX_EVENT_LINE} bytes")
                for line in lines:
                    line = line.strip()
                    if not line:
                        continue
                    ev = json.loads(line)
                    self.events_seen += 1
                    etype = ev.get("type")
                    if etype == "BOOKMARK":
                        continue
                    if etype == "ERROR":  # e.g. 410 Gone — caller re-lists
                        return
                    self._apply(ev.get("object", {}), deleted=etype == "DELETED")
        finally:
            resp.close()

    async def _loop(self) -> None:
        ctx = None
        ca = os.path.join(ha.SA_DIR, "ca.crt")
        if self.api_base.startswith("https") and os.path.isfile(ca):
            ctx = ssl.create_default_context(cafile=ca)
        client = HTTPClient(ssl_context=ctx)
        try:
            while True:
                try:
                    rv = await self._list(client)
                    self.last_error = None
                    await self._watch(client, rv)
                except asyncio.CancelledError:
                    raise
                except Exception as e:  # API hiccup -> backoff + full re-list
                    if str(e) != str(self.last_error or ""):
                        log.warning("k8s pod watch (%s ns=%s): %s — re-listing "
                                    "every %.1fs", self._label_selector,
                                    self.namespace, e, self.backoff)
                    self.last_error = e
                await asyncio.sleep(self.backoff)
        finally:
            await client.close()

    async def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._loop())

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
