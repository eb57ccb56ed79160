"""EPP high availability: leader election (active-passive) + active-active
(port of ``llmd_tpu/router/ha.py``; the k8s lease speaks HTTP through
``router/http.HTTPClient``, where the reference uses aiohttp).

Reference semantics
(docs/architecture/core/router/epp/configuration.md:455-459;
docs/architecture/advanced/kv-management/kv-indexer.md:77-101):

- **Active-passive** — EPP replicas > 1 run leader election; only the leader
  answers picks, standbys take over when the leader's lease lapses. The k8s
  deployment uses a coordination.k8s.io Lease (``K8sLease`` here, plain HTTP
  API with resourceVersion optimistic concurrency); co-located processes (the
  no-Kubernetes mode) use an flock-held ``FileLease`` — the OS drops the lock
  on crash, so failover needs no timeout heuristics.
- **Active-active** — for precise prefix routing, leader election is DISABLED
  and every replica subscribes to all pods' KV event streams (pod-discovery
  mode); each replica's index converges on the same state, so any replica
  produces the same pick. There is no code to add for this beyond what
  pod-discovery already does.

``attach_ha`` wires an elector into a RouterServer: standby replicas answer
generate requests 503 "standby replica" (the gateway's health checks and
retries move traffic to the leader; /health reports the role) while /metrics
keeps serving. The deployment CLI enables it with ``--ha-lease-file PATH``
(co-located processes) or ``--ha-k8s-lease NAME`` (in-cluster).
"""

from __future__ import annotations

import asyncio
import calendar
import os
import time
import uuid
from typing import Callable, Optional

from llmd_tpu_torch.router.http import HTTPClient, HTTPProtocolError, json_response

# the in-cluster service account (token, CA) of a pod
SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"
# what aiohttp's ClientError covers in the reference: the connection, the
# protocol, a status raised for, a body that is not JSON
_CLIENT_ERRORS = (OSError, HTTPProtocolError, ValueError)


def _in_cluster_base() -> str:
    """The API server's base URL inside a pod (the reference's
    ``K8sWatchSource._in_cluster_base``)."""
    # the in-cluster API server is always TLS regardless of port
    host = os.environ.get("KUBERNETES_SERVICE_HOST", "kubernetes.default.svc")
    port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
    return f"https://{host}:{port}"


def _in_cluster_token() -> Optional[str]:
    """The pod's service-account token, or None outside a cluster (the
    reference's ``K8sWatchSource._in_cluster_token``)."""
    try:
        with open(os.path.join(SA_DIR, "token")) as f:
            return f.read().strip()
    except OSError:
        return None


class FileLease:
    """flock-based lease for co-located replicas: the OS releases the lock the
    instant the holder dies — crash failover without staleness heuristics."""

    def __init__(self, path: str, identity: Optional[str] = None) -> None:
        self.path = path
        self.identity = identity or f"{os.getpid()}-{uuid.uuid4().hex[:6]}"
        self._fd: Optional[int] = None

    def try_acquire(self) -> bool:
        import fcntl

        if self._fd is not None:
            return True
        fd = os.open(self.path, os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            os.close(fd)
            return False
        os.ftruncate(fd, 0)
        os.pwrite(fd, self.identity.encode(), 0)
        self._fd = fd
        return True

    def renew(self) -> bool:
        return self._fd is not None  # flock holds until released/crash

    def release(self) -> None:
        if self._fd is not None:
            os.close(self._fd)  # closes → flock released
            self._fd = None

    def holder(self) -> Optional[str]:
        try:
            with open(self.path) as f:
                return f.read().strip() or None
        except OSError:
            return None


class K8sLease:
    """coordination.k8s.io/v1 Lease over the plain k8s API.

    Acquire: create (201) or take over when ``renewTime`` is older than the
    lease duration, via PUT preconditioned on resourceVersion — a 409 means a
    peer won the race. Renew: PUT our own record with a fresh renewTime.
    """

    def __init__(self, name: str, namespace: str = "default",
                 identity: Optional[str] = None, lease_seconds: float = 5.0,
                 api_base: Optional[str] = None, token: Optional[str] = None) -> None:
        self.name = name
        self.namespace = namespace
        self.identity = identity or f"{os.getpid()}-{uuid.uuid4().hex[:6]}"
        self.lease_seconds = lease_seconds
        self.api_base = api_base or _in_cluster_base()
        self.token = token if token is not None else _in_cluster_token()
        self._client: Optional[HTTPClient] = None
        self._held = False

    @property
    def _url(self) -> str:
        return (f"{self.api_base}/apis/coordination.k8s.io/v1/namespaces/"
                f"{self.namespace}/leases/{self.name}")

    def _headers(self) -> dict[str, str]:
        h = {"Content-Type": "application/json"}
        if self.token:
            h["Authorization"] = f"Bearer {self.token}"
        return h

    def _body(self, rv: Optional[str] = None) -> dict:
        meta: dict = {"name": self.name, "namespace": self.namespace}
        if rv:
            meta["resourceVersion"] = rv
        from datetime import datetime, timezone

        return {
            "apiVersion": "coordination.k8s.io/v1", "kind": "Lease",
            "metadata": meta,
            "spec": {
                "holderIdentity": self.identity,
                "leaseDurationSeconds": max(1, int(self.lease_seconds)),
                # k8s MicroTime (RFC3339 with microseconds) — whole-second
                # stamps would alias a fresh lease as up-to-1s stale
                "renewTime": datetime.now(timezone.utc).strftime(
                    "%Y-%m-%dT%H:%M:%S.%fZ"),
            },
        }

    def _http(self) -> HTTPClient:
        if self._client is None:
            self._client = HTTPClient()
        return self._client

    async def _call(self, method: str, url: str, body: Optional[dict] = None):
        """(status, JSON body or None) of one API call; its connection goes
        back to the pool."""
        r = await self._http().request(method, url, headers=self._headers(),
                                       json_body=body)
        try:
            if r.status == 404 or not 200 <= r.status < 300:
                await r.read()
                return r.status, None
            return r.status, await r.json()
        finally:
            r.close()

    async def try_acquire(self) -> bool:
        try:
            status, lease = await self._call("GET", self._url)
            if status == 404:
                base = self._url.rsplit("/", 1)[0]
                created, _ = await self._call("POST", base, self._body())
                self._held = created in (200, 201)
                return self._held
            if status >= 400:
                raise ValueError(f"lease GET answered {status}")  # raise_for_status
            spec = lease.get("spec", {})
            holder = spec.get("holderIdentity")
            renew = spec.get("renewTime", "1970-01-01T00:00:00.000000Z")
            try:
                # tolerate both MicroTime and second-precision RFC3339 ('...Z')
                whole = renew.split(".")[0].rstrip("Z")
                frac = (float("0." + renew.split(".")[1].rstrip("Z"))
                        if "." in renew else 0.0)
                age = time.time() - calendar.timegm(
                    time.strptime(whole, "%Y-%m-%dT%H:%M:%S")) - frac
            except (ValueError, IndexError):
                age = float("inf")  # unparseable renewTime = stale, takeover OK
            if holder not in (None, "", self.identity) and age < self.lease_seconds:
                self._held = False
                return False
            rv = lease.get("metadata", {}).get("resourceVersion")
            updated, _ = await self._call("PUT", self._url, self._body(rv))
            self._held = updated == 200  # 409: a peer won the race
            return self._held
        except _CLIENT_ERRORS:
            self._held = False
            return False

    async def renew(self) -> bool:
        return await self.try_acquire()

    async def release(self) -> None:
        if self._held:
            try:
                status, lease = await self._call("GET", self._url)
                if status == 200:
                    if lease.get("spec", {}).get("holderIdentity") == self.identity:
                        lease["spec"]["holderIdentity"] = ""
                        await self._call("PUT", self._url, lease)
            except _CLIENT_ERRORS:
                pass
        self._held = False
        if self._client is not None:
            await self._client.close()
            self._client = None


class LeaderElector:
    """Drives a lease on an interval; flips ``is_leader`` and notifies."""

    def __init__(self, lease, interval_s: float = 0.5,
                 on_change: Optional[Callable[[bool], None]] = None) -> None:
        self.lease = lease
        self.interval = interval_s
        self.on_change = on_change
        self.is_leader = False
        self.transitions = 0
        self._task: Optional[asyncio.Task] = None

    async def _tick(self) -> None:
        fn = self.lease.renew if self.is_leader else self.lease.try_acquire
        got = fn()
        if asyncio.iscoroutine(got):
            got = await got
        if got != self.is_leader:
            self.is_leader = got
            self.transitions += 1
            if self.on_change:
                self.on_change(got)

    async def start(self) -> None:
        await self._tick()
        self._task = asyncio.get_running_loop().create_task(self._loop())

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.interval)
            try:
                await self._tick()
            except Exception:
                if self.is_leader:
                    self.is_leader = False
                    self.transitions += 1
                    if self.on_change:
                        self.on_change(False)

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
        rel = self.lease.release()
        if asyncio.iscoroutine(rel):
            await rel
        if self.is_leader:
            self.is_leader = False
            self.transitions += 1
            if self.on_change:
                self.on_change(False)


def attach_ha(router, elector: LeaderElector) -> None:
    """Gate the router's generate path on leadership (active-passive mode).

    Standby replicas answer 503 "standby replica" (gateway health checks and
    retries move traffic to the leader); /metrics, /health, /v1/models keep
    serving so the replica stays observable — /health reports the role.
    The ext-proc front shares the same gate through admit_and_schedule.
    Call BEFORE ``router.start()`` — route registration binds the handlers at
    start time.
    """
    router.elector = elector
    orig = router.admit_and_schedule

    async def gated(req, span=None):
        if not elector.is_leader:
            from llmd_tpu_torch.router.server import Rejection

            # deliberate: a FailOpen gateway must not bypass the leader gate
            return None, Rejection(503, "standby replica (leader election)",
                                   deliberate=True)
        return await orig(req, span=span)

    router.admit_and_schedule = gated

    async def health(request):
        return json_response({
            "status": "ok", "endpoints": len(router.pool),
            "role": "leader" if elector.is_leader else "standby",
        })

    router._health = health
    router.extra_metrics.append(lambda: [
        f"llm_d_epp_leader {1 if elector.is_leader else 0}",
        f"llm_d_epp_leader_transitions_total {elector.transitions}",
    ])
