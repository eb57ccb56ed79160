"""Data layer: the Source -> Extract -> Attribute runtime feeding
``Endpoint.attrs`` (copy of ``llmd_tpu/router/datalayer.py``).

``MetricsPoller`` scrapes each endpoint's ``/metrics`` over the router's
standard-library HTTP client (``router/http.py``) and hands the samples to its
extractors (``CoreMetricsExtractor`` maps engine names onto the standard keys);
``load_endpoints_file`` and ``add_static_endpoints`` are the static sources of
the no-Kubernetes mode.
"""

from __future__ import annotations

import asyncio
import json
from typing import Optional

from llmd_tpu_torch.core.endpoint import Endpoint, EndpointPool, EndpointRole
from llmd_tpu_torch.core.metrics_contract import map_engine_metrics, parse_prometheus
from llmd_tpu_torch.router.http import HTTPClient


class Extractor:
    """Polling-source extractor (datalayer.md 'Extractor' interface): transform
    one endpoint's raw source payload into attributes on that endpoint."""

    name = "extractor"

    def extract(self, ep: Endpoint, raw) -> None:  # pragma: no cover - interface
        raise NotImplementedError


class CoreMetricsExtractor(Extractor):
    """core-metrics-extractor: engine-specific metric names → the standard
    attribute keys scorers consume (kv_usage, waiting, running, ...), with
    per-engine mapping so multiple inference engines coexist in one pool."""

    name = "core-metrics-extractor"

    def extract(self, ep: Endpoint, raw: list) -> None:
        for k, v in map_engine_metrics(ep.engine_type, raw).items():
            ep.attrs.put(k, v)


class EndpointExtractor:
    """Endpoint-lifecycle extractor (datalayer.md endpoint-notification-source
    consumer): set up / tear down per-endpoint state as the pool changes."""

    name = "endpoint-extractor"

    def on_endpoint_added(self, ep: Endpoint) -> None:  # pragma: no cover
        pass

    def on_endpoint_removed(self, ep: Endpoint) -> None:  # pragma: no cover
        pass


class DataLayerRuntime:
    """Source→extractor mapping + endpoint-event dispatch (datalayer.md
    'Runtime'). Polling sources register their extractor chains here; endpoint
    extractors bind to the pool's add/remove events."""

    def __init__(self, pool: EndpointPool) -> None:
        self.pool = pool
        self.endpoint_extractors: list[EndpointExtractor] = []
        self.error_counts: dict[str, int] = {}  # "<extractor>:<event>" → count
        pool.subscribe(self._on_pool_event)

    def register_endpoint_extractor(self, ext: EndpointExtractor) -> None:
        self.endpoint_extractors.append(ext)
        for ep in self.pool.list():  # late registration sees existing members
            self._dispatch(ext, "added", ep)

    def _dispatch(self, ext: EndpointExtractor, kind: str, ep: Endpoint) -> None:
        try:
            if kind == "added":
                ext.on_endpoint_added(ep)
            elif kind == "removed":
                ext.on_endpoint_removed(ep)
        except Exception:
            # one extractor's failure never starves the others, but it stays
            # VISIBLE — a silently-broken lifecycle extractor is undebuggable
            key = f"{ext.name}:{kind}"
            self.error_counts[key] = self.error_counts.get(key, 0) + 1

    def _on_pool_event(self, kind: str, ep: Endpoint) -> None:
        for ext in self.endpoint_extractors:
            self._dispatch(ext, kind, ep)


class MetricsPoller:
    """metrics-data-source + its extractor chain (HOT POLL).

    Polls every pool endpoint's Prometheus endpoint on an interval and hands
    the parsed samples to the registered extractors (CoreMetricsExtractor by
    default; register more via ``extractors`` for derived attributes)."""

    def __init__(self, pool: EndpointPool, interval_s: float = 0.5,
                 timeout_s: float = 2.0, metrics_path: str = "/metrics",
                 extractors: Optional[list[Extractor]] = None) -> None:
        self.pool = pool
        self.interval = interval_s
        self.timeout = timeout_s
        self.metrics_path = metrics_path
        self.extractors: list[Extractor] = (
            list(extractors) if extractors is not None else [CoreMetricsExtractor()])
        self._task: Optional[asyncio.Task] = None
        self.poll_count = 0
        self.error_counts: dict[str, int] = {}
        # scrape transport failures only (llm_d_epp_scrape_errors_total feeds
        # off this; extractor bugs stay in error_counts and don't inflate it)
        self.scrape_error_count = 0
        # resilience hook: called with the endpoint address on each scrape
        # failure — the breaker's passive-health signal (router attaches it)
        self.on_scrape_error = None

    def forget(self, address: str) -> None:
        """Drop an endpoint's error-count keys when it leaves discovery —
        scale-cycle churn must not grow the map without bound. Cascades to
        extractors holding per-endpoint state (fleet rollup) for the same
        reason."""
        self.error_counts.pop(address, None)
        for key in [k for k in self.error_counts
                    if k.startswith(address + ":")]:
            del self.error_counts[key]
        for ext in self.extractors:
            fn = getattr(ext, "forget", None)
            if fn is not None:
                try:
                    fn(address)
                except Exception:
                    key = f"{address}:{ext.name}"
                    self.error_counts[key] = self.error_counts.get(key, 0) + 1

    async def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._loop())

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass

    async def poll_once(self, client: HTTPClient) -> None:
        async def one(ep: Endpoint) -> None:
            try:
                resp = await client.request(
                    "GET", f"http://{ep.address}{self.metrics_path}", timeout=self.timeout)
                try:
                    text = await resp.text()
                finally:
                    resp.close()
                raw = parse_prometheus(text)
                all_ok = True
                for ext in self.extractors:
                    try:
                        ext.extract(ep, raw)
                    except Exception:
                        # a broken extractor never starves the rest, but the
                        # failure stays VISIBLE: error counted, freshness stamp
                        # withheld so staleness-aware consumers can react
                        all_ok = False
                        key = f"{ep.address}:{ext.name}"
                        self.error_counts[key] = self.error_counts.get(key, 0) + 1
                if all_ok:
                    ep.mark_scrape_ok()
            except Exception:
                # Scrape transport failure: the last-known metrics would
                # otherwise look fresh forever — flag the endpoint stale so
                # consumers (breaker passive health, /v1/models aggregation)
                # stop trusting it, and surface the failure as a counter.
                self.error_counts[ep.address] = self.error_counts.get(ep.address, 0) + 1
                self.scrape_error_count += 1
                ep.mark_scrape_failed()
                if self.on_scrape_error is not None:
                    try:
                        self.on_scrape_error(ep.address)
                    except Exception:
                        pass  # the hook must never kill the poll loop

        await asyncio.gather(*(one(e) for e in self.pool.list()))
        self.poll_count += 1

    async def _loop(self) -> None:
        client = HTTPClient()
        try:
            while True:
                await self.poll_once(client)
                await asyncio.sleep(self.interval)
        finally:
            await client.close()


def load_endpoints_file(pool: EndpointPool, path: str) -> None:
    """file-discovery: static endpoint list (JSON or line format 'addr[,role[,k=v...]]')."""
    with open(path) as f:
        text = f.read()
    try:
        entries = json.loads(text)
    except json.JSONDecodeError:
        entries = []
        for line in text.splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split(",")
            entry = {"address": parts[0]}
            if len(parts) > 1:
                entry["role"] = parts[1]
            entry["labels"] = dict(p.split("=", 1) for p in parts[2:] if "=" in p)
            entries.append(entry)
    for e in entries:
        pool.upsert(Endpoint(
            address=e["address"],
            role=EndpointRole(e.get("role", "both")),
            labels=e.get("labels", {}),
            engine_type=e.get("engineType", "vllm"),
        ))


def add_static_endpoints(pool: EndpointPool, addresses: list[str],
                         role: str = "both") -> None:
    for a in addresses:
        pool.upsert(Endpoint(address=a, role=EndpointRole(role)))
