"""Router server: the standalone-mode proxy and EPP in one process (copy of
``llmd_tpu/router/server.py`` on the standard library).

Parse -> flow-control gate -> schedule -> forward to the chosen endpoint ->
stream the response back, with the ``x-llm-d-*`` headers and the
``llm_d_epp_*`` / ``igw_*`` / ``llmd_tpu:*`` metric families of the reference.
The front is ``router/http.HTTPServer`` (``asyncio.start_server``) and the
proxy ``router/http.HTTPClient`` (a keep-alive pool per endpoint), where the
reference uses aiohttp; a streamed response is written on chunk by chunk as it
arrives.

P/D: when the disagg handler returns a prefill endpoint, the request goes to
the decode endpoint with the ``x-prefiller-host-port`` header; the routing
sidecar in front of the decode engine (``disagg/sidecar.py``) runs the P -> D
flow.

The global KV plane's router side (``kvplane/plane.py``, ``LLMD_KV_PLANE``)
swaps the prefix producers and scorers and stamps cross-engine prefix pulls;
the SLO engine (``obs/slo.py``, ``LLMD_SLO_*``) feeds the attainment and burn
gauges from every request's TTFT and e2e.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import hashlib
import json
import math
import time
import uuid
from dataclasses import dataclass
from typing import Any, Optional

from llmd_tpu_torch.core.config import FrameworkConfig
from llmd_tpu_torch.core.endpoint import EndpointPool, EndpointRole
from llmd_tpu_torch.core.request import (
    HDR_PREFILLER_HOST_PORT,
    HDR_REQUEST_TIMEOUT,
    HDR_TENANT,
    InferenceRequest,
    RequestOutcome,
    SamplingParams,
    clamp_request_id,
    mm_hashes_from_messages,
)
from llmd_tpu_torch.kv.index_backends import build_index
from llmd_tpu_torch.kv.plugins import CTX_KV_INDEX
from llmd_tpu_torch.kvplane import STATE_KV_PLANE, KVPlane
from llmd_tpu_torch.obs.attribution import attach_phase_exporter
from llmd_tpu_torch.obs.decisions import attach_decision_exporter, regret_topk
from llmd_tpu_torch.obs.events import (
    FlightRecorder,
    debug_detail_response,
    debug_list_response,
)
from llmd_tpu_torch.obs.fleet import FleetRollup
from llmd_tpu_torch.obs.metrics import Registry, register_router_metrics
from llmd_tpu_torch.obs.slo import SLOEngine
from llmd_tpu_torch.obs.tracing import extract_traceparent, global_tracer
from llmd_tpu_torch.router.datalayer import MetricsPoller
from llmd_tpu_torch.router.flowcontrol import FlowController
from llmd_tpu_torch.router.http import (
    HTTPClient,
    HTTPServer,
    Request,
    Response,
    StreamResponse,
    json_response,
)
from llmd_tpu_torch.router.resilience import (
    RETRYABLE_STATUSES,
    ResilienceConfig,
    ResilienceManager,
)
from llmd_tpu_torch.router.latency_plugins import predicted_e2e_ms
from llmd_tpu_torch.router.scheduler import Scheduler
from llmd_tpu_torch.router.scorers import STATE_PREDICTED
from llmd_tpu_torch.structured import validate_structured_body

GEN_PATHS = ("/v1/completions", "/v1/chat/completions", "/v1/embeddings",
             "/v1/responses")


@dataclass
class Rejection:
    """A non-dispatch admission outcome (admit_and_schedule error channel)."""

    status: int
    message: str
    # True = an enforced decision (shedding, standby gate) that FailOpen
    # gateways must still honour; False = the EPP couldn't answer.
    deliberate: bool = False


def parse_openai_request(path: str, body: dict, headers: dict[str, str]) -> InferenceRequest:
    """openai-parser: /completions, /chat/completions, /embeddings,
    /responses, /conversations."""
    req = InferenceRequest.from_headers(headers)
    req.model = str(body.get("model", ""))
    if path.endswith("/v1/responses"):
        # Responses API: input is str | [{role, content}] (epp-http-apis.md:153)
        inp = body.get("input", "")
        if isinstance(inp, list):
            req.messages = [
                {"role": it.get("role", "user"), "content": it.get("content", "")}
                for it in inp if isinstance(it, dict)
            ]
            req.mm_hashes = mm_hashes_from_messages(req.messages)
        else:
            req.prompt = str(inp)
    elif "messages" in body:
        req.messages = body["messages"]
        req.mm_hashes = mm_hashes_from_messages(body["messages"])
    elif "input" in body:  # /v1/embeddings: input is str | [str] | [int] | [[int]]
        inp = body["input"]
        req.prompt = inp if isinstance(inp, str) else json.dumps(inp)
    else:
        req.prompt = str(body.get("prompt", ""))
    req.lora_adapter = body.get("lora_adapter")
    # Structured outputs: malformed specs fail here as ValueError -> 400,
    # BEFORE the request ever reaches flow control; valid specs ride through
    # in sampling so scorers can see them.
    validate_structured_body(body)
    req.sampling = SamplingParams(
        max_tokens=int(body.get("max_output_tokens", body.get("max_tokens", 16))),
        temperature=float(body.get("temperature", 1.0)),
        guided_choice=body.get("guided_choice"),
        guided_regex=body.get("guided_regex"),
        response_format=body.get("response_format"),
        logit_bias=body.get("logit_bias"),
    )
    req.streaming = bool(body.get("stream", False))
    req.byte_size = len(json.dumps(body))
    return req


def parse_passthrough_request(path: str, body: dict, headers: dict[str, str]) -> InferenceRequest:
    """passthrough-parser: model-agnostic — content is
    NOT interpreted, so payload-driven plugins (prefix scorers, token producer)
    see an empty prompt and score nothing; routing runs on pool state alone.
    Model/objective still come from headers so objective priorities apply."""
    req = InferenceRequest.from_headers(headers)
    lower = {k.lower(): v for k, v in headers.items()}
    req.model = lower.get("x-model", "")
    try:
        req.byte_size = len(json.dumps(body))
    except (TypeError, ValueError):
        req.byte_size = 0
    return req


PARSERS = {
    "openai-parser": parse_openai_request,
    "passthrough-parser": parse_passthrough_request,
}


class RouterServer:
    def __init__(
        self,
        config: FrameworkConfig,
        pool: EndpointPool,
        host: str = "127.0.0.1",
        port: int = 8080,
        poll_interval_s: float = 0.5,
        objectives: Optional[dict[str, int]] = None,  # objective name -> priority
        model_rewrites: Optional[dict[str, list[tuple[str, float]]]] = None,
        seed: Optional[int] = None,
    ) -> None:
        self.config = config
        self.pool = pool
        self.host, self.port = host, port
        self.ctx: dict[str, Any] = {}
        kv_cfg = (config.raw.get("kvEvents") or {}) if config.raw else {}
        if kv_cfg.get("indexBackend") or kv_cfg.get("indexParams"):
            # seed the index BEFORE plugin construction: the precise-prefix
            # producer setdefaults CTX_KV_INDEX at plugin-build time, so a
            # kvEvents-configured backend created later would be constructed
            # and silently discarded (each replica running a private
            # in-memory index instead of the configured shared one)
            self.ctx[CTX_KV_INDEX] = build_index(
                kv_cfg.get("indexBackend", "in-memory"),
                **(kv_cfg.get("indexParams") or {}))
        # seed: the scheduler's draws (pickers, affinity filter) and the
        # model rewrite's; None draws a fresh one
        self.scheduler = Scheduler(config, pool, self.ctx, seed=seed)
        # Global KV plane (kvplane/plane.py): LLMD_KV_PLANE swaps prefix
        # producers/scorers on the built scheduler and enables cross-engine
        # pull stamping. "off" (the default) is a strict no-op — the config
        # graph behaves bitwise-identically to a plane-less build.
        self.kvplane = KVPlane.from_env(self.ctx, pool)
        self.kvplane.install(self.scheduler)
        self.flow: Optional[FlowController] = (
            FlowController(config.flow_control, pool, self.ctx)
            if config.flow_control.enabled else None
        )
        self.poller = MetricsPoller(pool, interval_s=poll_interval_s)
        # Producers exposing an async pre-schedule step (token-producer render call).
        self._async_producers = [
            p for p in self.scheduler.producers if hasattr(p, "aproduce")
        ]
        # KV-event subscription (precise prefix routing): on when the config declares
        # a precise producer or an explicit kvEvents section (kv-indexer.md:67-87).
        self.kv_subscriber = None
        wants_precise = any(p.type == "precise-prefix-cache-producer" for p in config.plugins)
        if wants_precise or self.kvplane.active or (config.raw and "kvEvents" in config.raw):
            from llmd_tpu_torch.kv.subscriber import KVEventSubscriberManager

            index = self.ctx.setdefault(CTX_KV_INDEX, build_index(
                kv_cfg.get("indexBackend", "in-memory"),
                **(kv_cfg.get("indexParams") or {})))
            self.kv_subscriber = KVEventSubscriberManager(
                index, pool,
                topic_filter=kv_cfg.get("topicFilter", "kv@"),
                default_events_port=kv_cfg.get("port"),
                bind_port=kv_cfg.get("bindPort"),
            )
        self.kvplane.subscriber = self.kv_subscriber  # feed-staleness signal
        self.objectives = objectives or {}
        self.model_rewrites = model_rewrites or {}
        # Request parser (request-handling.md:73-75): openai-parser default;
        # passthrough-parser routes without payload interpretation.
        parser_name = (config.raw.get("parser") if config.raw else None) or "openai-parser"
        if parser_name not in PARSERS:
            raise ValueError(f"unknown parser {parser_name!r}; known: {sorted(PARSERS)}")
        self._parser = PARSERS[parser_name]
        # Scheduling runs off the event loop on ONE worker thread: plugins may block
        # and share per-request mutable state — a single thread keeps them
        # serialized while the proxy loop stays responsive.
        self._sched_executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="epp-sched"
        )
        self._front: Optional[HTTPServer] = None
        self._client: Optional[HTTPClient] = None
        # EPP metric families (llm_d_epp_* / igw_*) live in one shared
        # registry; /metrics renders via Registry.expose() — the same code
        # path the engine server uses. Legacy counter dicts (scheduler.metrics,
        # flow.metrics) surface through scrape-time callbacks, so their owners
        # keep single-writer semantics.
        self.registry = Registry()
        self.metrics = register_router_metrics(self.registry)
        sched = self.scheduler.metrics
        self.metrics.scheduled.set_function(lambda: sched["scheduled_total"])
        self.metrics.rejected.set_function(lambda: sched["rejected_total"])
        self.metrics.pd_splits.set_function(lambda: sched["pd_splits_total"])
        self.metrics.pd_aggregated.set_function(
            lambda: sched["pd_aggregated_total"])
        for fam, key in ((self.metrics.flow_enqueued, "enqueued_total"),
                         (self.metrics.flow_dispatched, "dispatched_total"),
                         (self.metrics.flow_rejected_capacity,
                          "rejected_capacity_total"),
                         (self.metrics.flow_evicted_ttl, "evicted_ttl_total"),
                         (self.metrics.flow_queue_depth, "queue_depth")):
            fam.set_function(
                lambda k=key: self.flow.metrics[k] if self.flow else 0)
        self.metrics.igw_queue_depth.set_function(
            lambda: self.flow.metrics["queue_depth"] if self.flow else 0)
        self.metrics.igw_running.set_function(
            lambda: sum(self.ctx.get("inflight_requests", {}).values()))
        if self.flow is not None:
            self.flow.queue_wait_histogram = self.metrics.flow_queue_wait
        # OTel-shaped tracing (docs/operations/observability/tracing.md):
        # proxy/EPP span with child hops propagated via traceparent
        self.tracer = global_tracer()
        # always-on per-request flight recorder (obs/events.py): the router
        # plane records arrival → flow control → routing decision → forward →
        # response; /debug/requests exposes it live
        self.flight = FlightRecorder.from_env(tracer=self.tracer)
        if self.flow is not None:
            self.flow.flight = self.flight
            self.metrics.flow_evicted_deadline.set_function(
                lambda: self.flow.metrics["evicted_deadline_total"])
        # Resilience layer (router/resilience.py): deadlines, retries, per-
        # endpoint circuit breakers, drain awareness, hedging. The breaker
        # filter hooks into every scheduler pick; the poller's scrape failures
        # feed it as a passive-health signal.
        self.resilience = ResilienceManager(
            ResilienceConfig.from_env(), metrics=self.metrics,
            flight=self.flight)
        self.scheduler.endpoint_filter = self.resilience.filter_endpoints
        self.poller.on_scrape_error = self.resilience.note_scrape_error
        self.metrics.scrape_errors.set_function(
            lambda: self.poller.scrape_error_count)
        self.metrics.breaker_open_endpoints.set_function(
            lambda: len(self.resilience.open_endpoints()))
        stats = self.kvplane.stats
        for fam, key in ((self.metrics.kvplane_precise, "precise_requests"),
                         (self.metrics.kvplane_degraded, "degraded_requests"),
                         (self.metrics.kvplane_lookups, "lookups"),
                         (self.metrics.kvplane_lookup_hits, "lookup_hits"),
                         (self.metrics.kvplane_pulls_stamped, "pulls_planned"),
                         (self.metrics.kvplane_durable_pulls_stamped,
                          "durable_pulls_planned")):
            fam.set_function(lambda k=key: stats[k])
        self.metrics.kvplane_index_blocks.set_function(
            lambda: len(self.kv_index) if self.kv_index is not None else 0)
        self.metrics.kvplane_feed_age.set_function(self.kvplane.feed_age_s)
        # SLO objectives + burn rate (obs/slo.py, LLMD_SLO_*): per-tenant
        # attainment/burn gauges are scrape-time callbacks over the rolling
        # windows; individual breaches land on the flight timeline.
        self.slo = SLOEngine.from_env()
        self.slo.breach_counter = self.metrics.slo_breaches
        self.metrics.slo_attainment.set_labels_function(
            lambda: self.slo.gauge_samples("attainment"))
        self.metrics.slo_burn_rate.set_labels_function(
            lambda: self.slo.gauge_samples("burn"))
        # Latency attribution: fold each retired router timeline into the
        # phase ledger and export llmd_tpu:request_phase_seconds.
        attach_phase_exporter(self.flight, self.metrics.request_phase)
        # Decision plane (obs/decisions.py): chained AFTER the phase
        # exporter (on_finish is a single slot — the decision hook wraps
        # and forwards). When the ledger is off nothing is attached and
        # the scheduler records no detail: the off path costs nothing.
        if self.scheduler.record_decisions:
            attach_decision_exporter(self.flight, self.metrics,
                                     plane="router")
        # Fleet rollup plane (obs/fleet.py): rides the poller's extractor
        # chain; one router scrape then answers fleet tok/s, HBM headroom,
        # KV residency, fabric/stall counts without touching any replica.
        self.fleet = FleetRollup()
        self.poller.extractors.append(self.fleet)
        self.fleet.bind_gauges(self.metrics)
        # Discovery eviction: an endpoint leaving the pool (scale-down,
        # replica death) takes its breaker/draining/error-count state with
        # it — churned replicas must not leak state across scale cycles.
        # The KV index evicts on the SAME listener: without this, a router
        # whose subscriber isn't running against the departed pod (centralized
        # mode, or no subscriber at all) keeps its blocks forever and the
        # index grows unboundedly across controller churn.
        def _on_pool_event(kind: str, ep) -> None:
            if kind == "removed":
                self.resilience.forget(ep.address)
                self.poller.forget(ep.address)
                idx = self.kv_index
                if idx is not None:
                    idx.remove_pod(ep.address)

        self._pool_listener = _on_pool_event
        pool.subscribe(self._pool_listener)
        # extra Prometheus providers (the HA coordinator, ...): callables
        # returning lines, appended to /metrics
        self.extra_metrics: list[Any] = []

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    @property
    def kv_index(self):
        """The router's KV block index (``kv/indexer.py``), or None."""
        return self.ctx.get(CTX_KV_INDEX)

    async def start(self) -> None:
        self._client = HTTPClient()
        await self.poller.start()
        if self.flow:
            await self.flow.start()
        if self.kv_subscriber:
            await self.kv_subscriber.start()
        front = HTTPServer(max_body=64 * 1024 * 1024)
        for path in GEN_PATHS:
            front.add_route("POST", path, self._handle_generate)
        # Conversations API: pod-local state, so traffic is sticky by id —
        # hash(cid) picks the pod deterministically on every EPP replica
        front.add_route("POST", "/v1/conversations", self._handle_conversation)
        front.add_route("*", "/v1/conversations/{tail:.*}", self._handle_conversation)
        front.add_route("GET", "/metrics", self._metrics)
        front.add_route("GET", "/health", self._health)
        front.add_route("GET", "/v1/models", self._models)
        # runtime canary control: a rollout tool shifts
        # InferenceModelRewrite weights through here stage by stage
        front.add_route("GET", "/admin/model-rewrites", self._get_rewrites)
        front.add_route("POST", "/admin/model-rewrites", self._set_rewrites)
        front.add_route("GET", "/debug/requests", self._debug_requests)
        front.add_route("GET", "/debug/requests/{rid}", self._debug_request)
        self.port = await front.start(self.host, self.port)
        self._front = front

    async def stop(self) -> None:
        self.pool.unsubscribe(self._pool_listener)
        await self.poller.stop()
        if self.flow:
            await self.flow.stop()
        if self.kv_subscriber:
            await self.kv_subscriber.stop()
        if self._front:
            await self._front.stop()
        if self._client:
            await self._client.close()
        self._sched_executor.shutdown(wait=False)

    # ------------------------------------------------------------------
    async def _get_rewrites(self, request: Request):
        return json_response({
            m: [[t, w] for t, w in targets]
            for m, targets in self.model_rewrites.items()
        })

    async def _set_rewrites(self, request: Request):
        """Merge-update rewrite entries: {"model": [["target", weight], ...]}.
        An empty target list deletes the entry (traffic reverts to the plain
        model name). A rollout tool shifts canary weights through this."""
        try:
            body = await request.json()
            updates = {
                m: [(str(t), float(w)) for t, w in targets]
                for m, targets in body.items()
            }
        except Exception:
            return json_response(
                {"error": "body must be {model: [[target, weight], ...]}"},
                status=400)
        for m, targets in updates.items():
            # NaN/inf pass both the <0 and <=0 checks and then poison
            # random.choices' cumulative weights (every comparison False →
            # deterministic first pick): finite-and-nonnegative only
            if any(not math.isfinite(w) or w < 0 for _, w in targets):
                return json_response(
                    {"error": f"rewrite {m}: weights must be finite and >= 0"},
                    status=400)
            if targets and sum(w for _, w in targets) <= 0:
                return json_response(
                    {"error": f"rewrite {m}: zero total weight"}, status=400)
        for m, targets in updates.items():
            if targets:
                self.model_rewrites[m] = targets
            else:
                self.model_rewrites.pop(m, None)
        return json_response({"status": "ok",
                                  "rewrites": len(self.model_rewrites)})

    def _rewrite_model(self, req: InferenceRequest, body: dict) -> None:
        """InferenceModelRewrite: weighted model-name rewrite for canary/A-B
        Draws from the scheduler's rng (the reference: the global ``random``)."""
        targets = self.model_rewrites.get(req.model)
        if not targets:
            return
        names = [t[0] for t in targets]
        weights = [t[1] for t in targets]
        chosen = self.scheduler.rng.choices(names, weights=weights, k=1)[0]
        body["model"] = chosen
        req.state["model_rewritten_to"] = chosen

    @staticmethod
    def _profile_scores(result) -> Optional[dict]:
        """Flatten SchedulingResult per-profile endpoint scores for the flight
        timeline (the "why" behind a routing decision)."""
        out = {}
        for name, run in (result.profiles or {}).items():
            scores = getattr(run, "scores", None)
            if scores:
                out[name] = {ep.address: round(s, 4)
                             for ep, s in scores.items()}
        return out or None

    def _decision_payload(self, req: InferenceRequest, result) -> Optional[dict]:
        """Flatten a SchedulingResult's decision detail into the
        ``route_decision`` event payload (obs/decisions.py): per-profile
        filter eliminations, top-k ranked candidates, weighted per-scorer
        breakdown for the chosen endpoint and runner-up, tie width, regret,
        plus the predictor's stamps for the calibration join at retire."""
        topk = regret_topk()
        profs: dict = {}
        primary_regret = None
        for name, run in (result.profiles or {}).items():
            det = getattr(run, "detail", None)
            if det is None:
                continue
            scores = run.scores or {}
            ranked = sorted(scores.items(),
                            key=lambda kv: (-kv[1], kv[0].address))
            entry: dict = {
                "candidates": det["candidates"],
                "tie": det["tie"],
                "top": [[ep.address, round(s, 4)] for ep, s in ranked[:topk]],
            }
            if det["filters"]:
                entry["filters"] = det["filters"]
            chosen = run.endpoint.address if run.endpoint is not None else None
            if chosen is not None:
                entry["chosen"] = chosen
                runner = next((ep.address for ep, _ in ranked
                               if ep.address != chosen), None)
                breakdown: dict = {}
                for sname, weight, smap in det["scorers"]:
                    for ep, s in smap.items():
                        if ep.address in (chosen, runner):
                            breakdown.setdefault(ep.address, {})[sname] = \
                                round(weight * s, 4)
                if breakdown:
                    entry["breakdown"] = breakdown
                if runner is not None:
                    chosen_score = next(
                        (s for ep, s in ranked if ep.address == chosen), 0.0)
                    best_alt = max(
                        (s for ep, s in scores.items()
                         if ep.address != chosen), default=None)
                    if best_alt is not None:
                        entry["regret"] = round(chosen_score - best_alt, 4)
                        if (result.endpoint is not None
                                and chosen == result.endpoint.address):
                            primary_regret = entry["regret"]
            profs[name] = entry
        if not profs:
            return None
        payload: dict = {"profiles": profs}
        if primary_regret is not None:
            payload["regret"] = primary_regret
        if result.pre_drops:
            payload.update(result.pre_drops)
            if result.pre_drops.get("resilience_dropped"):
                breakers = self.resilience.attempt_states(
                    e.address for e in self.pool.list())
                if breakers:
                    payload["breakers"] = breakers
        kv_path = req.state.get(STATE_KV_PLANE)
        if kv_path:
            payload["kv_plane"] = kv_path  # "precise" | degraded-path reason
        if result.endpoint is not None:
            pred = (req.state.get(STATE_PREDICTED) or {}).get(
                result.endpoint.address)
            if pred is not None:
                payload["predicted_ttft_ms"] = round(float(pred[0]), 3)
                payload["predicted_e2e_ms"] = round(
                    predicted_e2e_ms(req, pred), 3)
        pd = getattr(result, "pd", None)
        if pd:
            payload["pd"] = pd  # disagg decider outcome + predicted deltas
        return payload

    def _record_route_decision(self, req: InferenceRequest, result,
                               attempt: Optional[int] = None) -> None:
        """Emit the decision ledger's ``route_decision`` event. Gated on the
        scheduler's cached knob so the off path never builds the payload."""
        if not self.scheduler.record_decisions:
            return
        payload = self._decision_payload(req, result)
        if payload is None:
            return
        if attempt is not None:
            payload["attempt"] = attempt
        self.flight.record(req.request_id, "route_decision", **payload)

    def _observe_e2e(self, seconds: float, exemplar=None) -> None:
        # promql.md alert HighP99Latency reads these buckets; the exemplar
        # (trace_id of the active span) lets Grafana jump bucket → trace
        self.metrics.e2e.observe(seconds, exemplar=exemplar)

    def _observe_slo(self, req: InferenceRequest, objective: str,
                     seconds: float) -> None:
        """Feed one latency sample into the SLO engine; a breach lands on
        the request's flight timeline (and the breach counter via the
        engine's hook) so slow-tail triage starts from the ledger."""
        if not self.slo.enabled:
            return
        if self.slo.observe(req.tenant, objective, seconds):
            self.flight.record(req.request_id, "slo_breach",
                               objective=objective, tenant=req.tenant,
                               latency_ms=round(seconds * 1e3, 3))

    def _account_usage(self, req: InferenceRequest, usage: dict) -> None:
        """Per-tenant token accounting from upstream usage payloads."""
        for key, fam in (("prompt_tokens", self.metrics.tenant_prompt_tokens),
                         ("completion_tokens",
                          self.metrics.tenant_completion_tokens)):
            try:
                n = float(usage.get(key) or 0)
            except (TypeError, ValueError):
                continue
            if n > 0:
                fam.labels(tenant=req.tenant, model=req.model).inc(n)

    def prepare_request(self, path: str, body: dict,
                        headers: dict[str, str]) -> InferenceRequest:
        """Parse + apply objectives and model rewrite (mutates ``body`` on
        rewrite). Shared preamble of the standalone HTTP path and the
        gateway-mode ext-proc path."""
        req = self._parser(path, body, headers)
        lower = {k.lower(): v for k, v in headers.items()}
        # clamped, not trusted: client ids become flight-recorder keys and
        # exemplar labels, so hostile bytes fall back to a generated id
        req.request_id = clamp_request_id(lower.get("x-request-id"))
        self.metrics.tenant_requests.labels(tenant=req.tenant,
                                            model=req.model).inc()
        if req.objective and req.objective in self.objectives:
            req.priority = self.objectives[req.objective]
        if req.timeout_s is None:
            # no client deadline header: the router default still bounds every
            # attempt (replacing the old hard-coded 600s forward timeout)
            req.timeout_s = self.resilience.cfg.request_timeout_s
        self._rewrite_model(req, body)
        return req

    async def _flow_gate(self, req: InferenceRequest, span=None) -> Optional[Rejection]:
        """Flow-control admission shared by the scheduled AND sticky paths."""
        if self.flow:
            if span:
                span.add_event("flow_control.enqueue")
            outcome = await self.flow.enqueue_and_wait(req)
            if outcome is not RequestOutcome.DISPATCHED:
                self.metrics.errors.inc()
                return Rejection(outcome.http_status,
                                 f"flow control: {outcome.value}", deliberate=True)
        return None

    async def admit_and_schedule(self, req: InferenceRequest, span=None):
        """Flow-control gate → async producers → scheduler pick.

        Returns (result, None) on success or (None, Rejection) — one admission
        semantics for both serving fronts. ``Rejection.deliberate`` marks
        enforced admission decisions (load shedding, standby gating) that a
        FailOpen gateway must NOT bypass, vs EPP-can't-answer conditions
        (no endpoint) that failureMode may pass through."""
        rej = await self._flow_gate(req, span)
        if rej is not None:
            return None, rej
        for p in self._async_producers:
            await p.aproduce(req, self.pool.list(), self._client)
        if span:
            span.add_event("schedule.start")
        result = await self._schedule(req)
        if result.endpoint is None:
            self.metrics.errors.inc()
            return None, Rejection(503, f"no endpoint: {result.rejected}")
        rem = req.remaining_s()
        if rem is not None and rem <= 0:
            # flow wait + scheduling ate the whole client budget: a 504 now is
            # honest; dispatching with a stale budget just wastes an endpoint
            self.metrics.deadline_exceeded.inc()
            self.flight.record(req.request_id, "deadline_exceeded",
                               where="post_schedule")
            return None, Rejection(504, "deadline exceeded before dispatch",
                                   deliberate=True)
        return result, None

    async def _schedule(self, req: InferenceRequest,
                        exclude: Optional[set] = None):
        """Scheduler pick on the single worker thread; ``exclude`` holds
        endpoints already tried this request (retry/hedge re-pick)."""
        return await asyncio.get_running_loop().run_in_executor(
            self._sched_executor, self.scheduler.schedule, req, exclude)

    def _note_outcome(self, address: str, status: int) -> None:
        """Feed a completed response into the breaker: any 5xx is a failure
        signal, everything else (including 4xx client errors) proves the
        endpoint's serving path works."""
        if status >= 500:
            self.resilience.on_failure(address, reason=f"http {status}")
        else:
            self.resilience.on_success(address)

    async def _post_maybe_hedged(self, req: InferenceRequest, target,
                                 path: str, body, fwd_headers: dict,
                                 timeout_s: float, first_attempt: bool):
        """POST to ``target``; on the first attempt of a hedge-eligible
        request, race a delayed second attempt on another endpoint ("The Tail
        at Scale" hedging). Returns ``(response, endpoint_that_answered)``;
        raises the transport error when every leg fails."""
        def post(ep):
            return self._client.request("POST", f"http://{ep.address}{path}",
                                        json_body=body, headers=fwd_headers,
                                        timeout=timeout_s)

        if not first_attempt or not self.resilience.hedge_eligible(req):
            return await post(target), target
        primary = asyncio.ensure_future(post(target))
        delay = self.resilience.hedge_delay_s()
        done, _ = await asyncio.wait({primary}, timeout=delay)
        if primary in done:
            return primary.result(), target  # under the hedge delay: no hedge
        alt = await self._schedule(req, {target.address})
        if alt.endpoint is None:
            return await primary, target  # nowhere to hedge to
        self.metrics.hedges.inc()
        self.flight.record(req.request_id, "hedge", primary=target.address,
                           secondary=alt.endpoint.address,
                           delay_ms=round(delay * 1e3, 3))
        secondary = asyncio.ensure_future(post(alt.endpoint))
        legs = {primary: target, secondary: alt.endpoint}
        pending = set(legs)
        winner = None  # first leg answering with a non-5xx
        # a 5xx leg is kept as fallback: returned unconsumed if nothing wins
        # so the caller's retry loop can judge its (retryable) status
        fallback = None
        error = None
        while pending and winner is None:
            done, pending = await asyncio.wait(
                pending, return_when=asyncio.FIRST_COMPLETED)
            for t in done:
                try:
                    r = t.result()
                except Exception as e:
                    error = e
                    continue
                if r.status < 500 and winner is None:
                    winner = t
                elif fallback is None:
                    fallback = t
                else:
                    r.release()
        chosen = winner if winner is not None else fallback
        for t, ep in legs.items():
            if t is chosen:
                continue
            if not t.done():
                t.cancel()
            asyncio.ensure_future(self._reap_leg(t))
            # the loser's pick also ran pre_request: settle its producer
            # bookkeeping here (the caller only settles the returned leg);
            # when both legs fail, the caller reports the primary itself
            if chosen is not None or t is secondary:
                self.scheduler.post_response(req, ep, {"hedge_loser": True})
        if chosen is None:
            raise error
        if chosen is secondary and winner is not None:
            self.metrics.hedge_wins.inc()
        return chosen.result(), legs[chosen]

    @staticmethod
    async def _reap_leg(task) -> None:
        """Close a cancelled/abandoned hedge leg's connection quietly: its
        body is never read, so the connection never goes back to the pool."""
        try:
            r = await task
        except BaseException:  # noqa: BLE001 — the leg's own failure or cancellation
            return
        r.close()

    def _sticky_endpoint(self, conversation_id: str):
        """Conversation→pod mapping: rendezvous (highest-random-weight) hashing,
        identical on every replica AND stable under pool changes — adding or
        removing a pod only remaps the conversations that pod itself owned,
        never the rest (a modulo scheme would 404 nearly every live
        conversation on any scale event)."""
        # decode-capable pods only: Conversations/Responses state and the
        # decode path don't exist on a prefill-only pod, so pinning a
        # conversation there (which the scheduler's own filters would have
        # excluded) would 404 every follow-up turn
        eps = [e for e in self.pool.list() if e.role != EndpointRole.PREFILL]
        if not eps:
            return None
        cid = conversation_id.encode()
        return max(eps, key=lambda e: hashlib.sha256(cid + b"@" + e.address.encode()).digest())

    async def _forward_sticky(self, target, method: str, path: str, body,
                              timeout_s: float,
                              fwd_headers: Optional[dict] = None):
        """Proxy one request to its sticky pod, echoing the pick header and
        propagating trace/request-id headers."""
        resp = None
        try:
            resp = await self._client.request(
                method, f"http://{target.address}{path}",
                json_body=body, headers=fwd_headers, timeout=timeout_s)
            payload = await resp.read()
        except Exception as e:
            self.metrics.errors.inc()
            return json_response(
                {"error": {"message": f"upstream error: {e}"}}, status=502)
        finally:
            if resp is not None:
                resp.close()
        return Response(body=payload, status=resp.status,
                        content_type=resp.content_type,
                        headers={"x-llm-d-endpoint": target.address})

    async def _handle_conversation(self, request: Request):
        """Forward Conversations API traffic to its sticky pod. Creation gets a
        router-assigned id so the hash mapping exists before any pod is asked."""
        self.metrics.requests.inc()
        body = None
        if request.method == "POST":
            try:
                body = await request.json() if request.can_read_body else {}
            except Exception:
                return json_response({"error": {"message": "invalid JSON"}},
                                         status=400)
        tail = request.match_info.get("tail", "")
        cid = tail.split("/", 1)[0] if tail else None
        if cid is None:  # create
            body = dict(body or {})
            cid = body.setdefault("id", f"conv_{uuid.uuid4().hex[:12]}")
        target = self._sticky_endpoint(cid)
        if target is None:
            return json_response({"error": {"message": "no endpoints"}}, status=503)
        return await self._forward_sticky(target, request.method, request.path,
                                          body, timeout_s=60)

    def _stamp_kv_pull(self, req, target, body: dict) -> None:
        """KV plane: when a peer engine holds materially more of this prompt's
        prefix than the chosen target, stamp transfer params so the target
        PULLS the prefix over the KV wire instead of re-prefilling it.
        Re-invoked on every retry re-pick so the stamp tracks the target;
        client-supplied kv_transfer_params (P/D flows) are never touched."""
        if not self.kvplane.active:
            return
        stamped = bool(req.state.get("kv_plane_stamped"))
        if body.get("kv_transfer_params") is not None and not stamped:
            return  # client-owned transfer params — leave untouched
        if stamped:
            body.pop("kv_transfer_params", None)
            req.state["kv_plane_stamped"] = False
        plan = self.kvplane.plan_pull(req, target.address)
        if plan is None:
            return
        peer = plan.pop("peer", None)
        saved = plan.pop("saved_tokens_est", None)
        body["kv_transfer_params"] = plan
        req.state["kv_plane_stamped"] = True
        self.flight.record(req.request_id, "kv_pull_stamped",
                           endpoint=target.address, peer=peer,
                           blocks=len(plan.get("block_hashes") or ()),
                           saved_tokens_est=saved)

    async def _handle_generate(self, request: Request):
        t_start = time.monotonic()
        self.metrics.requests.inc()
        try:
            body = await request.json()
        except Exception:
            return json_response({"error": {"message": "invalid JSON"}}, status=400)
        headers = dict(request.headers)
        # /v1/responses continuing a conversation must land on the pod holding
        # that conversation's items (and its KV prefix). Admission (flow
        # control, objectives, tracing) still applies — sticky affinity only
        # replaces the scheduler PICK, it is not a shedding bypass.
        if request.path.endswith("/v1/responses") and body.get("conversation"):
            try:
                req = self.prepare_request(request.path, body, headers)
            except ValueError as e:  # malformed structured spec → 400 pre-flow
                return json_response({"error": {"message": str(e)}},
                                         status=400)
            # span BEFORE the flow gate (parity with the scheduled path) so
            # the flight record carries a trace id from its first event on
            span = self.tracer.start_span(
                "epp.request", parent=extract_traceparent(headers),
                **{"llm_d.request_id": req.request_id, "llm_d.model": req.model,
                   "http.route": request.path, "llm_d.sticky": True})
            self.flight.start(req.request_id, model=req.model,
                              trace_id=span.context.trace_id,
                              tenant=req.tenant)
            self.flight.record(req.request_id, "arrival", path=request.path,
                               sticky=True)
            rej = await self._flow_gate(req, span)
            if rej is not None:
                self.flight.finish(req.request_id, event="rejected",
                                   status="rejected", reason=rej.message,
                                   http_status=rej.status)
                span.set_error(rej.message)
                span.end()
                return json_response({"error": {"message": rej.message}},
                                         status=rej.status)
            target = self._sticky_endpoint(str(body["conversation"]))
            if target is None:
                self.metrics.errors.inc()
                self.flight.finish(req.request_id, event="error",
                                   status="error", reason="no endpoints",
                                   http_status=503)
                span.set_error("no endpoints")
                span.end()
                return json_response({"error": {"message": "no endpoints"}},
                                         status=503)
            span.set_attribute("llm_d.endpoint", target.address)
            self.flight.record(req.request_id, "routing_decision",
                               endpoint=target.address, sticky=True)
            self.flight.record(req.request_id, "forward",
                               endpoint=target.address)
            rem = req.remaining_s()
            budget = (rem if rem is not None
                      else self.resilience.cfg.request_timeout_s)
            if budget <= 0:
                self.metrics.deadline_exceeded.inc()
                self.flight.record(req.request_id, "deadline_exceeded",
                                   where="sticky")
                self.flight.finish(req.request_id, event="rejected",
                                   status="rejected",
                                   reason="deadline exceeded", http_status=504)
                span.set_error("deadline exceeded")
                span.end()
                return json_response(
                    {"error": {"message": "deadline exceeded"}}, status=504)
            resp = await self._forward_sticky(
                target, "POST", request.path, body, timeout_s=budget,
                fwd_headers={"content-type": "application/json",
                             "traceparent": span.traceparent(),
                             "x-request-id": req.request_id,
                             HDR_TENANT: req.tenant,
                             HDR_REQUEST_TIMEOUT: f"{budget:.3f}"})
            # sticky traffic can't route around its pod, but its outcomes
            # still teach the breaker (protects the scheduled path)
            self._note_outcome(target.address, resp.status)
            if resp.status >= 500:
                self.flight.finish(req.request_id, event="error",
                                   status="error", http_status=resp.status)
            else:
                self.flight.finish(req.request_id, event="response",
                                   status="finished", http_status=resp.status)
            span.end()
            return resp
        try:
            req = self.prepare_request(request.path, body, headers)
        except ValueError as e:  # malformed structured spec → 400 pre-flow
            return json_response({"error": {"message": str(e)}}, status=400)

        span = self.tracer.start_span(
            "epp.request", parent=extract_traceparent(headers),
            **{"llm_d.request_id": req.request_id, "llm_d.model": req.model,
               "http.route": request.path})
        self.flight.start(req.request_id, model=req.model,
                          trace_id=span.context.trace_id, tenant=req.tenant)
        self.flight.record(req.request_id, "arrival", path=request.path)

        result, err = await self.admit_and_schedule(req, span=span)
        if err is not None:
            self.flight.finish(
                req.request_id,
                event="rejected" if err.deliberate else "error",
                status="rejected" if err.deliberate else "error",
                reason=err.message, http_status=err.status)
            span.set_error(err.message)
            span.end()
            return json_response({"error": {"message": err.message}},
                                     status=err.status)
        span.set_attribute("llm_d.endpoint", result.endpoint.address)
        span.add_event("proxy.forward")
        self.flight.record(
            req.request_id, "routing_decision",
            endpoint=result.endpoint.address,
            prefill_endpoint=(result.prefill_endpoint.address
                              if result.prefill_endpoint else None),
            latency_ms=round(result.latency_s * 1e3, 3),
            scores=self._profile_scores(result))
        self._record_route_decision(req, result)
        self.flight.record(req.request_id, "forward",
                           endpoint=result.endpoint.address)

        target = result.endpoint
        prefill = result.prefill_endpoint
        self._stamp_kv_pull(req, target, body)
        # Bounded retry loop: connect errors, attempt timeouts, and retryable
        # statuses (502/503/504) BEFORE any response body re-schedule on a
        # different endpoint (excluded set = llm-d excluded_runner_ids). Once
        # a non-retryable response arrives the request is committed to it.
        excluded = {target.address}
        attempt = 1
        resp = None
        while True:
            rem = req.remaining_s()
            if rem is not None and rem <= 0:
                self.metrics.deadline_exceeded.inc()
                self.flight.record(req.request_id, "deadline_exceeded",
                                   where="retry_loop", attempts=attempt - 1)
                self.flight.finish(req.request_id, event="rejected",
                                   status="rejected",
                                   reason="deadline exceeded",
                                   http_status=504)
                span.set_error("deadline exceeded")
                span.end()
                return json_response(
                    {"error": {"message": "deadline exceeded"}}, status=504)
            budget = rem if rem is not None else self.resilience.cfg.request_timeout_s
            fwd_headers = {"content-type": "application/json",
                           "traceparent": span.traceparent(),
                           "x-request-id": req.request_id,
                           HDR_TENANT: req.tenant,
                           # the engine sees the REMAINING budget, not the
                           # client's original: queue wait already spent it
                           HDR_REQUEST_TIMEOUT: f"{budget:.3f}"}
            if prefill is not None:
                fwd_headers[HDR_PREFILLER_HOST_PORT] = prefill.address
            failure = None  # (kind, detail) when this attempt failed retryably
            try:
                resp, target = await self._post_maybe_hedged(
                    req, target, request.path, body, fwd_headers, budget,
                    first_attempt=(attempt == 1))
            except asyncio.TimeoutError:
                failure = ("timeout", f"attempt timeout after {budget:.3f}s")
            except Exception as e:
                failure = ("connect", f"{type(e).__name__}: {e}")
            if failure is None and resp.status in RETRYABLE_STATUSES:
                failure = ("status", f"http {resp.status}")
                resp.release()
            if failure is None:
                break  # response committed (headers in, not retryable)
            kind, detail = failure
            self.metrics.errors.inc()
            self.resilience.on_failure(target.address, reason=detail)
            # every pick ran pre_request: failed attempts still owe producers
            # their post_response so inflight bookkeeping stays balanced
            self.scheduler.post_response(req, target, {"error": detail})
            if attempt >= self.resilience.cfg.retry_max_attempts:
                self.metrics.retries_exhausted.inc()
                self.flight.finish(req.request_id, event="error",
                                   status="error",
                                   reason=f"retries exhausted: {detail}",
                                   http_status=502, attempts=attempt)
                span.set_error(f"retries exhausted: {detail}")
                span.end()
                return json_response(
                    {"error": {"message": f"upstream error after {attempt} "
                                          f"attempts: {detail}"}}, status=502)
            self.metrics.retries.labels(reason=kind).inc()
            self.flight.record(req.request_id, "retry", attempt=attempt,
                               endpoint=target.address, reason=detail)
            delay = self.resilience.backoff_s(attempt)
            rem = req.remaining_s()
            if rem is not None:
                delay = min(delay, max(0.0, rem))
            if delay > 0:
                await asyncio.sleep(delay)
            repick = await self._schedule(req, set(excluded))
            if repick.endpoint is None:
                self.flight.finish(req.request_id, event="error",
                                   status="error",
                                   reason=f"no alternate endpoint: {detail}",
                                   http_status=502)
                span.set_error("no alternate endpoint for retry")
                span.end()
                return json_response(
                    {"error": {"message": f"upstream error: {detail} "
                                          "(no alternate endpoint)"}},
                    status=502)
            target = repick.endpoint
            prefill = repick.prefill_endpoint
            self._stamp_kv_pull(req, target, body)  # re-plan for the new target
            excluded.add(target.address)
            attempt += 1
            span.set_attribute("llm_d.endpoint", target.address)
            self.flight.record(req.request_id, "routing_decision",
                               endpoint=target.address, retry_attempt=attempt,
                               scores=self._profile_scores(repick))
            self._record_route_decision(req, repick, attempt=attempt)
            self.flight.record(req.request_id, "forward",
                               endpoint=target.address, attempt=attempt)

        echo = {
            "x-llm-d-endpoint": target.address,
            "x-llm-d-request-id": req.request_id,
        }
        if prefill is not None:
            echo[HDR_PREFILLER_HOST_PORT] = prefill.address
        if attempt > 1:
            echo["x-llm-d-attempts"] = str(attempt)

        try:
            if resp.headers.get("Content-Type", "").startswith("text/event-stream"):
                out = StreamResponse(
                    status=resp.status,
                    headers={"Content-Type": "text/event-stream", **echo},
                )
                await out.prepare(request)
                t_first = None
                t_last = t_start
                n_chunks = 0
                exemplar = {"trace_id": span.context.trace_id}
                try:
                    async for chunk in resp.iter_chunks():
                        t_last = time.monotonic()
                        if t_first is None:
                            t_first = t_last
                            self.metrics.ttft.observe(t_first - t_start,
                                                      exemplar=exemplar)
                            self._observe_slo(req, "ttft", t_first - t_start)
                        n_chunks += 1
                        await out.write(chunk)
                    await out.write_eof()
                except Exception as e:
                    # Mid-stream failure: the client already holds part of the
                    # stream, so a retry would replay tokens — NEVER retried.
                    # Report the failure (breaker signal) and end the stream.
                    self.metrics.errors.inc()
                    self.resilience.on_failure(target.address,
                                               reason=f"midstream: {e}")
                    self.scheduler.post_response(req, target,
                                                 {"error": str(e)})
                    self.flight.finish(req.request_id, event="error",
                                       status="error", midstream=True,
                                       reason=f"midstream: {e}",
                                       http_status=resp.status,
                                       chunks=n_chunks)
                    span.set_error(f"midstream: {e}")
                    return out
                self._note_outcome(target.address, resp.status)
                info: dict[str, Any] = {"status": resp.status}
                if t_first is not None:
                    info["ttft_ms"] = (t_first - t_start) * 1e3
                    info["e2e_ms"] = (t_last - t_start) * 1e3
                    if n_chunks > 1:  # mean inter-chunk latency ≈ ITL/TPOT sample
                        info["itl_ms"] = (t_last - t_first) * 1e3 / (n_chunks - 1)
                self.scheduler.post_response(req, target, info)
                self.metrics.responses.inc()
                if "e2e_ms" in info:
                    self._observe_e2e(info["e2e_ms"] / 1e3, exemplar=exemplar)
                    self._observe_slo(req, "e2e", info["e2e_ms"] / 1e3)
                self.flight.finish(
                    req.request_id, event="response", status="finished",
                    http_status=resp.status,
                    ttft_ms=(round(info["ttft_ms"], 3)
                             if "ttft_ms" in info else None),
                    streamed=True)
                for k in ("ttft_ms", "e2e_ms", "itl_ms"):
                    if k in info:
                        span.set_attribute(f"llm_d.{k}", round(info[k], 3))
                span.end()
                return out
            try:
                payload = await resp.read()
            except Exception as e:
                # body read failed after committed headers: no retry (the
                # response was already chosen), surface as upstream error
                self.metrics.errors.inc()
                self.resilience.on_failure(target.address, reason=f"read: {e}")
                self.scheduler.post_response(req, target, {"error": str(e)})
                self.flight.finish(req.request_id, event="error",
                                   status="error",
                                   reason=f"upstream read error: {e}",
                                   http_status=502)
                span.set_error(f"read: {e}")
                return json_response(
                    {"error": {"message": f"upstream read error: {e}"}},
                    status=502)
            e2e_s = time.monotonic() - t_start
            self._note_outcome(target.address, resp.status)
            self.resilience.note_latency(e2e_s)
            exemplar = {"trace_id": span.context.trace_id}
            self.metrics.ttft.observe(e2e_s, exemplar=exemplar)
            self._observe_slo(req, "ttft", e2e_s)
            info = {"status": resp.status, "e2e_ms": e2e_s * 1e3}
            try:
                usage = json.loads(payload).get("usage", {})
                info["usage"] = usage
                self._account_usage(req, usage)
                if usage.get("completion_tokens"):
                    info["itl_ms"] = e2e_s * 1e3 / usage["completion_tokens"]
            except Exception:
                pass
            self.scheduler.post_response(req, target, info)
            self.metrics.responses.inc()
            self._observe_e2e(e2e_s, exemplar=exemplar)
            self._observe_slo(req, "e2e", e2e_s)
            self.flight.finish(req.request_id, event="response",
                               status="finished", http_status=resp.status)
            span.set_attribute("llm_d.e2e_ms", round(info["e2e_ms"], 3))
            span.set_attribute("http.status_code", resp.status)
            span.end()
            return Response(
                body=payload, status=resp.status,
                headers={"Content-Type": "application/json", **echo},
            )
        finally:
            resp.release()
            span.end()  # idempotent backstop for exception exits

    async def _metrics(self, request: Request):
        # Registry families (llm_d_epp_*, igw_*, llmd_tpu:*) render via the
        # shared formatter; plugin providers (latency predictor) and extra
        # providers (HA) append their own pre-rendered lines after it.
        lines = [self.registry.expose().rstrip("\n")]
        for plugin in self.scheduler.plugins.values():
            if hasattr(plugin, "prometheus_lines"):
                lines += plugin.prometheus_lines()
        for provider in self.extra_metrics:
            lines += provider()
        return Response(("\n".join(lines) + "\n").encode(),
                        content_type="text/plain; charset=utf-8")

    async def _health(self, request: Request):
        return json_response({"status": "ok", "endpoints": len(self.pool),
                                  "resilience": self.resilience.snapshot()})

    async def _debug_requests(self, request: Request):
        status, payload = debug_list_response(self.flight, request.query)
        return json_response(payload, status=status)

    async def _debug_request(self, request: Request):
        status, payload = debug_detail_response(self.flight,
                                                request.match_info["rid"])
        return json_response(payload, status=status)

    async def _models(self, request: Request):
        """Union of /v1/models across the pool, skipping breaker-open,
        draining, and stale endpoints and tolerating per-endpoint failures.
        (Previously the first reachable endpoint answered alone, so a sick
        first endpoint hid every other endpoint's models.)"""
        eps = self.pool.list()
        candidates = [e for e in eps
                      if self.resilience.healthy(e.address) and not e.stale()]
        seen: dict[str, dict] = {}
        for ep in candidates or eps:  # everything filtered: best effort
            r = None
            try:
                r = await self._client.request(
                    "GET", f"http://{ep.address}/v1/models", timeout=2)
                if r.status != 200:
                    continue
                data = await r.json()
            except Exception:  # noqa: BLE001 — one sick endpoint never hides the rest
                continue
            finally:
                if r is not None:
                    r.close()
            for m in data.get("data", []) if isinstance(data, dict) else []:
                mid = m.get("id") if isinstance(m, dict) else None
                if mid is not None and mid not in seen:
                    seen[mid] = m
        return json_response({"object": "list",
                                  "data": list(seen.values())})
