"""Gateway-mode EPP: the Envoy external-processing (ext_proc) gRPC front (port
of ``llmd_tpu/router/extproc.py``, served on the port's own gRPC wire,
``router/grpc_wire.py``, with the hand codec of ``router/ext_proc_pb.py``).

In gateway mode the EPP does not proxy traffic itself: an Envoy (or any
GAIE-conformant gateway) parks each request and consults the EPP over the
ext_proc bidirectional stream; the EPP answers with header mutations naming
the chosen pod (``x-gateway-destination-endpoint``) and Envoy forwards (the
reference's docs/architecture/core/router/proxy.md:3-111). This front reuses
the standalone RouterServer's scheduling plane (parser -> flow control ->
producers -> scheduler) under Envoy's full method name.

Phase handling (buffered / FULL_DUPLEX-style chunked bodies both work):
- request_headers -> captured; CONTINUE.
- request_body chunks -> buffered; non-final chunks CONTINUE; the final chunk
  triggers the pick and its BodyResponse carries the routing header mutation
  (+ body mutation when InferenceModelRewrite rewrote the model name).
- flow-control rejection / no endpoint -> ImmediateResponse with the
  flow-control outcome's HTTP status, unless the InferencePool's
  ``failureMode`` is FailOpen, in which case CONTINUE without a mutation lets
  the gateway fall back to its default routing (deliberate admission
  decisions are always enforced).
- response_headers/response_body -> observed for usage/latency feedback
  (scheduler.post_response drives the inflight/latency producers); CONTINUE.

The streams run as tasks on the router's own event loop, where the reference
bounces grpcio worker threads through it: admission is awaited and the
response feedback called in place.
"""

from __future__ import annotations

import asyncio
import json
import time
from typing import AsyncIterator, Optional

from llmd_tpu_torch.core.request import HDR_PREFILLER_HOST_PORT
from llmd_tpu_torch.router import ext_proc_pb as pb
from llmd_tpu_torch.router.grpc_wire import Server

# Envoy's service/method name — what an ext_proc filter dials.
ENVOY_SERVICE = "envoy.service.ext_proc.v3.ExternalProcessor"
HDR_DESTINATION = "x-gateway-destination-endpoint"
# Standard gRPC health protocol — Envoy's ext_proc cluster health-checks the
# EPP with grpc_health_check; without this service a real Envoy marks the EPP
# unhealthy and never opens a stream.
HEALTH_SERVICE = "grpc.health.v1.Health"
# grpc.health.v1.HealthCheckResponse { ServingStatus status = 1; } SERVING=1:
# field 1, varint wire type, value 1
_HEALTH_SERVING = b"\x08\x01"


def _headers_to_dict(hm: pb.HeaderMap) -> dict[str, str]:
    out: dict[str, str] = {}
    for h in hm.headers:
        v = h.value or (h.raw_value.decode("utf-8", "replace") if h.raw_value else "")
        out[h.key.lower()] = v
    return out


def _mutation(headers: dict[str, str]) -> pb.HeaderMutation:
    return pb.HeaderMutation(set_headers=[
        pb.HeaderValueOption(
            header=pb.HeaderValue(key=k, raw_value=v.encode()),
            append_action=2,  # OVERWRITE_IF_EXISTS_OR_ADD
        )
        for k, v in headers.items()
    ])


def _continue_headers() -> pb.ProcessingResponse:
    return pb.ProcessingResponse(request_headers=pb.HeadersResponse(
        response=pb.CommonResponse(status=pb.CommonResponse.CONTINUE)))


class _Stream:
    """Per-request state across the phases of one ext_proc stream."""

    RESP_BUFFER_CAP = 256 * 1024  # usage parse only needs the (small) JSON body

    def __init__(self) -> None:
        self.headers: dict[str, str] = {}
        self.path = "/v1/completions"
        self.body = bytearray()
        self.resp_body = bytearray()
        self.resp_streaming = False  # SSE bodies carry no parseable usage JSON
        self.req = None
        self.endpoint = None
        self.t_start = time.monotonic()
        self.resp_status = 0


class ExtProcEPP:
    """ext_proc gRPC server over an existing RouterServer's scheduling plane."""

    def __init__(self, router, host: str = "0.0.0.0", port: int = 0,
                 failure_mode: str = "FailClose", max_streams: int = 256) -> None:
        self.router = router
        self.host, self.port = host, port
        self.failure_mode = failure_mode
        # each ext_proc stream lives for its request's whole HTTP lifetime;
        # max_streams bounds them and excess streams are REJECTED
        # (RESOURCE_EXHAUSTED) rather than queued behind long LLM responses
        self.max_streams = max_streams
        self._server: Optional[Server] = None
        self._stopping = asyncio.Event()  # releases parked Watch streams
        self.metrics = {"streams_total": 0, "picks_total": 0,
                        "immediate_total": 0, "fail_open_total": 0}

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> None:
        """Await from the router's event loop (flow control and the async
        producers are loop-bound; the streams run on it)."""
        server = Server(maximum_concurrent_rpcs=self.max_streams)
        server.add_method(f"/{ENVOY_SERVICE}/Process", "stream_stream", self._process,
                          request_deserializer=pb.ProcessingRequest.FromString,
                          response_serializer=pb.ProcessingResponse.SerializeToString)
        server.add_method(f"/{HEALTH_SERVICE}/Check", "unary_unary", self._health_check)
        server.add_method(f"/{HEALTH_SERVICE}/Watch", "unary_stream", self._health_watch)
        self.port = await server.start(self.host, self.port)
        self._server = server
        if self.prometheus_lines not in self.router.extra_metrics:
            self.router.extra_metrics.append(self.prometheus_lines)

    async def stop(self) -> None:
        self._stopping.set()
        if self._server is not None:
            await self._server.stop(grace=1.0)
            self._server = None

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    # -- health --------------------------------------------------------------
    async def _health_check(self, request: bytes, context) -> bytes:
        return _HEALTH_SERVING

    async def _health_watch(self, request: bytes, context) -> AsyncIterator[bytes]:
        # the health protocol requires Watch to STAY OPEN and stream status
        # changes — a completed stream reads as a failure to Watch-based
        # checkers. One SERVING now, then hold until the server stops (the
        # status never changes while serving).
        yield _HEALTH_SERVING
        await self._stopping.wait()

    # -- helpers -----------------------------------------------------------
    def _immediate(self, status: int, message: str) -> pb.ProcessingResponse:
        self.metrics["immediate_total"] += 1
        body = json.dumps({"error": {"message": message}}).encode()
        return pb.ProcessingResponse(immediate_response=pb.ImmediateResponse(
            status=pb.HttpStatus(code=status), body=body, details=message))

    @staticmethod
    def _wrap(phase: str, common: pb.CommonResponse) -> pb.ProcessingResponse:
        """Envoy requires the response oneof to match the request phase."""
        if phase == "request_headers":
            return pb.ProcessingResponse(
                request_headers=pb.HeadersResponse(response=common))
        return pb.ProcessingResponse(request_body=pb.BodyResponse(response=common))

    def _fail(self, st: _Stream, phase: str, status: int, message: str,
              deliberate: bool = False) -> pb.ProcessingResponse:
        """Reject, honouring the pool's failureMode for EPP-side failures only.

        failureMode governs what happens when the EPP *can't* answer —
        deliberate admission decisions (flow-control shedding, priority
        rejection) are always enforced, or FailOpen would disable load
        shedding exactly under the saturation it exists for."""
        if self.failure_mode == "FailOpen" and not deliberate:
            self.metrics["fail_open_total"] += 1
            return self._wrap(phase, pb.CommonResponse(
                status=pb.CommonResponse.CONTINUE))
        return self._immediate(status, message)

    # -- the pick ----------------------------------------------------------
    async def _pick(self, st: _Stream, phase: str = "request_body") -> pb.ProcessingResponse:
        r = self.router
        try:
            body = json.loads(bytes(st.body) or b"{}")
        except json.JSONDecodeError:
            return self._immediate(400, "invalid JSON body")
        rewritten = dict(body)
        req = r.prepare_request(st.path, rewritten, st.headers)
        st.req = req
        # one admission semantics with the standalone HTTP front
        try:
            result, err = await r.admit_and_schedule(req)
        except Exception as e:  # EPP-internal failure -> failureMode applies
            return self._fail(st, phase, 500, f"EPP error: {e}")
        if err is not None:
            return self._fail(st, phase, err.status, err.message,
                              deliberate=err.deliberate)
        st.endpoint = result.endpoint
        self.metrics["picks_total"] += 1
        hdrs = {
            HDR_DESTINATION: result.endpoint.address,
            "x-llm-d-endpoint": result.endpoint.address,
            "x-llm-d-request-id": req.request_id,
        }
        if result.prefill_endpoint is not None:
            hdrs[HDR_PREFILLER_HOST_PORT] = result.prefill_endpoint.address
        common = pb.CommonResponse(
            status=pb.CommonResponse.CONTINUE,
            header_mutation=_mutation(hdrs),
            clear_route_cache=True,
        )
        if rewritten.get("model") != body.get("model") and phase == "request_body":
            # plain CONTINUE + body_mutation: CONTINUE_AND_REPLACE would stop
            # Envoy sending the response phases, blinding usage/latency feedback
            # for exactly the canary traffic the rewrite exists to measure
            common.body_mutation = pb.BodyMutation(body=json.dumps(rewritten).encode())
        return self._wrap(phase, common)

    def _finish(self, st: _Stream) -> None:
        """Feed the response back to the latency/inflight producers (once)."""
        if st.req is None or st.endpoint is None:
            return
        info = {"status": st.resp_status,
                "e2e_ms": (time.monotonic() - st.t_start) * 1e3}
        try:
            usage = json.loads(bytes(st.resp_body)).get("usage", {})
            info["usage"] = usage
            if usage.get("completion_tokens"):
                info["itl_ms"] = info["e2e_ms"] / usage["completion_tokens"]
        except Exception:
            pass
        req, ep = st.req, st.endpoint
        st.req = None  # post once
        self.router.scheduler.post_response(req, ep, info)

    # -- stream handler ----------------------------------------------------
    async def _process(self, request_iterator: AsyncIterator[pb.ProcessingRequest],
                       context) -> AsyncIterator[pb.ProcessingResponse]:
        self.metrics["streams_total"] += 1
        st = _Stream()
        try:
            async for msg in request_iterator:
                which = msg.WhichOneof("request")
                if which == "request_headers":
                    st.headers = _headers_to_dict(msg.request_headers.headers)
                    st.path = st.headers.get(":path", st.path)
                    if msg.request_headers.end_of_stream:
                        # no body (GET-ish) — pick on headers alone
                        yield await self._pick(st, phase="request_headers")
                    else:
                        yield _continue_headers()
                elif which == "request_body":
                    st.body.extend(msg.request_body.body)
                    if msg.request_body.end_of_stream:
                        yield await self._pick(st)
                    else:
                        yield pb.ProcessingResponse(request_body=pb.BodyResponse(
                            response=pb.CommonResponse(
                                status=pb.CommonResponse.CONTINUE)))
                elif which == "response_headers":
                    rh = _headers_to_dict(msg.response_headers.headers)
                    st.resp_status = int(rh.get(":status", "0") or 0)
                    st.resp_streaming = rh.get("content-type", "").startswith(
                        "text/event-stream")
                    if msg.response_headers.end_of_stream:
                        self._finish(st)
                    yield pb.ProcessingResponse(response_headers=pb.HeadersResponse(
                        response=pb.CommonResponse(
                            status=pb.CommonResponse.CONTINUE)))
                elif which == "response_body":
                    if (not st.resp_streaming
                            and len(st.resp_body) < _Stream.RESP_BUFFER_CAP):
                        st.resp_body.extend(msg.response_body.body)
                    if msg.response_body.end_of_stream:
                        self._finish(st)
                    yield pb.ProcessingResponse(response_body=pb.BodyResponse(
                        response=pb.CommonResponse(
                            status=pb.CommonResponse.CONTINUE)))
                elif which == "request_trailers":
                    yield pb.ProcessingResponse(
                        request_trailers=pb.TrailersResponse())
                elif which == "response_trailers":
                    self._finish(st)
                    yield pb.ProcessingResponse(
                        response_trailers=pb.TrailersResponse())
        finally:
            self._finish(st)

    def prometheus_lines(self) -> list[str]:
        m = self.metrics
        return [
            f"llm_d_epp_extproc_streams_total {m['streams_total']}",
            f"llm_d_epp_extproc_picks_total {m['picks_total']}",
            f"llm_d_epp_extproc_immediate_total {m['immediate_total']}",
            f"llm_d_epp_extproc_fail_open_total {m['fail_open_total']}",
        ]
