"""vllmgrpc parser front: the router's gRPC serving surface (port of
``llmd_tpu/router/vllmgrpc.py``, served on the port's own gRPC wire,
``router/grpc_wire.py``, with the hand codec of ``router/vllm_grpc_pb.py``).

The reference's EPP ships a ``vllmgrpc-parser`` for the vLLM gRPC API's
``Generate`` and ``Embed`` methods (request-handling.md:74). This front parses
each RPC into an ``InferenceRequest``, runs the SAME admission pipeline as the
HTTP and ext-proc fronts (flow control -> async producers -> Filter/Score/
Pick), then proxies to the picked pod's OpenAI HTTP API over the router's
``HTTPClient`` and translates the answer back to protobuf: gRPC clients get
scheduler-quality routing without the pods growing a gRPC port. The RPCs run
as tasks on the router's event loop.
"""

from __future__ import annotations

import json
import time
from typing import AsyncIterator, Optional

from llmd_tpu_torch.core.request import HDR_PREFILLER_HOST_PORT
from llmd_tpu_torch.router import vllm_grpc_pb as pb
from llmd_tpu_torch.router.grpc_wire import Server, StatusCode

SERVICE = "llmd.vllmgrpc.v1.VllmService"


class VllmGrpcFront:
    """gRPC front sharing one RouterServer's scheduling plane."""

    def __init__(self, router, host: str = "127.0.0.1", port: int = 0,
                 max_rpcs: int = 64) -> None:
        self.router = router
        self.host, self.port = host, port
        self.max_rpcs = max_rpcs
        self._server: Optional[Server] = None
        self.metrics = {"generate_total": 0, "embed_total": 0, "errors_total": 0}

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    async def start(self) -> None:
        """Await from the router's loop (admission is loop-bound)."""
        server = Server(maximum_concurrent_rpcs=self.max_rpcs)
        server.add_method(f"/{SERVICE}/Generate", "unary_stream", self._generate,
                          request_deserializer=pb.GenerateRequest.FromString,
                          response_serializer=pb.GenerateResponse.SerializeToString)
        server.add_method(f"/{SERVICE}/Embed", "unary_unary", self._embed,
                          request_deserializer=pb.EmbedRequest.FromString,
                          response_serializer=pb.EmbedResponse.SerializeToString)
        self.port = await server.start(self.host, self.port)
        self._server = server

    async def stop(self) -> None:
        if self._server is not None:
            await self._server.stop(grace=1.0)
            self._server = None

    # -- helpers -----------------------------------------------------------
    def _parse(self, path: str, body: dict):
        # one parser, one admission semantics with the HTTP front
        return self.router.prepare_request(path, body, {})

    @staticmethod
    def _code_for(err) -> StatusCode:
        """Rejection -> gRPC status. 429 sheds map to RESOURCE_EXHAUSTED so
        standard client retry policy backs off instead of hammering."""
        return (StatusCode.RESOURCE_EXHAUSTED if err.status == 429
                else StatusCode.UNAVAILABLE)

    @staticmethod
    def _fwd_headers(ireq, result) -> dict:
        hdrs = {"x-request-id": ireq.request_id}
        if result.prefill_endpoint is not None:
            # P/D disaggregation rides this header through the pod's sidecar —
            # dropping it silently degrades gRPC traffic to aggregated serving
            hdrs[HDR_PREFILLER_HOST_PORT] = result.prefill_endpoint.address
        return hdrs

    async def _post_json(self, url: str, body: dict, headers: dict) -> dict:
        resp = await self.router._client.request("POST", url, json_body=body,
                                                  headers=headers, timeout=600)
        text = await resp.text()
        if resp.status != 200:
            raise RuntimeError(f"upstream HTTP {resp.status}: {text[:200]}")
        return json.loads(text)

    def _post(self, ireq, target, t0: float, status: int, **info) -> None:
        """The same response_info shape the HTTP front feeds the latency/SLO
        producers — gRPC traffic trains the predictor like any other."""
        self.router.scheduler.post_response(
            ireq, target, {"status": status, **info, "e2e_ms": (time.monotonic() - t0) * 1e3})

    async def _admit(self, ireq, context):
        try:
            result, err = await self.router.admit_and_schedule(ireq)
        except Exception as e:
            self.metrics["errors_total"] += 1
            context.abort(StatusCode.INTERNAL, f"EPP error: {e}")
        if err is not None:
            self.metrics["errors_total"] += 1
            context.abort(self._code_for(err), err.message)
        return result

    # -- RPCs --------------------------------------------------------------
    async def _generate(self, req: pb.GenerateRequest, context) -> AsyncIterator:
        self.metrics["generate_total"] += 1
        body: dict = {
            "model": req.model,
            "max_tokens": int(req.sampling_params.max_tokens or 16),
            "temperature": float(req.sampling_params.temperature),
        }
        if req.sampling_params.top_p:
            body["top_p"] = float(req.sampling_params.top_p)
        if req.sampling_params.top_k:
            body["top_k"] = int(req.sampling_params.top_k)
        if req.sampling_params.ignore_eos:
            body["ignore_eos"] = True
        if req.sampling_params.stop:
            body["stop"] = list(req.sampling_params.stop)
        if req.lora_adapter:
            body["lora_adapter"] = req.lora_adapter
        if req.WhichOneof("input") == "prompt_token_ids":
            body["prompt_token_ids"] = list(req.prompt_token_ids.values)
        else:
            body["prompt"] = req.prompt

        ireq = self._parse("/v1/completions", body)
        t0 = time.monotonic()
        result = await self._admit(ireq, context)
        target = result.endpoint
        rid = req.request_id or ireq.request_id
        hdrs = self._fwd_headers(ireq, result)

        if req.stream:
            async for msg in self._generate_streaming(body, ireq, target, rid, hdrs,
                                                      context, t0):
                yield msg
            return
        try:
            out = await self._post_json(f"http://{target.address}/v1/completions",
                                        body, hdrs)
        except Exception as e:
            self.metrics["errors_total"] += 1
            self._post(ireq, target, t0, 502, error=str(e))
            context.abort(StatusCode.UNAVAILABLE, f"upstream: {e}")
        usage = out.get("usage", {})
        self._post(ireq, target, t0, 200, usage=usage)
        choice = (out.get("choices") or [{}])[0]
        yield pb.GenerateResponse(
            request_id=rid,
            outputs=[pb.Completion(text=choice.get("text", ""),
                                   finish_reason=choice.get("finish_reason") or "")],
            finished=True,
            usage=pb.UsageInfo(
                prompt_tokens=int(usage.get("prompt_tokens", 0)),
                completion_tokens=int(usage.get("completion_tokens", 0)),
                cached_tokens=int(usage.get("cached_tokens", 0))),
            endpoint=target.address,
        )

    async def _generate_streaming(self, body, ireq, target, rid, hdrs, context,
                                  t0) -> AsyncIterator:
        """stream=true: bridge the upstream SSE stream into the gRPC stream —
        each data: chunk becomes one incremental GenerateResponse."""
        usage: dict = {}
        try:
            async for chunk in self._sse_chunks(
                    f"http://{target.address}/v1/completions", dict(body, stream=True),
                    hdrs):
                if chunk is None:
                    break
                choice = (chunk.get("choices") or [{}])[0]
                usage = chunk.get("usage") or usage
                yield pb.GenerateResponse(
                    request_id=rid,
                    outputs=[pb.Completion(
                        text=choice.get("text", ""),
                        finish_reason=choice.get("finish_reason") or "")],
                    finished=bool(choice.get("finish_reason")),
                    endpoint=target.address,
                )
        except Exception as e:
            self.metrics["errors_total"] += 1
            self._post(ireq, target, t0, 502, error=str(e))
            context.abort(StatusCode.UNAVAILABLE, f"upstream: {e}")
        self._post(ireq, target, t0, 200, usage=usage)

    async def _sse_chunks(self, url: str, body: dict, headers: dict) -> AsyncIterator:
        """The upstream SSE data: events (None at [DONE], or at the end)."""
        resp = await self.router._client.request("POST", url, json_body=body,
                                                  headers=headers, timeout=600)
        try:
            if resp.status != 200:
                raise RuntimeError(f"upstream HTTP {resp.status}")
            async for raw in _lines(resp.iter_chunks()):
                line = raw.decode(errors="replace").strip()
                if not line.startswith("data:"):
                    continue
                payload = line[5:].strip()
                if payload == "[DONE]":
                    yield None
                    return
                try:
                    yield json.loads(payload)
                except json.JSONDecodeError:
                    continue
        finally:
            resp.close()
        yield None

    async def _embed(self, req: pb.EmbedRequest, context) -> pb.EmbedResponse:
        self.metrics["embed_total"] += 1
        body = {"model": req.model, "input": req.input}
        ireq = self._parse("/v1/embeddings", body)
        t0 = time.monotonic()
        result = await self._admit(ireq, context)
        target = result.endpoint
        try:
            out = await self._post_json(f"http://{target.address}/v1/embeddings", body,
                                        self._fwd_headers(ireq, result))
        except Exception as e:
            self.metrics["errors_total"] += 1
            # release the inflight counters pre_request incremented
            self._post(ireq, target, t0, 502, error=str(e))
            context.abort(StatusCode.UNAVAILABLE, f"upstream: {e}")
        self._post(ireq, target, t0, 200, usage=out.get("usage", {}))
        emb = (out.get("data") or [{}])[0].get("embedding", [])
        return pb.EmbedResponse(request_id=req.request_id or ireq.request_id,
                                embedding=emb, endpoint=target.address)


async def _lines(chunks: AsyncIterator[bytes]) -> AsyncIterator[bytes]:
    """The lines of a body as it arrives (a line may span chunks; the last
    may end without a newline)."""
    buf = b""
    async for chunk in chunks:
        buf += chunk
        *lines, buf = buf.split(b"\n")
        for line in lines:
            yield line + b"\n"
    if buf:
        yield buf
