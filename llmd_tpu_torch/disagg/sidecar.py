"""Routing sidecar: per-decode-pod proxy orchestrating the P→D multi-step flow
(port of ``llmd_tpu/disagg/sidecar.py`` on ``router/http.py``'s asyncio server
and pooled client, where the reference uses aiohttp).

Parity: reference docs/architecture/advanced/disaggregation/README.md:104-131 and the
deployment shape in recipes/modelserver/base/single-host/pd/vllm/patch-sidecar.yaml —
the sidecar listens on the pod's serving port in front of the local decode engine,
reads the router's ``x-prefiller-host-port`` header, and:

1. sends the request to the prefiller with ``max_tokens=1`` + kv_transfer_params
   ``{do_remote_decode: true}`` (sampling disabled unless ``enable_prefiller_sampling``),
2. captures the returned transfer handle from the prefill response,
3. injects it (``do_remote_prefill``) into the original request and forwards it to the
   local decode engine, streaming the response straight through,
4. falls back to decoder-only (aggregated) when the prefiller fails with 5xx or is
   unreachable (README.md:130).

E/PD and E/P/D (encode disaggregation, guides/multimodal-serving/e-disaggregation/
README.md): with ``encode_hosts`` configured, requests carrying media content
parts first fan those parts out across the encode workers — one worker per item,
concurrently, round-robin — and attach the returned embedding rows as
``mm_items`` before the normal (P→)D flow. Text-only requests skip the E stage
entirely, exactly as the reference specifies.

Every other path (``/health``, ``/v1/models``, ``/metrics``, ...) is proxied
to the decode engine unchanged.

    python -m llmd_tpu_torch.disagg.sidecar --port 8000 --engine 127.0.0.1:8200
"""

from __future__ import annotations

import asyncio
import copy
from typing import Optional, Sequence

from llmd_tpu_torch.core.request import HDR_PREFILLER_HOST_PORT
from llmd_tpu_torch.router.http import (
    HTTPClient,
    HTTPProtocolError,
    HTTPServer,
    Request,
    Response,
    StreamResponse,
    json_response,
)

GEN_PATHS = ("/v1/completions", "/v1/chat/completions")
# what aiohttp's ClientError, OSError and a total timeout cover in the reference
_UPSTREAM_ERRORS = (OSError, HTTPProtocolError, asyncio.TimeoutError)
# hop-by-hop headers the client computes for the forwarded request itself
_HOP_HEADERS = ("host", "content-length", "transfer-encoding", "connection")


class RoutingSidecar:
    def __init__(
        self,
        decode_addr: str,
        host: str = "127.0.0.1",
        port: int = 0,
        enable_prefiller_sampling: bool = False,
        prefill_timeout_s: float = 120.0,
        encode_hosts: Optional[list[str]] = None,
        encode_timeout_s: float = 60.0,
    ) -> None:
        self.decode_addr = decode_addr
        self.host, self.port = host, port
        self.enable_prefiller_sampling = enable_prefiller_sampling
        self.prefill_timeout = prefill_timeout_s
        self.encode_hosts = list(encode_hosts or [])
        self.encode_timeout = encode_timeout_s
        self._encode_rr = 0  # round-robin cursor over the encode pool
        self._front: Optional[HTTPServer] = None
        self._client: Optional[HTTPClient] = None
        self.stats = {"pd_requests": 0, "aggregated_requests": 0,
                      "prefill_fallbacks": 0, "encoded_items": 0,
                      "encode_failures": 0}

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    async def start(self) -> None:
        self._client = HTTPClient()
        front = HTTPServer(max_body=32 * 1024 * 1024)
        for path in GEN_PATHS:
            front.add_route("POST", path, self._generate)
        front.add_route("*", "/{tail:.*}", self._passthrough)
        self.port = await front.start(self.host, self.port)
        self._front = front

    async def stop(self) -> None:
        if self._client:
            await self._client.close()
        if self._front:
            await self._front.stop()

    # ------------------------------------------------------------------
    async def _generate(self, request: Request):
        try:
            body = await request.json()
        except ValueError:
            return json_response({"error": {"message": "invalid JSON"}}, status=400)

        if self.encode_hosts:
            body = await self._run_encode(body)

        prefiller = request.headers.get(HDR_PREFILLER_HOST_PORT)
        if prefiller:
            ktp = await self._run_prefill(request.path, body, prefiller)
            if ktp is not None:
                body = dict(body)
                body["kv_transfer_params"] = {"do_remote_prefill": True, **ktp}
                self.stats["pd_requests"] += 1
            else:
                self.stats["prefill_fallbacks"] += 1
        else:
            self.stats["aggregated_requests"] += 1
        return await self._forward_decode(request, body)

    async def _run_encode(self, body: dict) -> dict:
        """E stage: fan media parts out across the encode pool, one item per
        worker concurrently (the reference's parallelized-across-entries
        property); attach the rows as mm_items. Failures leave the request
        un-annotated — the engine then serves text-only placeholders rather
        than 500ing the whole request (encode is best-effort like prefill)."""
        from llmd_tpu_torch.disagg.encode import iter_media_parts

        parts = list(iter_media_parts(body))
        if not parts or body.get("mm_items"):
            return body  # text-only, or already encoded upstream

        async def one(part: dict) -> Optional[dict]:
            # try up to two distinct workers (round-robin) before giving up on
            # an item; a failed item costs only ITS OWN encode downstream — the
            # successes still attach (partial results beat discarding work)
            for _ in range(min(2, len(self.encode_hosts))):
                host = self.encode_hosts[self._encode_rr % len(self.encode_hosts)]
                self._encode_rr += 1
                resp = None
                try:
                    resp = await self._client.request(
                        "POST", f"http://{host}/v1/encode", json_body={"items": [part]},
                        timeout=self.encode_timeout)
                    if resp.status != 200:
                        continue
                    return (await resp.json())["items"][0]
                except (*_UPSTREAM_ERRORS, ValueError, KeyError, IndexError):
                    continue
                finally:
                    if resp is not None:
                        resp.close()
            return None

        items = await asyncio.gather(*(one(p) for p in parts))
        ok = [i for i in items if i is not None]
        if len(ok) < len(items):
            self.stats["encode_failures"] += len(items) - len(ok)
        self.stats["encoded_items"] += len(ok)
        if ok:
            body = dict(body)
            body["mm_items"] = ok  # engine matches by part hash; missing items
            # re-encode there (tower) or degrade the request to text-only
        return body

    async def _run_prefill(self, path: str, body: dict, prefiller: str) -> Optional[dict]:
        """Phase 1: remote prefill. Returns the transfer handle, or None → fallback."""
        pbody = copy.deepcopy(body)
        pbody["max_tokens"] = 1
        pbody["stream"] = False
        pbody["kv_transfer_params"] = {"do_remote_decode": True}
        if not self.enable_prefiller_sampling:
            pbody["temperature"] = 0.0
        resp = None
        try:
            resp = await self._client.request(
                "POST", f"http://{prefiller}{path}", json_body=pbody,
                timeout=self.prefill_timeout)
            if resp.status >= 500:
                return None
            data = await resp.json()
        except (*_UPSTREAM_ERRORS, ValueError):  # ValueError: not JSON
            return None
        finally:
            if resp is not None:
                resp.close()
        ktp = data.get("kv_transfer_params")
        if not ktp or not ktp.get("remote_request_id"):
            return None
        if not ktp.get("remote_host"):
            ktp["remote_host"] = prefiller.rsplit(":", 1)[0]
        return ktp

    async def _forward_decode(self, request: Request, body: dict):
        """Phase 2: forward to the local decode engine, streaming straight through."""
        upstream = None
        try:
            upstream = await self._client.request(
                "POST", f"http://{self.decode_addr}{request.path}", json_body=body,
                timeout=None)
            if not body.get("stream"):
                payload = await upstream.read()
                return Response(payload, status=upstream.status,
                                content_type=upstream.content_type)
            resp = StreamResponse(status=upstream.status, headers={
                "Content-Type": upstream.headers.get("Content-Type", "text/event-stream"),
                "Cache-Control": "no-cache",
            })
            await resp.prepare(request)
            async for chunk in upstream.iter_chunks():
                await resp.write(chunk)
            await resp.write_eof()
            return resp
        except _UPSTREAM_ERRORS as e:
            return json_response(
                {"error": {"message": f"decode engine unreachable: {e}"}}, status=502)
        finally:
            if upstream is not None:
                upstream.close()

    async def _passthrough(self, request: Request):
        """Non-generate traffic (health, models, metrics) proxied to the engine."""
        upstream = None
        try:
            upstream = await self._client.request(
                request.method, f"http://{self.decode_addr}{request.target}",
                body=request.body or None,
                headers={k: v for k, v in request.headers.items()
                         if k.lower() not in _HOP_HEADERS})
            payload = await upstream.read()
            return Response(payload, status=upstream.status,
                            content_type=upstream.content_type)
        except _UPSTREAM_ERRORS as e:
            return json_response(
                {"error": {"message": f"decode engine unreachable: {e}"}}, status=502)
        finally:
            if upstream is not None:
                upstream.close()


def main(argv: Optional[Sequence[str]] = None) -> None:
    """CLI: python -m llmd_tpu_torch.disagg.sidecar --port 8000 --engine 127.0.0.1:8200

    Deployment entrypoint (reference patch-sidecar.yaml: sidecar on the pod's
    serving port, engine on the local port behind it)."""
    import argparse

    ap = argparse.ArgumentParser(prog="python -m llmd_tpu_torch.disagg.sidecar")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--engine", default="127.0.0.1:8200",
                    help="local decode engine address")
    ap.add_argument("--enable-prefiller-sampling", action="store_true")
    ap.add_argument("--prefill-timeout", type=float, default=120.0)
    ap.add_argument("--encode-hosts", default="",
                    help="comma-separated encode-worker host:port pool (E/PD); "
                         "empty disables the encode stage")
    ap.add_argument("--encode-timeout", type=float, default=60.0)
    args = ap.parse_args(argv)

    sidecar = RoutingSidecar(
        args.engine, host=args.host, port=args.port,
        enable_prefiller_sampling=args.enable_prefiller_sampling,
        prefill_timeout_s=args.prefill_timeout,
        encode_hosts=[h for h in args.encode_hosts.split(",") if h],
        encode_timeout_s=args.encode_timeout,
    )

    async def run() -> None:
        await sidecar.start()
        print(f"llmd-tpu routing sidecar on http://{sidecar.address} "
              f"-> engine {args.engine}", flush=True)
        await asyncio.Event().wait()

    asyncio.run(run())


if __name__ == "__main__":
    main()
