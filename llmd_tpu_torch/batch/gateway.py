"""Batch Gateway — OpenAI Files + Batches API over the router (copy of
``llmd_tpu/batch/gateway.py`` on ``router/http.py``: the same routes, codes
and bodies; the HTTP front and the dispatch client are the port's
``HTTPServer`` and ``HTTPClient`` where the reference uses aiohttp).

Parity: reference `llm-d/llm-d-batch-gateway` as specified in
`docs/architecture/advanced/batch/batch-gateway.md:11-87` (SURVEY §2.6 A3):
- REST surface: `/v1/files` (upload/fetch/content/delete) + `/v1/batches`
  (create/get/list/cancel), OpenAI Batch schema.
- Storage split: FS object store (S3 stand-in, tenant-hashed paths) +
  SQLite metadata (PostgreSQL stand-in) + in-process priority queue ordered by
  SLO priority (Redis sorted-set stand-in).
- Processor: poll → ingest (validate JSONL, count, extract model) → per-model
  workers bounded by global AND per-model concurrency caps → finalize (write
  output/error files, terminal status).
- Crash recovery: startup scan re-queues every non-terminal batch
  (`batch-gateway.md:55-59`).
- GC of aged terminal batches; tenant isolation via header + hashed paths;
  authN at the batch route (bearer key), authZ left to the inference path.

Where it departs from the reference: a ``multipart/*`` upload whose body does
not follow RFC 2046's framing answers 400 (aiohttp's reader raises into its
server, a 500); ``stop`` cancels the batch runs in flight, as a crash would,
so their rows stay non-terminal for the next gateway's recovery scan (the
reference's runs outlive its stop and dispatch on a closed session).
"""

from __future__ import annotations

import asyncio
import json
import time
import uuid
from dataclasses import dataclass
from typing import Optional

from llmd_tpu_torch.batch.files import FileStore, validate_batch_input
from llmd_tpu_torch.batch.store import BatchRow, BatchStore
from llmd_tpu_torch.router.http import (HTTPClient, HTTPServer, MultipartError, Request,
                                        Response, json_response, parse_multipart)

TENANT_HEADER = "x-llm-d-tenant"  # reference: tenant from auth header
MAX_BODY = 256 * 1024 * 1024  # the reference's aiohttp ``client_max_size``


def _window_seconds(window: str) -> float:
    try:
        if window.endswith("h"):
            return float(window[:-1]) * 3600
        if window.endswith("m"):
            return float(window[:-1]) * 60
        if window.endswith("s"):
            return float(window[:-1])
    except ValueError:
        pass
    return 24 * 3600


@dataclass
class BatchGatewayConfig:
    target_url: str = "http://127.0.0.1:8000"  # the llm-d Router
    files_root: str = "/tmp/llmd-batch-files"
    store_path: str = ":memory:"
    global_concurrency: int = 8     # cap across all models
    per_model_concurrency: int = 4  # cap per model
    poll_interval_s: float = 0.05
    gc_interval_s: float = 3600.0
    retention_s: float = 30 * 24 * 3600
    api_key: Optional[str] = None   # authN at the batch route; None = open
    request_timeout_s: float = 120.0


def _body_json(data: bytes):
    """aiohttp's ``json(content_type=None)``: None for a blank body."""
    text = data.decode("utf-8")
    return json.loads(text) if text.strip() else None


class BatchGateway:
    def __init__(self, cfg: BatchGatewayConfig, host: str = "127.0.0.1",
                 port: int = 0) -> None:
        self.cfg = cfg
        self.host, self.port = host, port
        self.files = FileStore(cfg.files_root)
        self.store = BatchStore(cfg.store_path)
        self._queue: asyncio.PriorityQueue = asyncio.PriorityQueue()
        self._global_sem = asyncio.Semaphore(cfg.global_concurrency)
        self._model_sems: dict[str, asyncio.Semaphore] = {}
        self._cancel_requested: set[str] = set()
        self._tasks: list[asyncio.Task] = []
        self._running: set[asyncio.Task] = set()
        self._http: Optional[HTTPServer] = None
        self._client: Optional[HTTPClient] = None
        self.stats = {"ingested": 0, "requests_done": 0, "requests_failed": 0,
                      "recovered": 0, "gc_deleted": 0}

    # ------------------------------------------------------------- lifecycle
    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    async def start(self) -> None:
        self._client = HTTPClient()
        # crash recovery scan: everything non-terminal goes back on the queue
        for row in self.store.recovery_scan():
            self.stats["recovered"] += 1
            self._enqueue(row)
        http = HTTPServer(max_body=MAX_BODY)
        http.add_route("POST", "/v1/files", self._upload_file)
        http.add_route("GET", "/v1/files/{file_id}", self._get_file)
        http.add_route("GET", "/v1/files/{file_id}/content", self._get_file_content)
        http.add_route("DELETE", "/v1/files/{file_id}", self._delete_file)
        http.add_route("POST", "/v1/batches", self._create_batch)
        http.add_route("GET", "/v1/batches", self._list_batches)
        http.add_route("GET", "/v1/batches/{batch_id}", self._get_batch)
        http.add_route("POST", "/v1/batches/{batch_id}/cancel", self._cancel_batch)
        http.add_route("GET", "/health", self._health)
        self._http = http
        self.port = await http.start(self.host, self.port)
        loop = asyncio.get_running_loop()
        self._tasks = [loop.create_task(self._process_loop()),
                       loop.create_task(self._gc_loop())]

    async def stop(self) -> None:
        tasks = self._tasks + list(self._running)
        for t in tasks:
            t.cancel()
        for t in tasks:
            try:
                await t
            except asyncio.CancelledError:
                pass
        if self._http:
            await self._http.stop()
        if self._client:
            await self._client.close()

    # ------------------------------------------------------------- HTTP: auth
    def _tenant(self, request: Request) -> Optional[str]:
        if self.cfg.api_key is not None:
            auth = request.headers.get("Authorization", "")
            if auth != f"Bearer {self.cfg.api_key}":
                return None
        return request.headers.get(TENANT_HEADER, "default")

    async def _health(self, request: Request) -> Response:
        return json_response({"status": "ok"})

    # ------------------------------------------------------------ HTTP: files
    async def _upload_file(self, request: Request) -> Response:
        tenant = self._tenant(request)
        if tenant is None:
            return json_response({"error": "unauthorized"}, status=401)
        filename, purpose, data = "file.jsonl", "batch", b""
        if request.content_type.startswith("multipart/"):
            try:
                parts = parse_multipart(request.body, request.headers.get("content-type"))
                for part in parts:
                    if part.name == "file":
                        filename = part.filename or filename
                        data = part.data
                    elif part.name == "purpose":
                        purpose = part.data.decode()
            except (MultipartError, UnicodeDecodeError) as e:
                return json_response({"error": f"malformed multipart body: {e}"},
                                     status=400)
        else:
            data = request.body
            filename = request.query.get("filename", filename)
            purpose = request.query.get("purpose", purpose)
        if not data:
            return json_response({"error": "empty file"}, status=400)
        meta = self.files.put(tenant, filename, data, purpose)
        return json_response(meta.to_openai())

    async def _get_file(self, request: Request) -> Response:
        tenant = self._tenant(request)
        if tenant is None:
            return json_response({"error": "unauthorized"}, status=401)
        meta = self.files.get_meta(tenant, request.match_info["file_id"])
        if meta is None:
            return json_response({"error": "not found"}, status=404)
        return json_response(meta.to_openai())

    async def _get_file_content(self, request: Request) -> Response:
        tenant = self._tenant(request)
        if tenant is None:
            return json_response({"error": "unauthorized"}, status=401)
        data = self.files.get_content(tenant, request.match_info["file_id"])
        if data is None:
            return json_response({"error": "not found"}, status=404)
        return Response(body=data, content_type="application/octet-stream")

    async def _delete_file(self, request: Request) -> Response:
        tenant = self._tenant(request)
        if tenant is None:
            return json_response({"error": "unauthorized"}, status=401)
        ok = self.files.delete(tenant, request.match_info["file_id"])
        return json_response({"deleted": ok, "id": request.match_info["file_id"]},
                             status=200 if ok else 404)

    # ---------------------------------------------------------- HTTP: batches
    async def _create_batch(self, request: Request) -> Response:
        tenant = self._tenant(request)
        if tenant is None:
            return json_response({"error": "unauthorized"}, status=401)
        try:
            body = await request.json()
        except json.JSONDecodeError:
            return json_response({"error": "invalid JSON"}, status=400)
        input_file_id = body.get("input_file_id", "")
        endpoint = body.get("endpoint", "/v1/completions")
        if self.files.get_meta(tenant, input_file_id) is None:
            return json_response({"error": "input file not found"}, status=404)
        row = self.store.create(
            tenant, input_file_id, endpoint,
            completion_window=body.get("completion_window", "24h"),
            metadata=body.get("metadata") or {},
            priority=int(body.get("priority", 0)),
        )
        self._enqueue(row)
        return json_response(row.to_openai())

    async def _get_batch(self, request: Request) -> Response:
        tenant = self._tenant(request)
        if tenant is None:
            return json_response({"error": "unauthorized"}, status=401)
        row = self.store.get(request.match_info["batch_id"], tenant)
        if row is None:
            return json_response({"error": "not found"}, status=404)
        return json_response(row.to_openai())

    async def _list_batches(self, request: Request) -> Response:
        tenant = self._tenant(request)
        if tenant is None:
            return json_response({"error": "unauthorized"}, status=401)
        rows = self.store.list(tenant)
        return json_response({"object": "list", "data": [r.to_openai() for r in rows]})

    async def _cancel_batch(self, request: Request) -> Response:
        tenant = self._tenant(request)
        if tenant is None:
            return json_response({"error": "unauthorized"}, status=401)
        row = self.store.get(request.match_info["batch_id"], tenant)
        if row is None:
            return json_response({"error": "not found"}, status=404)
        if row.status in ("validating", "in_progress"):
            row.status = "cancelling"
            self.store.update(row)
            self._cancel_requested.add(row.id)
        return json_response(row.to_openai())

    # -------------------------------------------------------------- processor
    def _enqueue(self, row: BatchRow) -> None:
        # SLO-priority sorted set: higher priority first, FIFO within a level
        self._queue.put_nowait((-row.priority, row.created_at, row.id))

    def _model_sem(self, model: str) -> asyncio.Semaphore:
        if model not in self._model_sems:
            self._model_sems[model] = asyncio.Semaphore(self.cfg.per_model_concurrency)
        return self._model_sems[model]

    async def _process_loop(self) -> None:
        while True:
            _, _, batch_id = await self._queue.get()
            row = self.store.get(batch_id)
            if row is None:
                continue
            if row.status == "cancelling":
                # covers both live cancels and 'cancelling' rows found by the
                # recovery scan (the in-memory cancel set dies with the process)
                row.status = "cancelled"
                self.store.update(row)
                self._cancel_requested.discard(row.id)
                continue
            # 'finalizing' re-runs after a crash mid-finalize (recovery scan);
            # _run_batch resets counts so the re-run can't double-count
            if row.status not in ("validating", "in_progress", "finalizing"):
                continue
            t = asyncio.get_running_loop().create_task(self._run_batch_safe(row))
            self._running.add(t)
            t.add_done_callback(self._running.discard)

    async def _run_batch_safe(self, row: BatchRow) -> None:
        """A crashed batch run must still reach a terminal status — an exception
        swallowed by the fire-and-forget task would strand it non-terminal with
        clients polling forever."""
        try:
            await self._run_batch(row)
        except asyncio.CancelledError:
            raise
        except Exception as exc:
            try:
                row.status = "failed"
                row.errors = json.dumps(
                    [{"message": f"processor error: {type(exc).__name__}: {exc}"}])
                self.store.update(row)
            except Exception:
                pass  # metadata store down too: recovery scan re-runs it on restart

    async def _run_batch(self, row: BatchRow) -> None:
        data = self.files.get_content(row.tenant, row.input_file_id)
        if data is None:
            row.status, row.errors = "failed", json.dumps(
                [{"message": "input file disappeared"}])
            self.store.update(row)
            return
        reqs, errors = validate_batch_input(data)
        if errors:
            # surfaced even when some lines are valid (lenient ingest: valid
            # lines run, rejects are recorded on the batch object)
            row.errors = json.dumps([{"message": e} for e in errors[:100]])
        if not reqs:
            row.status = "failed"
            self.store.update(row)
            return
        row.total = len(reqs)
        row.completed = row.failed = 0  # reset: recovery may re-run this batch
        row.model = next((r["body"].get("model", "") for r in reqs), "")
        row.status = "in_progress"
        self.store.update(row)
        self.stats["ingested"] += 1

        deadline = row.created_at + _window_seconds(row.completion_window)
        results: list[Optional[dict]] = [None] * len(reqs)
        cancelled = False

        async def one(i: int, req: dict) -> None:
            nonlocal cancelled
            model = req["body"].get("model", row.model)
            # Per-model cap OUTSIDE the global cap: a hot model's excess requests
            # queue at their own semaphore without holding global slots, so other
            # models' traffic is never starved by one model's backlog.
            async with self._model_sem(model), self._global_sem:
                # cancellation/expiry checked under the semaphore — every queued
                # request re-evaluates right before its dispatch slot
                if cancelled or row.id in self._cancel_requested:
                    cancelled = True
                    return
                if time.time() > deadline:
                    results[i] = {"error": {"message": "completion window expired"}}
                    return
                results[i] = await self._dispatch(row, req)

        # per-model workers: bounded fan-out under both caps
        await asyncio.gather(*(one(i, r) for i, r in enumerate(reqs)))

        if cancelled:
            row.status = "cancelled"
            self._cancel_requested.discard(row.id)
            self.store.update(row)
            return
        await self._finalize(row, reqs, results)

    async def _dispatch(self, row: BatchRow, req: dict) -> dict:
        url = f"{self.cfg.target_url}{req.get('url', row.endpoint)}"
        try:
            resp = await self._client.request(
                "POST", url, json_body=req["body"],
                headers={TENANT_HEADER: row.tenant,
                         "x-llm-d-inference-objective": "batch"},
                timeout=self.cfg.request_timeout_s)
            try:
                body = _body_json(await resp.read())
            finally:
                resp.close()
            if resp.status == 200:
                self.stats["requests_done"] += 1
                return {"status_code": 200, "body": body}
            self.stats["requests_failed"] += 1
            return {"status_code": resp.status, "body": body,
                    "error": {"message": f"HTTP {resp.status}"}}
        except Exception as exc:  # noqa: BLE001 — any transport error is the line's error
            self.stats["requests_failed"] += 1
            return {"error": {"message": f"{type(exc).__name__}: {exc}"}}

    async def _finalize(self, row: BatchRow, reqs: list[dict],
                        results: list[Optional[dict]]) -> None:
        row.status = "finalizing"
        self.store.update(row)
        out_lines, err_lines = [], []
        for req, res in zip(reqs, results):
            res = res or {"error": {"message": "not executed"}}
            line = {"id": f"batch_req_{uuid.uuid4().hex[:16]}",
                    "custom_id": req["custom_id"],
                    "response": ({"status_code": res["status_code"],
                                  "body": res["body"]}
                                 if "status_code" in res else None),
                    "error": res.get("error")}
            if res.get("status_code") == 200:
                row.completed += 1
                out_lines.append(line)
            else:
                row.failed += 1
                err_lines.append(line)
        if out_lines:
            meta = self.files.put(
                row.tenant, f"{row.id}_output.jsonl",
                "\n".join(json.dumps(l) for l in out_lines).encode(),
                purpose="batch_output")
            row.output_file_id = meta.id
        if err_lines:
            meta = self.files.put(
                row.tenant, f"{row.id}_errors.jsonl",
                "\n".join(json.dumps(l) for l in err_lines).encode(),
                purpose="batch_output")
            row.error_file_id = meta.id
        row.status = "completed" if row.completed or not row.failed else "failed"
        self.store.update(row)

    async def _gc_loop(self) -> None:
        while True:
            await asyncio.sleep(self.cfg.gc_interval_s)
            self.stats["gc_deleted"] += self.store.gc(self.cfg.retention_s)
