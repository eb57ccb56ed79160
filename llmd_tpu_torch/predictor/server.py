"""Latency-predictor sidecars: training server + prediction server (port of
``llmd_tpu/predictor/server.py`` on ``router/http.py``'s asyncio server, where
the reference serves with aiohttp).

Deployment shape per reference latency-predictor.md:22-57: both run next to the EPP;
the training server ingests completed-request samples and periodically refits,
writing the model to a shared volume; N prediction servers watch that file and answer
the EPP's hot-path /predict calls (scale-out table :99-107).

API (routes, bodies, status codes and ``/metrics`` lines as the reference's):
  training server:   POST /samples {"samples": [{...feature/latency fields...}]}
                     GET  /model/info
  prediction server: POST /predict {"samples": [{...feature fields...}]}
                     → {"predictions": [{"ttft_ms": x|null, "tpot_ms": y|null}]}
  both:              GET /health, GET /metrics

    python -m llmd_tpu_torch.predictor.server --role training --model-path m.pkl --port 8010
    python -m llmd_tpu_torch.predictor.server --role prediction --model-path m.pkl --port 8011
"""

from __future__ import annotations

import asyncio
import os
import time
from typing import Optional, Sequence

from llmd_tpu_torch.predictor.model import LatencyModel, LatencySample, StratifiedWindow
from llmd_tpu_torch.router.http import HTTPServer, Request, Response, json_response

_SAMPLE_FIELDS = (
    "kv_usage", "input_len", "queue_depth", "running_requests",
    "prefix_match_pct", "inflight_tokens", "tokens_generated", "ttft_ms", "tpot_ms",
)


def sample_from_dict(d: dict) -> LatencySample:
    return LatencySample(**{k: d[k] for k in _SAMPLE_FIELDS if d.get(k) is not None})


def _text(body: str) -> Response:
    return Response(body.encode(), content_type="text/plain; charset=utf-8")


class TrainingServer:
    """Ingests samples into the stratified window; refits on an interval."""

    def __init__(self, model_path: str, host: str = "127.0.0.1", port: int = 0,
                 retrain_interval_s: float = 5.0, per_bucket_cap: int = 256) -> None:
        self.model_path = model_path
        self.host, self.port = host, port
        self.retrain_interval = retrain_interval_s
        self.window = StratifiedWindow(per_bucket_cap)
        self.model = LatencyModel()
        self.samples_total = 0
        self._front: Optional[HTTPServer] = None
        self._task: Optional[asyncio.Task] = None

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    async def start(self) -> None:
        front = HTTPServer()
        front.add_route("POST", "/samples", self._samples)
        front.add_route("GET", "/model/info", self._info)
        front.add_route("GET", "/health", self._health)
        front.add_route("GET", "/metrics", self._metrics)
        self.port = await front.start(self.host, self.port)
        self._front = front
        self._task = asyncio.get_running_loop().create_task(self._retrain_loop())

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
        if self._front:
            await self._front.stop()

    async def retrain_now(self) -> bool:
        """One fit cycle (also used by tests to avoid sleeping out the interval)."""
        samples = self.window.snapshot()
        if not samples:
            return False
        loop = asyncio.get_running_loop()
        fitted = await loop.run_in_executor(None, self.model.fit, samples)
        if fitted:
            await loop.run_in_executor(None, self.model.save, self.model_path)
        return fitted

    async def _retrain_loop(self) -> None:
        while True:
            await asyncio.sleep(self.retrain_interval)
            try:
                await self.retrain_now()
            except Exception:  # noqa: BLE001 — a bad fit cycle must not kill ingestion
                pass

    async def _samples(self, request: Request):
        try:
            body = await request.json()
        except Exception:  # noqa: BLE001 — any unparseable body is the client's 400
            return json_response({"error": "invalid JSON"}, status=400)
        rows = body.get("samples", [])
        for d in rows:
            self.window.add(sample_from_dict(d))
        self.samples_total += len(rows)
        return json_response({"accepted": len(rows), "window": len(self.window)})

    async def _info(self, request: Request):
        return json_response({
            "version": self.model.version, "train_count": self.model.train_count,
            "mape": self.model.mape, "window": len(self.window),
        })

    async def _health(self, request: Request):
        return json_response({"status": "ok"})

    async def _metrics(self, request: Request):
        lines = [
            f"llmd_tpu:predictor_samples_total {self.samples_total}",
            f"llmd_tpu:predictor_window_size {len(self.window)}",
            f"llmd_tpu:predictor_model_version {self.model.version}",
        ]
        for k, v in self.model.mape.items():
            if v is not None:
                lines.append(f'llmd_tpu:predictor_mape{{target="{k}"}} {v:.6f}')
        return _text("\n".join(lines) + "\n")


class PredictionServer:
    """Serves /predict from the newest model on the shared volume (mtime watch)."""

    def __init__(self, model_path: str, host: str = "127.0.0.1", port: int = 0,
                 reload_interval_s: float = 2.0) -> None:
        self.model_path = model_path
        self.host, self.port = host, port
        self.reload_interval = reload_interval_s
        self.model: Optional[LatencyModel] = None
        self._mtime = 0.0
        self._last_check = 0.0
        self.predictions_total = 0
        self._front: Optional[HTTPServer] = None

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def _maybe_reload(self) -> None:
        now = time.monotonic()
        if now - self._last_check < self.reload_interval and self.model is not None:
            return
        self._last_check = now
        try:
            mtime = os.path.getmtime(self.model_path)
        except OSError:
            return
        if mtime > self._mtime:
            try:
                self.model = LatencyModel.load(self.model_path)
                self._mtime = mtime
            except Exception:  # noqa: BLE001 — half-written file (save is atomic, but be defensive)
                pass

    async def start(self) -> None:
        front = HTTPServer()
        front.add_route("POST", "/predict", self._predict)
        front.add_route("GET", "/health", self._health)
        front.add_route("GET", "/metrics", self._metrics)
        self.port = await front.start(self.host, self.port)
        self._front = front

    async def stop(self) -> None:
        if self._front:
            await self._front.stop()

    async def _predict(self, request: Request):
        try:
            body = await request.json()
        except Exception:  # noqa: BLE001 — any unparseable body is the client's 400
            return json_response({"error": "invalid JSON"}, status=400)
        self._maybe_reload()
        samples = [sample_from_dict(d) for d in body.get("samples", [])]
        self.predictions_total += len(samples)
        if self.model is None or not self.model.is_fit():
            return json_response({"predictions": None, "reason": "model not ready"},
                                 status=503)
        preds = self.model.predict(samples)
        return json_response({"predictions": [
            {"ttft_ms": t, "tpot_ms": p} for t, p in preds
        ]})

    async def _health(self, request: Request):
        ok = self.model is not None
        return json_response({"status": "ok" if ok else "no model"},
                             status=200 if ok else 503)

    async def _metrics(self, request: Request):
        v = self.model.version if self.model else 0
        return _text(
            f"llmd_tpu:predictor_predictions_total {self.predictions_total}\n"
            f"llmd_tpu:predictor_loaded_model_version {v}\n"
        )


def main(argv: Optional[Sequence[str]] = None) -> None:
    """CLI: one sidecar per process, the deployment's shape (a training
    server and N prediction servers on one shared model file)."""
    import argparse

    ap = argparse.ArgumentParser(prog="python -m llmd_tpu_torch.predictor.server")
    ap.add_argument("--role", choices=("training", "prediction"), required=True)
    ap.add_argument("--model-path", required=True, help="the shared model file")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--retrain-interval", type=float, default=5.0)
    ap.add_argument("--reload-interval", type=float, default=2.0)
    args = ap.parse_args(argv)
    if args.role == "training":
        srv = TrainingServer(args.model_path, args.host, args.port,
                             retrain_interval_s=args.retrain_interval)
    else:
        srv = PredictionServer(args.model_path, args.host, args.port,
                               reload_interval_s=args.reload_interval)

    async def run() -> None:
        await srv.start()
        print(f"llmd-tpu {args.role} predictor on http://{srv.address}", flush=True)
        await asyncio.Event().wait()

    asyncio.run(run())


if __name__ == "__main__":
    main()
