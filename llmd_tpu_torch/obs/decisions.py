"""Decision observability: why routing chose what it chose, and whether it
paid off (copy of ``llmd_tpu/obs/decisions.py``: the router's and the
engine's planes).

The phase ledger (``obs/attribution.py``) says where a request's time went;
this module folds, per request at retirement:

* the routing decision ledger: the scheduler's filter eliminations, the
  weighted per-scorer breakdown for the chosen endpoint and runner-up, the
  picker's tie width, retry and hedge re-schedules, from the router's
  ``route_decision`` flight events;
* predictor calibration: predicted TTFT / e2e stamps joined against the
  observed ones (``llmd_tpu:predictor_calibration_*``);
* lever efficiency: KV-plane pulls stamped by the router, and the engine's
  speculative-decoding economics (drafted, accepted, wasted verify positions,
  arm / disarm flips) and reused prefix tokens, plus the router's regret
  series.

``build_decision`` is a pure fold over the ``to_dict()`` record shape, so one
function serves the live exporter (chained onto ``FlightRecorder.on_finish``
after the phase exporter) and the ``/debug/requests/<id>`` detail view.

Knobs, read once at component construction (with the ledger off, the
scheduler allocates no decision detail and no exporter is attached):

* ``LLMD_DECISION_LEDGER``       "1" (default) records ledgers, "0" disables
* ``LLMD_DECISION_REGRET_TOPK``  ranked candidates kept per profile (3)
* ``LLMD_DECISION_CALIB_WINDOW`` rolling APE window per (objective, model)
"""

from __future__ import annotations

import os
import threading
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

__all__ = [
    "decisions_enabled",
    "regret_topk",
    "calibration_window",
    "build_decision",
    "CalibrationWindows",
    "attach_decision_exporter",
]


def decisions_enabled() -> bool:
    """Master switch; components cache this at construction time."""
    return os.environ.get("LLMD_DECISION_LEDGER", "1") not in ("0", "false", "")


def regret_topk() -> int:
    try:
        return max(1, int(os.environ.get("LLMD_DECISION_REGRET_TOPK", "3")))
    except ValueError:
        return 3


def calibration_window() -> int:
    try:
        return max(8, int(os.environ.get("LLMD_DECISION_CALIB_WINDOW", "256")))
    except ValueError:
        return 256


# ---------------------------------------------------------------------------
# the fold: flight record → decision ledger


def _router_ledger(rec: dict, events: list, schedules: list) -> dict:
    final = schedules[-1]
    ledger: dict = {
        "plane": "router",
        "schedules": len(schedules),
        "reschedules": {
            "retry": sum(1 for e in events if e.get("event") == "retry"),
            "hedge": sum(1 for e in events if e.get("event") == "hedge"),
        },
        "profiles": final.get("profiles") or {},
        "slo_breached": any(e.get("event") == "slo_breach" for e in events),
    }
    if final.get("regret") is not None:
        ledger["regret"] = final["regret"]
    for k in ("resilience_dropped", "excluded", "breakers", "kv_plane", "pd"):
        if final.get(k):
            ledger[k] = final[k]

    # calibration join: the final schedule's predicted stamps vs observed.
    # TTFT only exists on streamed responses; e2e only on a clean finish
    # (a retried/errored wall clock measures the retry loop, not the model).
    calib: dict = {}
    resp = next((e for e in reversed(events)
                 if e.get("event") == "response"), None)
    obs_ttft = resp.get("ttft_ms") if resp else None
    pred_ttft = final.get("predicted_ttft_ms")
    if pred_ttft is not None and obs_ttft is not None:
        calib["ttft_predicted_ms"] = pred_ttft
        calib["ttft_observed_ms"] = obs_ttft
        calib["ttft_error_ms"] = round(float(obs_ttft) - float(pred_ttft), 3)
    pred_e2e = final.get("predicted_e2e_ms")
    wall = rec.get("latency_ms")
    if (pred_e2e is not None and wall
            and rec.get("status") == "finished"
            and not ledger["reschedules"]["retry"]):
        calib["e2e_predicted_ms"] = pred_e2e
        calib["e2e_observed_ms"] = round(float(wall), 3)
        calib["e2e_error_ms"] = round(float(wall) - float(pred_e2e), 3)
    if calib:
        ledger["calibration"] = calib

    # KV lever, router view: pulls the scheduler stamped onto the forward
    stamped = [e for e in events if e.get("event") == "kv_pull_stamped"]
    if stamped:
        ledger["kv"] = {
            "stamped": len(stamped),
            "blocks": sum(int(e.get("blocks") or 0) for e in stamped),
            "saved_tokens_est": sum(int(e.get("saved_tokens_est") or 0)
                                    for e in stamped),
        }
    return ledger


def _engine_ledger(rec: dict, events: list) -> Optional[dict]:
    retired = next((e for e in reversed(events)
                    if e.get("event") == "retired"), None)
    pulls = [e for e in events if e.get("event") == "kv_pull"]
    ledger: dict = {"plane": "engine"}
    if retired is not None:
        drafted = int(retired.get("spec_drafted") or 0)
        flips = int(retired.get("spec_flips") or 0)
        if drafted or flips:
            accepted = int(retired.get("spec_accepted") or 0)
            ledger["spec"] = {
                "drafted": drafted,
                "accepted": accepted,
                "wasted": max(0, drafted - accepted),
                "flips": flips,
            }
        if retired.get("cached_tokens"):
            ledger["cached_tokens"] = int(retired["cached_tokens"])
    if pulls:
        last = pulls[-1]
        ledger["kv"] = {
            "outcome": last.get("outcome"),
            "blocks": sum(int(e.get("blocks") or 0) for e in pulls),
            "ms": round(sum(float(e.get("ms") or 0.0) for e in pulls), 3),
        }
    return ledger if len(ledger) > 1 else None


def build_decision(rec: dict) -> Optional[dict]:
    """Fold one flight record (``to_dict()`` shape) into a decision ledger,
    or None when the record carries nothing decision-relevant (ledger off,
    engine request with no spec/KV activity, pre-decision-plane dump)."""
    events = rec.get("events") or []
    schedules = [e for e in events if e.get("event") == "route_decision"]
    if schedules:
        return _router_ledger(rec, events, schedules)
    return _engine_ledger(rec, events)


# ---------------------------------------------------------------------------
# rolling calibration windows (the APE gauge's backing store)


class CalibrationWindows:
    """Bounded per-(objective, model) windows of absolute percentage errors.

    ``samples()`` is the scrape-time callback body for the
    ``llmd_tpu:predictor_calibration_ape`` gauge's ``set_labels_function`` —
    label sets track whatever (objective, model) pairs actually retired, the
    window bounds memory per pair."""

    def __init__(self, window: Optional[int] = None) -> None:
        self.window = window or calibration_window()
        self._lock = threading.Lock()
        self._w: Dict[Tuple[str, str], deque] = {}

    def add(self, objective: str, model: str,
            observed_ms: float, error_ms: float) -> None:
        ape = abs(float(error_ms)) / max(abs(float(observed_ms)), 1e-6)
        with self._lock:
            d = self._w.get((objective, model))
            if d is None:
                d = deque(maxlen=self.window)
                self._w[(objective, model)] = d
            d.append(ape)

    def samples(self) -> List[Tuple[Dict[str, str], float]]:
        with self._lock:
            return [({"objective": o, "model": m},
                     round(sum(d) / len(d), 6))
                    for (o, m), d in self._w.items() if d]


# ---------------------------------------------------------------------------
# live exporter


def attach_decision_exporter(flight, metrics, plane: str = "router",
                             windows: Optional[CalibrationWindows] = None,
                             ) -> Callable[[dict], None]:
    """Chain a decision exporter onto ``flight.on_finish``.

    ``on_finish`` is a single slot and the phase exporter (attribution.py)
    claims it first, so this hook wraps and forwards to whatever was
    installed before it. Router metrics get regret / calibration / KV
    families; engine metrics get the spec-economics families. The hook must
    never take down retirement: failures are swallowed per stage."""
    prev = flight.on_finish
    if plane == "router":
        windows = windows or CalibrationWindows()
        metrics.predictor_calibration_ape.set_labels_function(windows.samples)

    def _export(rec: dict) -> None:
        if prev is not None:
            try:
                prev(rec)
            except Exception:
                pass
        try:
            ledger = build_decision(rec)
            if ledger is None:
                return
            metrics.decision_ledgers.labels(plane=ledger["plane"]).inc()
            if ledger["plane"] == "router":
                _export_router(rec, ledger)
            else:
                _export_engine(ledger)
        except Exception:
            pass

    def _export_router(rec: dict, ledger: dict) -> None:
        regret = ledger.get("regret")
        if regret is not None:
            breached = "yes" if ledger.get("slo_breached") else "no"
            metrics.decision_regret.labels(slo_breached=breached).observe(
                float(regret))
        for kind, n in (ledger.get("reschedules") or {}).items():
            if n:
                metrics.decision_reschedules.labels(kind=kind).inc(n)
        calib = ledger.get("calibration") or {}
        model = rec.get("model") or ""
        for objective in ("ttft", "e2e"):
            err = calib.get(f"{objective}_error_ms")
            if err is None:
                continue
            metrics.predictor_calibration_error.labels(
                objective=objective, model=model).observe(float(err))
            windows.add(objective, model,
                        calib.get(f"{objective}_observed_ms") or 0.0, err)
        kv = ledger.get("kv") or {}
        if kv.get("blocks"):
            metrics.decision_kv_pull_blocks.inc(kv["blocks"])
        if kv.get("saved_tokens_est"):
            metrics.decision_kv_tokens_saved.inc(kv["saved_tokens_est"])

    def _export_engine(ledger: dict) -> None:
        spec = ledger.get("spec") or {}
        if spec.get("wasted"):
            metrics.decision_spec_wasted.inc(spec["wasted"])
        if spec.get("flips"):
            metrics.decision_spec_flips.inc(spec["flips"])

    flight.on_finish = _export
    return _export
