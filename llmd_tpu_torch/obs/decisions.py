"""Decision observability, engine plane (the engine's part of
``llmd_tpu/obs/decisions.py``).

The phase ledger (``obs/attribution.py``) says where a request's time went;
the decision ledger says what the engine's levers did for it: speculative
decoding's economics (drafted, accepted and wasted verify positions, the
per-sequence arm / disarm flips), the prefix tokens it reused and the KV
pulls that preceded its admission. ``build_decision`` is a pure fold over
the ``to_dict()`` record shape, so one function serves the live exporter
(chained onto ``FlightRecorder.on_finish`` after the phase exporter) and the
``/debug/requests/<id>`` detail view.

The router plane (routing regret, reschedules, predictor calibration,
``decision_kv_pull_blocks_total``) belongs to the router's registry, and the
router drives port engines unchanged, so it is not here: a record carrying
the router's ``route_decision`` events folds to None.

``LLMD_DECISION_LEDGER``: "1" (default) records ledgers, "0" disables them;
the engine reads it once at construction, so with the ledger off no exporter
is attached and the retire path adds nothing.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

__all__ = ["decisions_enabled", "build_decision", "attach_decision_exporter"]


def decisions_enabled() -> bool:
    """Master switch; components cache this at construction time."""
    return os.environ.get("LLMD_DECISION_LEDGER", "1") not in ("0", "false", "")


def _engine_ledger(events: list) -> Optional[dict]:
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
    """Fold one engine flight record (``to_dict()`` shape) into a decision
    ledger, or None when it carries nothing decision-relevant (ledger off, no
    spec or KV activity) or is a router record."""
    events = rec.get("events") or []
    if any(e.get("event") == "route_decision" for e in events):
        return None  # the router plane's ledger: not the engine's to fold
    return _engine_ledger(events)


def attach_decision_exporter(flight, metrics) -> Callable[[dict], None]:
    """Chain the engine's decision exporter onto ``flight.on_finish``
    (the reference's ``attach_decision_exporter(plane="engine")``).

    ``on_finish`` is a single slot that the phase exporter claims first, so
    this hook forwards to what was installed before it, then counts the
    ledger in ``decision_ledgers{plane="engine"}`` and the speculation
    lever's waste and flips. A failure never takes down retirement."""
    prev = flight.on_finish

    def _export(rec: dict) -> None:
        if prev is not None:
            try:
                prev(rec)
            except Exception:  # noqa: BLE001 — exporters never fail retirement
                pass
        try:
            ledger = build_decision(rec)
            if ledger is None:
                return
            metrics.decision_ledgers.labels(plane=ledger["plane"]).inc()
            spec = ledger.get("spec") or {}
            if spec.get("wasted"):
                metrics.decision_spec_wasted.inc(spec["wasted"])
            if spec.get("flips"):
                metrics.decision_spec_flips.inc(spec["flips"])
        except Exception:  # noqa: BLE001
            pass

    flight.on_finish = _export
    return _export
