"""Request latency attribution: flight timeline -> canonical phase ledger
(copy of ``llmd_tpu/obs/attribution.py``).

The flight recorder (``obs/events.py``) says what happened to a request; this
module says where the time went. At retirement each timeline folds into a
phase ledger (queue_wait, schedule, kv_pull, prefill, decode against
decode_overlap, chain_stage, spec, preempted, and the router's phases) whose
entries sum to the wall clock by construction: every interval between events
is attributed to exactly one phase, and what the transition maps do not
recognise lands in ``unattributed``, a real series for latency sources the
maps do not know yet.

``build_ledger`` folds the ``to_dict()`` record shape, so one function serves
the live exporter (``FlightRecorder.on_finish``) and the
``/debug/requests/<id>`` detail view.
"""

from __future__ import annotations

from typing import Callable

__all__ = ["PHASES", "build_ledger", "attach_phase_exporter"]

# Canonical phase vocabulary: the label values of
# llmd_tpu:request_phase_seconds, as the reference's.
PHASES = (
    "flow",           # router: parse + flow-control admission bookkeeping
    "queue_wait",     # router flow queue / engine waiting queue
    "schedule",       # scheduler pick / admission → first compute
    "retry",          # router: backoff + re-pick after a failed attempt
    "hedge",          # router: racing a hedged second attempt
    "upstream",       # router: time spent inside the forwarded engine call
    "kv_pull",        # cross-engine prefix pull ahead of admission
    "prefill",        # prompt computation
    "decode",         # serialized decode steps (host pack on the hot path)
    "decode_overlap", # chained decode: host pack hidden behind device call
    "chain_stage",    # dense grammar/bias table staging for a masked chain
    "spec",           # speculative draft + verify steps
    "preempted",      # unscheduled, waiting for re-admission
    "unattributed",   # interval after an event the maps don't know
)

# Events only the router plane emits — their presence selects the router
# transition map (the two planes share "arrival" with different meanings).
_ROUTER_ONLY = {"flow_enqueue", "flow_dispatch", "flow_reject",
                "routing_decision", "kv_pull_stamped", "forward", "response",
                "retry", "hedge", "slo_breach"}

_TERMINAL = {"response", "rejected", "error", "retired", "aborted"}

# state maps: the interval AFTER event X belongs to phase MAP[X].
_ROUTER_MAP = {
    "arrival": "flow",
    "flow_enqueue": "queue_wait",
    "flow_dispatch": "schedule",
    "routing_decision": "schedule",
    "kv_pull_stamped": "schedule",
    "forward": "upstream",
    "retry": "retry",
    "hedge": "upstream",
    "deadline_exceeded": "unattributed",
    "slo_breach": "unattributed",
}

_ENGINE_MAP = {
    "arrival": "queue_wait",
    "structured_compile": "queue_wait",
    "kv_pull": "queue_wait",
    "kv_reload": "schedule",
    "admitted": "schedule",
    "prefill_start": "prefill",
    "prefill_end": "prefill",
    "first_token": "decode",
    "decode": "decode",
    "structured_mask": "decode",
    "chain_dispatch": "decode_overlap",
    "spec_draft": "spec",
    "spec_verify": "spec",
    "preempted": "preempted",
}

# leading interval (record open → first event), keyed by the FIRST event:
# a record opened by the prefix pull attributes its lead-in to kv_pull.
_LEAD_MAP = {
    "kv_pull": "kv_pull",
    "arrival": "flow",  # router parse → arrival stamp (engine overridden below)
}


def _phase_of(event: dict, state_map: dict) -> str:
    name = event.get("event", "")
    phase = state_map.get(name)
    if phase is None:
        return "unattributed"
    if name == "chain_dispatch" and event.get("masked"):
        # masked chains stage dense grammar/bias tables before dispatch —
        # the chain_stage cost, distinct from plain pack overlap
        return "chain_stage"
    return phase


def build_ledger(rec: dict) -> dict:
    """Fold one flight record (``to_dict()`` shape) into a phase ledger.

    Returns ``{"plane", "wall_ms", "phases": {phase: ms}, "residual_ms",
    "residual_frac"}``. Invariant: ``sum(phases.values()) + residual_ms ==
    wall_ms`` exactly (up to float noise) — intervals partition the timeline
    and the residual is the tail past the last event plus nothing else.
    """
    events = [e for e in rec.get("events", []) if "t_ms" in e]
    events.sort(key=lambda e: e["t_ms"])
    plane = ("router" if any(e.get("event") in _ROUTER_ONLY for e in events)
             else "engine")
    state_map = _ROUTER_MAP if plane == "router" else _ENGINE_MAP
    wall_ms = float(rec.get("latency_ms") or 0.0)
    phases: dict[str, float] = {}

    def add(phase: str, ms: float) -> None:
        if ms > 0:
            phases[phase] = phases.get(phase, 0.0) + ms

    if events:
        # record open → first event
        first = events[0]
        lead_phase = _LEAD_MAP.get(first.get("event", ""), "unattributed")
        if plane == "engine" and first.get("event") == "arrival":
            lead_phase = "queue_wait"
        add(lead_phase, first["t_ms"])
        # event[i] → event[i+1]
        for prev, nxt in zip(events, events[1:]):
            add(_phase_of(prev, state_map), nxt["t_ms"] - prev["t_ms"])
        # last event → wall clock: for a terminal event this is finish
        # bookkeeping (≈0); for an active record it's the current state
        last = events[-1]
        tail = wall_ms - last["t_ms"]
        if last.get("event") in _TERMINAL:
            residual_ms = max(0.0, tail)
        else:
            add(_phase_of(last, state_map), tail)
            residual_ms = 0.0
    else:
        residual_ms = wall_ms
    # anything that fell into the explicit unattributed phase is residual too:
    # one series for the unknown-unknown detector
    residual_ms += phases.pop("unattributed", 0.0)
    return {
        "plane": plane,
        "wall_ms": round(wall_ms, 3),
        "phases": {k: round(v, 3) for k, v in phases.items()},
        "residual_ms": round(residual_ms, 3),
        "residual_frac": round(residual_ms / wall_ms, 4) if wall_ms > 0 else 0.0,
    }


def attach_phase_exporter(flight, histogram) -> Callable[[dict], None]:
    """Wire a FlightRecorder's ``on_finish`` hook to a
    ``llmd_tpu:request_phase_seconds{phase, tenant, model}`` histogram.

    Every retired request's ledger is exported phase by phase, with the
    residual as its own ``phase="unattributed"`` series. The hook must never
    take down retirement: any failure is swallowed."""

    def _export(rec: dict) -> None:
        try:
            ledger = build_ledger(rec)
            tenant = rec.get("tenant") or "anon"
            model = rec.get("model") or ""
            for phase, ms in ledger["phases"].items():
                histogram.labels(phase=phase, tenant=tenant,
                                 model=model).observe(ms / 1e3)
            histogram.labels(phase="unattributed", tenant=tenant,
                             model=model).observe(ledger["residual_ms"] / 1e3)
        except Exception:
            pass

    flight.on_finish = _export
    return _export
