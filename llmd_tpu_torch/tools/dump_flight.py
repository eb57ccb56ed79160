"""Render flight-recorder timelines from a live server or a dump file (the
port's copy of ``tools/dump_flight.py``: the same flags, output and exit
codes, the ledgers built by ``llmd_tpu_torch.obs``).

The flight recorder (llmd_tpu_torch/obs/events.py) keeps a bounded ring of
per-request event timelines on both the router and every engine pod,
exposed at ``/debug/requests`` (summaries) and ``/debug/requests/<id>``
(full timeline). This CLI renders either view human-readably, from a live
server URL or from a previously saved JSON dump (``--save`` writes one).

Usage:
  # list recent requests on a live server (router or engine pod)
  python -m llmd_tpu_torch.tools.dump_flight http://localhost:8000

  # filter: slow finished requests only
  python -m llmd_tpu_torch.tools.dump_flight http://localhost:8000 \
      --status finished --min-latency-ms 500 --limit 20

  # one request's full timeline
  python -m llmd_tpu_torch.tools.dump_flight http://localhost:8000 --id 1a2b3c...

  # where did the time go: phase-attribution ledger per request
  python -m llmd_tpu_torch.tools.dump_flight http://localhost:8000 --id 1a2b3c... --phases

  # why did we route here, and was it right: decision ledger per request
  python -m llmd_tpu_torch.tools.dump_flight http://localhost:8000 --id 1a2b3c... --decisions

  # correlate a trace with its flight timeline(s): every request that
  # carried this W3C trace id, rendered as full timelines. Render flags
  # compose: one invocation can select by trace AND append both ledgers
  python -m llmd_tpu_torch.tools.dump_flight http://localhost:8000 --trace 4bf92f35... \
      --phases --decisions

  # snapshot to a file, render offline later
  python -m llmd_tpu_torch.tools.dump_flight http://localhost:8000 --save flight.json
  python -m llmd_tpu_torch.tools.dump_flight flight.json
  python -m llmd_tpu_torch.tools.dump_flight flight.json --id 1a2b3c...
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.parse
import urllib.request


def _fetch(url: str, timeout: float) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read())


def _load(source: str, args: argparse.Namespace) -> dict:
    """Source is a server base URL or a dump-file path. Returns the
    ``/debug/requests`` list payload shape: {"requests": [...], "system": [...]}
    (single-record dumps are wrapped)."""
    if source.startswith("http://") or source.startswith("https://"):
        base = source.rstrip("/")
        if args.id:
            rec = _fetch(f"{base}/debug/requests/{urllib.parse.quote(args.id)}",
                         args.timeout)
            return {"requests": [rec], "system": []}
        query = {}
        if args.status:
            query["status"] = args.status
        if args.model:
            query["model"] = args.model
        if args.min_latency_ms is not None:
            query["min_latency_ms"] = str(args.min_latency_ms)
        if args.trace:
            query["trace"] = args.trace
        query["limit"] = str(args.limit)
        qs = urllib.parse.urlencode(query)
        payload = _fetch(f"{base}/debug/requests?{qs}", args.timeout)
        if args.trace:
            # trace correlation renders full timelines: fetch each matching
            # request's detail (summaries carry no events)
            details = []
            for r in payload.get("requests", []):
                rid = r.get("request_id", "")
                try:
                    details.append(_fetch(
                        f"{base}/debug/requests/{urllib.parse.quote(rid)}",
                        args.timeout))
                except Exception:
                    details.append(r)  # evicted between list and detail
            payload["requests"] = details
        return payload
    with open(source) as f:
        data = json.load(f)
    if isinstance(data, dict) and "requests" in data:
        return data
    if isinstance(data, list):
        return {"requests": data, "system": []}
    return {"requests": [data], "system": []}  # single-record dump


def _fmt_attrs(ev: dict) -> str:
    return " ".join(f"{k}={ev[k]}" for k in ev
                    if k not in ("event", "t_ms", "t_unix"))


def render_timeline(rec: dict, out=sys.stdout, phases: bool = False,
                    decisions: bool = False) -> None:
    print(f"request {rec.get('request_id')}  model={rec.get('model') or '-'}  "
          f"tenant={rec.get('tenant') or '-'}  "
          f"status={rec.get('status')}  latency={rec.get('latency_ms')}ms  "
          f"trace={rec.get('trace_id') or '-'}", file=out)
    if rec.get("finish_reason"):
        print(f"  finish_reason: {rec['finish_reason']}", file=out)
    if rec.get("events_dropped"):
        print(f"  ({rec['events_dropped']} events dropped past the "
              f"per-request cap)", file=out)
    for ev in rec.get("events", []):
        print(f"  {ev['t_ms']:>10.3f}ms  {ev['event']:<18} {_fmt_attrs(ev)}",
              file=out)
    if phases:
        render_phases(rec, out=out)
    if decisions:
        render_decisions(rec, out=out)


def render_phases(rec: dict, out=sys.stdout) -> None:
    """Phase-attribution ledger table (obs/attribution.py): which lifecycle
    phases the request's wall clock went to, residual included. Works on
    detail payloads (events present) computed locally, so offline dumps and
    older servers without the embedded ledger both render."""
    from llmd_tpu_torch.obs.attribution import build_ledger

    if not rec.get("events"):
        print("  (no events: phase ledger unavailable — summaries carry no "
              "timeline; use --id or --trace for detail records)", file=out)
        return
    ledger = rec.get("phase_ledger") or build_ledger(rec)
    total = sum(ledger["phases"].values()) + ledger["residual_ms"]
    print(f"  phase ledger ({ledger['plane']} plane, "
          f"wall {ledger['wall_ms']}ms):", file=out)
    rows = sorted(ledger["phases"].items(), key=lambda kv: -kv[1])
    rows.append(("unattributed (residual)", ledger["residual_ms"]))
    for phase, ms in rows:
        pct = 100.0 * ms / total if total > 0 else 0.0
        print(f"    {phase:<26} {ms:>12.3f}ms  {pct:>5.1f}%", file=out)


def render_decisions(rec: dict, out=sys.stdout) -> None:
    """Decision-ledger table (obs/decisions.py): why routing picked this
    endpoint, whether the predictor was calibrated, and whether the KV/spec
    levers paid. Computed locally from events when the server didn't embed
    one, so offline dumps and older servers both render."""
    from llmd_tpu_torch.obs.decisions import build_decision

    if not rec.get("events"):
        print("  (no events: decision ledger unavailable — summaries carry "
              "no timeline; use --id or --trace for detail records)", file=out)
        return
    ledger = rec.get("decision") or build_decision(rec)
    if ledger is None:
        print("  (no decision ledger: recorded with LLMD_DECISION_LEDGER "
              "off, or nothing decision-relevant happened)", file=out)
        return
    if ledger["plane"] == "router":
        resched = ledger.get("reschedules") or {}
        print(f"  decision ledger (router plane): "
              f"schedules={ledger.get('schedules')} "
              f"retries={resched.get('retry', 0)} "
              f"hedges={resched.get('hedge', 0)} "
              f"regret={ledger.get('regret', '-')} "
              f"slo_breached={ledger.get('slo_breached')}", file=out)
        for key in ("excluded", "resilience_dropped", "kv_plane"):
            if ledger.get(key):
                print(f"    {key}: {ledger[key]}", file=out)
        for name, prof in (ledger.get("profiles") or {}).items():
            print(f"    profile {name}: candidates={prof.get('candidates')} "
                  f"tie={prof.get('tie')} chosen={prof.get('chosen', '-')} "
                  f"regret={prof.get('regret', '-')}", file=out)
            for fname, dropped in prof.get("filters") or []:
                print(f"      filter {fname}: dropped {dropped}", file=out)
            for addr, score in prof.get("top") or []:
                parts = (prof.get("breakdown") or {}).get(addr)
                detail = (" (" + ", ".join(f"{k}={v}"
                                           for k, v in parts.items()) + ")"
                          if parts else "")
                print(f"      {addr:<24} {score:>8.4f}{detail}", file=out)
        calib = ledger.get("calibration")
        if calib:
            print("    predictor calibration:", file=out)
            for obj in ("ttft", "e2e"):
                if f"{obj}_error_ms" in calib:
                    print(f"      {obj}: predicted="
                          f"{calib.get(f'{obj}_predicted_ms')}ms observed="
                          f"{calib.get(f'{obj}_observed_ms')}ms error="
                          f"{calib[f'{obj}_error_ms']:+}ms", file=out)
        kv = ledger.get("kv")
        if kv:
            print(f"    kv lever: stamped={kv.get('stamped')} "
                  f"blocks={kv.get('blocks')} "
                  f"saved_tokens_est={kv.get('saved_tokens_est')}", file=out)
    else:
        print("  decision ledger (engine plane):", file=out)
        spec = ledger.get("spec")
        if spec:
            print(f"    spec lever: drafted={spec.get('drafted')} "
                  f"accepted={spec.get('accepted')} "
                  f"wasted={spec.get('wasted')} flips={spec.get('flips')}",
                  file=out)
        kv = ledger.get("kv")
        if kv:
            print(f"    kv lever: outcome={kv.get('outcome')} "
                  f"blocks={kv.get('blocks')} pull_ms={kv.get('ms')}",
                  file=out)
        if ledger.get("cached_tokens"):
            print(f"    cached_tokens: {ledger['cached_tokens']}", file=out)


def render_list(payload: dict, out=sys.stdout) -> None:
    rows = payload.get("requests", [])
    if not rows:
        print("no requests recorded", file=out)
        return
    print(f"{'request_id':<34} {'model':<12} {'status':<10} "
          f"{'latency_ms':>11} {'events':>6}  finish_reason", file=out)
    for r in rows:
        print(f"{r.get('request_id', ''):<34} {r.get('model') or '-':<12} "
              f"{r.get('status', ''):<10} {r.get('latency_ms', 0):>11.1f} "
              f"{r.get('n_events', 0):>6}  {r.get('finish_reason') or ''}",
              file=out)
    system = payload.get("system", [])
    if system:
        print(f"\nsystem events ({len(system)}):", file=out)
        for ev in system[-20:]:
            print(f"  t={ev.get('t_unix')}  {ev['event']:<12} "
                  f"{_fmt_attrs(ev)}", file=out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Render flight-recorder request timelines")
    ap.add_argument("source",
                    help="server base URL (http://host:port) or dump file")
    ap.add_argument("--id", help="render one request's full timeline")
    ap.add_argument("--trace",
                    help="render full timelines of every request carrying "
                         "this trace id (trace ↔ timeline correlation)")
    ap.add_argument("--status",
                    help="filter: active|finished|aborted|rejected|error")
    ap.add_argument("--model", help="filter by model name")
    ap.add_argument("--min-latency-ms", type=float, default=None,
                    help="filter: e2e (or age-so-far) at least this")
    ap.add_argument("--phases", action="store_true",
                    help="append the phase-attribution ledger (where the "
                         "wall clock went, residual included) to each "
                         "rendered timeline")
    ap.add_argument("--decisions", action="store_true",
                    help="append the decision ledger (why routing chose "
                         "this endpoint, predictor calibration, KV/spec "
                         "lever economics) to each rendered timeline; "
                         "composes with --phases and --trace")
    ap.add_argument("--limit", type=int, default=100)
    ap.add_argument("--timeout", type=float, default=10.0)
    ap.add_argument("--save", metavar="PATH",
                    help="write the raw JSON payload to PATH instead of "
                         "rendering")
    args = ap.parse_args(argv)

    try:
        payload = _load(args.source, args)
    except Exception as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if args.save:
        with open(args.save, "w") as f:
            json.dump(payload, f, indent=2)
        print(f"wrote {args.save}")
        return 0
    recs, err = select_records(payload, args)
    if err:
        print(f"error: {err}", file=sys.stderr)
        return 1
    if args.id or args.trace or args.phases or args.decisions:
        # timeline mode: one shared selection, composable render flags —
        # --phases and --decisions each append their ledger per record
        if args.trace:
            print(f"trace {args.trace}: {len(recs)} request(s)")
        for rec in recs:
            render_timeline(rec, phases=args.phases,
                            decisions=args.decisions)
    else:
        render_list(payload)
    return 0


def select_records(payload: dict, args: argparse.Namespace):
    """Shared record-selection path for every render mode: ``--id`` picks
    one record, ``--trace`` filters by trace id (offline dumps filter here;
    live payloads arrive pre-filtered and already carry full timelines),
    otherwise every record. Returns (records, error)."""
    rows = payload.get("requests", [])
    if args.id:
        recs = [r for r in rows if r.get("request_id") == args.id] or rows[:1]
        if not recs:
            return [], f"request {args.id!r} not found"
        return recs[:1], None
    if args.trace:
        recs = [r for r in rows if r.get("trace_id") == args.trace]
        if not recs:
            return [], f"no request carries trace {args.trace!r}"
        return recs, None
    return rows, None


if __name__ == "__main__":
    sys.exit(main())
