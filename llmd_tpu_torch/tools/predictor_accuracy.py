"""Predictor accuracy artifact (port of ``tools/predictor_accuracy.py``: both
modes, the same flags, artifact keys and exit codes).

Offline (the default; ``tools/predictor_offline.py``, which holds the engine
run, so this module stays host code for the live mode): serves a
multi-regime workload on the port's engine (on the card; on the CPU with
``--cpu``), trains the port's GBDT latency
predictor (``predictor/model.LatencyModel`` over ``predictor/gbdt.py``) from
the engine-emitted traces (the reference's train-on-live-traffic loop,
docs/architecture/advanced/latency-predictor.md), evaluates on a held-out
interleaved slice, and writes the artifact (``--out``) with TTFT/TPOT MAPE
against the reference's ~5% headline figure (latency-predictor.md:58). Skill
against the constant-mean baseline is the portable claim: absolute latencies
on the CPU jitter with the machine's load. The repo's ``PREDICTOR_ACCURACY.json``
is a TPU-era artifact: a run on the port names its own ``--out``.

Live mode (``--from-metrics URL-or-path``): reads a router ``/metrics`` scrape
(or a saved exposition file) and reports the decision plane's calibration
accounting — the ``llmd_tpu:predictor_calibration_*`` families the live
exporter (obs/decisions.py) folds at every retirement: rolling APE, sample
count and mean signed error per (objective, model).
``tools/decision_check.py`` checks that a scrape of its router folds to a
non-empty result.

Usage: python -m llmd_tpu_torch.tools.predictor_accuracy [--cpu] [--reps 12]
           [--model tiny] [--out PREDICTOR_ACCURACY.json]
       python -m llmd_tpu_torch.tools.predictor_accuracy --from-metrics
           URL-or-path [--out PREDICTOR_ACCURACY.json]
"""

from __future__ import annotations

import argparse
import json
import re
import sys

_CALIB_LINE = re.compile(
    r"^(llmd_tpu:predictor_calibration_(?:ape|error_ms_sum|error_ms_count))"
    r"\{([^}]*)\}\s+([0-9eE+.-]+)\s*$")
_LABEL = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def accuracy_from_metrics(text: str) -> dict:
    """Fold a Prometheus exposition into per-(objective, model) calibration:
    rolling APE (the gauge), sample count, and mean signed error (histogram
    sum/count). Returns {"<objective>/<model>": {...}} — empty when the
    calibration families carried no samples."""
    acc: dict[str, dict] = {}
    for line in text.splitlines():
        m = _CALIB_LINE.match(line.strip())
        if m is None:
            continue
        family, rawlabels, value = m.groups()
        labels = {k: v for k, v in _LABEL.findall(rawlabels)}
        key = f"{labels.get('objective', '?')}/{labels.get('model', '')}"
        entry = acc.setdefault(key, {})
        if family.endswith("_ape"):
            entry["rolling_ape"] = float(value)
        elif family.endswith("_sum"):
            entry["signed_error_sum_ms"] = float(value)
        elif family.endswith("_count"):
            entry["n"] = int(float(value))
    out = {}
    for key, entry in acc.items():
        n = entry.get("n", 0)
        if not n and "rolling_ape" not in entry:
            continue
        if n and "signed_error_sum_ms" in entry:
            entry["mean_signed_error_ms"] = round(
                entry.pop("signed_error_sum_ms") / n, 3)
        else:
            entry.pop("signed_error_sum_ms", None)
        out[key] = entry
    return out


def _from_metrics(source: str, out_path: str) -> int:
    if source.startswith("http://") or source.startswith("https://"):
        import urllib.request

        with urllib.request.urlopen(source, timeout=10.0) as resp:
            text = resp.read().decode()
    else:
        with open(source) as f:
            text = f.read()
    calib = accuracy_from_metrics(text)
    artifact = {
        "artifact": "predictor-accuracy",
        "mode": "live-metrics",
        "source": source,
        "calibration": calib,
        "reference_mape": 0.05,  # latency-predictor.md:58
    }
    with open(out_path, "w") as f:
        json.dump(artifact, f, indent=2)
    print(json.dumps(artifact))
    if not calib:
        print("WARNING: no predictor calibration samples in the scrape — "
              "is the decision ledger on and the predicted-latency-producer "
              "configured?", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--model", default="tiny")
    ap.add_argument("--reps", type=int, default=12,
                    help="workload regime repetitions (more = stabler MAPE)")
    ap.add_argument("--from-metrics", metavar="URL_OR_PATH",
                    help="read live llmd_tpu:predictor_calibration_* "
                         "families from a /metrics URL or a saved exposition "
                         "file instead of serving an offline workload")
    ap.add_argument("--out", default="PREDICTOR_ACCURACY.json")
    args = ap.parse_args(argv)
    if args.from_metrics:
        return _from_metrics(args.from_metrics, args.out)
    from llmd_tpu_torch.tools.predictor_offline import offline

    offline(args.model, args.cpu, args.reps, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
