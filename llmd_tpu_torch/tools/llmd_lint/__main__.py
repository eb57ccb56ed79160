"""llmd-lint runner: all analyzers, one exit code.

Exit 0 = zero unallowlisted findings. Allowlisted findings are echoed with
their justification (a suppression you cannot read the reason for is a
suppression you cannot audit).

    python -m llmd_tpu_torch.tools.llmd_lint [--json] [--analyzer NAME ...]
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import replace

from llmd_tpu_torch.tools.llmd_lint import (
    core, envcontract, events_contract, hotpath, locks, metrics_contract,
)

ANALYZERS = [
    ("locks", locks),
    ("hotpath", hotpath),
    ("env-contract", envcontract),
    ("metrics-contract", metrics_contract),
    ("events-contract", events_contract),
]


def run_suite(project: core.Project, names=None):
    """Run the selected analyzers; returns (findings, summaries). The central
    allowlist's rows are fresh per run, so their use is this run's."""
    cfg = project.config
    allowlist = [replace(e, used=False) for e in cfg.allowlist]
    findings: list[core.Finding] = []
    summaries: dict[str, dict] = {}
    selected = [(n, m) for n, m in ANALYZERS if not names or n in names]
    for name, mod in selected:
        fs = mod.run(project)
        core.apply_inline_allows(project, fs)
        core.apply_central_allowlist(fs, allowlist)
        findings.extend(fs)
        if hasattr(mod, "summary"):
            summaries[name] = mod.summary(project)
    findings.extend(project.syntax_errors)
    if not names:  # full run: audit the allowlist itself
        findings.extend(core.annotation_findings(project, findings))
        for entry in allowlist:
            if not entry.justification:
                findings.append(core.Finding(
                    "allow-missing-justification", cfg.config_file,
                    0, f"central allow[{entry.check}] ({entry.match!r}) has "
                       f"no justification"))
            elif not entry.used:
                findings.append(core.Finding(
                    "allow-unused", cfg.config_file, 0,
                    f"central allow[{entry.check}] ({entry.match!r}) matches "
                    f"no finding — stale suppression, remove it"))
    return findings, summaries


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="llmd-lint",
        description="lock-discipline, hot-path, and contract static analysis "
                    "of the port")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output on stdout")
    ap.add_argument("--analyzer", action="append",
                    choices=[n for n, _ in ANALYZERS],
                    help="run a subset (repeatable); default: all")
    ap.add_argument("--root", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    project = core.Project(args.root) if args.root else core.Project()
    findings, summaries = run_suite(project, args.analyzer)
    failures = [f for f in findings if not f.allowed]
    allowed = [f for f in findings if f.allowed]

    if args.as_json:
        print(json.dumps({
            "ok": not failures,
            "counts": {"failures": len(failures), "allowed": len(allowed)},
            "findings": [f.to_dict() for f in findings],
            "summaries": summaries,
        }, indent=2, default=list))
        return 1 if failures else 0

    for f in sorted(failures, key=lambda f: (f.check, f.file, f.line)):
        print(f"LLMD-LINT {f.check} {f.location()}: {f.message}")
    for f in sorted(allowed, key=lambda f: (f.check, f.file, f.line)):
        print(f"LLMD-LINT allowed[{f.check}] {f.location()}: {f.message}"
              f" — {f.justification}")
    lk = summaries.get("locks")
    if lk:
        print(f"llmd-lint locks: {lk['num_classes']} classes holding "
              f"{lk['num_locks']} locks, {lk['num_edges']} acquisition-order "
              f"edges")
    print(f"llmd-lint: {'OK' if not failures else 'FAILED'} — "
          f"{len(failures)} finding(s), {len(allowed)} allowlisted")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
