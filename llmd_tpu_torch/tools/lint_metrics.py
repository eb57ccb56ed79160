#!/usr/bin/env python3
"""Metrics doc-contract linter over the port (the port's copy of
``tools/lint_metrics.py``) — shim over ``llmd_lint/metrics_contract.py``.

The observability kit (grafana dashboards, alert rules, the promql cookbook)
must only reference metric families the port emits: its registry's declared
families (``llmd_tpu_torch/obs/metrics.py``, expanded with histogram/summary
series suffixes) plus raw-line providers found by scanning
``llmd_tpu_torch/``. A reference the port's central allowlist covers is
echoed with its justification and does not fail. Output format and exit
codes are the reference's.

    python -m llmd_tpu_torch.tools.lint_metrics     (exit 0 = contract holds)
"""

from __future__ import annotations

import sys
from dataclasses import replace

from llmd_tpu_torch.tools.llmd_lint import metrics_contract as _mc
from llmd_tpu_torch.tools.llmd_lint.config import PORT
from llmd_tpu_torch.tools.llmd_lint.core import REPO_ROOT as ROOT, apply_central_allowlist
from llmd_tpu_torch.tools.llmd_lint.metrics_contract import METRIC_PAT  # noqa: F401


def registry_families() -> set[str]:
    return _mc.registry_families(ROOT)


def rawline_families() -> set[str]:
    return _mc.rawline_families(ROOT)


def referenced() -> dict[str, list[str]]:
    return _mc.referenced(ROOT)


def findings():
    out = _mc.evaluate(registry_families() | rawline_families(), referenced())
    apply_central_allowlist(out, [replace(e, used=False) for e in PORT.allowlist])
    return out


def lint() -> list[str]:
    return [f.message for f in findings() if not f.allowed]


def main() -> int:
    fs = findings()
    errors = [f.message for f in fs if not f.allowed]
    for e in errors:
        print(f"METRICS-LINT: {e}")
    for f in fs:
        if f.allowed:
            print(f"METRICS-LINT allowed: {f.message} — {f.justification}")
    print(f"metrics contract: "
          f"{'OK' if not errors else f'{len(errors)} dangling reference(s)'}")
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
