#!/usr/bin/env python3
"""Env-var contract linter over the port (the port's copy of
``tools/lint_envvars.py``) — shim over ``llmd_lint/envcontract.py``.

The one-directional checks of the reference's entry point (undocumented
reads, undocumented artifact vars, dead knobs) over ``llmd_tpu_torch/``,
against the reference's ``deploy/ENV_VARS.md`` and manifests, in its output
format; a finding the port's central allowlist covers is echoed with its
justification and does not fail. The full bidirectional contract check
(stale rows, consumer drift) runs in ``python -m llmd_tpu_torch.tools.llmd_lint``.

    python -m llmd_tpu_torch.tools.lint_envvars     (exit 0 = contract holds)
"""

from __future__ import annotations

import sys
from dataclasses import replace

from llmd_tpu_torch.tools.llmd_lint import envcontract as _ec
from llmd_tpu_torch.tools.llmd_lint.core import (
    REPO_ROOT as ROOT, Project, apply_central_allowlist)

# checks this entry point enforces (the historical lint_envvars contract)
_LEGACY_CHECKS = ("env-undocumented", "env-artifact-undocumented",
                  "env-dead-knob")


def vars_read_in_source() -> dict[str, list[str]]:
    return _ec.vars_read_in_source(Project(ROOT))


def vars_set_in_artifacts() -> dict[str, list[str]]:
    return _ec.vars_set_in_artifacts(ROOT)


def contract_vars() -> dict[str, str]:
    return _ec.contract_rows(ROOT)


def findings():
    cfg = Project(ROOT).config
    out = [f for f in _ec.evaluate(contract_vars(), vars_read_in_source(),
                                   vars_set_in_artifacts(),
                                   package=cfg.consumer_package)
           if f.check in _LEGACY_CHECKS]
    apply_central_allowlist(out, [replace(e, used=False) for e in cfg.allowlist])
    return out


def lint() -> list[str]:
    return [f.message for f in findings() if not f.allowed]


def main() -> int:
    fs = findings()
    errors = [f.message for f in fs if not f.allowed]
    for e in errors:
        print(f"ENVVAR-LINT: {e}")
    for f in fs:
        if f.allowed:
            print(f"ENVVAR-LINT allowed: {f.message} — {f.justification}")
    print(f"env-var contract: "
          f"{'OK' if not errors else f'{len(errors)} violation(s)'}")
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
