#!/usr/bin/env python3
"""Flight-recorder event-catalog linter over the port (the port's copy of
``tools/lint_events.py``) — shim over ``llmd_lint/events_contract.py``.

Three sources must agree on the per-request event names: the authoritative
``EVENT_CATALOG`` in ``llmd_tpu_torch/obs/events.py``, the emit sites across
``llmd_tpu_torch/``, and the operator docs table in
``observability/flight-recorder.md``. Output format and exit codes are the
reference's.

    python -m llmd_tpu_torch.tools.lint_events     (exit 0 = contract holds)
"""

from __future__ import annotations

import sys

from llmd_tpu_torch.tools.llmd_lint import events_contract as _ev
from llmd_tpu_torch.tools.llmd_lint.core import REPO_ROOT as ROOT


def catalog_events() -> set[str]:
    return _ev.catalog_events(ROOT)


def emitted_events() -> dict[str, list[str]]:
    return _ev.emitted_events(ROOT)


def documented_events() -> set[str]:
    return _ev.documented_events(ROOT)


def main() -> int:
    catalog = catalog_events()
    errors = [f.message for f in _ev.evaluate(
        catalog, emitted_events(), documented_events())]
    if errors:
        print(f"lint_events: {len(errors)} error(s)")
        for e in errors:
            print(f"  {e}")
        return 1
    print(f"lint_events: OK — {len(catalog)} events, catalog / emit sites / "
          f"docs in sync")
    return 0


if __name__ == "__main__":
    sys.exit(main())
