"""Flight-recorder event-catalog analyzer (the port's copy of
``tools/llmd_lint/events_contract.py`` — same checked contract).

Three sources must agree on the set of per-request event names: the
authoritative ``EVENT_CATALOG`` (``llmd_tpu_torch/obs/events.py`` under the
port's configuration), the emit sites across the package, and the operator
docs table in ``observability/flight-recorder.md`` (read, never edited).
"""

from __future__ import annotations

import importlib
import re
import sys
from pathlib import Path

from .core import Finding, Project, REPO_ROOT
from .metrics_contract import LINT_DIR

# flight.record(<rid>, "<event>", ...) / flight.record_system("<event>", ...)
# / flight.finish(<rid>, event="<event>", ...). Emit sites always use literal
# names — that's what makes the contract lintable.
RECORD_PAT = re.compile(r"\.record\(\s*[^,()]+,\s*\"([a-z_]+)\"")
RECORD_SYSTEM_PAT = re.compile(r"\.record_system\(\s*\"([a-z_]+)\"")
FINISH_EVENT_PAT = re.compile(r"\bevent=\"([a-z_]+)\"")

# doc table rows: | `event_name` | ... |
DOC_ROW_PAT = re.compile(r"^\|\s*`([a-z_]+)`", re.MULTILINE)

DOC_REL = "observability/flight-recorder.md"


def catalog_events(root: Path = REPO_ROOT,
                   module: str = "llmd_tpu_torch.obs.events") -> set[str]:
    added = str(root) not in sys.path
    if added:
        sys.path.insert(0, str(root))
    try:
        return set(importlib.import_module(module).EVENT_CATALOG)
    finally:
        if added:
            sys.path.remove(str(root))


def emitted_events(root: Path = REPO_ROOT,
                   package: str = "llmd_tpu_torch") -> dict[str, list[str]]:
    """event name → files emitting it, scanned from the package's source
    (obs/events.py itself is the declaration, not an emit site; nor is this
    lint's own source)."""
    out: dict[str, list[str]] = {}
    for path in sorted((root / package).rglob("*.py")):
        if (path.name == "events.py" and path.parent.name == "obs") \
                or LINT_DIR in path.resolve().parents:
            continue
        text = path.read_text()
        rel = path.relative_to(root).as_posix()
        for pat in (RECORD_PAT, RECORD_SYSTEM_PAT, FINISH_EVENT_PAT):
            for name in pat.findall(text):
                out.setdefault(name, [])
                if rel not in out[name]:
                    out[name].append(rel)
    return out


def documented_events(root: Path = REPO_ROOT) -> set[str]:
    doc = root / DOC_REL
    if not doc.exists():
        return set()
    return set(DOC_ROW_PAT.findall(doc.read_text()))


def evaluate(catalog: set[str], emitted: dict[str, list[str]],
             documented: set[str],
             catalog_file: str = "llmd_tpu_torch/obs/events.py") -> list[Finding]:
    findings: list[Finding] = []
    for name in sorted(set(emitted) - catalog):
        findings.append(Finding(
            "event-unregistered-emit", emitted[name][0], 0,
            f"emitted but not in EVENT_CATALOG: {name!r} "
            f"(from {', '.join(emitted[name])})"))
    for name in sorted(catalog - set(emitted)):
        findings.append(Finding(
            "event-never-emitted", catalog_file, 0,
            f"in EVENT_CATALOG but never emitted: {name!r}"))
    if not documented:
        findings.append(Finding(
            "event-doc-missing", DOC_REL, 0,
            f"{DOC_REL} missing or has no event-catalog table rows "
            f"(| `event` | ...)"))
    else:
        for name in sorted(catalog - documented):
            findings.append(Finding(
                "event-undocumented", DOC_REL, 0,
                f"in EVENT_CATALOG but undocumented in {DOC_REL}: {name!r}"))
        for name in sorted(documented - catalog):
            findings.append(Finding(
                "event-doc-stale", DOC_REL, 0,
                f"documented in {DOC_REL} but not in EVENT_CATALOG: "
                f"{name!r}"))
    return findings


def run(project: Project) -> list[Finding]:
    root, cfg = project.root, project.config
    return evaluate(catalog_events(root, cfg.events_module),
                    emitted_events(root, cfg.package_dir),
                    documented_events(root),
                    cfg.events_module.replace(".", "/") + ".py")
