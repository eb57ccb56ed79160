"""Metrics doc-contract analyzer (the port's copy of
``tools/llmd_lint/metrics_contract.py`` — same checked contract, same sources
of truth).

The observability kit (grafana dashboards, alert rules, the promql cookbook)
must only reference metric families the stack actually emits: the shared
registry's declared families (expanded with histogram/summary series
suffixes) plus raw-line providers found by scanning the source. Under the
port's configuration the registry is ``llmd_tpu_torch/obs/metrics.py`` and
the scanned source ``llmd_tpu_torch/``; the kit is read, never edited.
"""

from __future__ import annotations

import importlib
import json
import re
import sys
from pathlib import Path

from .core import Finding, Project, REPO_ROOT

LINT_DIR = Path(__file__).resolve().parent

# family-shaped names used across the stack (same pattern test_lint.py uses)
METRIC_PAT = re.compile(
    r"(llmd_tpu:[a-z_]+|llm_d_epp_[a-z_]+|igw_[a-z_]+|vllm:[a-z_]+"
    r"|inference_objective_[a-z_]+)")

REGISTER_FUNCTIONS = ("register_engine_metrics", "register_engine_server_metrics",
                      "register_router_metrics", "register_pool_metrics",
                      "register_device_metrics")


def registry_families(root: Path = REPO_ROOT,
                      module: str = "llmd_tpu_torch.obs.metrics") -> set[str]:
    """Every family name the shared registry declares, expanded with the
    series suffixes histograms and summaries emit."""
    added = str(root) not in sys.path
    if added:
        sys.path.insert(0, str(root))
    try:
        mod = importlib.import_module(module)
    finally:
        if added:
            sys.path.remove(str(root))

    reg = mod.Registry()
    for fn in REGISTER_FUNCTIONS:
        getattr(mod, fn)(reg)
    names: set[str] = set()
    for name in reg.families():
        names.add(name)
        fam = reg.get(name)
        if isinstance(fam, mod.Histogram):
            names |= {name + "_bucket", name + "_sum", name + "_count"}
        elif isinstance(fam, mod.Summary):
            names |= {name + "_sum", name + "_count"}
    return names


def rawline_families(root: Path = REPO_ROOT,
                     package: str = "llmd_tpu_torch") -> set[str]:
    """Family names emitted as pre-rendered lines (plugin providers, sidecars)
    anywhere in the source tree (this lint's own sources, which quote names,
    are no provider)."""
    names: set[str] = set()
    for py in (root / package).rglob("*.py"):
        if LINT_DIR in py.resolve().parents:
            continue
        names |= set(METRIC_PAT.findall(py.read_text(errors="replace")))
    return names


def referenced(root: Path = REPO_ROOT) -> dict[str, list[str]]:
    """Metric names referenced by the observability kit → referencing files."""
    refs: dict[str, list[str]] = {}

    def note(name: str, where: str) -> None:
        refs.setdefault(name, []).append(where)

    for dash in sorted((root / "observability" / "grafana").glob("*.json")):
        doc = json.loads(dash.read_text())
        for panel in doc.get("panels", []):
            for tgt in panel.get("targets", []):
                for m in METRIC_PAT.findall(tgt.get("expr", "")):
                    note(m, f"grafana/{dash.name}")
    alerts = root / "observability" / "alerts.yaml"
    if alerts.exists():
        for m in METRIC_PAT.findall(alerts.read_text()):
            note(m, "alerts.yaml")
    promql = root / "observability" / "promql.md"
    if promql.exists():
        for m in METRIC_PAT.findall(promql.read_text()):
            note(m, "promql.md")
    return refs


def evaluate(emitted: set[str],
             refs: dict[str, list[str]]) -> list[Finding]:
    findings: list[Finding] = []
    for name, where in sorted(refs.items()):
        if name not in emitted:
            findings.append(Finding(
                "metrics-dangling-ref", "observability", 0,
                f"{name}: referenced by {sorted(set(where))} but no registry "
                f"family or raw-line provider emits it"))
    return findings


def run(project: Project) -> list[Finding]:
    root, cfg = project.root, project.config
    return evaluate(registry_families(root, cfg.registry_module)
                    | rawline_families(root, cfg.package_dir),
                    referenced(root))
