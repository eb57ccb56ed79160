"""Env/config contract analyzer (the port's copy of
``tools/llmd_lint/envcontract.py``).

``deploy/ENV_VARS.md`` is the single contract table; this analyzer checks it
against the code and the shipped artifacts in BOTH directions:

* ``env-undocumented`` — a variable the source reads with no contract row.
  Reads are found by AST, which also sees the wrapper idiom the old regex
  linter was blind to: any call passing an ``LLMD_*``/``[A-Z_]*`` string
  literal to an env-helper (``_env_f("LLMD_X", d)``, ``_env_i``, …) counts,
  alongside ``os.environ.get``/``os.getenv``/``os.environ[...]``.
* ``env-artifact-undocumented`` / ``env-dead-knob`` — a variable set by
  ``docker/Dockerfile.tpu`` or a ``deploy/`` manifest must be documented,
  and (unless marked ``(external)``) consumed by the source.
* ``env-doc-stale`` — an ``LLMD_*`` contract row nothing reads any more:
  the knob was removed but its documentation survived.
* ``env-consumer-drift`` — the row's Consumer column names a
  ``llmd_tpu.x.y`` module, but no read of the variable occurs in that
  module (the flag plumbing moved; the contract must follow). Under the
  port's configuration the module is the port's counterpart,
  ``llmd_tpu_torch/x/y.py`` (``LintConfig.consumer_package``).

The contract document and the manifests are read only: the port is held to
the operator documents the reference ships.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Optional

from .core import Finding, Project, dotted_name, const_str

VAR_PAT = re.compile(r"^[A-Z][A-Z0-9_]*$")
ROW_PAT = re.compile(r"^\|\s*`([A-Z_][A-Z0-9_]*)`\s*\|\s*([^|]+)\|", re.M)
CONSUMER_MODULE_PAT = re.compile(r"\bllmd_tpu(?:\.[a-zA-Z_][a-zA-Z0-9_]*)+")
ENV_HELPER_PAT = re.compile(r"(?:^|_)env", re.I)


def vars_read_in_source(project: Project) -> dict[str, list[str]]:
    """var -> repo-relative files reading it (direct os.environ forms plus
    env-helper wrapper calls carrying a literal var name)."""
    found: dict[str, list[str]] = {}

    def note(var: str, rel: str) -> None:
        found.setdefault(var, [])
        if rel not in found[var]:
            found[var].append(rel)

    for sf in project.files(project.config.env_source_globs):
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Subscript):
                base = dotted_name(node.value)
                if base in ("os.environ", "environ") \
                        and isinstance(node.ctx, ast.Load):
                    var = const_str(node.slice)
                    if var and VAR_PAT.match(var):
                        note(var, sf.rel)
            if not isinstance(node, ast.Call) or not node.args:
                continue
            fname = dotted_name(node.func) or ""
            leaf = fname.split(".")[-1]
            var = const_str(node.args[0])
            if var is None or not VAR_PAT.match(var):
                continue
            if fname in ("os.environ.get", "os.getenv", "environ.get",
                         "getenv"):
                note(var, sf.rel)
            elif ENV_HELPER_PAT.search(leaf):
                note(var, sf.rel)
    return found


def vars_set_in_artifacts(root: Path) -> dict[str, list[str]]:
    out: dict[str, list[str]] = {}
    df = root / "docker" / "Dockerfile.tpu"
    if df.exists():
        in_env = False
        for line in df.read_text().splitlines():
            stripped = line.strip()
            if in_env and stripped.startswith("#"):
                continue  # Docker permits comment lines inside continuations
            if stripped.startswith("ENV "):
                in_env = True
                stripped = stripped[4:]
            if in_env:
                for m in re.finditer(r"([A-Z_][A-Z0-9_]*)=", stripped):
                    out.setdefault(m.group(1), []).append("docker/Dockerfile.tpu")
                if not line.rstrip().endswith("\\"):
                    in_env = False
    deploy = root / "deploy"
    if deploy.is_dir():
        for manifest in deploy.rglob("*.yaml"):
            text = manifest.read_text(errors="replace")
            for m in re.finditer(
                    r"-\s+name:\s+([A-Z_][A-Z0-9_]*)\s*\n\s+value:", text):
                out.setdefault(m.group(1), []).append(
                    manifest.relative_to(root).as_posix())
    return out


def contract_rows(root: Path) -> dict[str, str]:
    doc = root / "deploy" / "ENV_VARS.md"
    if not doc.exists():
        return {}
    return {m.group(1): m.group(2).strip()
            for m in ROW_PAT.finditer(doc.read_text())}


def _module_file(module: str, package: str = "llmd_tpu") -> str:
    return package + module[len("llmd_tpu"):].replace(".", "/") + ".py"


def evaluate(contract: dict[str, str], read: dict[str, list[str]],
             setters: dict[str, list[str]],
             contract_file: str = "deploy/ENV_VARS.md",
             package: str = "llmd_tpu") -> list[Finding]:
    findings: list[Finding] = []
    for var, where in sorted(read.items()):
        if var not in contract:
            findings.append(Finding(
                "env-undocumented", contract_file, 0,
                f"{var}: read by {sorted(set(where))} but missing from "
                f"deploy/ENV_VARS.md"))
    for var, where in sorted(setters.items()):
        if var not in contract:
            findings.append(Finding(
                "env-artifact-undocumented", contract_file, 0,
                f"{var}: set in {sorted(set(where))} but missing from "
                f"deploy/ENV_VARS.md"))
            continue
        consumer = contract[var]
        if "(external)" in consumer:
            continue  # owned by a dependency (jax/xla/python/k8s)
        if var not in read:
            findings.append(Finding(
                "env-dead-knob", contract_file, 0,
                f"{var}: set in {sorted(set(where))}, documented as consumed "
                f"by {consumer!r}, but nothing in the source reads it "
                f"(dead knob)"))
    for var, consumer in sorted(contract.items()):
        if not var.startswith("LLMD_") or "(external)" in consumer:
            continue
        if var not in read:
            findings.append(Finding(
                "env-doc-stale", contract_file, 0,
                f"{var}: documented (consumer {consumer!r}) but nothing in "
                f"the source reads it — stale contract row"))
            continue
        modules = CONSUMER_MODULE_PAT.findall(consumer)
        if modules:
            files = {f for f in read[var]}
            wanted = {_module_file(m, package) for m in modules}
            if not (files & wanted):
                findings.append(Finding(
                    "env-consumer-drift", contract_file, 0,
                    f"{var}: contract names consumer {sorted(wanted)} but "
                    f"reads come from {sorted(files)} — update the Consumer "
                    f"column"))
    return findings


def run(project: Project) -> list[Finding]:
    cfg = project.config
    return evaluate(contract_rows(project.root),
                    vars_read_in_source(project),
                    vars_set_in_artifacts(project.root),
                    package=cfg.consumer_package)
