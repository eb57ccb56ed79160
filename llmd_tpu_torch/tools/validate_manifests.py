"""Hardware-free manifest validation — the ci-kustomize-dry-run analogue (the
port's copy of ``tools/validate_manifests.py``: the same checks, output and
exit codes, standard library only, over the port's binaries).

Upstream llm-d validates every guide's manifests in CI without hardware
(its ``.github/workflows/ci-kustomize-dry-run.yaml``, including the
simulated-accelerators filter). This validator does the same for
deploy/*/manifests.yaml, plus checks a kustomize dry-run can't do — it knows
our binaries:

1. k8s object shape (apiVersion/kind/metadata.name; Deployment selector must
   match template labels; probe contract: /health liveness + /v1/models
   readiness on engine containers).
2. our CRDs parse + validate through llmd_tpu_torch.core.crds (targetPorts ≤
   8, failureMode, cross-references); every file is read by the port's YAML
   reader (``core/config.load_yaml_all``).
3. **container args resolve against the real argparse surface** of the named
   module, read by AST without importing it. A container names the
   reference's module (``llmd_tpu.engine.serve`` / ``router.serve`` /
   ``disagg.sidecar``); it is resolved against the port's counterpart,
   ``llmd_tpu_torch.<same path>``, so a flag a deploy guide passes that the
   port does not accept fails validation instead of CrashLoopBackOff.
4. port consistency: InferencePool targetPorts ⊆ some pod's containerPorts;
   probe ports declared.

Usage: python -m llmd_tpu_torch.tools.validate_manifests [deploy/]   (exit 0 = valid)
"""

from __future__ import annotations

import argparse
import ast
import glob
import os
import sys
from pathlib import Path

from llmd_tpu_torch.core.config import load_yaml_all
from llmd_tpu_torch.core.crds import ManifestError, load_manifests

ENTRYPOINT_FLAGS: dict[str, set[str]] = {}
PORT_PACKAGE = Path(__file__).resolve().parent.parent  # llmd_tpu_torch/


def port_module(module: str) -> str:
    """The port's counterpart of a module a manifest names: ``llmd_tpu.x.y``
    is ``llmd_tpu_torch.x.y``; any other name is itself."""
    head, _, rest = module.partition(".")
    return f"{PORT_PACKAGE.name}.{rest}" if head == "llmd_tpu" and rest else module


def _module_file(module: str) -> Path:
    """The source file of a port module, found without importing it (or its
    package, whose ``__init__`` loads torch)."""
    head, _, rest = module.partition(".")
    if head != PORT_PACKAGE.name or not rest:
        raise ModuleNotFoundError(f"no module named {module!r} in the port")
    base = PORT_PACKAGE.joinpath(*rest.split("."))
    for path in (base.with_suffix(".py"), base / "__main__.py"):
        if path.is_file():
            return path
    raise ModuleNotFoundError(f"no module named {module!r}")


def _argparse_flags(module: str) -> set[str]:
    """Extract the real --flag surface of a CLI module without executing it."""
    module = port_module(module)
    if module in ENTRYPOINT_FLAGS:
        return ENTRYPOINT_FLAGS[module]
    flags: set[str] = set()
    tree = ast.parse(_module_file(module).read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            for arg in node.args:
                if isinstance(arg, ast.Constant) and str(arg.value).startswith("--"):
                    flags.add(str(arg.value))
    ENTRYPOINT_FLAGS[module] = flags
    return flags


class Issues:
    def __init__(self) -> None:
        self.errors: list[str] = []

    def err(self, path: str, msg: str) -> None:
        self.errors.append(f"{path}: {msg}")


def _containers(doc: dict) -> list[dict]:
    return (doc.get("spec", {}).get("template", {}).get("spec", {})
            .get("containers", []))


def _validate_deployment(path: str, doc: dict, iss: Issues) -> None:
    name = doc.get("metadata", {}).get("name", "?")
    spec = doc.get("spec", {})
    sel = spec.get("selector", {}).get("matchLabels", {})
    tmpl_labels = spec.get("template", {}).get("metadata", {}).get("labels", {})
    if not sel:
        iss.err(path, f"Deployment {name}: missing selector.matchLabels")
    for k, v in sel.items():
        if tmpl_labels.get(k) != v:
            iss.err(path, f"Deployment {name}: selector {k}={v} not in template labels")
    cs = _containers(doc)
    if not cs:
        iss.err(path, f"Deployment {name}: no containers")
    for c in cs:
        _validate_container(path, name, c, iss)


def _validate_container(path: str, dep: str, c: dict, iss: Issues) -> None:
    args = [str(a) for a in c.get("args", [])]
    ports = {p.get("containerPort") for p in c.get("ports", [])}
    # module invocation: python -m <module> --flags... (both "--flag value"
    # and "--flag=value" are legal k8s args)
    if "-m" in args and args.index("-m") + 1 < len(args):
        module = args[args.index("-m") + 1]
        try:
            known = _argparse_flags(module)
        except Exception as e:
            iss.err(path, f"{dep}/{c.get('name')}: module {module!r} not importable: {e}")
            return
        flag_value: dict[str, str] = {}
        toks = args[args.index("-m") + 2:]
        for i, a in enumerate(toks):
            if not a.startswith("--"):
                continue
            name, eq, val = a.partition("=")
            if not eq and i + 1 < len(toks) and not toks[i + 1].startswith("--"):
                val = toks[i + 1]
            if name not in known:
                iss.err(path, f"{dep}/{c.get('name')}: unknown flag {name} for "
                              f"{module} (has: {', '.join(sorted(known))})")
            else:
                flag_value[name] = val
        # declared serving port should match the --port arg when present
        if "--port" in flag_value:
            try:
                port = int(flag_value["--port"])
                if ports and port not in ports:
                    iss.err(path, f"{dep}/{c.get('name')}: --port {port} not in "
                                  f"containerPorts {sorted(p for p in ports if p)}")
            except ValueError:
                iss.err(path, f"{dep}/{c.get('name')}: malformed --port arg")
    elif "-m" in args:
        iss.err(path, f"{dep}/{c.get('name')}: dangling -m with no module")
    for probe in ("livenessProbe", "readinessProbe"):
        pr = c.get(probe)
        if pr and "httpGet" in pr:
            pport = pr["httpGet"].get("port")
            if ports and pport not in ports:
                iss.err(path, f"{dep}/{c.get('name')}: {probe} port {pport} "
                              f"not declared in containerPorts")


def _validate_kustomization(path: str, doc: dict, iss: Issues) -> None:
    """Kustomize dry-run essentials (the reference gates these in CI via
    `kubectl kustomize`): every referenced resource/patch path must exist."""
    base = os.path.dirname(path)
    for res in doc.get("resources", []):
        if not os.path.exists(os.path.join(base, str(res))):
            iss.err(path, f"kustomization resource {res!r} does not exist")
    for patch in doc.get("patches", []):
        p = patch.get("path") if isinstance(patch, dict) else patch
        if p and not os.path.exists(os.path.join(base, str(p))):
            iss.err(path, f"kustomization patch {p!r} does not exist")


def _validate_file(path: str, iss: Issues) -> None:
    with open(path) as f:
        docs = [d for d in load_yaml_all(f.read()) if d]
    crd_docs, deployments, pod_ports = [], [], set()
    for doc in docs:
        kind = doc.get("kind")
        if kind == "Kustomization":  # has no metadata.name by design
            _validate_kustomization(path, doc, iss)
            continue
        if not kind or not doc.get("metadata", {}).get("name"):
            iss.err(path, f"document missing kind/metadata.name: {str(doc)[:80]}")
            continue
        if kind in ("InferencePool", "InferenceObjective", "InferenceModelRewrite",
                    "VariantAutoscaling"):
            crd_docs.append(doc)
        elif kind == "Deployment":
            deployments.append(doc)
            _validate_deployment(path, doc, iss)
            for c in _containers(doc):
                pod_ports |= {p.get("containerPort") for p in c.get("ports", [])}
        elif kind == "Gateway":
            spec = doc.get("spec", {})
            # base gateways declare listeners; variant patches must at least
            # pin the gatewayClassName they exist to select
            if not spec.get("listeners") and not spec.get("gatewayClassName"):
                iss.err(path, f"Gateway {doc['metadata']['name']}: neither "
                              "listeners nor gatewayClassName")
        elif kind == "HTTPRoute":
            for rule in doc.get("spec", {}).get("rules", []):
                for ref in rule.get("backendRefs", []):
                    if ref.get("kind") == "InferencePool" and not ref.get("name"):
                        iss.err(path, "HTTPRoute backendRef InferencePool "
                                      "without a name")
        elif kind == "HorizontalPodAutoscaler":
            spec = doc.get("spec", {})
            if not spec.get("scaleTargetRef", {}).get("name"):
                iss.err(path, f"HPA {doc['metadata']['name']}: no scaleTargetRef")
            if not spec.get("metrics"):
                iss.err(path, f"HPA {doc['metadata']['name']}: no metrics")
        elif kind == "ScaledObject":
            if not doc.get("spec", {}).get("triggers"):
                iss.err(path, f"ScaledObject {doc['metadata']['name']}: no triggers")
        elif kind in ("Service", "ConfigMap", "Namespace", "GatewayParameters"):
            pass
        else:
            iss.err(path, f"unexpected kind {kind!r}")
    try:
        ms = load_manifests(crd_docs)
    except ManifestError as e:
        iss.err(path, f"CRD validation: {e}")
        return
    for pool in ms.pools:
        for port in pool.target_ports:
            if pod_ports and port not in pod_ports:
                iss.err(path, f"InferencePool {pool.name}: targetPort {port} not "
                              f"exposed by any container")
        # the selector must select at least one Deployment's template labels
        matched = any(
            all(d.get("spec", {}).get("template", {}).get("metadata", {})
                .get("labels", {}).get(k) == v for k, v in pool.selector.items())
            for d in deployments
        )
        if deployments and not matched:
            iss.err(path, f"InferencePool {pool.name}: selector {pool.selector} "
                          f"matches no Deployment template")


def validate(root: str) -> list[str]:
    iss = Issues()
    files = sorted(glob.glob(os.path.join(root, "**", "*.yaml"), recursive=True))
    if not files:
        iss.err(root, "no manifest files found")
    for path in files:
        if os.path.basename(os.path.dirname(path)) == "standalone-envoy":
            continue  # Envoy bootstrap config, not a Kubernetes manifest
        _validate_file(path, iss)
    return iss.errors


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default="deploy")
    args = ap.parse_args(argv)
    errors = validate(args.root)
    if errors:
        for e in errors:
            print(f"ERROR {e}", file=sys.stderr)
        raise SystemExit(1)
    n = len(glob.glob(os.path.join(args.root, "**", "*.yaml"), recursive=True))
    print(f"OK: {n} manifest files valid under {args.root}/")


if __name__ == "__main__":
    main()
