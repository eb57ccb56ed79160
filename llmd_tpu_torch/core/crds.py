"""API-surface schema objects: the reference's CRDs as validated config types
(copy of ``llmd_tpu/core/crds.py``; the manifests are read by the port's own
YAML reader, ``core/config.load_yaml_all``, where the reference uses PyYAML).

Parity targets (each section cites its reference spec):
- ``InferencePool`` — inference.networking.k8s.io/v1: selector, targetPorts
  (≤ 8, one endpoint per podIP:port — the DP-rank fan-out), endpointPickerRef
  with failureMode FailOpen|FailClose
  (the reference's docs/api-reference/inferencepool.md:1-60).
- ``InferenceObjective`` — llm-d.ai/v1alpha2: priority + poolRef
  (docs/api-reference/inferenceobjective.md:1-48).
- ``InferenceModelRewrite`` — weighted model-name targets for canary/A-B
  (docs/api-reference/inferencemodelrewrite.md:1-66).
- ``VariantAutoscaling`` — llmd.ai/v1alpha1 (autoscaling/wva.md:205-237).

These are plain dataclasses loadable from k8s-shaped YAML/JSON manifests
(apiVersion/kind/metadata/spec), so the same documents deploy to a cluster and
configure the no-Kubernetes standalone mode. ``load_manifests`` is the entry:
it validates kinds, field types, and cross-object references.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

MAX_TARGET_PORTS = 8


class ManifestError(ValueError):
    pass


@dataclass
class EndpointPickerRef:
    name: str
    port: int = 9002
    failure_mode: str = "FailClose"  # FailOpen | FailClose

    def __post_init__(self) -> None:
        if self.failure_mode not in ("FailOpen", "FailClose"):
            raise ManifestError(
                f"endpointPickerRef.failureMode must be FailOpen|FailClose, "
                f"got {self.failure_mode!r}")


@dataclass
class InferencePool:
    name: str
    selector: dict[str, str]
    target_ports: list[int]
    endpoint_picker_ref: Optional[EndpointPickerRef] = None
    namespace: str = "default"

    def __post_init__(self) -> None:
        if not self.selector:
            raise ManifestError(f"InferencePool {self.name}: empty selector")
        if not self.target_ports:
            raise ManifestError(f"InferencePool {self.name}: no targetPorts")
        if len(self.target_ports) > MAX_TARGET_PORTS:
            raise ManifestError(
                f"InferencePool {self.name}: {len(self.target_ports)} targetPorts "
                f"exceeds the {MAX_TARGET_PORTS}-port limit")
        if len(set(self.target_ports)) != len(self.target_ports):
            raise ManifestError(f"InferencePool {self.name}: duplicate targetPorts")

    @property
    def failure_mode(self) -> str:
        return (self.endpoint_picker_ref.failure_mode
                if self.endpoint_picker_ref else "FailClose")

    @classmethod
    def from_manifest(cls, doc: dict) -> "InferencePool":
        spec = doc.get("spec", {})
        meta = doc.get("metadata", {})
        ports = [
            int(p["number"] if isinstance(p, dict) else p)
            for p in spec.get("targetPorts", [])
        ]
        epr = spec.get("endpointPickerRef")
        return cls(
            name=meta.get("name", ""),
            namespace=meta.get("namespace", "default"),
            selector=dict(spec.get("selector", {}).get("matchLabels",
                                                       spec.get("selector", {}))),
            target_ports=ports,
            endpoint_picker_ref=EndpointPickerRef(
                name=epr.get("name", ""),
                port=int(epr.get("port", 9002)),
                failure_mode=epr.get("failureMode", "FailClose"),
            ) if epr else None,
        )


@dataclass
class InferenceObjective:
    name: str
    priority: int
    pool_ref: str
    namespace: str = "default"

    @classmethod
    def from_manifest(cls, doc: dict) -> "InferenceObjective":
        spec = doc.get("spec", {})
        meta = doc.get("metadata", {})
        pool = spec.get("poolRef", {})
        return cls(
            name=meta.get("name", ""),
            namespace=meta.get("namespace", "default"),
            priority=int(spec.get("priority", 0)),
            pool_ref=pool.get("name", "") if isinstance(pool, dict) else str(pool),
        )


@dataclass
class RewriteTarget:
    model: str
    weight: float = 1.0

    def __post_init__(self) -> None:
        if self.weight < 0:
            raise ManifestError(f"rewrite target {self.model}: negative weight")


@dataclass
class InferenceModelRewrite:
    name: str
    model: str  # client-facing name
    targets: list[RewriteTarget] = field(default_factory=list)
    namespace: str = "default"

    def __post_init__(self) -> None:
        if not self.targets:
            raise ManifestError(f"InferenceModelRewrite {self.name}: no targets")
        if sum(t.weight for t in self.targets) <= 0:
            raise ManifestError(
                f"InferenceModelRewrite {self.name}: zero total weight")

    @classmethod
    def from_manifest(cls, doc: dict) -> "InferenceModelRewrite":
        spec = doc.get("spec", {})
        meta = doc.get("metadata", {})
        return cls(
            name=meta.get("name", ""),
            namespace=meta.get("namespace", "default"),
            model=spec.get("modelName", meta.get("name", "")),
            targets=[
                RewriteTarget(model=t.get("modelName", t.get("model", "")),
                              weight=float(t.get("weight", 1.0)))
                for t in spec.get("targetModels", spec.get("targets", []))
            ],
        )


@dataclass
class VariantAutoscaling:
    name: str
    model_id: str
    min_replicas: int = 0
    max_replicas: int = 8
    slo_ttft_ms: Optional[float] = None
    slo_tpot_ms: Optional[float] = None
    namespace: str = "default"

    @classmethod
    def from_manifest(cls, doc: dict) -> "VariantAutoscaling":
        spec = doc.get("spec", {})
        meta = doc.get("metadata", {})
        slo = spec.get("slo", {})
        return cls(
            name=meta.get("name", ""),
            namespace=meta.get("namespace", "default"),
            model_id=spec.get("modelID", ""),
            min_replicas=int(spec.get("minReplicas", 0)),
            max_replicas=int(spec.get("maxReplicas", 8)),
            slo_ttft_ms=slo.get("ttftMs"),
            slo_tpot_ms=slo.get("tpotMs"),
        )


# single registry: kind → (parser, ManifestSet attribute)
_KINDS = {
    "InferencePool": (InferencePool.from_manifest, "pools"),
    "InferenceObjective": (InferenceObjective.from_manifest, "objectives"),
    "InferenceModelRewrite": (InferenceModelRewrite.from_manifest, "rewrites"),
    "VariantAutoscaling": (VariantAutoscaling.from_manifest, "autoscalings"),
}


@dataclass
class ManifestSet:
    pools: list[InferencePool] = field(default_factory=list)
    objectives: list[InferenceObjective] = field(default_factory=list)
    rewrites: list[InferenceModelRewrite] = field(default_factory=list)
    autoscalings: list[VariantAutoscaling] = field(default_factory=list)

    def objectives_map(self) -> dict[str, int]:
        """objective name → priority (RouterServer's objectives input)."""
        return {o.name: o.priority for o in self.objectives}

    def rewrites_map(self) -> dict[str, list[tuple[str, float]]]:
        return {r.model: [(t.model, t.weight) for t in r.targets]
                for r in self.rewrites}


def load_manifests(docs: list[dict]) -> ManifestSet:
    """Parse + cross-validate a list of k8s-shaped manifest documents."""
    out = ManifestSet()
    for doc in docs:
        if not doc:
            continue
        kind = doc.get("kind", "")
        entry = _KINDS.get(kind)
        if entry is None:
            raise ManifestError(f"unknown kind {kind!r}")
        fn, attr = entry
        getattr(out, attr).append(fn(doc))
    pool_names = {p.name for p in out.pools}
    for o in out.objectives:
        if o.pool_ref and pool_names and o.pool_ref not in pool_names:
            raise ManifestError(
                f"InferenceObjective {o.name}: poolRef {o.pool_ref!r} matches no "
                f"InferencePool (have {sorted(pool_names)})")
    return out


def load_manifest_yaml(text: str) -> ManifestSet:
    from llmd_tpu_torch.core.config import load_yaml_all

    return load_manifests(load_yaml_all(text))
