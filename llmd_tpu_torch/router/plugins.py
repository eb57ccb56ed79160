"""Scheduler plugin framework: extension points and registry (copy of
``llmd_tpu/router/plugins.py``).

Extension points Filter, Scorer and Picker, plus DataProducer (per-request
state with PreRequest / PostResponse hooks) and Admitter. Plugin instances
are declared in the config graph (``core/config.FrameworkConfig``) by ``type``
and wired by ``name``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Protocol, runtime_checkable

from llmd_tpu_torch.core.endpoint import Endpoint
from llmd_tpu_torch.core.request import InferenceRequest


@runtime_checkable
class Filter(Protocol):
    def filter(self, req: InferenceRequest, endpoints: list[Endpoint]) -> list[Endpoint]: ...


@runtime_checkable
class Scorer(Protocol):
    def score(self, req: InferenceRequest, endpoints: list[Endpoint]) -> dict[Endpoint, float]: ...


@runtime_checkable
class Picker(Protocol):
    def pick(self, req: InferenceRequest, scored: dict[Endpoint, float]) -> Optional[Endpoint]: ...


class DataProducer:
    """Per-request state producer with lifecycle hooks (request-handling.md:81-86)."""

    def produce(self, req: InferenceRequest, endpoints: list[Endpoint]) -> None: ...

    def pre_request(self, req: InferenceRequest, endpoint: Endpoint) -> None: ...

    def post_response(self, req: InferenceRequest, endpoint: Endpoint,
                      response_info: dict[str, Any]) -> None: ...


class Admitter:
    """Admission gate evaluated after producers, before scheduling."""

    def admit(self, req: InferenceRequest, endpoints: list[Endpoint]) -> tuple[bool, str]:
        return True, ""


PLUGIN_REGISTRY: dict[str, Callable[..., Any]] = {}


def register_plugin(type_name: str):
    def deco(cls):
        PLUGIN_REGISTRY[type_name] = cls
        cls.plugin_type = type_name
        return cls

    return deco


def build_plugin(type_name: str, params: dict[str, Any], ctx: Optional[dict[str, Any]] = None):
    """Instantiate a plugin type with its config params (+ optional shared context).

    Plugins that need shared services (prefix index, predictor client) declare
    `needs_ctx = True` and receive the context dict as first arg.
    """
    cls = PLUGIN_REGISTRY.get(type_name)
    if cls is None:
        raise KeyError(f"unknown plugin type {type_name!r}; known: {sorted(PLUGIN_REGISTRY)}")
    if getattr(cls, "needs_ctx", False):
        # NOT `ctx or {}`: the shared context is an EMPTY dict at construction
        # time, which is falsy — that would hand every plugin a private fresh
        # dict and silently break all cross-component ctx sharing (the KV-event
        # subscriber feeding an index no scorer reads, inflight counts no
        # flow-controller sees).
        return cls(ctx if ctx is not None else {}, **params)
    return cls(**params)


def known_plugin_types() -> set[str]:
    return set(PLUGIN_REGISTRY)
