"""Step-program registry and the decode programs' attention choice (port of
``llmd_tpu/engine/programs.py``).

The engine's forward work is a small set of programs: the unified mixed step,
the speculative verify program and its grammar-masked variant, the decode
program and its masked variant. ``ProgramRegistry`` holds them as entries:

* ``register(name, ...)`` stores a program with an eligibility predicate
  over the engine and a ``run`` hook. Entries without a ``run`` hook (the masked variants) are dispatched by a routable program
  and never routed to.
* ``route(engine)`` returns the first registered program (registration order
  is priority) whose predicate holds: the whole of ``LLMEngine.step``'s
  choice.
* ``record_dispatch`` / ``record_complete`` count each program's issued and
  landed calls; ``quiesced()`` holds when every dispatch has been read back
  by the host, and the engine asserts it at every drain.
* ``compile_counts()``: each program's CUDA-graph captures (the reference
  counts jit cache entries). On the card the decode programs are captured,
  each at its first call; everything else runs eagerly, and on the CPU
  nothing is captured, so those read 0.

``select_decode_attn_impl`` is program metadata too: which attention kernel
the decode-shaped programs run.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Optional

from llmd_tpu_torch.ops.mla_decode import mla_decode_ref, mla_paged_attention_latent


@dataclass
class ProgramSpec:
    """One registry entry."""

    name: str
    # eligibility predicate over the live engine; None = never routed to
    # directly (the program is dispatched by another program's run hook)
    eligible: Optional[Callable[[Any], bool]] = None
    run: Optional[Callable[[Any], None]] = None


@dataclass
class _Counters:
    dispatched: int = 0
    completed: int = 0
    captures: int = 0


class ProgramRegistry:
    """Ordered program table with per-program dispatch, completion and
    capture counts."""

    def __init__(self, on_dispatch: Optional[Callable[[str], None]] = None):
        self._specs: dict[str, ProgramSpec] = {}
        self._counters: dict[str, _Counters] = {}
        self._on_dispatch = on_dispatch

    def register(self, name: str, *,
                 eligible: Optional[Callable[[Any], bool]] = None,
                 run: Optional[Callable[[Any], None]] = None) -> None:
        """Add a program."""
        if name in self._specs:
            raise ValueError(f"program {name!r} already registered")
        self._specs[name] = ProgramSpec(name=name, eligible=eligible, run=run)
        self._counters[name] = _Counters()

    def specs(self) -> list[ProgramSpec]:
        return list(self._specs.values())

    def route(self, engine) -> ProgramSpec:
        """First registered program whose eligibility predicate holds. The
        last routable program must always be eligible (the engine registers
        the decode program with ``eligible=lambda eng: True``)."""
        for spec in self._specs.values():
            if spec.run is not None and spec.eligible is not None \
                    and spec.eligible(engine):
                return spec
        raise RuntimeError("no eligible step program (registry misconfigured: "
                           "the final routable entry must always be eligible)")

    def record_dispatch(self, name: str) -> None:
        """Count one issued call of ``name``. Unregistered names (the
        deferred prefill sample, "sample") get counters of their own, so the
        quiesce check covers them too."""
        self._counters.setdefault(name, _Counters()).dispatched += 1
        if self._on_dispatch is not None:
            self._on_dispatch(name)

    def record_complete(self, name: str) -> None:
        self._counters.setdefault(name, _Counters()).completed += 1

    def record_capture(self, name: str) -> None:
        """Count one CUDA-graph capture of ``name``."""
        self._counters.setdefault(name, _Counters()).captures += 1

    def quiesced(self) -> bool:
        """True iff every program's dispatches were read back by the host."""
        return all(c.dispatched == c.completed for c in self._counters.values())

    def counters(self) -> dict[str, tuple[int, int]]:
        return {n: (c.dispatched, c.completed) for n, c in sorted(self._counters.items())}

    def compile_counts(self) -> dict[str, int]:
        """CUDA-graph captures per registered program (0 for a program that
        runs eagerly, and for every program on the CPU)."""
        return {name: self._counters[name].captures for name in self._specs}


def select_decode_attn_impl(engine, unified_attn: Callable) -> Callable:
    """Attention impl of the decode programs. GQA models share the unified
    impl (K1 serves every program). MLA models take the latent decode
    kernel K3 (``mla_paged_attention_latent``): the decode batch is exactly
    its shape, one query row per sequence over the single-plane latent pool,
    while the unified and verify programs keep ``unified_attn`` (K1 on that
    pool). Under ``attn_impl="reference"`` it is K3's plain version on every
    device; otherwise the kernel's wrapper (the kernel for CUDA tensors, its
    plain version for CPU tensors: the engine has refused ``pallas`` on the
    CPU already)."""
    if not engine.model_cfg.is_mla:
        return unified_attn
    if engine.cfg.attn_impl == "reference":
        return functools.partial(mla_paged_attention_latent, decode=mla_decode_ref)
    return mla_paged_attention_latent
