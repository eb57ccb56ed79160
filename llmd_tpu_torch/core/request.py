"""Sampling parameters (the fields of ``llmd_tpu/core/request.py::SamplingParams``
that this slice honours).

Structured-output, penalty, logprob and multi-sample fields exist with the
reference's names so callers can pass the same objects, but setting one away
from its default raises: their slice has not landed yet. ``stop`` strings are
applied by the server to the returned text; ``seed`` is accepted and, as in the
reference engine, draws come from the engine's own generator.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

# field -> the value that means "off"; anything else is refused
_UNSERVED = {
    "min_p": 0.0, "logprobs": None, "presence_penalty": 0.0,
    "frequency_penalty": 0.0, "repetition_penalty": 1.0, "n": 1,
    "guided_choice": None, "guided_regex": None, "response_format": None,
    "logit_bias": None,
}


@dataclass
class SamplingParams:
    """OpenAI-compatible sampling parameters understood by the engine."""

    max_tokens: int = 16
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0  # 0 = disabled
    min_p: float = 0.0
    stop: Sequence[str] = ()
    stop_token_ids: Sequence[int] = ()
    seed: Optional[int] = None
    logprobs: Optional[int] = None
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    repetition_penalty: float = 1.0
    ignore_eos: bool = False
    n: int = 1
    guided_choice: Optional[Sequence[str]] = None
    guided_regex: Optional[str] = None
    response_format: Optional[dict] = None
    logit_bias: Optional[dict] = None

    def __post_init__(self) -> None:
        for name, off in _UNSERVED.items():
            if getattr(self, name) != off:
                raise ValueError(f"SamplingParams.{name} is not served by this "
                                 "port yet (structured, penalty and logprob "
                                 "sampling are later ROADMAP items)")

    def greedy(self) -> bool:
        return self.temperature == 0.0
