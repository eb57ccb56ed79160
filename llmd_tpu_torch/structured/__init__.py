"""Structured outputs: grammar-constrained decoding with on-device masks.

A copy of ``llmd_tpu/structured/__init__.py`` (numpy and the standard library only); tests hold
it against the original.

Pipeline: an OpenAI-shaped request (``guided_choice`` / ``guided_regex`` /
``response_format`` json_object|json_schema) lowers to a regex
(`json_schema.py`), compiles to a char-level DFA (`regex_dfa.py`), lifts to
a token-level automaton over the real tokenizer vocab (`grammar.py`), and is
shared across requests through an LRU keyed by regex hash + tokenizer
fingerprint (`cache.py`). At each step the engine extracts the current
state's allow-set into a packed ``[rows, V]`` additive bias the sampler adds
on device — logits never leave the accelerator, and engines that never see
a structured request never compile the biased sampler (lazy jit, mirroring
``spec.py``).

Validation is split to fail fast: ``validate_structured_body`` needs no
tokenizer (router + engine frontend reject malformed bodies as 400 before
flow control/admission); ``compile_grammar`` does the vocab lift engine-side.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Optional

from llmd_tpu_torch.structured.cache import (
    GrammarCache,
    global_cache,
    reset_global_cache,
)
from llmd_tpu_torch.structured.grammar import (
    NEG_BIAS,
    StructuredState,
    TokenGrammar,
    token_strings,
)
from llmd_tpu_torch.structured.json_schema import (
    json_object_regex,
    regex_for_schema,
    validate_instance,
)
from llmd_tpu_torch.structured.regex_dfa import (
    RegexError,
    compile_regex,
    escape_literal,
)

__all__ = [
    "GrammarCache", "NEG_BIAS", "RegexError", "StructuredState",
    "TokenGrammar", "compile_grammar", "compile_regex", "escape_literal",
    "global_cache", "json_object_regex", "parse_logit_bias",
    "regex_for_schema", "reset_global_cache", "spec_to_regex",
    "structured_spec", "token_strings", "validate_instance",
    "validate_structured_body",
]


def structured_spec(sampling) -> Optional[tuple[str, Any]]:
    """(kind, payload) a SamplingParams constrains to, or None. Precedence
    follows vLLM: explicit guided_* beats response_format."""
    if getattr(sampling, "guided_choice", None):
        return ("choice", list(sampling.guided_choice))
    if getattr(sampling, "guided_regex", None):
        return ("regex", sampling.guided_regex)
    rf = getattr(sampling, "response_format", None)
    if isinstance(rf, dict):
        typ = rf.get("type")
        if typ == "json_object":
            return ("json_object", None)
        if typ == "json_schema":
            return ("json_schema", (rf.get("json_schema") or {}).get("schema"))
    return None


def spec_to_regex(kind: str, payload) -> str:
    if kind == "choice":
        if not payload or not all(isinstance(c, str) and c for c in payload):
            raise ValueError("guided_choice must be a non-empty list of "
                             "non-empty strings")
        return "(" + "|".join(escape_literal(c) for c in payload) + ")"
    if kind == "regex":
        if not isinstance(payload, str) or not payload:
            raise ValueError("guided_regex must be a non-empty string")
        return payload
    if kind == "json_object":
        return json_object_regex()
    if kind == "json_schema":
        if not isinstance(payload, dict):
            raise ValueError("response_format.json_schema.schema must be an "
                             "object")
        return regex_for_schema(payload)
    raise ValueError(f"unknown structured kind {kind!r}")


def parse_logit_bias(raw) -> Optional[dict[int, float]]:
    """OpenAI ``logit_bias``: {token_id: bias in [-100, 100]} with string or
    int keys. Returns a normalized {int: float} map (None when absent/empty);
    raises ValueError on malformed input."""
    if raw is None:
        return None
    if not isinstance(raw, dict):
        raise ValueError("logit_bias must be an object of token_id -> bias")
    out: dict[int, float] = {}
    for key, val in raw.items():
        try:
            tid = int(key)
            bias = float(val)
        except (TypeError, ValueError):
            raise ValueError(
                f"logit_bias entry {key!r}: {val!r} is not token_id -> "
                f"number") from None
        if tid < 0:
            raise ValueError(f"logit_bias token id {tid} is negative")
        if not -100.0 <= bias <= 100.0:
            raise ValueError(f"logit_bias value {bias} outside [-100, 100]")
        out[tid] = bias
    return out or None


def validate_structured_body(body: dict) -> None:
    """Tokenizer-free structural validation of an OpenAI request body; raises
    ValueError (-> 400) on malformed structured fields. Runs at the router
    (before flow control) and the engine frontend (before admission)."""
    rf = body.get("response_format")
    if rf is not None:
        if not isinstance(rf, dict):
            raise ValueError("response_format must be an object")
        typ = rf.get("type")
        if typ not in ("text", "json_object", "json_schema"):
            raise ValueError(f"unsupported response_format.type {typ!r}")
    parse_logit_bias(body.get("logit_bias"))
    sampling_like = _BodyView(body)
    spec = structured_spec(sampling_like)
    if spec is not None:
        # full lowering to the char-level automaton: catches unsupported
        # schema constructs AND unsatisfiable patterns, without the vocab lift
        compile_regex(spec_to_regex(*spec))


class _BodyView:
    """Duck-types a raw request body as SamplingParams for structured_spec."""

    def __init__(self, body: dict):
        self.guided_choice = body.get("guided_choice")
        self.guided_regex = body.get("guided_regex")
        self.response_format = body.get("response_format")


def grammar_key(kind: str, regex: str, tokenizer, vocab_size: int) -> tuple:
    fingerprint = (type(tokenizer).__name__, tokenizer.vocab_size,
                   tokenizer.eos_id)
    return (fingerprint, kind,
            hashlib.sha256(regex.encode()).hexdigest(), vocab_size)


def compile_grammar(kind: str, payload, tokenizer, vocab_size: int,
                    cache: Optional[GrammarCache] = None) -> tuple[TokenGrammar, bool]:
    """Compile (or fetch) the token grammar for a request. Returns
    (grammar, cache_hit); raises ValueError on malformed specs."""
    regex = spec_to_regex(kind, payload)
    cache = cache if cache is not None else global_cache()

    def build() -> TokenGrammar:
        return TokenGrammar(compile_regex(regex),
                            token_strings(tokenizer, vocab_size),
                            tokenizer.eos_id, vocab_size)

    return cache.get_or_compile(
        grammar_key(kind, regex, tokenizer, vocab_size), build)


def canonical_payload(kind: str, payload) -> str:
    """Stable textual form of a spec (flight-recorder provenance)."""
    if kind == "json_schema":
        return json.dumps(payload, sort_keys=True)
    if kind == "choice":
        return json.dumps(payload)
    return str(payload)
