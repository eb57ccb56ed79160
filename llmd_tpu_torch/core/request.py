"""Sampling parameters (``llmd_tpu/core/request.py::SamplingParams``, every
field with the reference's name), the deadline and tenant headers, the chat flattening
that the router and the engine share, and the media helpers (which content
parts are media, and their cache identities).

As in the reference, ``min_p``, ``logprobs``, the penalties and ``n`` are
accepted and not acted on (one choice per request; the reference's
``apply_penalties`` has no caller). The structured-output fields
(``guided_choice``, ``guided_regex``, ``response_format``) and ``logit_bias``
are served by the engine (``llmd_tpu_torch/structured``). ``stop`` strings are
applied by the server to the returned text; ``seed`` is accepted and, as in
the reference engine, draws come from the engine's own generator.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Any, Optional, Sequence

# End-to-end deadline header: seconds of budget left. The router decrements it
# across its queue wait and forwards the remainder, so the engine sees how much
# budget the client has left.
HDR_REQUEST_TIMEOUT = "x-request-timeout"
# Tenant identity for per-tenant accounting (the router forwards the clamped
# value, so engine-side flight records and phase ledgers carry it too).
HDR_TENANT = "x-llm-d-tenant"
# identifier hygiene: the tenant becomes a flight-recorder field and a label
# value, so a hostile header must not mint fresh label sets
_IDENT_CHARS = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789._-")
MAX_TENANT_LEN = 64


def clamp_tenant(raw: Optional[str]) -> str:
    """The reference's tenant check: bounded length, [A-Za-z0-9._-] only;
    anything else (or nothing) is "anon"."""
    if not raw:
        return "anon"
    v = raw.strip()
    if not v or len(v) > MAX_TENANT_LEN or not set(v) <= _IDENT_CHARS:
        return "anon"
    return v


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
    # Structured outputs (llmd_tpu_torch/structured): guided_* follow vLLM's
    # guided decoding surface, response_format the OpenAI one ({"type":
    # "json_object" | "json_schema", ...}).
    guided_choice: Optional[Sequence[str]] = None
    guided_regex: Optional[str] = None
    response_format: Optional[dict] = None
    # OpenAI logit_bias: token id -> additive bias in [-100, 100]; -100 bans.
    logit_bias: Optional[dict] = None

    def greedy(self) -> bool:
        return self.temperature == 0.0

    def constrained(self) -> bool:
        """True when decoding needs the biased sampler (grammar or bias)."""
        return bool(self.guided_choice or self.guided_regex or self.logit_bias
                    or (isinstance(self.response_format, dict)
                        and self.response_format.get("type")
                        in ("json_object", "json_schema")))


def media_url_of_part(part: Any) -> "tuple[Optional[str], Optional[str]]":
    """(kind, payload url or data) of a media content part, else (None, None)."""
    if not isinstance(part, dict):
        return None, None
    kind = part.get("type")
    if kind == "image_url":
        url = (part.get("image_url") or {}).get("url", "")
    elif kind in ("input_audio", "video_url", "audio_url"):
        sub = part.get(kind) or {}
        url = sub.get("url", "") or sub.get("data", "")
    else:
        return None, None
    return (kind, str(url)) if url else (kind, None)


def _is_inline_payload(url: Optional[str]) -> bool:
    """The inline-media rule: a ``data:`` URI. Every media predicate and
    identity below derives from it, so the router's and the engine's cache
    keys agree."""
    return url is not None and url.startswith("data:")


def part_is_inline_media(part: Any) -> bool:
    """True for the parts the serving stack treats as media: inline ``data:``
    URIs (a remote URL is text to the cache)."""
    return _is_inline_payload(media_url_of_part(part)[1])


def _mm_hash(part: dict[str, Any]) -> Optional[bytes]:
    """Cache identity of one inline media part: sha256 over ``kind:`` and the
    URI, so the same bytes sent as image and as video are two identities.
    None for anything that is not inline media."""
    kind, url = media_url_of_part(part)
    if not _is_inline_payload(url):
        return None
    return hashlib.sha256(f"{kind}:".encode() + url.encode()).digest()


def mm_hashes_from_messages(messages: Sequence[dict[str, Any]]) -> list[bytes]:
    """The media identities of a chat, in order of appearance: the extra keys
    folded into every block key of its prompt."""
    hashes: list[bytes] = []
    for m in messages:
        content = m.get("content")
        if isinstance(content, list):
            for part in content:
                if isinstance(part, dict) and (h := _mm_hash(part)) is not None:
                    hashes.append(h)
    return hashes


def flatten_messages(messages: Sequence[dict[str, Any]]) -> str:
    """Canonical chat-to-text flattening (reference ``flatten_messages``).

    The router computes block keys over this rendering, so the engine must
    use the same one: ``role: content`` lines joined by newlines, text parts
    joined by spaces, and media parts rendered as ``<kind:hash16>``
    placeholders (``<kind>`` when the part carries no payload)."""
    out = []
    for m in messages:
        content = m.get("content", "")
        if isinstance(content, list):
            pieces = []
            for part in content:
                if not isinstance(part, dict):  # a bare string in the parts list
                    pieces.append(str(part))
                elif part.get("type") == "text":
                    pieces.append(part.get("text", ""))
                else:
                    kind, url = media_url_of_part(part)
                    kind = kind or part.get("type", "media")
                    pieces.append(
                        f"<{kind}:{hashlib.sha256(url.encode()).hexdigest()[:16]}>"
                        if url else f"<{kind}>")
            content = " ".join(pieces)
        out.append(f"{m.get('role', '')}: {content}")
    return "\n".join(out)
