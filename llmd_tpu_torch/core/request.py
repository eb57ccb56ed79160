"""The request model and the llm-d HTTP header contract (copy of
``llmd_tpu/core/request.py``): sampling parameters (every field with the
reference's name), the ``x-llm-d-*`` headers, the router's ``InferenceRequest``
and the flow-control outcomes with their HTTP codes, the chat flattening that
the router and the engine share, and the media helpers (which content parts
are media, and their cache identities).

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
import time
import uuid
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Optional, Sequence

# HTTP header contract (x-llm-d-*), verbatim for drop-in client compatibility.
HDR_OBJECTIVE = "x-llm-d-inference-objective"
HDR_FAIRNESS_ID = "x-llm-d-inference-fairness-id"
HDR_MODEL_REWRITE = "x-llm-d-model-name-rewrite"
HDR_SLO_TTFT_MS = "x-llm-d-slo-ttft-ms"
HDR_SLO_TPOT_MS = "x-llm-d-slo-tpot-ms"
HDR_PREFILLER_HOST_PORT = "x-prefiller-host-port"
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
MAX_REQUEST_ID_LEN = 128


def clamp_tenant(raw: Optional[str]) -> str:
    """The reference's tenant check: bounded length, [A-Za-z0-9._-] only;
    anything else (or nothing) is "anon"."""
    if not raw:
        return "anon"
    v = raw.strip()
    if not v or len(v) > MAX_TENANT_LEN or not set(v) <= _IDENT_CHARS:
        return "anon"
    return v


def clamp_request_id(raw: Optional[str]) -> str:
    """Validate a client x-request-id; invalid or oversized values fall back to
    a generated id rather than keying recorder entries on hostile bytes."""
    if raw:
        v = raw.strip()
        if v and len(v) <= MAX_REQUEST_ID_LEN and set(v) <= _IDENT_CHARS:
            return v
    return uuid.uuid4().hex


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


class RequestOutcome(str, Enum):
    """Flow-control dispatch outcomes and their HTTP mapping: queue full 429,
    TTL expiry or disconnect 503, shutdown 500, deadline spent in the queue 504,
    dispatched forwarded."""

    DISPATCHED = "dispatched"
    REJECTED_CAPACITY = "rejected_capacity"  # → 429
    EVICTED_TTL = "evicted_ttl"  # → 503
    EVICTED_DISCONNECT = "evicted_disconnect"  # → 503
    EVICTED_SHUTDOWN = "evicted_shutdown"  # → 500
    EVICTED_DEADLINE = "evicted_deadline"  # → 504 (client budget spent in queue)

    @property
    def http_status(self) -> int:
        return {
            RequestOutcome.DISPATCHED: 200,
            RequestOutcome.REJECTED_CAPACITY: 429,
            RequestOutcome.EVICTED_TTL: 503,
            RequestOutcome.EVICTED_DISCONNECT: 503,
            RequestOutcome.EVICTED_SHUTDOWN: 500,
            RequestOutcome.EVICTED_DEADLINE: 504,
        }[self]


@dataclass
class InferenceRequest:
    """A parsed inference request flowing through the router: built by a
    parser (openai or passthrough), enriched by data producers (token ids,
    prefix-block keys), consumed by the Filter -> Score -> Pick scheduler."""

    request_id: str = field(default_factory=lambda: uuid.uuid4().hex)
    model: str = ""
    # One of prompt (text) / messages (chat) / token_ids (pre-tokenized).
    prompt: Optional[str] = None
    messages: Optional[list[dict[str, Any]]] = None
    token_ids: Optional[list[int]] = None
    sampling: SamplingParams = field(default_factory=SamplingParams)
    streaming: bool = False
    arrival_time: float = field(default_factory=time.monotonic)

    # Header-derived routing state.
    objective: Optional[str] = None  # InferenceObjective name -> priority band
    fairness_id: str = ""  # FlowKey = (fairness_id, priority)
    tenant: str = "anon"  # clamped x-llm-d-tenant (accounting + SLO gauges)
    priority: int = 0
    slo_ttft_ms: Optional[float] = None
    slo_tpot_ms: Optional[float] = None
    # Total end-to-end budget in seconds (x-request-timeout header or router
    # default). The deadline is absolute: arrival_time + timeout_s, so queueing
    # and scheduling time decrement the budget without extra bookkeeping.
    timeout_s: Optional[float] = None
    lora_adapter: Optional[str] = None
    # Multimodal content hashes folded into block keys.
    mm_hashes: list[bytes] = field(default_factory=list)

    # Producer-attached state (typed scratch shared across plugins).
    state: dict[str, Any] = field(default_factory=dict)

    # Approximate request size for flow-control byte accounting.
    byte_size: int = 0

    def prompt_text(self) -> str:
        if self.prompt is not None:
            return self.prompt
        if self.messages is not None:
            return flatten_messages(self.messages)
        return ""

    def flow_key(self) -> tuple[str, int]:
        return (self.fairness_id, self.priority)

    def deadline(self) -> Optional[float]:
        """Absolute monotonic deadline, or None when no budget was set."""
        if self.timeout_s is None:
            return None
        return self.arrival_time + self.timeout_s

    def remaining_s(self, now: Optional[float] = None) -> Optional[float]:
        """Budget left (may be negative once expired); None = unbounded."""
        dl = self.deadline()
        if dl is None:
            return None
        return dl - (time.monotonic() if now is None else now)

    @classmethod
    def from_headers(cls, headers: dict[str, str], **kw: Any) -> "InferenceRequest":
        req = cls(**kw)
        get = {k.lower(): v for k, v in headers.items()}.get
        req.objective = get(HDR_OBJECTIVE)
        req.fairness_id = get(HDR_FAIRNESS_ID, "") or ""
        req.tenant = clamp_tenant(get(HDR_TENANT))
        # Malformed client-supplied SLO headers are ignored, not fatal.
        for hdr, attr in ((HDR_SLO_TTFT_MS, "slo_ttft_ms"), (HDR_SLO_TPOT_MS, "slo_tpot_ms")):
            raw = get(hdr)
            if raw:
                try:
                    setattr(req, attr, float(raw))
                except ValueError:
                    pass
        raw = get(HDR_REQUEST_TIMEOUT)
        if raw:
            try:
                t = float(raw)
                if t > 0:
                    req.timeout_s = t
            except ValueError:
                pass
        return req
