"""Prompt-lookup speculative drafting (Saxena 2023): draft-model-free n-gram
matching against the request's own context.

A copy of ``llmd_tpu/engine/spec.py`` (numpy and the standard library only); tests hold
it against the original.

The drafter is pure host-side numpy over the sequence's token history
(prompt + generated). The last ``n`` tokens are matched against every
earlier position; the tokens that followed the match become the draft.
Longer n-grams are tried first (``spec_ngram_max`` down to
``spec_ngram_min``) because a longer match is a stronger predictor of the
continuation; the first hit wins. Verification happens in the engine's flat
mixed-batch program (engine.py), where greedy acceptance keeps output
bitwise identical to non-speculative decoding — the drafter only has to be
*useful*, never *correct*. Constrained rows (grammar masks / logit_bias)
are drafted the same way; the engine then trims the proposal to its longest
constraint-legal prefix (``LLMEngine._spec_filter_draft``) before the
grammar-masked verify program checks it.

This pays exactly on the traffic the ROADMAP north-star targets: shared
prefixes, agentic tool loops, and summarization, where the output echoes
spans of the prompt or of its own earlier output.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

__all__ = ["propose_ngram_draft"]


def propose_ngram_draft(token_ids: Sequence[int], k: int,
                        ngram_max: int = 3, ngram_min: int = 1) -> List[int]:
    """Propose up to ``k`` draft tokens for the next positions of ``token_ids``.

    Matches the suffix n-gram (longest first) anywhere earlier in the
    sequence and proposes the continuation that followed it. Returns [] when
    nothing matches — the engine then falls back to plain decode for this
    sequence, so an empty draft is always safe.
    """
    L = len(token_ids)
    if k <= 0 or L < ngram_min + 1:
        return []
    arr = np.asarray(token_ids, dtype=np.int64)
    # n may not exceed L-1: the suffix itself must leave at least one earlier
    # position to match against.
    for n in range(min(ngram_max, L - 1), max(ngram_min, 1) - 1, -1):
        pattern = arr[L - n:]
        # Candidate window starts: exclude the suffix occurrence itself.
        windows = np.lib.stride_tricks.sliding_window_view(arr, n)[:L - n]
        hits = np.nonzero((windows == pattern).all(axis=1))[0]
        if hits.size == 0:
            continue
        # Most recent occurrence that still has a full k-token continuation
        # (recent context is the better predictor for cyclic/echo traffic) —
        # a match butting against the end of the sequence would truncate the
        # draft to almost nothing. Fall back to the earliest hit, whose
        # continuation window is the longest available.
        full = hits[hits <= L - n - k]
        i = int(full[-1]) if full.size else int(hits[0])
        draft = arr[i + n:i + n + k]
        if draft.size:
            return [int(t) for t in draft]
    return []
