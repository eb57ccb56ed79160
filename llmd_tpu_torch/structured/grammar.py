"""Token-level grammar: the char DFA lifted onto the tokenizer vocabulary.

A copy of ``llmd_tpu/structured/grammar.py`` (numpy and the standard library only); tests hold
it against the original.

For every live char-DFA state and every vocab token, the token's decoded
string is walked through the char automaton; tokens whose walk survives into
a live state become the state's allowed set, and the (state, token) -> state
map is the decoding-time automaton. This is the precompute that makes the
per-step cost a single array scatter: ``fill_bias`` writes 0 at allowed ids
and a large negative bias everywhere else, and the packed ``[rows, V]`` bias
is added to the logits on device before argmax/sample.

EOS is grammar-external: it is allowed exactly at accepting states (the
constrained text is complete) and moves the automaton to a synthetic
terminal state where only further EOS is allowed — so ``ignore_eos``
benchmarks keep a well-defined mask instead of counting violations.
"""

from __future__ import annotations

import numpy as np

from llmd_tpu_torch.structured.regex_dfa import UNIVERSE, CharDFA

# Additive ban bias. Finite (not -inf) so a fully-banned top-k tail softmaxes
# to ~0 instead of NaN; at float32 it dominates any real logit by ~7 orders.
NEG_BIAS = np.float32(-1e9)


def token_strings(tokenizer, vocab_size: int) -> dict[int, str]:
    """id -> decoded string for every maskable vocab entry. Specials and
    tokens containing out-of-universe characters are omitted (they can never
    satisfy a grammar, so omission == ban, the safe direction)."""
    out: dict[int, str] = {}
    special = {getattr(tokenizer, "bos_id", -1), getattr(tokenizer, "eos_id", -1)}
    for tid in range(min(tokenizer.vocab_size, vocab_size)):
        if tid in special:
            continue
        try:
            text = tokenizer.decode([tid])
        except Exception:
            continue
        if text and all(ch in UNIVERSE for ch in text):
            out[tid] = text
    return out


class TokenGrammar:
    """Immutable compiled artifact shared across requests via the LRU cache."""

    def __init__(self, dfa: CharDFA, tok_strs: dict[int, str], eos_id: int,
                 vocab_size: int):
        n = dfa.n_states
        self.eos_id = eos_id
        self.vocab_size = vocab_size
        self.start = dfa.start
        self.accept = dfa.accept
        self.terminal = n  # synthetic post-EOS state
        self.n_states = n + 1
        nxt: list[dict[int, int]] = [{} for _ in range(n)]
        for tid, text in tok_strs.items():
            # walk once per (state, token); prefix-sharing tries would speed
            # large HF vocabs but the compile is LRU-cached either way
            for s in range(n):
                st: int | None = s
                for ch in text:
                    st = dfa.trans[st].get(ch)  # type: ignore[index]
                    if st is None:
                        break
                if st is not None:
                    nxt[s][tid] = st
        self._next = nxt
        allowed: list[np.ndarray] = []
        for s in range(n):
            ids = sorted(nxt[s])
            if s in dfa.accept:
                ids.append(eos_id)
            if not ids:
                # no token can extend this live state (vocab gap): force
                # finish rather than livelock; _retire counts the truncation
                ids = [eos_id]
            allowed.append(np.asarray(ids, np.int32))
        allowed.append(np.asarray([eos_id], np.int32))  # terminal
        self._allowed = allowed

    def advance(self, state: int, tid: int) -> int | None:
        """Next state after emitting ``tid``, or None if it violates."""
        if state == self.terminal:
            return self.terminal if tid == self.eos_id else None
        if tid == self.eos_id:
            return self.terminal if state in self.accept else None
        return self._next[state].get(tid)

    def legal_prefix_len(self, state: int, tokens) -> int:
        """Length of the longest prefix of ``tokens`` that stays inside the
        grammar when consumed from ``state`` — FSM-aware draft truncation:
        the speculative drafter keeps the legal prefix of an n-gram
        continuation instead of skipping constrained rows outright."""
        n = 0
        for t in tokens:
            nxt = self.advance(state, t)
            if nxt is None:
                break
            state = nxt
            n += 1
        return n

    def allowed_ids(self, state: int) -> np.ndarray:
        return self._allowed[state]

    def is_complete(self, state: int) -> bool:
        """The constrained text parses fully at this state."""
        return state == self.terminal or state in self.accept

    def fill_bias(self, row: np.ndarray, state: int) -> None:
        """Write the additive mask for ``state`` into a ``[V]`` f32 row."""
        row.fill(NEG_BIAS)
        row[self._allowed[state]] = 0.0

    def dense_tables(self) -> tuple[np.ndarray, np.ndarray]:
        """Whole-automaton dense form for the device-resident decode chain:
        ``bias [S, V] f32`` (rows exactly as ``fill_bias`` would write them)
        and ``nxt [S, V] i32`` (state transition per emitted token).

        A violating token self-loops in ``nxt`` — the device freezes on the
        same state the host-side ``StructuredState.sync`` freeze lands on, so
        replaying the emitted tokens through ``advance`` reproduces the
        device's trajectory bit-for-bit (that replay is still how violations
        get counted). Cached on the grammar, which is itself LRU-cached.
        """
        cached = getattr(self, "_dense", None)
        if cached is not None:
            return cached
        S, V = self.n_states, self.vocab_size
        bias = np.full((S, V), NEG_BIAS, np.float32)
        nxt = np.tile(np.arange(S, dtype=np.int32)[:, None], (1, V))
        for s in range(S):
            bias[s, self._allowed[s]] = 0.0
        for s, row in enumerate(self._next):
            for tid, st in row.items():
                nxt[s, tid] = st
            if s in self.accept:
                nxt[s, self.eos_id] = self.terminal
        self._dense = (bias, nxt)
        return self._dense


class StructuredState:
    """Per-sequence automaton cursor.

    The cursor is (state, n_seen) over ``token_ids[prompt_len:]`` and is
    re-derived lazily from the sequence's own token history — preemption
    resets KV/progress but never generated tokens, so ``sync`` after
    re-prefill lands on exactly the pre-preemption state with no extra
    bookkeeping in the preemption path.
    """

    __slots__ = ("grammar", "kind", "state", "n_seen", "violations",
                 "mask_logged")

    def __init__(self, grammar: TokenGrammar, kind: str):
        self.grammar = grammar
        self.kind = kind
        self.state = grammar.start
        self.n_seen = 0
        self.violations = 0
        self.mask_logged = False

    def sync(self, token_ids: list[int], prompt_len: int) -> int:
        """Advance over tokens appended since the last sync; returns how many
        violated the grammar (state freezes at the first violation)."""
        gen = token_ids[prompt_len:]
        if self.n_seen > len(gen):  # defensive: token history never shrinks
            self.state, self.n_seen = self.grammar.start, 0
        fresh_violations = 0
        for tid in gen[self.n_seen:]:
            nxt = self.grammar.advance(self.state, tid)
            if nxt is None:
                fresh_violations += 1
            else:
                self.state = nxt
            self.n_seen += 1
        self.violations += fresh_violations
        return fresh_violations

    @property
    def complete(self) -> bool:
        return self.grammar.is_complete(self.state)
