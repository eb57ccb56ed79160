"""Character-level regex -> DFA compiler for constrained decoding.

A copy of ``llmd_tpu/structured/regex_dfa.py`` (numpy and the standard library only); tests hold
it against the original.

Self-contained (the zero-egress image has no outlines/xgrammar): a small
regex dialect is parsed to an AST, lowered to a Thompson epsilon-NFA whose
edges carry character *sets*, then determinized by subset construction and
trimmed to live states (states from which an accepting state is reachable).
The result is the char-level automaton `grammar.TokenGrammar` lifts to the
tokenizer vocabulary (Willard & Louf 2023, "Efficient Guided Generation").

Supported syntax: literals, `.`, escapes (`\\d \\D \\w \\W \\s \\S \\n \\t
\\r` + escaped literal), classes `[a-z0-9_]` / negated `[^...]`, groups
`(...)` (and non-capturing `(?:...)`), alternation `|`, quantifiers `* + ?
{m} {m,} {m,n}`, and anchors `^`/`$` (no-ops: matching is always
full-string). Everything is defined over a finite printable-ASCII universe,
which keeps `.`, negated classes, and `\\D/\\W/\\S` finite — tokens
containing characters outside the universe simply can never be allowed,
which is the correct degradation for a constrainer (it restricts, never
widens).
"""

from __future__ import annotations

from dataclasses import dataclass

# Finite character universe (printable ASCII + \t \n \r). `.`, negated
# classes, and complement escapes expand over exactly this set.
UNIVERSE: frozenset[str] = (frozenset(chr(c) for c in range(32, 127))
                            | frozenset("\t\n\r"))

_DIGITS = frozenset("0123456789")
_WORD = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_")
_SPACE = frozenset(" \t\n\r")

# Bounded-repetition expansion is literal copies; cap it so a hostile
# {1,100000} cannot DoS the compiler (requests hit this as a 400).
MAX_REPEAT = 256
# Subset construction is worst-case exponential; a hostile pattern must fail
# compilation (-> 400), not stall the serving process.
MAX_DFA_STATES = 20000


class RegexError(ValueError):
    """Unsupported or malformed pattern (maps to HTTP 400 at the servers)."""


def escape_literal(text: str) -> str:
    """Escape ``text`` so it matches itself under this dialect."""
    return "".join("\\" + ch if ch in "\\.^$*+?()[]{}|" else ch
                   for ch in text)


# ------------------------------------------------------------------ AST
# nodes: ("lit", frozenset[str]) | ("cat", [nodes]) | ("alt", [nodes])
#        | ("rep", node, lo, hi|None)

_ESCAPES = {
    "d": _DIGITS, "D": UNIVERSE - _DIGITS,
    "w": _WORD, "W": UNIVERSE - _WORD,
    "s": _SPACE, "S": UNIVERSE - _SPACE,
}
_ESCAPE_LITERALS = {"n": "\n", "t": "\t", "r": "\r"}


class _Parser:
    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0

    def _peek(self) -> str | None:
        return self.p[self.i] if self.i < len(self.p) else None

    def _next(self) -> str:
        ch = self.p[self.i]
        self.i += 1
        return ch

    def parse(self):
        node = self._alt()
        if self.i != len(self.p):
            raise RegexError(f"unexpected {self.p[self.i]!r} at {self.i}")
        return node

    def _alt(self):
        branches = [self._cat()]
        while self._peek() == "|":
            self._next()
            branches.append(self._cat())
        return branches[0] if len(branches) == 1 else ("alt", branches)

    def _cat(self):
        parts = []
        while self._peek() not in (None, "|", ")"):
            parts.append(self._repeat())
        if len(parts) == 1:
            return parts[0]
        return ("cat", parts)

    def _repeat(self):
        node = self._atom()
        while True:
            ch = self._peek()
            if ch == "*":
                self._next()
                node = ("rep", node, 0, None)
            elif ch == "+":
                self._next()
                node = ("rep", node, 1, None)
            elif ch == "?":
                self._next()
                node = ("rep", node, 0, 1)
            elif ch == "{":
                node = ("rep", node, *self._braces())
            else:
                return node

    def _braces(self) -> tuple[int, int | None]:
        start = self.i
        self._next()  # "{"
        body = ""
        while self._peek() not in (None, "}"):
            body += self._next()
        if self._peek() is None:
            raise RegexError(f"unterminated {{...}} at {start}")
        self._next()  # "}"
        try:
            if "," not in body:
                lo = hi = int(body)
            else:
                lo_s, hi_s = body.split(",", 1)
                lo = int(lo_s) if lo_s else 0
                hi = int(hi_s) if hi_s else None
        except ValueError:
            raise RegexError(f"bad repetition {{{body}}}") from None
        if hi is not None and (hi < lo or hi > MAX_REPEAT):
            raise RegexError(f"bad repetition bounds {{{body}}} "
                             f"(max {MAX_REPEAT})")
        if lo > MAX_REPEAT:
            raise RegexError(f"repetition too large {{{body}}}")
        return lo, hi

    def _atom(self):
        ch = self._next()
        if ch == "(":
            if self.p[self.i:self.i + 2] == "?:":
                self.i += 2
            elif self._peek() == "?":
                raise RegexError(f"unsupported group (?{self.p[self.i + 1:self.i + 2]}...)")
            node = self._alt()
            if self._peek() != ")":
                raise RegexError("unbalanced (")
            self._next()
            return node
        if ch == "[":
            return ("lit", self._cls())
        if ch == "\\":
            return ("lit", self._escape())
        if ch == ".":
            return ("lit", UNIVERSE)
        if ch in "^$":
            return ("cat", [])  # anchors are no-ops under full matching
        if ch in "*+?{":
            raise RegexError(f"nothing to repeat before {ch!r}")
        if ch in ")|":
            raise RegexError(f"unexpected {ch!r}")
        return ("lit", frozenset((ch,)))

    def _escape(self) -> frozenset[str]:
        if self._peek() is None:
            raise RegexError("dangling backslash")
        ch = self._next()
        if ch in _ESCAPES:
            return _ESCAPES[ch]
        return frozenset((_ESCAPE_LITERALS.get(ch, ch),))

    def _cls(self) -> frozenset[str]:
        negate = False
        if self._peek() == "^":
            self._next()
            negate = True
        chars: set[str] = set()
        first = True
        while True:
            ch = self._peek()
            if ch is None:
                raise RegexError("unterminated [...]")
            if ch == "]" and not first:
                self._next()
                break
            first = False
            self._next()
            if ch == "\\":
                chars |= self._escape()
                continue
            # range a-z (a lone trailing "-" is a literal)
            if self._peek() == "-" and self.p[self.i + 1:self.i + 2] not in ("", "]"):
                self._next()
                hi = self._next()
                if hi == "\\":
                    hi = next(iter(self._escape()))
                if ord(hi) < ord(ch):
                    raise RegexError(f"bad range {ch}-{hi}")
                chars |= {chr(c) for c in range(ord(ch), ord(hi) + 1)}
            else:
                chars.add(ch)
        return frozenset(UNIVERSE - chars) if negate else frozenset(chars)


# ------------------------------------------------------------ NFA -> DFA


class _NFA:
    def __init__(self):
        self.eps: list[list[int]] = []
        self.edges: list[list[tuple[frozenset[str], int]]] = []

    def state(self) -> int:
        self.eps.append([])
        self.edges.append([])
        return len(self.eps) - 1

    def build(self, node) -> tuple[int, int]:
        kind = node[0]
        if kind == "lit":
            s, e = self.state(), self.state()
            if node[1]:
                self.edges[s].append((node[1], e))
            else:  # empty class matches nothing: s has no out-edges
                pass
            return s, e
        if kind == "cat":
            s = cur = self.state()
            for child in node[1]:
                cs, ce = self.build(child)
                self.eps[cur].append(cs)
                cur = ce
            return s, cur
        if kind == "alt":
            s, e = self.state(), self.state()
            for child in node[1]:
                cs, ce = self.build(child)
                self.eps[s].append(cs)
                self.eps[ce].append(e)
            return s, e
        if kind == "rep":
            _, child, lo, hi = node
            s = cur = self.state()
            for _ in range(lo):
                cs, ce = self.build(child)
                self.eps[cur].append(cs)
                cur = ce
            if hi is None:  # star/plus tail: loop
                cs, ce = self.build(child)
                e = self.state()
                self.eps[cur] += [cs, e]
                self.eps[ce] += [cs, e]
                return s, e
            # bounded optional copies, each skippable to the end
            e = self.state()
            for _ in range(hi - lo):
                cs, ce = self.build(child)
                self.eps[cur] += [cs, e]
                cur = ce
            self.eps[cur].append(e)
            return s, e
        raise AssertionError(f"unknown node {kind}")


def _closure(states: set[int], eps: list[list[int]]) -> frozenset[int]:
    seen = set(states)
    stack = list(states)
    while stack:
        for nxt in eps[stack.pop()]:
            if nxt not in seen:
                seen.add(nxt)
                stack.append(nxt)
    return frozenset(seen)


@dataclass(frozen=True)
class CharDFA:
    """Trimmed char-level DFA: every state can still reach acceptance."""

    start: int
    accept: frozenset[int]
    trans: tuple[dict[str, int], ...]

    @property
    def n_states(self) -> int:
        return len(self.trans)


def compile_regex(pattern: str) -> CharDFA:
    """Full-match DFA for ``pattern``; raises RegexError on unsupported or
    unsatisfiable (matches-nothing) patterns."""
    nfa = _NFA()
    start, end = nfa.build(_Parser(pattern).parse())

    start_set = _closure({start}, nfa.eps)
    ids: dict[frozenset[int], int] = {start_set: 0}
    trans: list[dict[str, int]] = [{}]
    accept: set[int] = set()
    queue = [start_set]
    while queue:
        cur = queue.pop()
        cid = ids[cur]
        if end in cur:
            accept.add(cid)
        moves: dict[str, set[int]] = {}
        for ns in cur:
            for chars, tgt in nfa.edges[ns]:
                for ch in chars:
                    moves.setdefault(ch, set()).add(tgt)
        for ch, tgts in moves.items():
            nxt = _closure(tgts, nfa.eps)
            if nxt not in ids:
                if len(ids) >= MAX_DFA_STATES:
                    raise RegexError(
                        f"pattern too complex (> {MAX_DFA_STATES} DFA states)")
                ids[nxt] = len(ids)
                trans.append({})
                queue.append(nxt)
            trans[cid][ch] = ids[nxt]

    # trim to live states (can reach an accepting state)
    rev: list[set[int]] = [set() for _ in trans]
    for sid, edges in enumerate(trans):
        for tgt in edges.values():
            rev[tgt].add(sid)
    live = set(accept)
    stack = list(accept)
    while stack:
        for src in rev[stack.pop()]:
            if src not in live:
                live.add(src)
                stack.append(src)
    if 0 not in live:
        raise RegexError("pattern matches no strings")
    remap = {old: new for new, old in enumerate(sorted(live))}
    new_trans = tuple(
        {ch: remap[t] for ch, t in trans[old].items() if t in live}
        for old in sorted(live))
    return CharDFA(start=remap[0],
                   accept=frozenset(remap[a] for a in accept),
                   trans=new_trans)
