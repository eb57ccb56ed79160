"""LRU cache for compiled token grammars.

A copy of ``llmd_tpu/structured/cache.py`` (numpy and the standard library only); tests hold
it against the original.

Compilation (schema -> regex -> char DFA -> token lift over the vocab) is
the expensive step — milliseconds for choices, potentially seconds for large
HF vocabs — while agentic traffic reuses a handful of schemas across
thousands of requests. Keys hash the *derived regex* (so textually different
bodies that lower identically share an entry) plus a tokenizer fingerprint
(a grammar lifted over one vocab is meaningless for another).

Capacity comes from ``LLMD_STRUCTURED_CACHE_SIZE`` (default 64), read when
the process-global cache is first touched.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Callable, Optional

from llmd_tpu_torch.structured.grammar import TokenGrammar

DEFAULT_CACHE_SIZE = 64


def _env_capacity() -> int:
    try:
        return max(1, int(os.environ.get("LLMD_STRUCTURED_CACHE_SIZE",
                                         str(DEFAULT_CACHE_SIZE))))
    except ValueError:
        return DEFAULT_CACHE_SIZE


class GrammarCache:
    def __init__(self, capacity: Optional[int] = None):
        self.capacity = capacity if capacity is not None else _env_capacity()
        self._entries: OrderedDict[tuple, TokenGrammar] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def get_or_compile(self, key: tuple,
                       builder: Callable[[], TokenGrammar]) -> tuple[TokenGrammar, bool]:
        """(grammar, was_hit). The build runs outside the lock: a concurrent
        miss on the same key compiles twice rather than serializing every
        request behind one compile."""
        with self._lock:
            grammar = self._entries.get(key)
            if grammar is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                return grammar, True
        grammar = builder()
        with self._lock:
            self._entries[key] = grammar
            self._entries.move_to_end(key)
            self.misses += 1
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.evictions += 1
        return grammar, False


_global: Optional[GrammarCache] = None
_global_lock = threading.Lock()


def global_cache() -> GrammarCache:
    global _global
    with _global_lock:
        if _global is None:
            _global = GrammarCache()
        return _global


def reset_global_cache() -> None:
    """Drop the process-global cache (tests re-read the env on next use)."""
    global _global
    with _global_lock:
        _global = None
