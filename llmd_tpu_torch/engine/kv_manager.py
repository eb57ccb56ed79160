"""Host-side paged-KV bookkeeping (copy of ``llmd_tpu/engine/kv_manager.py``):
page allocator with content-hash prefix reuse, and per-request state.

- free-list allocation,
- automatic prefix caching: completed pages are indexed by chained block hash
  (``core/kv_events.hash_block_tokens``) and reused by later requests,
- LRU eviction of unreferenced cached pages,
- KV-event emission (BlockStored / BlockRemoved) to an optional sink,
- the offload tier's hooks: ``evict_hook`` just before a cached page is
  recycled, and ``demote_lru`` for the batched drain (``kv/offload.py``),
- LoRA: a sequence's block hashes chain its adapter's generation-scoped key
  (``Sequence.lora_key``, else ``lora_id``), each BlockStored event carries
  it, and ``purge_lora`` drops an unloaded adapter's cached blocks,
- multimodal: a sequence's media identities (``Sequence.mm_items``) are the
  extra keys of every block hash, so two prompts whose tokens agree but whose
  images differ never share a cached block.
"""

from __future__ import annotations

from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Callable, Optional

from llmd_tpu_torch.core.kv_events import (
    BlockRemoved,
    BlockStored,
    KVEvent,
    hash_block_tokens,
)


@dataclass
class PageInfo:
    refs: int = 0
    block_hash: Optional[int] = None  # set once the page holds a complete, hashed block
    lora_id: Optional[str] = None  # the adapter key the block was computed under


class PageAllocator:
    """Reference-counted page allocator with content-addressed reuse."""

    def __init__(
        self,
        num_pages: int,
        page_size: int,
        enable_prefix_caching: bool = True,
        event_sink: Optional[Callable[[list[KVEvent]], None]] = None,
        medium: str = "gpu",
    ) -> None:
        self.num_pages = num_pages
        self.page_size = page_size
        self.enable_prefix_caching = enable_prefix_caching
        self.event_sink = event_sink
        self.medium = medium
        # Called (block_hash, page_id) just before a cached page is recycled:
        # the offload connector's HBM -> CPU hook (kv/offload.py).
        self.evict_hook: Optional[Callable[[int, int], None]] = None
        self.free: deque[int] = deque(range(num_pages))
        self.pages: dict[int, PageInfo] = {}
        # block_hash → page_id for complete blocks still resident (any refcount)
        self.cached: dict[int, int] = {}
        # refcount-0 cached pages in LRU order (evictable)
        self.lru: OrderedDict[int, int] = OrderedDict()  # block_hash → page_id

    def _emit(self, events: list[KVEvent]) -> None:
        if self.event_sink and events:
            self.event_sink(events)

    @property
    def num_free(self) -> int:
        """Pages allocatable right now (truly free + evictable cached)."""
        return len(self.free) + len(self.lru)

    @property
    def num_active(self) -> int:
        return self.num_pages - self.num_free

    def match_prefix(self, block_hashes: list[int]) -> list[int]:
        """Longest consecutive resident prefix → page ids."""
        out: list[int] = []
        for h in block_hashes:
            pid = self.cached.get(h)
            if pid is None:
                break
            out.append(pid)
        return out

    def allocate(self) -> Optional[int]:
        """Allocate a fresh (uncached) page; evict the LRU cached page if needed."""
        if self.free:
            pid = self.free.popleft()
        elif self.lru:
            h, pid = self.lru.popitem(last=False)
            if self.evict_hook is not None:
                self.evict_hook(h, pid)
            del self.cached[h]
            del self.pages[pid]
            self._emit([BlockRemoved(block_hashes=[h], medium=self.medium)])
        else:
            return None
        self.pages[pid] = PageInfo(refs=1)
        return pid

    def acquire_cached(self, page_id: int) -> None:
        info = self.pages[page_id]
        if info.refs == 0 and info.block_hash is not None:
            self.lru.pop(info.block_hash, None)
        info.refs += 1

    def commit_block(
        self,
        page_id: int,
        block_hash: int,
        token_ids: list[int],
        parent_hash: Optional[int],
        lora_id: Optional[str] = None,
    ) -> None:
        """Mark a page as holding a complete block; index + announce it."""
        if not self.enable_prefix_caching:
            return
        info = self.pages[page_id]
        if info.block_hash == block_hash:
            return
        if self.cached.get(block_hash) is not None:
            # Same content computed twice (identical prompts prefilling together):
            # keep the existing entry and leave THIS page unhashed, so it returns
            # to the plain free list on release (one page per hash).
            return
        info.block_hash = block_hash
        info.lora_id = lora_id
        self.cached[block_hash] = page_id
        self._emit([
            BlockStored(
                block_hashes=[block_hash], parent_block_hash=parent_hash,
                token_ids=list(token_ids), block_size=self.page_size,
                lora_id=lora_id, medium=self.medium,
            )
        ])

    def release(self, page_id: int) -> None:
        """Drop one reference; refcount-0 pages stay cached (evictable) or free."""
        info = self.pages.get(page_id)
        if info is None:
            return
        info.refs -= 1
        if info.refs > 0:
            return
        if info.block_hash is not None and self.enable_prefix_caching:
            self.lru[info.block_hash] = page_id
            self.lru.move_to_end(info.block_hash)
        else:
            del self.pages[page_id]
            self.free.append(page_id)

    def demote_lru(self, n: int) -> list[tuple[int, int]]:
        """Pop the n oldest evictable cached pages onto the free list and return
        their (block_hash, page_id) pairs: the offload connector's batched
        drain (one device-to-host gather for the batch instead of one copy a
        page in ``allocate()``). The evict_hook is NOT called; the caller owns
        the copy-out, which is safe until the freed pages are reallocated AND
        rewritten."""
        pairs: list[tuple[int, int]] = []
        while self.lru and len(pairs) < n:
            h, pid = self.lru.popitem(last=False)
            pairs.append((h, pid))
            del self.cached[h]
            del self.pages[pid]
            self.free.append(pid)
        if pairs:
            self._emit([BlockRemoved(block_hashes=[h for h, _ in pairs], medium=self.medium)])
        return pairs

    def purge_lora(self, lora_id: str) -> int:
        """Drop the cached blocks computed under an adapter (its bare name or
        any ``name@<digest>`` key), at unload: an evictable page returns to
        the free list, a page a live sequence holds keeps serving it and is
        never matched again. Correctness does not depend on this (the hashes
        chain the generation-scoped key); it frees the pages early."""
        removed: list[int] = []
        for h, pid in list(self.cached.items()):
            info = self.pages.get(pid)
            if info is None or info.lora_id is None or not (
                    info.lora_id == lora_id or info.lora_id.startswith(lora_id + "@")):
                continue
            del self.cached[h]
            if h in self.lru:
                self.lru.pop(h)
                del self.pages[pid]
                self.free.append(pid)
            else:
                info.block_hash = None
            removed.append(h)
        if removed:
            self._emit([BlockRemoved(block_hashes=removed, medium=self.medium)])
        return len(removed)


@dataclass
class Sequence:
    """One in-flight request's engine-side state."""

    request_id: str
    token_ids: list[int]  # prompt + generated
    prompt_len: int
    max_tokens: int
    sampling: "object" = None  # SamplingParams
    lora_id: Optional[str] = None
    # the generation-scoped hash key (the engine's ``_lora_hash_key``):
    # "name@<weights digest>" under LoRA serving, else == lora_id; every block
    # hash chains it, so KV computed under other weights never matches
    lora_key: Optional[str] = None
    pages: list[int] = field(default_factory=list)
    num_computed: int = 0  # tokens whose KV is resident
    num_cached_prompt: int = 0  # tokens reused from the prefix cache
    slot: int = -1  # batch slot
    finished: bool = False
    finish_reason: Optional[str] = None
    block_hashes: list[int] = field(default_factory=list)  # chained hashes of committed blocks
    arrival_time: float = 0.0
    first_token_time: Optional[float] = None  # time.monotonic() when its first token landed
    # Speculative decoding tallies: drafted / accepted feed the per-request
    # acceptance-rate summary observed at retirement.
    spec_drafted: int = 0
    spec_accepted: int = 0
    # Per-sequence draft arming: a row whose prompt-lookup probe came up
    # empty stays disarmed until fresh tokens land for it.
    spec_armed: bool = True
    spec_flips: int = 0  # arm/disarm transitions over the sequence's life
    # Structured outputs: the automaton cursor (StructuredState) of a
    # grammar-constrained request, re-derived from token_ids (which
    # preemption keeps), and the static OpenAI logit_bias map.
    structured: Optional[object] = None
    logit_bias: Optional[dict] = None
    # multimodal: (identity, embeddings [mm_tokens, hidden]) per media item in
    # prompt order; placeholder occurrence j of token_ids takes row j % k of
    # item j // k. The identities fold into every block key.
    mm_items: list = field(default_factory=list)
    # the server's request span context (tracing.SpanContext): its trace id
    # keys the flight record and the step exemplars; a sampled one parents
    # the engine.step spans
    trace_ctx: Optional[object] = None

    @property
    def num_generated(self) -> int:
        return len(self.token_ids) - self.prompt_len

    def last_block_hash(self) -> Optional[int]:
        return self.block_hashes[-1] if self.block_hashes else None

    def maybe_commit_blocks(self, alloc: PageAllocator) -> None:
        """Hash+commit any newly completed pages (called after compute advances)."""
        ps = alloc.page_size
        committed = len(self.block_hashes)
        mm = self.mm_hashes()
        while (committed + 1) * ps <= self.num_computed:
            start = committed * ps
            chunk = self.token_ids[start : start + ps]
            key = self.lora_key if self.lora_key is not None else self.lora_id
            h = hash_block_tokens(self.last_block_hash(), chunk, key, mm)
            alloc.commit_block(self.pages[committed], h, chunk, self.last_block_hash(), key)
            self.block_hashes.append(h)
            committed += 1

    def mm_hashes(self) -> list[bytes]:
        return [h for h, _ in self.mm_items]
