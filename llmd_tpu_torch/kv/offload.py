"""KV offload connector: HBM -> CPU -> FS tiering for the paged pool (port of
``llmd_tpu/kv/offload.py``, same names and KV events).

The pool is the flat layer-folded ``[L*P + 1, ps, planes, D]`` (the last row
is the scratch row); a logical KV page is the row set ``{l*P + page_id}``.
Offload is one gather of those rows to the host (pinned memory on the card);
a reload is a batched scatter back, in place, padded to
``offload_staging_blocks`` as the reference pads its jitted scatter: the
padding goes to the scratch row, as ``write_kv`` sends padding slots there
(the reference drops page id -1). Evicted-but-offloaded blocks keep earning
prefix hits: the engine checks HBM, then CPU, then FS at admission, and each
transition emits KV events with the right ``medium``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Optional

import torch

from llmd_tpu_torch.core.kv_events import (
    MEDIUM_CPU,
    MEDIUM_FS,
    BlockRemoved,
    BlockStored,
    KVEvent,
)
from llmd_tpu_torch.disagg.transfer import gather_pages, insert_blocks
from llmd_tpu_torch.kv.dtypes import nbytes, to_host
from llmd_tpu_torch.kv.fs_backend import FSKVBackend


class CPUOffloadStore:
    """Bounded host-memory KV block store with LRU demotion to an optional FS tier."""

    def __init__(
        self,
        capacity_blocks: int,
        fs_backend: Optional[FSKVBackend] = None,
        event_sink: Optional[Callable[[list[KVEvent]], None]] = None,
        metrics=None,
    ) -> None:
        self.capacity = capacity_blocks
        self.fs = fs_backend
        self.event_sink = event_sink
        self.metrics = metrics  # EngineMetrics (obs.metrics) or None
        self._blocks: OrderedDict[int, torch.Tensor] = OrderedDict()
        self._pending_fs: dict[int, object] = {}  # hash -> in-flight demotion future
        self.saves = 0
        self.loads = 0
        self.demotions = 0

    def _emit(self, events: list[KVEvent]) -> None:
        if self.event_sink and events:
            self.event_sink(events)

    def put(self, block_hash: int, array: torch.Tensor) -> None:
        if block_hash in self._blocks:
            self._blocks.move_to_end(block_hash)
            return
        self._blocks[block_hash] = array
        self.saves += 1
        if self.metrics is not None:
            self.metrics.offload_transfer_bytes.labels(direction="save").observe(nbytes(array))
        events: list[KVEvent] = [BlockStored(
            block_hashes=[block_hash], parent_block_hash=None, token_ids=[],
            block_size=0, medium=MEDIUM_CPU,
        )]
        while len(self._blocks) > self.capacity:
            old_hash, old_arr = self._blocks.popitem(last=False)
            if self.metrics is not None:
                self.metrics.offload_evictions.inc()
            events.append(BlockRemoved(block_hashes=[old_hash], medium=MEDIUM_CPU))
            if self.fs is not None:
                # async demotion keeps the step loop off the disk; the popped
                # tensor stays alive in the future's closure until written
                fut = self.fs.put_async(old_hash, old_arr)
                self._pending_fs[old_hash] = fut
                fut.add_done_callback(lambda _f, h=old_hash: self._pending_fs.pop(h, None))
                self.demotions += 1
                events.append(BlockStored(
                    block_hashes=[old_hash], parent_block_hash=None, token_ids=[],
                    block_size=0, medium=MEDIUM_FS,
                ))
        self._emit(events)

    def get(self, block_hash: int) -> Optional[torch.Tensor]:
        arr = self._blocks.get(block_hash)
        if arr is not None:
            self._blocks.move_to_end(block_hash)
            self.loads += 1
            self._record_hit(arr)
            return arr
        if self.fs is not None:
            fut = self._pending_fs.get(block_hash)
            if fut is not None:
                try:
                    fut.result()  # wait out an in-flight demotion write
                except OSError:
                    self._record_miss()
                    return None
            arr = self.fs.get(block_hash)
            if arr is not None:
                self.loads += 1
                self._record_hit(arr)
                return arr
        self._record_miss()
        return None

    def _record_hit(self, arr: torch.Tensor) -> None:
        if self.metrics is not None:
            self.metrics.offload_hits.inc()
            self.metrics.offload_transfer_bytes.labels(direction="load").observe(nbytes(arr))

    def _record_miss(self) -> None:
        if self.metrics is not None:
            self.metrics.offload_misses.inc()

    def contains(self, block_hash: int) -> bool:
        if block_hash in self._blocks:
            return True
        if self.fs is None:
            return False
        return block_hash in self._pending_fs or self.fs.contains(block_hash)

    def __len__(self) -> int:
        return len(self._blocks)


class KVOffloadConnector:
    """Engine-side connector: page eviction hook + batched reload into the pool.

    The engine wires ``on_evict`` into the PageAllocator (called just before a
    cached page is recycled) and calls ``match_suffix`` / ``load_into_cache``
    at admission. Reloads are padded to ``staging_blocks`` (the reference's
    STAGING_BLOCKS width)."""

    def __init__(
        self,
        num_cpu_chunks: int,
        staging_blocks: int = 16,
        fs_backend: Optional[FSKVBackend] = None,
        event_sink: Optional[Callable[[list[KVEvent]], None]] = None,
        pages_per_layer: Optional[int] = None,
        metrics=None,
        flight=None,
    ) -> None:
        self.store = CPUOffloadStore(num_cpu_chunks, fs_backend, event_sink, metrics=metrics)
        self.flight = flight  # obs.events.FlightRecorder or None
        self.staging_blocks = max(1, staging_blocks)
        # P, to gather one logical page's rows across layers; None = one layer
        self.pages_per_layer = pages_per_layer
        # optional durable-tier tee (kv/writeback.py): eviction and demotion
        # re-offer their host bytes, so the cluster store rides the same reads
        self.writeback = None

    # ------------------------------------------------------------------ evict
    def on_evict(self, cache: torch.Tensor, block_hash: int, page_id: int) -> None:
        """Backstop for demand outrunning the proactive drain: copy one
        about-to-be-recycled page to the host (one host wait a page; the
        batched ``demote_batch`` is the steady-state route). Runs inside
        ``allocate()``, never while a graph is being captured."""
        block = to_host(gather_pages(cache, [page_id], self.pages_per_layer))
        self.store.put(block_hash, block[0])
        if self.writeback is not None:
            self.writeback.offer([block_hash], block)
        if self.flight is not None:
            self.flight.record_system("kv_offload", n_blocks=1, path="evict")

    def demote_batch(self, cache: torch.Tensor, pairs: list[tuple[int, int]]) -> None:
        """Offload a batch of demoted pages in ONE gather to the host.

        ``pairs`` come from PageAllocator.demote_lru; the pages are already on
        the free list, but their contents are intact until reallocated and
        rewritten, which cannot happen before this returns (one step thread,
        and the gather is ordered on the engine's stream)."""
        if not pairs:
            return
        arr = to_host(gather_pages(cache, [pid for _, pid in pairs], self.pages_per_layer))
        for (h, _), block in zip(pairs, arr):
            self.store.put(h, block)
        if self.writeback is not None:
            self.writeback.offer([h for h, _ in pairs], arr)
        if self.flight is not None:
            self.flight.record_system("kv_offload", n_blocks=len(pairs), path="drain")

    # ------------------------------------------------------------------ match
    def match_suffix(self, block_hashes: list[int]) -> int:
        """How many consecutive leading blocks the offload tiers hold."""
        n = 0
        for h in block_hashes:
            if not self.store.contains(h):
                break
            n += 1
        return n

    # ------------------------------------------------------------------ reload
    def load_into_cache(self, cache: torch.Tensor, block_hashes: list[int],
                        page_ids: list[int], request_id: Optional[str] = None):
        """Scatter offloaded blocks back into freshly allocated pages, in place.

        Returns (cache, n_loaded): the same tensor, and a count that may stop
        short if a block vanished (the FS evictor raced us); callers
        recompute the remainder. ``request_id``: the request whose flight
        record gets the ``kv_reload`` event."""
        S = self.staging_blocks
        P = self.pages_per_layer or cache.shape[0] - 1
        L = (cache.shape[0] - 1) // P
        block_shape = (L,) + tuple(cache.shape[1:])  # [L, ps, planes, D]
        arrays: list[torch.Tensor] = []
        for h in block_hashes:
            arr = self.store.get(h)
            if arr is None:
                break
            if tuple(arr.shape) != block_shape:
                # a blob persisted under another pool layout: hashes fold
                # tokens only, so the match cannot see this; a miss (callers
                # recompute) rather than a shape-mismatched scatter
                break
            arrays.append(arr)
        n_loaded = len(arrays)
        pin = cache.device.type == "cuda"
        for start in range(0, n_loaded, S):
            group = arrays[start : start + S]
            pids = list(page_ids[start : start + len(group)]) + [-1] * (S - len(group))
            stacked = torch.zeros((S,) + block_shape, dtype=group[0].dtype, pin_memory=pin)
            for i, a in enumerate(group):
                if a.dtype == stacked.dtype:  # uint8 views: copy_ of fp8 bytes as they are
                    stacked[i].view(torch.uint8).copy_(a.view(torch.uint8))
                else:
                    stacked[i].copy_(a)
            insert_blocks(cache, pids, stacked, P)
        if self.flight is not None and request_id and n_loaded:
            self.flight.record(request_id, "kv_reload", n_blocks=n_loaded,
                               bytes=sum(a.numel() * a.element_size() for a in arrays))
        return cache, n_loaded
