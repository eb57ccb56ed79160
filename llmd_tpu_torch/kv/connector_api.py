"""Out-of-tree KV-cache connector API (port of ``llmd_tpu/kv/connector_api.py``):
the seam through which an external cache engine plugs in.

- scheduler side: ``get_num_matched_blocks`` consults the external engine at
  admission, AFTER local HBM prefix hits and the native CPU/FS tiers; the
  connector covers the remaining suffix only;
- worker side: ``load_blocks`` writes blocks into the given fresh pages (in
  place: the pool's address is baked into the captured decode programs; it
  returns the same tensor, where the reference returns a new array) and
  ``save_blocks`` receives block-major host tensors it may hand to any store;
- lifecycle: ``request_finished`` releases per-request resources.

Connectors register by name (``register_kv_connector``) and activate through
``EngineConfig.kv_connector``.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable, Optional

import torch

if TYPE_CHECKING:
    from llmd_tpu_torch.disagg.transfer import PoolView


class KVConnectorBase:
    """Interface an external KV-cache engine implements."""

    def __init__(self, params: Optional[dict] = None) -> None:
        self.params = params or {}

    # ---------------------------------------------------------- scheduler side
    def get_num_matched_blocks(self, block_hashes: list[int]) -> int:
        """How many CONSECUTIVE blocks (from the start of the given suffix
        chain) the external engine can supply. Called under the engine lock at
        admission; must be cheap (index lookup, no IO)."""
        raise NotImplementedError

    # ------------------------------------------------------------- worker side
    def load_blocks(self, cache: "PoolView", block_hashes: list[int],
                    page_ids: list[int], pages_per_layer: int):
        """Write the block data for ``block_hashes`` into the given fresh
        pages with ``cache.insert(page_ids, blocks)``: ``cache`` is the
        engine's ``kv_pool`` (``disagg/transfer.PoolView``, every rank's
        planes under a mesh).
        Returns (cache, n_loaded); n_loaded < requested means the tail was
        unavailable after all (the engine recomputes it)."""
        raise NotImplementedError

    def save_blocks(self, block_hashes: list[int], token_chunks: list[list[int]],
                    blocks: torch.Tensor) -> None:
        """Persist block-major host blocks ([n, L, ps, 2Hk, D]) keyed by the
        chained hashes. Called off the engine loop (retirement path)."""
        raise NotImplementedError

    # -------------------------------------------------------------- lifecycle
    def request_finished(self, request_id: str) -> None:  # pragma: no cover
        pass


_REGISTRY: dict[str, Callable[[Optional[dict]], KVConnectorBase]] = {}


def register_kv_connector(name: str,
                          factory: Callable[[Optional[dict]], KVConnectorBase]) -> None:
    _REGISTRY[name] = factory


# in-tree connectors register at module import; names map to their modules so
# an EngineConfig naming one works without the caller importing it first
_BUILTIN_MODULES = {"remote-store": "llmd_tpu_torch.kv.remote_store"}


def build_kv_connector(name: str, params: Optional[dict] = None) -> KVConnectorBase:
    if name not in _REGISTRY and name in _BUILTIN_MODULES:
        import importlib

        importlib.import_module(_BUILTIN_MODULES[name])
    if name not in _REGISTRY:
        raise KeyError(f"unknown KV connector {name!r}; registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name](params)


class InMemoryKVConnector(KVConnectorBase):
    """Reference connector: a process-local dict store, the worked example and
    the CI stand-in for external engines."""

    def __init__(self, params: Optional[dict] = None) -> None:
        super().__init__(params)
        self.store: dict[int, torch.Tensor] = {}
        self.stats = {"saved_blocks": 0, "loaded_blocks": 0, "lookups": 0}

    def get_num_matched_blocks(self, block_hashes: list[int]) -> int:
        self.stats["lookups"] += 1
        n = 0
        for h in block_hashes:
            if h not in self.store:
                break
            n += 1
        return n

    def load_blocks(self, cache, block_hashes, page_ids, pages_per_layer):
        # CONSECUTIVE prefix only: the engine commits returned blocks under
        # block_hashes[:n_loaded] positionally, so skipping a missing middle
        # block would commit wrong bytes under the wrong hash
        have: list[int] = []
        for h in block_hashes[: len(page_ids)]:
            if h not in self.store:
                break
            have.append(h)
        if not have:
            return cache, 0
        blocks = torch.stack([self.store[h] for h in have])
        cache.insert(page_ids[: len(have)], blocks)
        self.stats["loaded_blocks"] += len(have)
        return cache, len(have)

    def save_blocks(self, block_hashes, token_chunks, blocks) -> None:
        for h, b in zip(block_hashes, blocks):
            self.store[h] = b.clone()
        self.stats["saved_blocks"] += len(block_hashes)


register_kv_connector("in-memory", InMemoryKVConnector)
