"""KV-event schema and chained block hashing (copy of ``llmd_tpu/core/kv_events.py``
without the msgpack wire codec; KV-event publication is a later slice).

Block-key chaining: key_i = H(key_{i-1} ‖ tokens_i ‖ lora ‖ mm_extra), so a block
is only reusable behind its unbroken prefix chain. Hashes are sha256-based and
bit-identical to the reference's, so router-side keys match.
"""

from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass, field
from typing import Iterable, Optional, Sequence, Union

MEDIUM_HBM = "gpu"  # tier name kept from the reference for scorer-weight parity


@dataclass
class BlockStored:
    block_hashes: list[int]
    parent_block_hash: Optional[int]
    token_ids: list[int]  # concatenated token chunk covered by these blocks
    block_size: int
    lora_id: Optional[str] = None
    medium: str = MEDIUM_HBM
    extra_keys: list[bytes] = field(default_factory=list)


@dataclass
class BlockRemoved:
    block_hashes: list[int]
    medium: str = MEDIUM_HBM


@dataclass
class AllBlocksCleared:
    pass


KVEvent = Union[BlockStored, BlockRemoved, AllBlocksCleared]


def hash_block_tokens(
    parent_hash: Optional[int],
    token_ids: Sequence[int],
    lora_id: Optional[str] = None,
    extra_keys: Iterable[bytes] = (),
) -> int:
    """Content hash of one KV block, chained to its parent (stable across
    processes: sha256, not Python ``hash()``)."""
    h = hashlib.sha256()
    h.update(struct.pack("<q", -1 if parent_hash is None else parent_hash))
    h.update(struct.pack(f"<{len(token_ids)}i", *token_ids))
    if lora_id:
        h.update(lora_id.encode())
    for k in extra_keys:
        h.update(k)
    return struct.unpack("<q", h.digest()[:8])[0]


def block_keys_for_tokens(
    token_ids: Sequence[int],
    block_size: int,
    lora_id: Optional[str] = None,
    mm_hashes: Iterable[bytes] = (),
) -> list[int]:
    """Chained block keys for a full token sequence (only complete blocks are keyed)."""
    keys: list[int] = []
    parent: Optional[int] = None
    mm = list(mm_hashes)
    for i in range(0, len(token_ids) - len(token_ids) % block_size, block_size):
        parent = hash_block_tokens(parent, token_ids[i : i + block_size], lora_id, mm)
        keys.append(parent)
    return keys
