"""POSIX-filesystem KV block store (port of ``llmd_tpu/kv/fs_backend.py``;
its files are byte-for-byte the reference's, so a JAX pod and a port pod
sharing an ``offload_fs_path`` read each other's blocks). Blocks are torch
CPU tensors; dtypes are named as numpy names them (``kv/dtypes.py``), with
no ``ml_dtypes``.

Parity: reference kv-offloader.md:120-169,183-207 — KV blocks stored as files on any
shared POSIX FS (CephFS/Lustre/NVMe-local), the **directory is the index** (no extra
metadata service: presence of the file = presence of the block), writes are
atomic (tmp + rename) so concurrent writers of the same content-addressed block are
idempotent, and there is **no internal eviction** — an external evictor
(`evict_to_bytes`, the PVC Evictor analogue) trims by LRU mtime.

Blocks are content-addressed by their chained block hash, sharded into 256 prefix
directories to keep directory listings bounded.
"""

from __future__ import annotations

import json
import os
import struct
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import torch

from llmd_tpu_torch.kv.dtypes import dtype_name, from_bytes, to_bytes


def _hash_hex(block_hash: int) -> str:
    return struct.pack("<q", block_hash).hex()


def _hex_hash(hexstr: str) -> int:
    return struct.unpack("<q", bytes.fromhex(hexstr))[0]


class FSKVBackend:
    """KV blocks as files; directory = index; async-capable via a thread pool
    (the reference uses a NUMA-aware pool of 64 threads/GPU — here sized by arg)."""

    def __init__(self, shared_storage_path: str, threads: int = 4) -> None:
        self.root = shared_storage_path
        os.makedirs(self.root, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=threads, thread_name_prefix="fskv")
        self._lock = threading.Lock()
        self.puts = 0
        self.gets = 0
        self.misses = 0

    # ------------------------------------------------------------------ paths
    def _path(self, block_hash: int) -> str:
        h = _hash_hex(block_hash)
        return os.path.join(self.root, h[:2], h + ".kvblock")

    # ------------------------------------------------------------------ ops
    def put(self, block_hash: int, array: torch.Tensor) -> None:
        """Atomic write; concurrent identical writes are harmless (same content)."""
        path = self._path(block_hash)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        meta = {"shape": list(array.shape), "dtype": dtype_name(array.dtype)}
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                header = json.dumps(meta).encode()
                f.write(struct.pack("<I", len(header)))
                f.write(header)
                f.write(to_bytes(array))
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self.puts += 1

    def put_async(self, block_hash: int, array: torch.Tensor):
        return self._pool.submit(self.put, block_hash, array)

    def get(self, block_hash: int) -> Optional[torch.Tensor]:
        path = self._path(block_hash)
        try:
            with open(path, "rb") as f:
                (hlen,) = struct.unpack("<I", f.read(4))
                meta = json.loads(f.read(hlen))
                raw = bytearray(f.read())
            os.utime(path)  # refresh LRU mtime for the external evictor
            block = from_bytes(raw, meta["dtype"], meta["shape"])
        except (OSError, ValueError, TypeError, RuntimeError, json.JSONDecodeError):
            self.misses += 1
            return None
        self.gets += 1
        return block

    def contains(self, block_hash: int) -> bool:
        return os.path.exists(self._path(block_hash))

    def remove(self, block_hash: int) -> bool:
        try:
            os.unlink(self._path(block_hash))
            return True
        except OSError:
            return False

    # ------------------------------------------------------------------ index
    def scan(self) -> Iterator[int]:
        """Directory walk = the index (kv-offloader.md 'directory=index')."""
        for shard in sorted(os.listdir(self.root)):
            sdir = os.path.join(self.root, shard)
            if not os.path.isdir(sdir):
                continue
            for name in os.listdir(sdir):
                if name.endswith(".kvblock"):
                    yield _hex_hash(name[: -len(".kvblock")])

    def total_bytes(self) -> int:
        total = 0
        for dirpath, _, files in os.walk(self.root):
            for f in files:
                if f.endswith(".kvblock"):
                    total += os.path.getsize(os.path.join(dirpath, f))
        return total

    # ------------------------------------------------------------------ evictor
    def evict_to_bytes(self, max_bytes: int) -> list[int]:
        """External-evictor pass (PVC Evictor analogue): drop oldest-mtime blocks
        until total size ≤ max_bytes. Returns evicted hashes (for KV events)."""
        entries = []
        for dirpath, _, files in os.walk(self.root):
            for f in files:
                if f.endswith(".kvblock"):
                    p = os.path.join(dirpath, f)
                    try:
                        st = os.stat(p)
                    except OSError:
                        continue
                    entries.append((st.st_mtime, st.st_size, p, f))
        total = sum(e[1] for e in entries)
        evicted: list[int] = []
        for mtime, size, path, name in sorted(entries):
            if total <= max_bytes:
                break
            try:
                os.unlink(path)
                total -= size
                evicted.append(_hex_hash(name[: -len(".kvblock")]))
            except OSError:
                pass
        return evicted

    def close(self) -> None:
        self._pool.shutdown(wait=True)
