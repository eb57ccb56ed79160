"""Pool-level snapshot store: engine-config-fingerprinted warm-start state
(copy of ``llmd_tpu/pool/snapshot.py``; the same fingerprints and layout, so
either package reads a store the other wrote).

A cold 0→1 transition pays the full engine build; for a port replica on the
card that is mostly nvcc building the kernel libraries. Everything in that
path is a pure function of the engine config, so the pool controller
snapshots the reusable artifacts once per config fingerprint and later
launches against the snapshot:

- fake mode: the snapshot's existence itself is the signal — the simulated
  engine-build delay is skipped;
- engine mode: the snapshot directory carries the compile cache, handed to
  ``engine/serve.py`` via ``--compile-cache-dir`` so the relaunch loads the
  built kernel libraries instead of compiling them (``native/build.py``).

Fingerprints are sha256 over the sorted-JSON engine config, mirroring how
the engine's own compile cache keys on (program shape, flags).
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Any, Optional


def config_fingerprint(config: dict[str, Any]) -> str:
    """Stable hash of an engine config dict (order-insensitive)."""
    blob = json.dumps(config, sort_keys=True, separators=(",", ":"),
                      default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


class PoolSnapshotStore:
    """Filesystem store of per-fingerprint warm-start snapshots.

    Layout: ``<root>/<fingerprint>/meta.json`` plus whatever artifact
    directories the launcher parks next to it (``checkpoint/``,
    ``compile_cache/``). ``meta.json`` is written last, atomically, so a
    half-built snapshot never reads as warm.
    """

    def __init__(self, root_dir: str) -> None:
        self.root = root_dir
        os.makedirs(root_dir, exist_ok=True)

    def _dir(self, fingerprint: str) -> str:
        return os.path.join(self.root, fingerprint)

    def _meta_path(self, fingerprint: str) -> str:
        return os.path.join(self._dir(fingerprint), "meta.json")

    def has(self, fingerprint: str) -> bool:
        return os.path.exists(self._meta_path(fingerprint))

    def path(self, fingerprint: str, *parts: str) -> str:
        """Artifact path inside the snapshot dir (created on demand)."""
        d = os.path.join(self._dir(fingerprint), *parts)
        os.makedirs(d, exist_ok=True)
        return d

    def save(self, fingerprint: str, meta: dict[str, Any]) -> str:
        """Commit a snapshot: artifacts must already be in place under
        :meth:`path`; the atomic meta write flips it to warm."""
        os.makedirs(self._dir(fingerprint), exist_ok=True)
        payload = dict(meta)
        payload.setdefault("fingerprint", fingerprint)
        payload.setdefault("created_unix", round(time.time(), 3))
        tmp = self._meta_path(fingerprint) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
        os.replace(tmp, self._meta_path(fingerprint))
        return self._dir(fingerprint)

    def load(self, fingerprint: str) -> Optional[dict[str, Any]]:
        if not self.has(fingerprint):
            return None
        with open(self._meta_path(fingerprint)) as f:
            return json.load(f)

    def fingerprints(self) -> list[str]:
        return sorted(
            d for d in os.listdir(self.root)
            if os.path.exists(self._meta_path(d)))
