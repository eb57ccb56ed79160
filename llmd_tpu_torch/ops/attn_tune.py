"""Shape-keyed launch-config table of K1 (copy of ``llmd_tpu/ops/attn_tune.py``).

The reference keys Pallas block sizes by serving shape; the port keys K1's
``mma`` plan (``ops/paged_attention._plan``) the same way, in the same file:

    {"version": 1,
     "entries": [{"batch": 64, "page_size": 16, "pages_per_seq": 64,
                  "head_layout": "h32x64kv16", "bkv": 16, "bq": 16,
                  "us_per_call": 41.9, "tuned_on": "NVIDIA H100 80GB HBM3"}, ...]}

A file either package writes loads in the other. What an entry means here:

- ``batch`` is the launch's token count, ``pages_per_seq`` its page-table
  width, ``head_layout`` :func:`head_layout_key` at the port's UNPADDED head
  dim (the reference pads it to 128 lanes);
- ``bkv`` is pages per KV split: the split covers ``bkv * page_size`` keys,
  rounded up to a whole number of stages and pages;
- ``bq`` is the query tile in tokens. The ``mma`` instance's tile is fixed at
  ``MMA_ROWS // qpk``; an entry with another ``bq`` is a miss and the
  policy stands (the kernel is never launched with a tile it lacks).

Lookup (:meth:`AttnTuneTable.lookup`) needs an exact (batch, page_size,
head_layout) match and takes the nearest ``pages_per_seq``. :func:`load_table`
drops malformed entries one by one, and also those whose ``tuned_on`` does
not name an NVIDIA card (a TPU's block sizes mean something else), counting
both in ``dropped`` with a warning; a missing or corrupt file gives a warning
and ``None`` (the policy). The hash (:func:`entries_hash`) covers the entries
the port serves, so for a file of NVIDIA entries both packages compute the
same hash. :func:`merge_and_save` keeps every valid entry of the file it
merges into, whatever card tuned it.

The engine holds the table it was built with (``EngineConfig.attn_tune_file``,
else :func:`active_table`: a table pinned by :func:`activate`, else
``LLMD_ATTN_TUNE_FILE``) and passes it to K1's wrapper, so two engines in one
process keep their own plans; a direct call of the wrapper without a table
runs the policy.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from dataclasses import dataclass

log = logging.getLogger("llmd_tpu_torch.attn_tune")

ENV_TUNE_FILE = "LLMD_ATTN_TUNE_FILE"

_REQUIRED_INT_FIELDS = ("batch", "page_size", "pages_per_seq", "bkv", "bq")


def head_layout_key(num_q_heads: int, head_dim: int, kv_planes: int) -> str:
    """Canonical head-layout key: query heads x head width, KV planes per
    token (2*Hk for K/V pools, 1 for the MLA latent plane)."""
    return f"h{num_q_heads}x{head_dim}kv{kv_planes}"


def tuned_on_nvidia(entry: dict) -> bool:
    """True when the entry's ``tuned_on`` names an NVIDIA card."""
    return "nvidia" in str(entry.get("tuned_on", "")).lower()


@dataclass(frozen=True)
class AttnTuneTable:
    """Validated, immutable view of a tune file."""

    entries: tuple = ()
    source: str = ""
    sha: str = ""  # short content hash of the served entries, for provenance
    dropped: int = 0  # entries discarded at load (malformed or not NVIDIA-tuned)

    def lookup(self, batch: int, page_size: int, pages_per_seq: int,
               head_layout: "str | None") -> "tuple[int, int] | None":
        best = None
        for e in self.entries:
            if e["batch"] != batch or e["page_size"] != page_size:
                continue
            if head_layout is not None and e["head_layout"] != head_layout:
                continue
            d = abs(e["pages_per_seq"] - pages_per_seq)
            if best is None or d < best[0]:
                best = (d, e)
        if best is None:
            return None
        e = best[1]
        # a table tuned at more pages a sequence than this launch's table
        # holds must not split past it
        return (max(1, min(pages_per_seq, int(e["bkv"]))), max(1, int(e["bq"])))


def _validate_entry(e) -> "dict | None":
    if not isinstance(e, dict):
        return None
    out = {}
    for k in _REQUIRED_INT_FIELDS:
        v = e.get(k)
        if isinstance(v, bool) or not isinstance(v, int) or v < 1:
            return None
        out[k] = v
    hl = e.get("head_layout")
    if not isinstance(hl, str) or not hl:
        return None
    out["head_layout"] = hl
    # provenance fields ride through merges untouched
    for k in ("us_per_call", "tuned_on", "tuned_at"):
        if k in e:
            out[k] = e[k]
    return out


def entries_hash(entries) -> str:
    """Order-independent short hash over the shape -> winner mapping
    (provenance fields included, so a re-tune with the same winners still
    changes it)."""
    canon = sorted(json.dumps(e, sort_keys=True) for e in entries)
    return hashlib.sha256("\n".join(canon).encode()).hexdigest()[:12]


def _read(path: str) -> "tuple[list[dict], int] | None":
    """(valid entries, malformed count) of a tune file; None, with a
    warning, for a missing, unreadable or unknown-schema file."""
    try:
        with open(path) as f:
            raw = json.load(f)
    except FileNotFoundError:
        log.warning("attn tune file %s not found; using the launch-plan policy", path)
        return None
    except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
        log.warning("attn tune file %s unreadable (%s); using the launch-plan policy",
                    path, e)
        return None
    if not isinstance(raw, dict) or raw.get("version") != 1 \
            or not isinstance(raw.get("entries"), list):
        log.warning("attn tune file %s has unknown schema; using the launch-plan policy",
                    path)
        return None
    valid, dropped = [], 0
    for e in raw["entries"]:
        v = _validate_entry(e)
        if v is None:
            dropped += 1
        else:
            valid.append(v)
    return valid, dropped


def _served(path: str, entries: list, dropped: int) -> AttnTuneTable:
    """The table of ``entries`` the port serves: the NVIDIA-tuned ones."""
    ours = [e for e in entries if tuned_on_nvidia(e)]
    foreign = len(entries) - len(ours)
    if foreign:
        log.warning("attn tune file %s: skipped %d entries not tuned on an NVIDIA card",
                    path, foreign)
    return AttnTuneTable(entries=tuple(ours), source=path, sha=entries_hash(ours),
                         dropped=dropped + foreign)


def load_table(path: str) -> "AttnTuneTable | None":
    """Parse + validate a tune file. Returns None (with a warning) on any
    file-level problem; drops malformed and non-NVIDIA entries one by one."""
    read = _read(path)
    if read is None:
        return None
    valid, dropped = read
    if dropped:
        log.warning("attn tune file %s: dropped %d malformed entries", path, dropped)
    return _served(path, valid, dropped)


def merge_and_save(path: str, new_entries) -> AttnTuneTable:
    """The tuner's export: merge winners into the table file (same shape key:
    newest wins; every other valid entry kept) and write it back atomically.
    Returns the table the port serves from the merged file."""
    existing = _read(path) if os.path.exists(path) else None

    def key(e):
        return (e["batch"], e["page_size"], e["pages_per_seq"], e["head_layout"])

    merged = {key(e): e for e in (existing[0] if existing else ())}
    for e in new_entries:
        v = _validate_entry(e)
        if v is None:
            raise ValueError(f"refusing to write malformed tune entry: {e!r}")
        merged[key(v)] = v
    entries = [merged[k] for k in sorted(merged)]
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"version": 1, "entries": entries}, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return _served(path, entries, 0)


# ---------------------------------------------------------------------------
# the process-wide active table
# ---------------------------------------------------------------------------
_active: "AttnTuneTable | None" = None
_pinned = False  # an explicit activate() beats the environment
_resolved_env_path: "object" = None  # the env path last resolved (cache key)


def activate(table: "AttnTuneTable | None") -> None:
    """Pin a table; activate(None) unpins and hands control back to
    ``LLMD_ATTN_TUNE_FILE``."""
    global _active, _pinned, _resolved_env_path
    _active = table
    _pinned = table is not None
    _resolved_env_path = object()  # force re-resolution once unpinned


def active_table() -> "AttnTuneTable | None":
    """An activate()d table, else ``LLMD_ATTN_TUNE_FILE`` loaded lazily and
    re-loaded whenever the variable changes."""
    global _active, _resolved_env_path
    if _pinned:
        return _active
    env_path = os.environ.get(ENV_TUNE_FILE) or None
    if env_path != _resolved_env_path:
        _resolved_env_path = env_path
        _active = load_table(env_path) if env_path else None
    return _active


def active_hash() -> "str | None":
    t = active_table()
    return t.sha if t else None
