"""KV-event schema, wire format and chained block hashing (copy of
``llmd_tpu/core/kv_events.py``).

Wire: a batch is msgpack ``[seq, [tagged event, ...]]`` on the topic
``kv@<pod address>@<model>``. The card machine's Python has no guaranteed
``msgpack``, so :func:`encode_event_batch` writes exactly the subset the
reference emits by hand, byte for byte as ``msgpack.packb(..., use_bin_type=True)``
writes it (the shortest form of every int, str, bin and array), and
:func:`decode_event_batch` reads it back.

Block-key chaining: key_i = H(key_{i-1} ‖ tokens_i ‖ lora ‖ mm_extra), so a block
is only reusable behind its unbroken prefix chain. Hashes are sha256-based and
bit-identical to the reference's, so router-side keys match.
"""

from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass, field
from typing import Iterable, Optional, Sequence, Union

MEDIUM_HBM = "gpu"  # tier names kept from the reference for scorer-weight parity
MEDIUM_CPU = "cpu"
MEDIUM_FS = "fs"


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

_TAGS = {"BlockStored": 0, "BlockRemoved": 1, "AllBlocksCleared": 2}


def kv_topic(pod_address: str, model: str) -> str:
    return f"kv@{pod_address}@{model}"


def encode_event_batch(events: Sequence[KVEvent], seq: int = 0) -> bytes:
    """Encode an event batch: msgpack ``[seq, [tagged event, ...]]``."""
    rows: list = []
    for ev in events:
        if isinstance(ev, BlockStored):
            rows.append([
                _TAGS["BlockStored"], ev.block_hashes, ev.parent_block_hash,
                ev.token_ids, ev.block_size, ev.lora_id, ev.medium, ev.extra_keys,
            ])
        elif isinstance(ev, BlockRemoved):
            rows.append([_TAGS["BlockRemoved"], ev.block_hashes, ev.medium])
        elif isinstance(ev, AllBlocksCleared):
            rows.append([_TAGS["AllBlocksCleared"]])
        else:
            raise TypeError(f"unknown event {ev!r}")
    out = bytearray()
    _pack(out, [seq, rows])
    return bytes(out)


def decode_event_batch(data: bytes) -> tuple[int, list[KVEvent]]:
    (seq, rows), end = _unpack(memoryview(data), 0)
    if end != len(data):
        raise ValueError(f"trailing bytes after the batch ({len(data) - end})")
    out: list[KVEvent] = []
    for row in rows:
        tag = row[0]
        if tag == _TAGS["BlockStored"]:
            out.append(BlockStored(
                block_hashes=list(row[1]), parent_block_hash=row[2],
                token_ids=list(row[3]), block_size=row[4], lora_id=row[5],
                medium=row[6], extra_keys=list(row[7]),
            ))
        elif tag == _TAGS["BlockRemoved"]:
            out.append(BlockRemoved(block_hashes=list(row[1]), medium=row[2]))
        elif tag == _TAGS["AllBlocksCleared"]:
            out.append(AllBlocksCleared())
    return seq, out


# -- the msgpack subset: nil, int, str, bin, array ---------------------------
_B, _H, _I, _Q = struct.Struct(">B"), struct.Struct(">H"), struct.Struct(">I"), struct.Struct(">Q")
_b, _h, _i, _q = struct.Struct(">b"), struct.Struct(">h"), struct.Struct(">i"), struct.Struct(">q")


def _pack_int(out: bytearray, v: int) -> None:
    """msgpack's shortest form: fixints, then uint8-64 for positive values
    and int8-64 for negative ones."""
    if v >= 0:
        if v < 0x80:
            out.append(v)
        elif v <= 0xFF:
            out += b"\xcc" + _B.pack(v)
        elif v <= 0xFFFF:
            out += b"\xcd" + _H.pack(v)
        elif v <= 0xFFFFFFFF:
            out += b"\xce" + _I.pack(v)
        elif v <= 0xFFFFFFFFFFFFFFFF:
            out += b"\xcf" + _Q.pack(v)
        else:
            raise OverflowError(f"int {v} does not fit msgpack's uint64")
    elif v >= -0x20:
        out.append(v & 0xFF)
    elif v >= -0x80:
        out += b"\xd0" + _b.pack(v)
    elif v >= -0x8000:
        out += b"\xd1" + _h.pack(v)
    elif v >= -0x80000000:
        out += b"\xd2" + _i.pack(v)
    elif v >= -0x8000000000000000:
        out += b"\xd3" + _q.pack(v)
    else:
        raise OverflowError(f"int {v} does not fit msgpack's int64")


def _pack_len(out: bytearray, n: int, fix: "int | None", fix_max: int,
              codes: tuple[bytes, bytes, bytes]) -> None:
    """A length header: the fix form below ``fix_max`` (when the type has
    one), then the 8- (when it has one), 16- and 32-bit forms."""
    c8, c16, c32 = codes
    if fix is not None and n < fix_max:
        out.append(fix | n)
    elif c8 and n <= 0xFF:
        out += c8 + _B.pack(n)
    elif n <= 0xFFFF:
        out += c16 + _H.pack(n)
    elif n <= 0xFFFFFFFF:
        out += c32 + _I.pack(n)
    else:
        raise ValueError(f"length {n} does not fit msgpack's 32 bits")


def _pack(out: bytearray, v) -> None:
    if v is None:
        out.append(0xC0)
    elif isinstance(v, bool):
        out.append(0xC3 if v else 0xC2)
    elif isinstance(v, int):
        _pack_int(out, v)
    elif isinstance(v, str):
        b = v.encode("utf-8")
        _pack_len(out, len(b), 0xA0, 32, (b"\xd9", b"\xda", b"\xdb"))
        out += b
    elif isinstance(v, (bytes, bytearray, memoryview)):
        b = bytes(v)
        _pack_len(out, len(b), None, 0, (b"\xc4", b"\xc5", b"\xc6"))
        out += b
    elif isinstance(v, (list, tuple)):
        _pack_len(out, len(v), 0x90, 16, (b"", b"\xdc", b"\xdd"))
        for x in v:
            _pack(out, x)
    else:
        raise TypeError(f"can not serialize {type(v).__name__!r} object")


_FIXED = {0xCC: _B, 0xCD: _H, 0xCE: _I, 0xCF: _Q, 0xD0: _b, 0xD1: _h, 0xD2: _i, 0xD3: _q}
_LENGTH = {0xD9: (_B, "str"), 0xDA: (_H, "str"), 0xDB: (_I, "str"),
           0xC4: (_B, "bin"), 0xC5: (_H, "bin"), 0xC6: (_I, "bin"),
           0xDC: (_H, "array"), 0xDD: (_I, "array")}


def _unpack(buf: memoryview, pos: int):
    """(value, next position) of the msgpack object at ``pos``."""
    c = buf[pos]
    pos += 1
    if c < 0x80:
        return c, pos
    if c >= 0xE0:
        return c - 0x100, pos
    if 0xA0 <= c <= 0xBF:
        return _take(buf, pos, c & 0x1F, "str")
    if 0x90 <= c <= 0x9F:
        return _take(buf, pos, c & 0x0F, "array")
    if c == 0xC0:
        return None, pos
    if c in (0xC2, 0xC3):
        return c == 0xC3, pos
    st = _FIXED.get(c)
    if st is not None:
        return st.unpack_from(buf, pos)[0], pos + st.size
    ln = _LENGTH.get(c)
    if ln is None:
        raise ValueError(f"msgpack type byte 0x{c:02x} is outside the KV-event subset")
    st, kind = ln
    return _take(buf, pos + st.size, st.unpack_from(buf, pos)[0], kind)


def _take(buf: memoryview, pos: int, n: int, kind: str):
    if kind == "array":
        items = []
        for _ in range(n):
            v, pos = _unpack(buf, pos)
            items.append(v)
        return items, pos
    if pos + n > len(buf):
        raise ValueError("truncated msgpack payload")
    raw = bytes(buf[pos: pos + n])
    return (raw.decode("utf-8") if kind == "str" else raw), pos + n


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
