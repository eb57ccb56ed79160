"""A hand protobuf (proto3) codec for the message subsets the gateway fronts
speak (``router/ext_proc_pb.py``, ``router/vllm_grpc_pb.py``; the reference
uses the modules protoc generated from ``protos/*.proto``, whose runtime the
card's Python does not have).

A message class lists its fields as ``Field(number, name, kind)``: ``kind`` is
a scalar type name or a ``Message`` subclass, ``repeated`` a list, ``oneof``
the name of its group. The parts of the generated API the fronts use are kept:
keyword construction, attribute access (an unset scalar reads as its default,
an unset message as an empty one), ``WhichOneof``, ``HasField``,
``SerializeToString`` and ``FromString``.

Encoding is proto3's, as the protobuf runtime writes it: fields in field-number
order; a scalar at its default is left out unless it is a member of a oneof
(then its presence is the choice); a sub-message that is set is written even
when empty; repeated numbers are packed. Decoding takes every field in either
repeated form and skips the fields it does not know, of every wire type (an
Envoy sends more of its protocol than the subset holds).
"""

from __future__ import annotations

import struct
from typing import Any, Optional

__all__ = ["DecodeError", "Field", "Message"]


class DecodeError(ValueError):
    pass


_DEFAULTS = {"string": "", "bytes": b"", "bool": False, "int32": 0, "uint32": 0,
             "enum": 0, "float": 0.0}


class Field:
    __slots__ = ("number", "name", "kind", "repeated", "oneof")

    def __init__(self, number: int, name: str, kind: Any, repeated: bool = False,
                 oneof: Optional[str] = None) -> None:
        self.number, self.name, self.kind = number, name, kind
        self.repeated, self.oneof = repeated, oneof

    @property
    def is_message(self) -> bool:
        return isinstance(self.kind, type)


def _varint(n: int) -> bytes:
    if n < 0:
        n += 1 << 64  # negative int32 / enum: ten bytes, as the runtime writes them
    out = bytearray()
    while n >= 0x80:
        out.append(n & 0x7F | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    n = shift = 0
    while True:
        if i >= len(buf):
            raise DecodeError("truncated varint")
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7
        if shift >= 70:
            raise DecodeError("varint too long")


def _skip(buf: bytes, i: int, wire: int, number: int) -> int:
    """Past one field of an unknown number."""
    if wire == 0:
        return _read_varint(buf, i)[1]
    if wire == 1:
        return i + 8
    if wire == 2:
        n, i = _read_varint(buf, i)
        return i + n
    if wire == 5:
        return i + 4
    if wire == 3:  # a group: up to its matching end tag
        while True:
            if i >= len(buf):
                raise DecodeError("truncated group")
            tag, i = _read_varint(buf, i)
            if tag & 7 == 4:
                if tag >> 3 != number:
                    raise DecodeError("mismatched end of group")
                return i
            i = _skip(buf, i, tag & 7, tag >> 3)
    raise DecodeError(f"wire type {wire}")


def _scalar_bytes(kind: str, value: Any) -> bytes:
    if kind == "float":
        return struct.pack("<f", value)
    if kind == "bool":
        return b"\x01" if value else b"\x00"
    if kind in ("int32", "enum"):
        return _varint(int(value))
    return _varint(int(value) & 0xFFFFFFFF)  # uint32


def _is_default(kind: str, value: Any) -> bool:
    if kind == "float":  # -0.0 is written: its bits are not zero
        return struct.pack("<f", value) == b"\0\0\0\0"
    return value == _DEFAULTS[kind]


def _from_varint(kind: str, n: int) -> Any:
    if kind == "bool":
        return n != 0
    n &= 0xFFFFFFFF
    if kind in ("int32", "enum") and n >= 1 << 31:
        return n - (1 << 32)
    return n


class Message:
    FIELDS: tuple = ()
    _by_name: dict
    _by_number: dict
    _ordered: tuple

    def __init_subclass__(cls, **kw) -> None:
        super().__init_subclass__(**kw)
        cls._ordered = tuple(sorted(cls.FIELDS, key=lambda f: f.number))
        cls._by_name = {f.name: f for f in cls.FIELDS}
        cls._by_number = {f.number: f for f in cls.FIELDS}

    def __init__(self, **kw: Any) -> None:
        object.__setattr__(self, "_v", {})
        for k, v in kw.items():
            setattr(self, k, v)

    def __getattr__(self, name: str) -> Any:
        f = type(self)._by_name.get(name)
        if f is None:
            raise AttributeError(name)
        values = self.__dict__["_v"]
        if name in values:
            return values[name]
        if f.repeated:
            values[name] = []
            return values[name]
        return f.kind() if f.is_message else _DEFAULTS[f.kind]

    def __setattr__(self, name: str, value: Any) -> None:
        f = type(self)._by_name.get(name)
        if f is None:
            raise AttributeError(f"{type(self).__name__} has no field {name!r}")
        if f.oneof is not None:
            for other in type(self).FIELDS:
                if other.oneof == f.oneof:
                    self._v.pop(other.name, None)
        self._v[name] = list(value) if f.repeated else value

    def HasField(self, name: str) -> bool:
        return name in self._v

    def WhichOneof(self, group: str) -> Optional[str]:
        for f in type(self)._ordered:
            if f.oneof == group and f.name in self._v:
                return f.name
        return None

    def __repr__(self) -> str:
        return f"{type(self).__name__}({', '.join(f'{k}={v!r}' for k, v in self._v.items())})"

    # -- encoding ------------------------------------------------------------
    def SerializeToString(self) -> bytes:
        out = bytearray()
        for f in type(self)._ordered:
            if f.name not in self._v:
                continue
            value = self._v[f.name]
            if f.repeated:
                if not value:
                    continue
                if f.is_message or f.kind in ("string", "bytes"):
                    for item in value:
                        out += _length_field(f, item)
                else:
                    packed = b"".join(_scalar_bytes(f.kind, v) for v in value)
                    out += _varint(f.number << 3 | 2) + _varint(len(packed)) + packed
            elif f.is_message or f.kind in ("string", "bytes"):
                if value is None or (not f.is_message and f.oneof is None and not value):
                    continue
                out += _length_field(f, value)
            else:
                if value is None or (f.oneof is None and _is_default(f.kind, value)):
                    continue
                wire = 5 if f.kind == "float" else 0
                out += _varint(f.number << 3 | wire) + _scalar_bytes(f.kind, value)
        return bytes(out)

    # -- decoding ------------------------------------------------------------
    @classmethod
    def FromString(cls, data: bytes) -> "Message":
        msg = cls()
        buf = bytes(data)
        i = 0
        while i < len(buf):
            tag, i = _read_varint(buf, i)
            number, wire = tag >> 3, tag & 7
            f = cls._by_number.get(number)
            if f is None or not _wire_fits(f, wire):
                i = _skip(buf, i, wire, number)
                if i > len(buf):
                    raise DecodeError("truncated field")
                continue
            if wire == 2:
                n, i = _read_varint(buf, i)
                if i + n > len(buf):
                    raise DecodeError("truncated field")
                raw, i = buf[i:i + n], i + n
                if f.is_message:
                    value: Any = f.kind.FromString(raw)
                    if not f.repeated and f.name in msg._v:  # a split message merges
                        value = f.kind.FromString(msg._v[f.name].SerializeToString() + raw)
                elif f.kind == "string":
                    value = raw.decode("utf-8")
                elif f.kind == "bytes":
                    value = raw
                else:  # packed numbers
                    msg._set(f, _unpack(f.kind, raw), extend=True)
                    continue
            elif wire == 5:
                value = struct.unpack("<f", buf[i:i + 4])[0]
                i += 4
            else:
                n, i = _read_varint(buf, i)
                value = _from_varint(f.kind, n)
            msg._set(f, [value] if f.repeated else value, extend=f.repeated)
        return msg

    def _set(self, f: Field, value: Any, extend: bool = False) -> None:
        if extend:
            self._v.setdefault(f.name, []).extend(value)
        else:
            setattr(self, f.name, value)


def _length_field(f: Field, value: Any) -> bytes:
    if f.is_message:
        payload = value.SerializeToString()
    elif f.kind == "string":
        payload = value.encode("utf-8")
    else:
        payload = bytes(value)
    return _varint(f.number << 3 | 2) + _varint(len(payload)) + payload


def _wire_fits(f: Field, wire: int) -> bool:
    if f.is_message or f.kind in ("string", "bytes"):
        return wire == 2
    if f.kind == "float":
        return wire == 5 or (wire == 2 and f.repeated)
    return wire == 0 or (wire == 2 and f.repeated)


def _unpack(kind: str, raw: bytes) -> list:
    if kind == "float":
        if len(raw) % 4:
            raise DecodeError("packed floats of a length not a multiple of 4")
        return list(struct.unpack(f"<{len(raw) // 4}f", raw))
    out, i = [], 0
    while i < len(raw):
        n, i = _read_varint(raw, i)
        out.append(_from_varint(kind, n))
    return out
