"""gRPC over HTTP/2 on asyncio, on the standard library: a server and a client
(the reference serves its gateway fronts with grpcio, which the card's Python
does not have; grpcio is this module's reference, and the tests hold the two
against each other in both directions).

Layers, bottom up:

- **HPACK** (RFC 7541): the static table (Appendix A), a dynamic table per
  direction (an entry's size is its name + value + 32 bytes, the oldest
  evicted as it fills or as its limit drops), prefixed integers, and Huffman
  decoding (Appendix B: the code is canonical, so it is rebuilt from its 257
  code lengths). The encoder writes literals without Huffman coding, indexing
  what it may reuse; it signals a table-size change the peer asked for at the
  start of its next block.
- **HTTP/2** (RFC 9113): the client preface, SETTINGS with their ACK, PING
  answered with its ACK (grpcio probes the bandwidth with pings), HEADERS with
  CONTINUATION, padding and priority fields skipped, DATA split at the peer's
  ``MAX_FRAME_SIZE``, flow control both ways (nothing is sent past the peer's
  stream and connection windows; WINDOW_UPDATE gives back what was taken in:
  the connection's on receipt, a stream's as its reader consumes it), RST_STREAM,
  and GOAWAY when a side stops.
- **gRPC** (the HTTP/2 protocol of grpc/grpc ``doc/PROTOCOL-HTTP2.md``): the
  5-byte length prefix, ``:status 200`` and ``content-type: application/grpc``,
  the trailers ``grpc-status`` / ``grpc-message`` (percent-encoded UTF-8),
  trailers-only replies, ``grpc-timeout``, ``-bin`` metadata in base64. A
  ``grpc-encoding`` other than ``identity`` is refused with UNIMPLEMENTED
  (no compression is offered), and a compressed message with INTERNAL.

Server (``Server``): methods registered by full name (``/package.Service/
Method``) as unary-unary, unary-stream or stream-stream handlers, run as tasks
on the event loop that awaited ``start``. A handler gets the request (or an
async iterator of requests) and a ``ServicerContext``; a streaming handler is
an async generator. ``context.abort(code, details)`` ends the call with that
status. ``maximum_concurrent_rpcs`` refuses calls past it with
RESOURCE_EXHAUSTED, as grpcio does; a call past its deadline is cancelled and
answered DEADLINE_EXCEEDED; a cancelled call (RST_STREAM) cancels its handler.

Client (``Channel``): one HTTP/2 connection per channel, opened on the first
call and again after the peer went away. ``unary_unary(method)`` gives an
awaitable call, ``unary_stream`` an async iterator, ``stream_stream`` a
``Call`` with ``write`` / ``done_writing`` / ``read`` (None at the end). A
call that ends with another status than OK raises ``RpcError``.
"""

from __future__ import annotations

import asyncio
import base64
import collections
import enum
import logging
import math
import struct
from typing import Any, AsyncIterator, Awaitable, Callable, Iterable, Optional
from urllib.parse import quote, unquote_to_bytes

__all__ = ["StatusCode", "RpcError", "HPACKError", "HPACKDecoder", "HPACKEncoder",
           "huffman_decode", "Server", "ServicerContext", "Channel", "Call"]

log = logging.getLogger(__name__)


# --------------------------------------------------------------------- HPACK
class HPACKError(Exception):
    """A header block that does not decode (a COMPRESSION_ERROR)."""


STATIC_TABLE: tuple[tuple[bytes, bytes], ...] = tuple(
    (n.encode(), v.encode()) for n, v in (
        (":authority", ""), (":method", "GET"), (":method", "POST"), (":path", "/"),
        (":path", "/index.html"), (":scheme", "http"), (":scheme", "https"),
        (":status", "200"), (":status", "204"), (":status", "206"), (":status", "304"),
        (":status", "400"), (":status", "404"), (":status", "500"), ("accept-charset", ""),
        ("accept-encoding", "gzip, deflate"), ("accept-language", ""),
        ("accept-ranges", ""), ("accept", ""), ("access-control-allow-origin", ""),
        ("age", ""), ("allow", ""), ("authorization", ""), ("cache-control", ""),
        ("content-disposition", ""), ("content-encoding", ""), ("content-language", ""),
        ("content-length", ""), ("content-location", ""), ("content-range", ""),
        ("content-type", ""), ("cookie", ""), ("date", ""), ("etag", ""), ("expect", ""),
        ("expires", ""), ("from", ""), ("host", ""), ("if-match", ""),
        ("if-modified-since", ""), ("if-none-match", ""), ("if-range", ""),
        ("if-unmodified-since", ""), ("last-modified", ""), ("link", ""),
        ("location", ""), ("max-forwards", ""), ("proxy-authenticate", ""),
        ("proxy-authorization", ""), ("range", ""), ("referer", ""), ("refresh", ""),
        ("retry-after", ""), ("server", ""), ("set-cookie", ""),
        ("strict-transport-security", ""), ("transfer-encoding", ""), ("user-agent", ""),
        ("vary", ""), ("via", ""), ("www-authenticate", "")))
_STATIC_FULL = {entry: i + 1 for i, entry in reversed(list(enumerate(STATIC_TABLE)))}
_STATIC_NAME = {name: i + 1 for i, (name, _) in reversed(list(enumerate(STATIC_TABLE)))}

# RFC 7541 Appendix B: the code length of each symbol 0..255 and EOS (256).
# The code is canonical: codes of one length are consecutive in symbol order,
# each length's first code follows the last code of the length before.
HUFFMAN_LENGTHS = (
    13, 23, 28, 28, 28, 28, 28, 28, 28, 24, 30, 28, 28, 30, 28, 28,  # 0
    28, 28, 28, 28, 28, 28, 30, 28, 28, 28, 28, 28, 28, 28, 28, 28,  # 16
    6, 10, 10, 12, 13, 6, 8, 11, 10, 10, 8, 11, 8, 6, 6, 6,  # 32
    5, 5, 5, 6, 6, 6, 6, 6, 6, 6, 7, 8, 15, 6, 12, 10,  # 48
    13, 6, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7,  # 64
    7, 7, 7, 7, 7, 7, 7, 7, 8, 7, 8, 13, 19, 13, 14, 6,  # 80
    15, 5, 6, 5, 6, 5, 6, 6, 6, 5, 7, 7, 6, 6, 6, 5,  # 96
    6, 7, 6, 5, 5, 6, 7, 7, 7, 7, 7, 15, 11, 14, 13, 28,  # 112
    20, 22, 20, 20, 22, 22, 22, 23, 22, 23, 23, 23, 23, 23, 24, 23,  # 128
    24, 24, 22, 23, 24, 23, 23, 23, 23, 21, 22, 23, 22, 23, 23, 24,  # 144
    22, 21, 20, 22, 22, 23, 23, 21, 23, 22, 22, 24, 21, 22, 23, 23,  # 160
    21, 21, 22, 21, 23, 22, 23, 23, 20, 22, 22, 22, 23, 22, 22, 23,  # 176
    26, 26, 20, 19, 22, 23, 22, 25, 26, 26, 26, 27, 27, 26, 24, 25,  # 192
    19, 21, 26, 27, 27, 26, 27, 24, 21, 21, 26, 26, 28, 27, 27, 27,  # 208
    20, 24, 20, 21, 22, 21, 21, 23, 22, 22, 25, 25, 24, 24, 26, 23,  # 224
    26, 27, 26, 26, 27, 27, 27, 27, 27, 28, 27, 27, 27, 27, 27, 26,  # 240
    30)  # EOS
EOS = 256


def huffman_codes() -> list[tuple[int, int]]:
    """(code, length) of every symbol, rebuilt from ``HUFFMAN_LENGTHS``."""
    order = sorted(range(len(HUFFMAN_LENGTHS)), key=lambda s: (HUFFMAN_LENGTHS[s], s))
    codes: list[tuple[int, int]] = [(0, 0)] * len(HUFFMAN_LENGTHS)
    code, prev = 0, HUFFMAN_LENGTHS[order[0]]
    for i, sym in enumerate(order):
        n = HUFFMAN_LENGTHS[sym]
        if i:
            code = (code + 1) << (n - prev)
        codes[sym], prev = (code, n), n
    return codes


# a code of length n keyed as code | 1 << n: one int names (length, code)
_HUFFMAN_DECODE = {code | (1 << n): sym for sym, (code, n) in enumerate(huffman_codes())}


def huffman_decode(data: bytes) -> bytes:
    """A Huffman-coded string literal (RFC 7541 5.2): the padding is the
    EOS code's leading ones, shorter than 8 bits; EOS itself is an error."""
    out = bytearray()
    key = 1
    for byte in data:
        for shift in range(7, -1, -1):
            key = key << 1 | (byte >> shift) & 1
            sym = _HUFFMAN_DECODE.get(key)
            if sym is not None:
                if sym == EOS:
                    raise HPACKError("EOS inside a Huffman string")
                out.append(sym)
                key = 1
            elif key >> 30:
                raise HPACKError("no Huffman code matches")
    n = key.bit_length() - 1
    if n > 7 or key != (1 << (n + 1)) - 1:
        raise HPACKError("Huffman padding is not the EOS code's prefix")
    return bytes(out)


def encode_int(value: int, prefix: int, first: int = 0) -> bytearray:
    """An integer on a ``prefix``-bit prefix (RFC 7541 5.1); ``first`` holds
    the first byte's other bits."""
    limit = (1 << prefix) - 1
    if value < limit:
        return bytearray([first | value])
    out = bytearray([first | limit])
    value -= limit
    while value >= 128:
        out.append(value & 0x7F | 0x80)
        value >>= 7
    out.append(value)
    return out


def _decode_int(data: bytes, i: int, prefix: int) -> tuple[int, int]:
    limit = (1 << prefix) - 1
    value = data[i] & limit
    i += 1
    if value < limit:
        return value, i
    shift = 0
    while True:
        if i >= len(data):
            raise HPACKError("truncated integer")
        b = data[i]
        i += 1
        value += (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return value, i
        if shift > 28:
            raise HPACKError("integer too large")


def _entry_size(name: bytes, value: bytes) -> int:
    return len(name) + len(value) + 32


class _Table:
    """The dynamic table: newest first, the oldest evicted to fit ``limit``."""

    def __init__(self, limit: int) -> None:
        self.entries: collections.deque = collections.deque()
        self.size = 0
        self.limit = limit

    def resize(self, limit: int) -> None:
        self.limit = limit
        self._evict(0)

    def _evict(self, room: int) -> None:
        while self.entries and self.size + room > self.limit:
            name, value = self.entries.pop()
            self.size -= _entry_size(name, value)

    def add(self, name: bytes, value: bytes) -> None:
        size = _entry_size(name, value)
        self._evict(size)
        if size <= self.limit:  # an entry larger than the table empties it
            self.entries.appendleft((name, value))
            self.size += size

    def get(self, index: int) -> tuple[bytes, bytes]:
        if 1 <= index <= len(STATIC_TABLE):
            return STATIC_TABLE[index - 1]
        i = index - len(STATIC_TABLE) - 1
        if 0 <= i < len(self.entries):
            return self.entries[i]
        raise HPACKError(f"index {index} is outside the tables")


class HPACKDecoder:
    """One direction's decoder; ``max_table_size`` is what this side's
    SETTINGS_HEADER_TABLE_SIZE allows the peer's encoder."""

    def __init__(self, max_table_size: int = 4096) -> None:
        self.max_table_size = max_table_size
        self.table = _Table(max_table_size)

    def _string(self, data: bytes, i: int) -> tuple[bytes, int]:
        if i >= len(data):
            raise HPACKError("truncated string")
        huffman = data[i] & 0x80
        n, i = _decode_int(data, i, 7)
        if i + n > len(data):
            raise HPACKError("truncated string")
        raw = bytes(data[i:i + n])
        return (huffman_decode(raw) if huffman else raw), i + n

    def decode(self, data: bytes) -> list[tuple[bytes, bytes]]:
        out: list[tuple[bytes, bytes]] = []
        i = 0
        while i < len(data):
            b = data[i]
            if b & 0x80:  # indexed field
                index, i = _decode_int(data, i, 7)
                if index == 0:
                    raise HPACKError("index 0")
                out.append(self.table.get(index))
                continue
            if b & 0xE0 == 0x20:  # dynamic table size update
                if out:
                    raise HPACKError("a table size update after a field")
                size, i = _decode_int(data, i, 5)
                if size > self.max_table_size:
                    raise HPACKError(f"table size {size} above {self.max_table_size}")
                self.table.resize(size)
                continue
            prefix = 6 if b & 0xC0 == 0x40 else 4  # with indexing, or without / never
            index, i = _decode_int(data, i, prefix)
            if index:
                name = self.table.get(index)[0]
            else:
                name, i = self._string(data, i)
            value, i = self._string(data, i)
            if prefix == 6:
                self.table.add(name, value)
            out.append((name, value))
        return out


class HPACKEncoder:
    """Literals without Huffman coding; a field seen before is sent by its
    index, and every field but those in ``NO_INDEX`` is added to the table."""

    NO_INDEX = {b"grpc-timeout", b"grpc-message", b"content-length"}

    def __init__(self, table_size: int = 4096) -> None:
        self.table = _Table(table_size)
        self._resize: list[int] = []  # sizes to signal at the next block

    def set_max_table_size(self, size: int) -> None:
        """The peer's SETTINGS_HEADER_TABLE_SIZE (this side keeps at most 4 KiB)."""
        size = min(size, 4096)
        if size != self.table.limit:
            self._resize.append(size)
            self.table.resize(size)

    def _find(self, name: bytes, value: bytes) -> tuple[int, int]:
        """(full match index or 0, name match index or 0)."""
        full = _STATIC_FULL.get((name, value), 0)
        if full:
            return full, full
        name_at = _STATIC_NAME.get(name, 0)
        for i, (n, v) in enumerate(self.table.entries):
            if n == name:
                if v == value:
                    return len(STATIC_TABLE) + 1 + i, 0
                name_at = name_at or len(STATIC_TABLE) + 1 + i
        return 0, name_at

    @staticmethod
    def _string(data: bytes) -> bytearray:
        return encode_int(len(data), 7) + data

    def encode(self, headers: Iterable[tuple[bytes, bytes]]) -> bytes:
        out = bytearray()
        if self._resize:
            for size in sorted({min(self._resize), self.table.limit}):
                out += encode_int(size, 5, 0x20)
            self._resize = []
        for name, value in headers:
            full, name_at = self._find(name, value)
            if full:
                out += encode_int(full, 7, 0x80)
                continue
            index = name not in self.NO_INDEX
            out += encode_int(name_at, 6 if index else 4, 0x40 if index else 0)
            if not name_at:
                out += self._string(name)
            out += self._string(value)
            if index:
                self.table.add(name, value)
        return bytes(out)


# -------------------------------------------------------------------- HTTP/2
PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"
DATA, HEADERS, PRIORITY, RST_STREAM, SETTINGS, PUSH_PROMISE, PING, GOAWAY, \
    WINDOW_UPDATE, CONTINUATION = range(10)
END_STREAM, ACK, END_HEADERS, PADDED, PRIORITY_FLAG = 0x1, 0x1, 0x4, 0x8, 0x20
S_HEADER_TABLE_SIZE, S_ENABLE_PUSH, S_MAX_CONCURRENT_STREAMS, S_INITIAL_WINDOW_SIZE, \
    S_MAX_FRAME_SIZE, S_MAX_HEADER_LIST_SIZE = range(1, 7)
NO_ERROR, PROTOCOL_ERROR, INTERNAL_ERROR, FLOW_CONTROL_ERROR, _, STREAM_CLOSED, \
    FRAME_SIZE_ERROR, REFUSED_STREAM, CANCEL, COMPRESSION_ERROR = range(10)
LOST = -1  # not an HTTP/2 code: the connection itself ended
DEFAULT_WINDOW = 65535
MAX_WINDOW = 2 ** 31 - 1
FRAME_SIZE = 16384  # this side's SETTINGS_MAX_FRAME_SIZE (the default)


class ConnectionClosed(Exception):
    """The HTTP/2 connection ended (EOF, GOAWAY, a connection error)."""


class StreamReset(Exception):
    def __init__(self, code: int) -> None:
        super().__init__(f"stream reset (HTTP/2 error {code})")
        self.code = code


def frame(ftype: int, flags: int, stream_id: int, payload: bytes = b"") -> bytes:
    return (struct.pack(">I", len(payload))[1:] + bytes((ftype, flags))
            + struct.pack(">I", stream_id & 0x7FFFFFFF) + payload)


class H2Stream:
    """One stream's state on a connection. Received headers and data arrive
    as events on ``events``: ("headers", [(name, value)], end_stream),
    ("data", bytes, end_stream), ("reset", code)."""

    def __init__(self, conn: "H2Connection", stream_id: int) -> None:
        self.conn, self.id = conn, stream_id
        self.send_window = conn.peer_initial_window
        self.events: asyncio.Queue = asyncio.Queue()
        self.unacked = 0  # consumed bytes not yet given back by WINDOW_UPDATE
        self.local_closed = self.remote_closed = False
        self.reset_code: Optional[int] = None
        self.on_reset: Optional[Callable[[], None]] = None  # the peer reset it

    def consumed(self, n: int) -> None:
        """The reader took ``n`` bytes of DATA: give them back to the peer's
        stream window in batches of half the window."""
        self.unacked += n
        if self.unacked >= DEFAULT_WINDOW // 2 and not self.remote_closed \
                and self.reset_code is None:
            self.conn.write(frame(WINDOW_UPDATE, 0, self.id, struct.pack(">I", self.unacked)))
            self.unacked = 0

    def send_headers(self, headers: list[tuple[bytes, bytes]], end_stream: bool = False) -> None:
        self.conn.send_headers(self, headers, end_stream)

    async def send_data(self, data: bytes, end_stream: bool = False) -> None:
        await self.conn.send_data(self, data, end_stream)

    def reset(self, code: int = CANCEL) -> None:
        """Send RST_STREAM (unless the stream is already closed both ways)."""
        if self.reset_code is None and not (self.local_closed and self.remote_closed):
            self.reset_code = code
            self.conn.write(frame(RST_STREAM, 0, self.id, struct.pack(">I", code)))
            self.conn.wake()
        self.conn.forget(self)


class H2Connection:
    """One HTTP/2 connection over asyncio streams, either side. ``on_stream``
    (server side) is called with each new stream and its request headers."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                 client: bool, on_stream: Optional[Callable] = None) -> None:
        self.reader, self.writer = reader, writer
        self.client = client
        self.on_stream = on_stream
        self.encoder = HPACKEncoder()
        self.decoder = HPACKDecoder()
        self.streams: dict[int, H2Stream] = {}
        self.peer_initial_window = DEFAULT_WINDOW
        self.peer_max_frame = FRAME_SIZE
        self.peer_max_streams = math.inf
        self.send_window = DEFAULT_WINDOW  # the connection's, toward the peer
        self.recv_unacked = 0
        self.next_id = 1 if client else 2
        self.last_peer_id = 0
        self.closed = False
        self.going_away = False  # a GOAWAY came: no new streams here
        self._wakeup = asyncio.Event()  # a window grew, a stream slot freed, or a close
        self._task: Optional[asyncio.Task] = None

    # -- lifecycle -----------------------------------------------------------
    async def start(self) -> None:
        settings = struct.pack(">HI", S_ENABLE_PUSH, 0) if self.client else b""
        if self.client:
            self.write(PREFACE)
        self.write(frame(SETTINGS, 0, 0, settings))
        await self.writer.drain()
        self._task = asyncio.get_running_loop().create_task(self._read_loop())

    async def close(self, code: int = NO_ERROR) -> None:
        """Send GOAWAY and close the transport; fail every open stream."""
        if not self.closed:
            self.write(frame(GOAWAY, 0, 0, struct.pack(">II", self.last_peer_id, code)))
            try:
                await asyncio.wait_for(self.writer.drain(), 1.0)
            except (ConnectionError, asyncio.TimeoutError):
                pass
        self._shutdown()
        if self._task is not None and self._task is not asyncio.current_task():
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass

    def _shutdown(self) -> None:
        if self.closed:
            return
        self.closed = True
        self.writer.close()
        for st in list(self.streams.values()):
            self._peer_reset(st, LOST)
        self.streams.clear()
        self.wake()

    @staticmethod
    def _peer_reset(st: H2Stream, code: int) -> None:
        st.reset_code = code
        st.events.put_nowait(("reset", code))
        if st.on_reset is not None:
            st.on_reset()

    def goaway(self, code: int = NO_ERROR) -> None:
        """Tell the peer no stream above the last it opened will be served."""
        if not self.closed:
            self.write(frame(GOAWAY, 0, 0, struct.pack(">II", self.last_peer_id, code)))

    def wake(self) -> None:
        self._wakeup.set()

    async def wait_change(self) -> None:
        self._wakeup.clear()
        await self._wakeup.wait()

    def write(self, data: bytes) -> None:
        if not self.closed:
            self.writer.write(data)

    async def drain(self) -> None:
        if self.closed:
            raise ConnectionClosed("connection closed")
        await self.writer.drain()

    def forget(self, st: H2Stream) -> None:
        if self.streams.pop(st.id, None) is not None:
            self.wake()

    def _maybe_forget(self, st: H2Stream) -> None:
        if st.local_closed and st.remote_closed:
            self.forget(st)

    # -- streams (client side) ------------------------------------------------
    async def open_stream(self) -> H2Stream:
        while len(self.streams) >= self.peer_max_streams and not self.closed \
                and not self.going_away:
            await self.wait_change()
        if self.closed or self.going_away:
            raise ConnectionClosed("connection going away")
        st = H2Stream(self, self.next_id)
        self.next_id += 2
        self.streams[st.id] = st
        return st

    # -- sending ---------------------------------------------------------------
    def send_headers(self, st: H2Stream, headers: list[tuple[bytes, bytes]],
                     end_stream: bool) -> None:
        """HEADERS and its CONTINUATIONs, written together (nothing else may
        come between them on the wire, and the encoder's table moves with
        them)."""
        if self.closed:
            raise ConnectionClosed("connection closed")
        block = self.encoder.encode(headers)
        size = self.peer_max_frame
        parts = [block[i:i + size] for i in range(0, len(block), size)] or [b""]
        flags = END_STREAM if end_stream else 0
        out = bytearray()
        for k, part in enumerate(parts):
            last = END_HEADERS if k == len(parts) - 1 else 0
            out += frame(HEADERS if k == 0 else CONTINUATION,
                         (flags | last) if k == 0 else last, st.id, part)
        self.write(bytes(out))
        if end_stream:
            st.local_closed = True
            self._maybe_forget(st)

    async def send_data(self, st: H2Stream, data: bytes, end_stream: bool) -> None:
        """DATA frames within the peer's windows and its frame size; waits
        for WINDOW_UPDATE when a window is spent."""
        view = memoryview(data)
        while True:
            if st.reset_code is not None:
                raise StreamReset(st.reset_code)
            if self.closed:
                raise ConnectionClosed("connection closed")
            room = min(self.send_window, st.send_window, self.peer_max_frame)
            if room <= 0 and len(view):
                await self.wait_change()
                continue
            n = min(room, len(view))
            last = n == len(view)
            self.write(frame(DATA, END_STREAM if (last and end_stream) else 0, st.id,
                             bytes(view[:n])))
            self.send_window -= n
            st.send_window -= n
            view = view[n:]
            if last:
                break
        if end_stream:
            st.local_closed = True
            self._maybe_forget(st)
        await self.drain()

    # -- receiving -------------------------------------------------------------
    async def _read_frame(self) -> tuple[int, int, int, bytes]:
        head = await self.reader.readexactly(9)
        length = int.from_bytes(head[:3], "big")
        if length > FRAME_SIZE:
            raise _ConnError(FRAME_SIZE_ERROR, f"frame of {length} bytes")
        sid = int.from_bytes(head[5:9], "big") & 0x7FFFFFFF
        payload = await self.reader.readexactly(length) if length else b""
        return head[3], head[4], sid, payload

    async def _read_loop(self) -> None:
        try:
            if not self.client:
                if await self.reader.readexactly(len(PREFACE)) != PREFACE:
                    raise _ConnError(PROTOCOL_ERROR, "bad client preface")
            while True:
                ftype, flags, sid, payload = await self._read_frame()
                if ftype == HEADERS:
                    await self._on_headers(flags, sid, payload)
                else:
                    self._on_frame(ftype, flags, sid, payload)
        except _ConnError as e:
            log.warning("HTTP/2 connection error: %s", e)
            self.goaway(e.code)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        except asyncio.CancelledError:
            pass
        finally:
            self._shutdown()

    async def _on_headers(self, flags: int, sid: int, payload: bytes) -> None:
        block = bytearray(_strip_padding(flags, payload, priority=bool(flags & PRIORITY_FLAG)))
        end_stream = bool(flags & END_STREAM)
        while not flags & END_HEADERS:
            ftype, flags, csid, more = await self._read_frame()
            if ftype != CONTINUATION or csid != sid:
                raise _ConnError(PROTOCOL_ERROR, "HEADERS not followed by its CONTINUATION")
            block += more
        try:
            headers = self.decoder.decode(bytes(block))
        except HPACKError as e:
            raise _ConnError(COMPRESSION_ERROR, str(e)) from None
        st = self.streams.get(sid)
        if st is None:
            if self.client or sid % 2 == 0 or sid <= self.last_peer_id:
                return  # a stream already closed (reset, or done)
            self.last_peer_id = sid
            if self.going_away:
                self.write(frame(RST_STREAM, 0, sid, struct.pack(">I", REFUSED_STREAM)))
                return
            st = H2Stream(self, sid)
            self.streams[sid] = st
            st.remote_closed = end_stream
            st.events.put_nowait(("headers", headers, end_stream))
            self.on_stream(st, headers)
            return
        if end_stream:
            st.remote_closed = True
        st.events.put_nowait(("headers", headers, end_stream))
        self._maybe_forget(st)

    def _on_frame(self, ftype: int, flags: int, sid: int, payload: bytes) -> None:
        if ftype == DATA:
            self.recv_unacked += len(payload)
            if self.recv_unacked >= DEFAULT_WINDOW // 2:
                self.write(frame(WINDOW_UPDATE, 0, 0, struct.pack(">I", self.recv_unacked)))
                self.recv_unacked = 0
            st = self.streams.get(sid)
            data = _strip_padding(flags, payload)
            if st is None:
                return
            pad = len(payload) - len(data)
            if pad:
                st.consumed(pad)
            if flags & END_STREAM:
                st.remote_closed = True
            st.events.put_nowait(("data", data, bool(flags & END_STREAM)))
            self._maybe_forget(st)
        elif ftype == SETTINGS:
            if flags & ACK:
                return
            if len(payload) % 6:
                raise _ConnError(FRAME_SIZE_ERROR, "SETTINGS length")
            for off in range(0, len(payload), 6):
                key, value = struct.unpack(">HI", payload[off:off + 6])
                if key == S_INITIAL_WINDOW_SIZE:
                    if value > MAX_WINDOW:
                        raise _ConnError(FLOW_CONTROL_ERROR, "initial window too large")
                    delta = value - self.peer_initial_window
                    self.peer_initial_window = value
                    for st in self.streams.values():
                        st.send_window += delta
                elif key == S_MAX_FRAME_SIZE:
                    self.peer_max_frame = value
                elif key == S_MAX_CONCURRENT_STREAMS:
                    self.peer_max_streams = value
                elif key == S_HEADER_TABLE_SIZE:
                    self.encoder.set_max_table_size(value)
            self.write(frame(SETTINGS, ACK, 0))
            self.wake()
        elif ftype == WINDOW_UPDATE:
            inc = struct.unpack(">I", payload)[0] & 0x7FFFFFFF
            if sid == 0:
                self.send_window += inc
            elif (st := self.streams.get(sid)) is not None:
                st.send_window += inc
            self.wake()
        elif ftype == PING:
            if not flags & ACK:
                self.write(frame(PING, ACK, 0, payload))
        elif ftype == RST_STREAM:
            st = self.streams.pop(sid, None)
            if st is not None:
                self._peer_reset(st, struct.unpack(">I", payload)[0])
                self.wake()
        elif ftype == GOAWAY:
            last = struct.unpack(">I", payload[:4])[0] & 0x7FFFFFFF
            self.going_away = True
            for st_id in [i for i in self.streams if i > last and (i % 2 == 1) == self.client]:
                self._peer_reset(self.streams.pop(st_id), REFUSED_STREAM)
            self.wake()
        elif ftype == PUSH_PROMISE:
            raise _ConnError(PROTOCOL_ERROR, "PUSH_PROMISE with push disabled")
        elif ftype == CONTINUATION:
            raise _ConnError(PROTOCOL_ERROR, "CONTINUATION without HEADERS")
        # PRIORITY and unknown frame types are ignored


class _ConnError(Exception):
    def __init__(self, code: int, what: str) -> None:
        super().__init__(what)
        self.code = code


def _strip_padding(flags: int, payload: bytes, priority: bool = False) -> bytes:
    start, end = 0, len(payload)
    if flags & PADDED:
        if not payload or payload[0] >= len(payload):
            raise _ConnError(PROTOCOL_ERROR, "bad padding")
        start, end = 1, len(payload) - payload[0]
    if priority:
        start += 5
    return payload[start:end]


# ---------------------------------------------------------------------- gRPC
class StatusCode(enum.IntEnum):
    OK = 0
    CANCELLED = 1
    UNKNOWN = 2
    INVALID_ARGUMENT = 3
    DEADLINE_EXCEEDED = 4
    NOT_FOUND = 5
    ALREADY_EXISTS = 6
    PERMISSION_DENIED = 7
    RESOURCE_EXHAUSTED = 8
    FAILED_PRECONDITION = 9
    ABORTED = 10
    OUT_OF_RANGE = 11
    UNIMPLEMENTED = 12
    INTERNAL = 13
    UNAVAILABLE = 14
    DATA_LOSS = 15
    UNAUTHENTICATED = 16


# an HTTP status in place of a gRPC one (PROTOCOL-HTTP2.md, "HTTP to gRPC")
_HTTP_CODES = {400: StatusCode.INTERNAL, 401: StatusCode.UNAUTHENTICATED,
               403: StatusCode.PERMISSION_DENIED, 404: StatusCode.UNIMPLEMENTED,
               429: StatusCode.UNAVAILABLE, 502: StatusCode.UNAVAILABLE,
               503: StatusCode.UNAVAILABLE, 504: StatusCode.UNAVAILABLE}
MAX_MESSAGE = 4 * 1024 * 1024  # grpcio's default receive limit
_RESERVED = {b"content-type", b"te", b"grpc-timeout", b"grpc-encoding",
             b"grpc-accept-encoding", b"grpc-status", b"grpc-message",
             b"grpc-status-details-bin"}
Metadata = Iterable[tuple[str, Any]]


class RpcError(Exception):
    """A call that ended with another status than OK (grpcio's ``RpcError``
    accessors)."""

    def __init__(self, code: StatusCode, details: str,
                 trailing_metadata: tuple = ()) -> None:
        super().__init__(f"{code.name}: {details}")
        self._code, self._details, self._trailing = code, details, trailing_metadata

    def code(self) -> StatusCode:
        return self._code

    def details(self) -> str:
        return self._details

    def trailing_metadata(self) -> tuple:
        return self._trailing


def encode_message(data: bytes) -> bytes:
    return b"\x00" + struct.pack(">I", len(data)) + data


def _percent_encode(text: str) -> bytes:
    return quote(text.encode("utf-8"), safe=bytes(range(0x20, 0x7F)).replace(b"%", b"")
                 .decode()).encode("ascii")


def _percent_decode(raw: bytes) -> str:
    return unquote_to_bytes(raw).decode("utf-8", "replace")


def _timeout_header(seconds: float) -> bytes:
    micros = max(1, math.ceil(seconds * 1e6))
    for unit, scale in ((b"u", 1), (b"m", 1000), (b"S", 10 ** 6), (b"M", 6 * 10 ** 7)):
        if -(-micros // scale) < 10 ** 8:
            return str(-(-micros // scale)).encode() + unit
    return str(min(-(-micros // (36 * 10 ** 8)), 10 ** 8 - 1)).encode() + b"H"


def _parse_timeout(raw: bytes) -> Optional[float]:
    scale = {b"H": 3600.0, b"M": 60.0, b"S": 1.0, b"m": 1e-3, b"u": 1e-6, b"n": 1e-9}
    try:
        return int(raw[:-1]) * scale[raw[-1:]]
    except (ValueError, KeyError):
        return None


def metadata_headers(metadata: Optional[Metadata]) -> list[tuple[bytes, bytes]]:
    out = []
    for key, value in metadata or ():
        k = key.lower().encode("ascii")
        if k.endswith(b"-bin"):
            raw = value if isinstance(value, bytes) else str(value).encode()
            out.append((k, base64.b64encode(raw).rstrip(b"=")))
        else:
            out.append((k, value if isinstance(value, bytes) else str(value).encode()))
    return out


def headers_metadata(headers: list[tuple[bytes, bytes]]) -> tuple:
    """Received headers -> metadata: pseudo-headers and gRPC's own dropped,
    ``-bin`` values base64-decoded (padded or not)."""
    out = []
    for k, v in headers:
        if k.startswith(b":") or k in _RESERVED:
            continue
        key = k.decode("ascii", "replace")
        if key.endswith("-bin"):
            out.append((key, base64.b64decode(v + b"=" * (-len(v) % 4))))
        else:
            out.append((key, v.decode("utf-8", "replace")))
    return tuple(out)


class _Deframer:
    """gRPC messages out of a stream's DATA."""

    def __init__(self) -> None:
        self.buf = bytearray()

    def feed(self, data: bytes) -> list[bytes]:
        self.buf += data
        out = []
        while len(self.buf) >= 5:
            flag = self.buf[0]
            n = int.from_bytes(self.buf[1:5], "big")
            if flag & 1:
                raise RpcError(StatusCode.INTERNAL,
                               "a compressed message without a grpc-encoding")
            if n > MAX_MESSAGE:
                raise RpcError(StatusCode.RESOURCE_EXHAUSTED,
                               f"Received message larger than max ({n} vs. {MAX_MESSAGE})")
            if len(self.buf) < 5 + n:
                break
            out.append(bytes(self.buf[5:5 + n]))
            del self.buf[:5 + n]
        return out


def _status_headers(code: StatusCode, details: str, trailing: Metadata = ()) -> list:
    out = [(b"grpc-status", str(int(code)).encode())]
    if details:
        out.append((b"grpc-message", _percent_encode(details)))
    return out + metadata_headers(trailing)


def _identity(x):
    return x


# -- server -------------------------------------------------------------------
class _Abort(Exception):
    def __init__(self, code: StatusCode, details: str) -> None:
        super().__init__(details)
        self.code, self.details = code, details


class ServicerContext:
    """What a handler sees of its call (the parts of grpcio's context the
    fronts use)."""

    def __init__(self, st: H2Stream, metadata: tuple) -> None:
        self._st = st
        self._metadata = metadata
        self._trailing: list = []
        self.cancelled = False

    def invocation_metadata(self) -> tuple:
        return self._metadata

    def is_active(self) -> bool:
        return not self.cancelled and self._st.reset_code is None

    def set_trailing_metadata(self, metadata: Metadata) -> None:
        self._trailing = list(metadata)

    def abort(self, code: StatusCode, details: str) -> None:
        """End the call with ``code`` and ``details`` (raises)."""
        raise _Abort(code, details)


class _Method:
    def __init__(self, kind: str, handler: Callable, deserializer, serializer) -> None:
        self.kind, self.handler = kind, handler
        self.deserializer = deserializer or _identity
        self.serializer = serializer or _identity


class Server:
    """A gRPC server on the running event loop (see the module docstring)."""

    KINDS = ("unary_unary", "unary_stream", "stream_stream")

    def __init__(self, maximum_concurrent_rpcs: Optional[int] = None) -> None:
        self.max_rpcs = maximum_concurrent_rpcs
        self._methods: dict[str, _Method] = {}
        self._server: Optional[asyncio.base_events.Server] = None
        self._conns: set[H2Connection] = set()
        self._calls: set[asyncio.Task] = set()
        self._stopping = False
        self.port = 0

    def add_method(self, full_name: str, kind: str, handler: Callable,
                   request_deserializer: Optional[Callable] = None,
                   response_serializer: Optional[Callable] = None) -> None:
        """``full_name`` is ``/package.Service/Method``; ``kind`` one of
        ``KINDS``. Without (de)serializers the handler sees bytes."""
        if kind not in self.KINDS:
            raise ValueError(f"unknown handler kind {kind!r}")
        self._methods[full_name] = _Method(kind, handler, request_deserializer,
                                           response_serializer)

    async def start(self, host: str, port: int) -> int:
        self._server = await asyncio.start_server(self._on_conn, host, port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def stop(self, grace: Optional[float] = 1.0) -> None:
        """No new connections or calls; GOAWAY to every peer; the calls in
        flight get ``grace`` seconds, then are cancelled."""
        self._stopping = True
        if self._server is not None:
            self._server.close()
        for conn in list(self._conns):
            conn.goaway()
        if self._calls and grace:
            await asyncio.wait(list(self._calls), timeout=grace)
        for task in list(self._calls):
            task.cancel()
        if self._calls:
            await asyncio.gather(*self._calls, return_exceptions=True)
        for conn in list(self._conns):
            await conn.close()
        if self._server is not None:
            await self._server.wait_closed()
            self._server = None

    async def _on_conn(self, reader: asyncio.StreamReader,
                       writer: asyncio.StreamWriter) -> None:
        if self._stopping:
            writer.transport.abort()
            return
        conn = H2Connection(reader, writer, client=False)
        conn.on_stream = self._on_stream
        self._conns.add(conn)
        try:
            await conn.start()
            await conn._task
        except (ConnectionError, OSError):
            pass
        finally:
            self._conns.discard(conn)
            conn._shutdown()

    def _on_stream(self, st: H2Stream, headers: list) -> None:
        task = asyncio.get_running_loop().create_task(self._call(st, headers))
        self._calls.add(task)
        task.add_done_callback(self._calls.discard)

    @staticmethod
    def _trailers_only(st: H2Stream, code: StatusCode, details: str,
                       extra: list = ()) -> None:
        st.send_headers([(b":status", b"200"), (b"content-type", b"application/grpc"),
                         *extra, *_status_headers(code, details)], end_stream=True)
        if not st.remote_closed:
            st.reset(NO_ERROR)

    async def _call(self, st: H2Stream, headers: list) -> None:
        hd = dict(headers)
        path = hd.get(b":path", b"").decode("utf-8", "replace")
        try:
            if not hd.get(b"content-type", b"").startswith(b"application/grpc"):
                st.send_headers([(b":status", b"415")], end_stream=True)
                if not st.remote_closed:
                    st.reset(NO_ERROR)
                return
            encoding = hd.get(b"grpc-encoding", b"identity")
            if encoding != b"identity":
                self._trailers_only(
                    st, StatusCode.UNIMPLEMENTED,
                    f"grpc-encoding {encoding.decode('latin-1')} is not supported",
                    [(b"grpc-accept-encoding", b"identity")])
                return
            method = self._methods.get(path)
            if method is None:
                self._trailers_only(st, StatusCode.UNIMPLEMENTED, "Method not found!")
                return
            active = len(self._calls) - 1  # this call is among them
            if self.max_rpcs is not None and active >= self.max_rpcs:
                self._trailers_only(st, StatusCode.RESOURCE_EXHAUSTED,
                                    "Concurrent RPC limit exceeded!")
                return
            timeout = _parse_timeout(hd[b"grpc-timeout"]) if b"grpc-timeout" in hd else None
            ctx = ServicerContext(st, headers_metadata(headers))
            run = _ServerCall(st, method, ctx)
            st.on_reset = asyncio.current_task().cancel  # the client cancelled
            try:
                await asyncio.wait_for(run.run(), timeout)
            except asyncio.TimeoutError:
                run.finish(StatusCode.DEADLINE_EXCEEDED, "Deadline Exceeded")
            await st.conn.drain()
        except (ConnectionClosed, StreamReset, ConnectionError):
            pass
        except asyncio.CancelledError:
            st.reset(CANCEL)
            if not self._stopping:
                return  # the client's RST_STREAM: the call is over
            raise
        finally:
            st.on_reset = None
            st.conn.forget(st)


class _ServerCall:
    """One call's handler run: request messages in, responses and the
    status out."""

    def __init__(self, st: H2Stream, method: _Method, ctx: ServicerContext) -> None:
        self.st, self.method, self.ctx = st, method, ctx
        self.sent_headers = False
        self.done = False
        self.deframer = _Deframer()
        self.pending: collections.deque = collections.deque()
        self.ended = False  # the client's half closed

    async def _next_request(self):
        """The next request message, or None at the end of the client's half."""
        while not self.pending:
            if self.ended:
                return None
            kind, *rest = await self.st.events.get()
            if kind == "reset":
                self.ctx.cancelled = True
                raise StreamReset(rest[0])
            if kind == "data":
                data, end = rest
                self.pending.extend(self.deframer.feed(data))
                self.st.consumed(len(data))
            else:  # headers: the request's own (already read) or trailers
                end = rest[1]
            self.ended = self.ended or end
        return self.method.deserializer(self.pending.popleft())

    async def _requests(self) -> AsyncIterator:
        while (msg := await self._next_request()) is not None:
            yield msg

    async def _send(self, response) -> None:
        if not self.sent_headers:
            self._send_headers()
        await self.st.send_data(encode_message(self.method.serializer(response)))

    def _send_headers(self) -> None:
        self.sent_headers = True
        self.st.send_headers([(b":status", b"200"), (b"content-type", b"application/grpc")])

    def finish(self, code: StatusCode, details: str) -> None:
        if self.done or self.st.reset_code is not None or self.st.conn.closed:
            return
        self.done = True
        status = _status_headers(code, details, self.ctx._trailing)
        if self.sent_headers:
            self.st.send_headers(status, end_stream=True)
        else:
            self.st.send_headers([(b":status", b"200"),
                                  (b"content-type", b"application/grpc"), *status],
                                 end_stream=True)
        if not self.st.remote_closed:
            self.st.reset(NO_ERROR)

    async def run(self) -> None:
        m, ctx = self.method, self.ctx
        try:
            if m.kind == "stream_stream":
                request: Any = self._requests()
            else:
                request = await self._next_request()
                if request is None:
                    self.finish(StatusCode.INTERNAL, "the call carried no request message")
                    return
            if m.kind == "unary_unary":
                response = await m.handler(request, ctx)
                await self._send(response)
            else:
                agen = m.handler(request, ctx)
                try:
                    async for response in agen:
                        await self._send(response)
                finally:
                    await agen.aclose()
            self.finish(StatusCode.OK, "")
        except _Abort as e:
            self.finish(e.code, e.details)
        except RpcError as e:  # a request that did not deframe
            self.finish(e.code(), e.details())
        except (StreamReset, ConnectionClosed):
            ctx.cancelled = True
        except asyncio.CancelledError:
            ctx.cancelled = True
            raise
        except Exception as e:  # noqa: BLE001 — one failed handler is one status
            log.exception("gRPC handler for a %s call failed", m.kind)
            what = ("Exception calling application" if m.kind == "unary_unary"
                    else "Exception iterating responses")
            self.finish(StatusCode.UNKNOWN, f"{what}: {e}")


# -- client -------------------------------------------------------------------
class Call:
    """One client call: ``write`` requests, ``done_writing``, ``read``
    responses (None at the end; a status other than OK raises ``RpcError``).
    Iterating it reads to the end."""

    def __init__(self, channel: "Channel", method: str, serializer, deserializer,
                 timeout: Optional[float], metadata: Optional[Metadata]) -> None:
        self._channel = channel
        self._method = method
        self._serializer = serializer or _identity
        self._deserializer = deserializer or _identity
        self._timeout = timeout
        self._metadata = metadata
        self._st: Optional[H2Stream] = None
        self._deframer = _Deframer()
        self._pending: collections.deque = collections.deque()
        self._status: Optional[tuple[StatusCode, str, tuple]] = None
        self._got_headers = False
        self._timer: Optional[asyncio.TimerHandle] = None
        self._writer_task: Optional[asyncio.Task] = None
        self._opening: Optional[asyncio.Future] = None

    async def _open(self) -> None:
        """Open the stream once (the writer task and the reader both call
        this; the second waits for the first)."""
        if self._st is not None:
            return
        if self._opening is None:
            self._opening = asyncio.ensure_future(self._open_stream())
        await self._opening

    async def _open_stream(self) -> None:
        try:
            conn = await self._channel._connection()
            st = await conn.open_stream()
        except (OSError, ConnectionClosed) as e:
            self._end(StatusCode.UNAVAILABLE, f"failed to connect to {self._channel.target}: {e}")
            self._raise()
        host = self._channel.target.encode()
        headers = [(b":method", b"POST"), (b":scheme", b"http"),
                   (b":path", self._method.encode()), (b":authority", host),
                   (b"te", b"trailers"), (b"content-type", b"application/grpc"),
                   (b"user-agent", b"grpc-wire-python")]
        if self._timeout is not None:
            headers.append((b"grpc-timeout", _timeout_header(self._timeout)))
            self._timer = asyncio.get_running_loop().call_later(
                self._timeout, self._expire)
        headers += metadata_headers(self._metadata)
        st.send_headers(headers)
        self._st = st

    def _expire(self) -> None:
        if self._status is None:
            self._status = (StatusCode.DEADLINE_EXCEEDED, "Deadline Exceeded", ())
            if self._st is not None:
                self._st.reset(CANCEL)
                self._st.events.put_nowait(("expired",))

    def cancel(self) -> None:
        if self._status is None:
            self._status = (StatusCode.CANCELLED, "Locally cancelled by application!", ())
            if self._st is not None:
                self._st.reset(CANCEL)
                self._st.events.put_nowait(("expired",))
        if self._writer_task is not None:
            self._writer_task.cancel()

    async def write(self, request) -> None:
        await self._open()
        if self._status is not None:
            self._raise()
        try:
            await self._st.send_data(encode_message(self._serializer(request)))
        except (StreamReset, ConnectionClosed):
            pass  # the status arrives on the read side

    async def done_writing(self) -> None:
        await self._open()
        if self._status is None and not self._st.local_closed:
            try:
                await self._st.send_data(b"", end_stream=True)
            except (StreamReset, ConnectionClosed):
                pass

    def _raise(self):
        code, details, trailing = self._status
        if code != StatusCode.OK:
            raise RpcError(code, details, trailing)

    def _end(self, code: StatusCode, details: str, trailing: tuple = ()) -> None:
        if self._status is None:
            self._status = (code, details, trailing)
        st = self._st
        if st is not None and st.id in st.conn.streams:  # no longer wanted either way
            st.reset(NO_ERROR if st.remote_closed else CANCEL)
        if self._timer is not None:
            self._timer.cancel()
        if self._writer_task is not None and not self._writer_task.done():
            self._writer_task.cancel()

    def _on_headers(self, headers: list, end: bool) -> None:
        hd = dict(headers)
        if not self._got_headers:
            self._got_headers = True
            status = hd.get(b":status", b"")
            if status != b"200":
                http = int(status or 0)
                self._end(_HTTP_CODES.get(http, StatusCode.UNKNOWN),
                          f"Received http2 header with status: {http}")
                return
            if not end:
                return
        code = hd.get(b"grpc-status")
        if code is None:
            self._end(StatusCode.UNKNOWN, "the trailers carry no grpc-status")
            return
        try:
            status = StatusCode(int(code))
        except ValueError:
            status = StatusCode.UNKNOWN
        self._end(status, _percent_decode(hd.get(b"grpc-message", b"")),
                  headers_metadata(headers))

    async def read(self):
        """The next response, or None once the call ended OK."""
        await self._open()
        while not self._pending:
            if self._status is not None:
                self._raise()
                return None
            kind, *rest = await self._st.events.get()
            if kind == "headers":
                self._on_headers(rest[0], rest[1])
            elif kind == "data":
                data, end = rest
                try:
                    self._pending.extend(self._deframer.feed(data))
                except RpcError as e:
                    self._st.reset(CANCEL)
                    self._end(e.code(), e.details())
                self._st.consumed(len(data))
                if end and self._status is None:
                    self._end(StatusCode.INTERNAL, "the stream ended without trailers")
            elif kind == "reset":
                if rest[0] == LOST:
                    self._end(StatusCode.UNAVAILABLE, "the connection closed")
                else:
                    self._end(StatusCode.UNAVAILABLE if rest[0] == REFUSED_STREAM
                              else StatusCode.CANCELLED if rest[0] == CANCEL
                              else StatusCode.INTERNAL,
                              f"Received RST_STREAM with error code {rest[0]}")
            # "expired": the status is already set
        return self._deserializer(self._pending.popleft())

    def __aiter__(self):
        return self._iter()

    async def _iter(self):
        while (msg := await self.read()) is not None:
            yield msg

    def code(self) -> Optional[StatusCode]:
        return None if self._status is None else self._status[0]

    def details(self) -> Optional[str]:
        return None if self._status is None else self._status[1]

    def trailing_metadata(self) -> tuple:
        return () if self._status is None else self._status[2]

    async def _write_all(self, requests) -> None:
        try:
            if hasattr(requests, "__aiter__"):
                async for r in requests:
                    await self.write(r)
            else:
                for r in requests:
                    await self.write(r)
            await self.done_writing()
        except asyncio.CancelledError:
            pass

    async def _unary(self, request):
        try:
            await self.write(request)
            await self.done_writing()
            response = await self.read()
            if response is None:
                raise RpcError(StatusCode.INTERNAL, "no response message")
            if await self.read() is not None:
                raise RpcError(StatusCode.INTERNAL, "more than one response message")
            return response
        except BaseException:
            self.cancel()
            raise


class Channel:
    """A client of one ``host:port`` (one HTTP/2 connection, reopened after
    the peer went away)."""

    def __init__(self, target: str) -> None:
        self.target = target
        self._conn: Optional[H2Connection] = None
        self._lock = asyncio.Lock()

    async def _connection(self) -> H2Connection:
        async with self._lock:
            if self._conn is None or self._conn.closed or self._conn.going_away:
                host, _, port = self.target.rpartition(":")
                reader, writer = await asyncio.open_connection(host.strip("[]"), int(port))
                conn = H2Connection(reader, writer, client=True)
                await conn.start()
                self._conn = conn
            return self._conn

    def unary_unary(self, method: str, request_serializer=None,
                    response_deserializer=None) -> Callable[..., Awaitable]:
        def call(request, timeout: Optional[float] = None,
                 metadata: Optional[Metadata] = None):
            return Call(self, method, request_serializer, response_deserializer,
                        timeout, metadata)._unary(request)
        return call

    def unary_stream(self, method: str, request_serializer=None,
                     response_deserializer=None) -> Callable[..., Call]:
        def call(request, timeout: Optional[float] = None,
                 metadata: Optional[Metadata] = None) -> Call:
            c = Call(self, method, request_serializer, response_deserializer, timeout,
                     metadata)
            c._writer_task = asyncio.get_running_loop().create_task(c._write_all([request]))
            return c
        return call

    def stream_stream(self, method: str, request_serializer=None,
                      response_deserializer=None) -> Callable[..., Call]:
        """The call's requests come from ``request_iterator`` (sync or async)
        when given, else from ``Call.write`` / ``done_writing``."""
        def call(request_iterator=None, timeout: Optional[float] = None,
                 metadata: Optional[Metadata] = None) -> Call:
            c = Call(self, method, request_serializer, response_deserializer, timeout,
                     metadata)
            if request_iterator is not None:
                c._writer_task = asyncio.get_running_loop().create_task(
                    c._write_all(request_iterator))
            return c
        return call

    async def close(self) -> None:
        if self._conn is not None:
            await self._conn.close()
            self._conn = None
