"""HTTP/1.1 over asyncio streams for the router: a server front and a pooled
client, on the standard library (the reference router serves and proxies with
aiohttp, which the card's Python does not promise).

Server (``HTTPServer``): ``asyncio.start_server``; keep-alive connections; a
request body sized by ``Content-Length`` or chunked, at most ``max_body``
bytes (``parse_multipart`` splits a ``multipart/form-data`` one into its
parts); routes by method and a path pattern (``{name}`` matches one segment,
``{name:.*}`` the rest); a handler returns a ``Response`` or a
``StreamResponse`` it has prepared and written. A stream is sent with chunked
transfer encoding, each ``write`` flushed as one chunk, and terminated when the
handler returns, as aiohttp does. ``stop`` closes the listener, cancels the
connections' handlers and waits for their connections to close, at most
``STOP_GRACE_S`` before it aborts the rest; a connection accepted as the
server stops is aborted unserved.

Client (``HTTPClient``): one pool of idle keep-alive connections per
``host:port`` (TLS for an ``https`` URL, with the default trust store or the
``ssl_context`` given, as the Kubernetes watch trusts its service account's
CA). ``request`` returns once the status line and headers are in; the body is
read whole (``read``) or chunk by chunk as it arrives
(``iter_chunks``), sized by ``Content-Length``, chunked, or up to the close.
One ``timeout`` bounds the whole exchange, body included, and raises
``asyncio.TimeoutError`` as aiohttp's total timeout does; ``None`` sets no
bound. A connection goes
back to the pool only when its response was read to the end and the peer did
not ask to close it; ``close`` (or ``release`` of an unfinished response) shuts
it, so a cancelled or abandoned exchange never leaves a half-read connection
to the next request. A request on a pooled connection that the peer had
already closed is sent again once on a new connection, before any byte of its
response arrived.
"""

from __future__ import annotations

import asyncio
import json
import logging
import math
import re
import ssl
import time
import weakref
from typing import Any, AsyncIterator, Awaitable, Callable, Optional
from urllib.parse import parse_qsl, unquote, urlsplit

__all__ = ["Headers", "Request", "Response", "StreamResponse", "json_response",
           "HTTPServer", "HTTPClient", "ClientResponse", "HTTPProtocolError",
           "BodyPart", "MultipartError", "parse_multipart"]

log = logging.getLogger(__name__)

MAX_LINE = 64 * 1024
STOP_GRACE_S = 2.0
_JSON_TYPE = re.compile(r"^application/(?:[\w.+-]+?\+)?json")
REASONS = {200: "OK", 201: "Created", 204: "No Content", 400: "Bad Request",
           404: "Not Found", 405: "Method Not Allowed", 409: "Conflict",
           413: "Payload Too Large", 429: "Too Many Requests",
           500: "Internal Server Error", 502: "Bad Gateway",
           503: "Service Unavailable", 504: "Gateway Timeout"}


class HTTPProtocolError(Exception):
    """The peer sent something that is not HTTP/1.x, or closed mid-message."""


class _Stale(Exception):
    """A reused connection answered nothing: the peer had closed it."""


class Headers(dict):
    """Header map with lower-cased names (case-insensitive lookups)."""

    def __init__(self, items=()) -> None:
        super().__init__()
        for k, v in (items.items() if isinstance(items, dict) else items):
            self[k] = v

    def __setitem__(self, key: str, value: str) -> None:
        super().__setitem__(key.lower(), value)

    def __getitem__(self, key: str) -> str:
        return super().__getitem__(key.lower())

    def __contains__(self, key: object) -> bool:
        return isinstance(key, str) and super().__contains__(key.lower())

    def get(self, key: str, default: Any = None) -> Any:
        return super().get(key.lower(), default)


async def _read_line(reader: asyncio.StreamReader) -> bytes:
    try:
        line = await reader.readuntil(b"\n")
    except asyncio.IncompleteReadError as e:
        if e.partial:
            raise HTTPProtocolError("connection closed mid-line") from None
        return b""
    except asyncio.LimitOverrunError:
        raise HTTPProtocolError("header line too long") from None
    return line


async def _read_headers(reader: asyncio.StreamReader) -> Headers:
    headers = Headers()
    total = 0
    while True:
        line = await _read_line(reader)
        if not line:
            raise HTTPProtocolError("connection closed in the headers")
        total += len(line)
        if total > MAX_LINE:
            raise HTTPProtocolError("headers too long")
        if line in (b"\r\n", b"\n"):
            return headers
        name, sep, value = line.decode("latin-1").partition(":")
        if not sep or not name.strip():
            raise HTTPProtocolError(f"bad header line {line[:80]!r}")
        headers[name.strip()] = value.strip()


def _chunked(headers: Headers) -> bool:
    return "chunked" in headers.get("transfer-encoding", "").lower()


def _length(headers: Headers) -> Optional[int]:
    raw = headers.get("content-length")
    if raw is None:
        return None
    try:
        n = int(raw)
    except ValueError:
        raise HTTPProtocolError(f"bad Content-Length {raw!r}") from None
    if n < 0:
        raise HTTPProtocolError(f"bad Content-Length {raw!r}")
    return n


async def _read_chunk_size(reader: asyncio.StreamReader) -> int:
    line = await _read_line(reader)
    if not line:
        raise HTTPProtocolError("connection closed in a chunked body")
    try:
        return int(line.split(b";", 1)[0].strip(), 16)
    except ValueError:
        raise HTTPProtocolError(f"bad chunk size {line[:40]!r}") from None


async def _read_exactly(reader: asyncio.StreamReader, n: int) -> bytes:
    try:
        return await reader.readexactly(n)
    except asyncio.IncompleteReadError:
        raise HTTPProtocolError("connection closed mid-body") from None


async def _read_trailer(reader: asyncio.StreamReader) -> None:
    while (line := await _read_line(reader)) not in (b"\r\n", b"\n"):
        if not line:
            raise HTTPProtocolError("connection closed in a chunked trailer")


def _head(status: int, headers: dict) -> bytes:
    lines = [f"HTTP/1.1 {status} {REASONS.get(status, 'Unknown')}"]
    lines += [f"{k}: {v}" for k, v in headers.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


# ----------------------------------------------------------------- server side
class Request:
    """One request as a handler sees it (the parts of aiohttp's the router
    reads: ``method``, ``path``, ``query``, ``headers``, ``match_info``,
    ``json()``, ``can_read_body``, ``content_type``)."""

    def __init__(self, method: str, target: str, headers: Headers, body: bytes,
                 writer: asyncio.StreamWriter) -> None:
        parts = urlsplit(target)
        self.target = target  # path and query as sent (aiohttp's ``path_qs``)
        self.method = method
        self.path = unquote(parts.path) or "/"  # decoded, as aiohttp's
        self.query = dict(parse_qsl(parts.query, keep_blank_values=True))
        self.headers = headers
        self.body = body
        self.match_info: dict[str, str] = {}
        self._writer = writer

    @property
    def can_read_body(self) -> bool:
        return bool(self.body)

    @property
    def content_type(self) -> str:
        """The media type of ``Content-Type``, lower-cased, without its
        parameters; ``application/octet-stream`` when absent or malformed
        (aiohttp's)."""
        return media_type(self.headers.get("content-type"))

    async def json(self) -> Any:
        return json.loads(self.body)


def media_type(raw: Optional[str]) -> str:
    mtype = (raw or "").split(";", 1)[0].strip().lower()
    kind, sep, sub = mtype.partition("/")
    if not sep or not kind or not sub or "/" in sub:
        return "application/octet-stream"
    return mtype


def header_params(raw: str) -> dict[str, str]:
    """The ``; name=value`` parameters of a header value (values quoted or
    not, names lower-cased; a quoted value's backslash escapes undone)."""
    params: dict[str, str] = {}
    i, n = raw.find(";"), len(raw)
    if i < 0:
        return params
    i += 1
    while i < n:
        eq = raw.find("=", i)
        semi = raw.find(";", i)
        if eq < 0 or (0 <= semi < eq):
            if semi < 0:
                break
            i = semi + 1  # a parameter without a value
            continue
        name = raw[i:eq].strip().lower()
        i = eq + 1
        while i < n and raw[i] in " \t":
            i += 1
        if i < n and raw[i] == '"':
            out, i = [], i + 1
            while i < n and raw[i] != '"':
                if raw[i] == "\\" and i + 1 < n:
                    i += 1
                out.append(raw[i])
                i += 1
            if i >= n:
                raise ValueError(f"unterminated quoted parameter {name!r}")
            value = "".join(out)
            semi = raw.find(";", i + 1)
        else:
            semi = raw.find(";", i)
            value = raw[i:semi if semi >= 0 else n].strip()
        if name:
            params[name] = value
        if semi < 0:
            break
        i = semi + 1
    return params


class MultipartError(ValueError):
    """A ``multipart/*`` body that does not follow RFC 2046's framing."""


class BodyPart:
    """One part of a multipart body: its headers, ``name`` and ``filename``
    from ``Content-Disposition``, and its bytes as sent (aiohttp's
    ``read(decode=False)``)."""

    def __init__(self, headers: Headers, data: bytes) -> None:
        self.headers = headers
        self.data = data
        disposition = header_params(headers.get("content-disposition", ""))
        self.name: Optional[str] = disposition.get("name")
        self.filename: Optional[str] = disposition.get("filename")


def parse_multipart(body: bytes, content_type: Optional[str]) -> list[BodyPart]:
    """The parts of a ``multipart/*`` body (RFC 2046): the boundary from the
    header's parameter, CRLF-framed delimiters, a preamble before the first
    and an epilogue after the close delimiter ignored. Anything else raises
    ``MultipartError``."""
    try:
        boundary = header_params(content_type or "").get("boundary")
    except ValueError as e:
        raise MultipartError(str(e)) from None
    if media_type(content_type).split("/")[0] != "multipart" or not boundary:
        raise MultipartError("a multipart body needs a multipart type with a boundary")
    if len(boundary) > 70:
        raise MultipartError("boundary longer than 70 characters")
    delim = b"--" + boundary.encode("latin-1")
    if body.startswith(delim):
        pos = len(delim)
    else:
        at = body.find(b"\r\n" + delim)
        if at < 0:
            raise MultipartError("no delimiter line in the body")
        pos = at + 2 + len(delim)
    parts: list[BodyPart] = []
    while True:
        if body.startswith(b"--", pos):
            return parts  # the close delimiter: what follows is the epilogue
        eol = body.find(b"\r\n", pos)
        if eol < 0 or body[pos:eol].strip(b" \t"):
            raise MultipartError("a delimiter line does not end with CRLF")
        head_end = body.find(b"\r\n\r\n", eol)
        if head_end == eol:  # a part with no header lines
            headers, start = Headers(), eol + 4
        elif head_end < 0:
            raise MultipartError("a part's headers do not end")
        else:
            headers = Headers()
            for line in body[eol + 2:head_end].split(b"\r\n"):
                name, sep, value = line.decode("latin-1").partition(":")
                if not sep or not name.strip():
                    raise MultipartError(f"bad part header line {line[:80]!r}")
                headers[name.strip()] = value.strip()
            start = head_end + 4
        end = body.find(b"\r\n" + delim, start)
        if end < 0:
            raise MultipartError("a part has no closing delimiter")
        try:
            parts.append(BodyPart(headers, body[start:end]))
        except ValueError as e:
            raise MultipartError(str(e)) from None
        pos = end + 2 + len(delim)


class Response:
    def __init__(self, body: bytes = b"", status: int = 200,
                 headers: Optional[dict] = None,
                 content_type: Optional[str] = None) -> None:
        self.body = body
        self.status = status
        self.headers = Headers(headers or {})
        if content_type is not None:
            self.headers["Content-Type"] = content_type
        self.headers.setdefault("content-type", "application/octet-stream")


def json_response(obj: Any, status: int = 200, headers: Optional[dict] = None) -> Response:
    return Response(json.dumps(obj).encode(), status=status,
                    headers={**(headers or {}), "Content-Type": "application/json"})


class StreamResponse:
    """A chunked response the handler prepares, writes chunk by chunk (each
    one flushed as it is written) and ends with ``write_eof``."""

    def __init__(self, status: int = 200, headers: Optional[dict] = None) -> None:
        self.status = status
        self.headers = Headers(headers or {})
        self._writer: Optional[asyncio.StreamWriter] = None
        self.finished = False

    async def prepare(self, request: Request) -> None:
        self._writer = request._writer
        head = dict(self.headers)
        head["transfer-encoding"] = "chunked"
        self._writer.write(_head(self.status, head))
        await self._writer.drain()

    async def write(self, data: bytes) -> None:
        if data:
            self._writer.write(b"%x\r\n%s\r\n" % (len(data), data))
            await self._writer.drain()

    async def write_eof(self) -> None:
        if not self.finished:
            self.finished = True
            self._writer.write(b"0\r\n\r\n")
            await self._writer.drain()


Handler = Callable[[Request], Awaitable[Any]]


class HTTPServer:
    def __init__(self, max_body: int = 64 * 1024 * 1024) -> None:
        self.max_body = max_body
        self._routes: list[tuple[str, re.Pattern, Handler]] = []
        self._server: Optional[asyncio.base_events.Server] = None
        self._conns: set[asyncio.Task] = set()
        self._transports: "weakref.WeakSet[asyncio.BaseTransport]" = weakref.WeakSet()
        self._closing = False
        self.port = 0

    def add_route(self, method: str, pattern: str, handler: Handler) -> None:
        """``method`` "*" takes any; ``{name}`` matches one path segment,
        ``{name:regex}`` the regex."""
        rx = ""
        for part in re.split(r"(\{[^}]+\})", pattern):
            if part.startswith("{"):
                name, _, expr = part[1:-1].partition(":")
                rx += f"(?P<{name}>{expr or '[^/]+'})"
            else:
                rx += re.escape(part)
        self._routes.append((method, re.compile(rx + "$"), handler))

    async def start(self, host: str, port: int) -> int:
        self._server = await asyncio.start_server(self._serve, host, port, limit=MAX_LINE)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def stop(self) -> None:
        self._closing = True
        if self._server is not None:
            self._server.close()
        for t in list(self._conns):
            t.cancel()
        if self._conns:
            await asyncio.gather(*self._conns, return_exceptions=True)
        if self._server is not None:
            # a handler that escaped the cancel, or a close still flushing to a
            # peer that does not read, would hold wait_closed for ever
            try:
                await asyncio.wait_for(asyncio.shield(self._server.wait_closed()),
                                       STOP_GRACE_S)
            except asyncio.TimeoutError:
                for tr in list(self._transports):
                    tr.abort()
                await self._server.wait_closed()
            self._server = None

    def _match(self, method: str, path: str):
        allowed = False
        for m, rx, handler in self._routes:
            hit = rx.match(path)
            if hit is None:
                continue
            if m in ("*", method):
                return handler, hit.groupdict(), True
            allowed = True
        return None, None, allowed

    async def _serve(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        if self._closing:  # accepted as the server stopped: its handler would
            writer.transport.abort()  # outlive the cancel that ``stop`` sends
            return
        self._transports.add(writer.transport)
        task = asyncio.current_task()
        self._conns.add(task)
        try:
            while await self._one(reader, writer):
                pass
        except (HTTPProtocolError, ConnectionError, asyncio.CancelledError):
            pass
        finally:
            self._conns.discard(task)
            writer.close()

    async def _one(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> bool:
        """Serve one request; False when the connection is to close."""
        line = await _read_line(reader)
        if not line:
            return False
        try:
            method, target, version = line.decode("latin-1").split()
        except ValueError:
            raise HTTPProtocolError(f"bad request line {line[:80]!r}") from None
        headers = await _read_headers(reader)
        keep = (version == "HTTP/1.1"
                and headers.get("connection", "").lower() != "close")
        if _chunked(headers):
            parts, size = [], 0
            while (n := await _read_chunk_size(reader)) > 0:
                size += n
                if size > self.max_body:
                    await self._send(writer, Response(b"body too large", 413), False)
                    return False
                parts.append(await _read_exactly(reader, n))
                await _read_exactly(reader, 2)
            await _read_trailer(reader)
            body = b"".join(parts)
        else:
            n = _length(headers) or 0
            if n > self.max_body:
                await self._send(writer, Response(b"body too large", 413), False)
                return False
            body = await _read_exactly(reader, n) if n else b""
        request = Request(method.upper(), target, headers, body, writer)
        handler, params, allowed = self._match(request.method, request.path)
        if handler is None:
            status = 405 if allowed else 404
            await self._send(writer, Response(
                f"{status}: {REASONS[status]}".encode(), status,
                content_type="text/plain; charset=utf-8"), keep)
            return keep
        request.match_info = params
        try:
            resp = await handler(request)
        except (ConnectionError, asyncio.CancelledError):
            raise
        except Exception:  # noqa: BLE001 — one failed handler is one 500, not a dead front
            log.exception("handler for %s %s failed", request.method, request.path)
            resp = Response(b"500 Internal Server Error", 500,
                            content_type="text/plain; charset=utf-8")
        if isinstance(resp, StreamResponse):
            if resp._writer is None:
                await resp.prepare(request)
            await resp.write_eof()
            return keep
        await self._send(writer, resp, keep)
        return keep

    @staticmethod
    async def _send(writer: asyncio.StreamWriter, resp: Response, keep: bool) -> None:
        head = dict(resp.headers)
        head["content-length"] = str(len(resp.body))
        if not keep:
            head["connection"] = "close"
        writer.write(_head(resp.status, head) + resp.body)
        await writer.drain()


# ----------------------------------------------------------------- client side
class _Conn:
    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        self.reader, self.writer = reader, writer

    def close(self) -> None:
        self.writer.close()


class ClientResponse:
    """A response whose status line and headers are in; its body is read
    with ``read`` / ``json`` / ``text`` or, as it arrives, ``iter_chunks``."""

    def __init__(self, client: "HTTPClient", key: str, conn: _Conn, status: int,
                 headers: Headers, deadline: float, method: str) -> None:
        self._client, self._key, self._conn = client, key, conn
        self.status = status
        self.headers = headers
        self._deadline = deadline
        self._chunked = _chunked(headers)
        self._left = _length(headers)
        self._keep = headers.get("connection", "").lower() != "close"
        no_body = method == "HEAD" or status in (204, 304) or 100 <= status < 200
        if no_body:
            self._left, self._chunked = 0, False
        elif not self._chunked and self._left is None:
            self._keep = False  # the body runs to the close
        self._done = no_body or self._left == 0

    @property
    def content_type(self) -> str:
        raw = self.headers.get("content-type", "application/octet-stream")
        return raw.split(";", 1)[0].strip() or "application/octet-stream"

    async def _timed(self, coro):
        if self._deadline == math.inf:
            return await coro
        left = self._deadline - time.monotonic()
        if left <= 0:
            coro.close()
            raise asyncio.TimeoutError
        return await asyncio.wait_for(coro, left)

    async def _next(self) -> bytes:
        r = self._conn.reader
        if self._chunked:
            n = await _read_chunk_size(r)
            if n == 0:
                await _read_trailer(r)
                self._done = True
                return b""
            data = await _read_exactly(r, n)
            await _read_exactly(r, 2)
            return data
        if self._left is None:
            data = await r.read(65536)
            if not data:
                self._done = True
            return data
        data = await r.read(min(self._left, 65536))
        if not data:
            raise HTTPProtocolError("connection closed mid-body")
        self._left -= len(data)
        self._done = self._left == 0
        return data

    async def iter_chunks(self) -> AsyncIterator[bytes]:
        """The body as it arrives: each piece as soon as it is read."""
        while not self._done:
            data = await self._timed(self._next())
            if data:
                yield data
        self.release()

    async def read(self) -> bytes:
        out = bytearray()
        async for data in self.iter_chunks():
            out += data
        return bytes(out)

    async def json(self) -> Any:
        """The body as JSON; like aiohttp, a content type other than JSON
        raises (``ValueError``)."""
        if not _JSON_TYPE.match(self.content_type):
            self.close()
            raise ValueError(f"unexpected content type {self.content_type!r}")
        return json.loads(await self.read())

    async def text(self) -> str:
        return (await self.read()).decode("utf-8", errors="replace")

    def release(self) -> None:
        """Give the connection back when the body was read to its end and the
        peer keeps it open; otherwise close it."""
        conn, self._conn = self._conn, None
        if conn is None:
            return
        if self._done and self._keep:
            self._client._put(self._key, conn)
        else:
            conn.close()

    def close(self) -> None:
        conn, self._conn = self._conn, None
        if conn is not None:
            conn.close()


class HTTPClient:
    def __init__(self, max_idle_per_host: int = 64,
                 ssl_context: Optional[ssl.SSLContext] = None) -> None:
        self.max_idle = max_idle_per_host
        self.ssl_context = ssl_context
        self._idle: dict[str, list[_Conn]] = {}
        self.connections_opened = 0

    def _put(self, key: str, conn: _Conn) -> None:
        idle = self._idle.setdefault(key, [])
        if len(idle) < self.max_idle and not conn.writer.is_closing():
            idle.append(conn)
        else:
            conn.close()

    async def _open(self, key: str) -> _Conn:
        tls = key.startswith("https://")
        host, _, port = key.removeprefix("https://").rpartition(":")
        reader, writer = await asyncio.open_connection(
            host.strip("[]"), int(port), limit=MAX_LINE,
            ssl=(self.ssl_context or ssl.create_default_context()) if tls else None)
        self.connections_opened += 1
        return _Conn(reader, writer)

    async def request(self, method: str, url: str, body: Optional[bytes] = None,
                      headers: Optional[dict] = None, timeout: Optional[float] = 300.0,
                      json_body: Any = None) -> ClientResponse:
        """``url`` is ``http[s]://host[:port]/path?query``. ``json_body`` (when
        not None) is sent as JSON with its content type."""
        parts = urlsplit(url)
        tls = parts.scheme == "https"
        key = parts.netloc if parts.port else f"{parts.netloc}:{443 if tls else 80}"
        if tls:
            key = "https://" + key
        target = (parts.path or "/") + (f"?{parts.query}" if parts.query else "")
        head = Headers(headers or {})
        if json_body is not None:
            body = json.dumps(json_body).encode()
            head.setdefault("content-type", "application/json")
        head["host"] = parts.netloc
        if body is not None or method in ("POST", "PUT", "PATCH"):
            head["content-length"] = str(len(body or b""))
        lines = [f"{method} {target} HTTP/1.1"] + [f"{k}: {v}" for k, v in head.items()]
        wire = ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + (body or b"")
        if timeout is None:
            return await self._exchange(key, wire, method, math.inf)
        deadline = time.monotonic() + timeout
        return await asyncio.wait_for(self._exchange(key, wire, method, deadline), timeout)

    async def _exchange(self, key: str, wire: bytes, method: str,
                        deadline: float) -> ClientResponse:
        idle = self._idle.get(key)
        while idle:
            conn = idle.pop()
            if conn.writer.is_closing() or conn.reader.at_eof():
                conn.close()
                continue
            try:
                return await self._send(key, conn, wire, method, deadline)
            except (ConnectionError, _Stale):
                pass  # the peer had closed the pooled connection: take a new one
        conn = await self._open(key)
        try:
            return await self._send(key, conn, wire, method, deadline)
        except _Stale:
            conn.close()
            raise HTTPProtocolError("connection closed before the response") from None

    async def _send(self, key: str, conn: _Conn, wire: bytes, method: str,
                    deadline: float) -> ClientResponse:
        try:
            conn.writer.write(wire)
            await conn.writer.drain()
            line = await _read_line(conn.reader)
            if not line:
                raise _Stale
            try:
                version, code, *_ = line.decode("latin-1").split(None, 2)
                status = int(code)
            except ValueError:
                raise HTTPProtocolError(f"bad status line {line[:80]!r}") from None
            headers = await _read_headers(conn.reader)
        except BaseException:
            conn.close()
            raise
        resp = ClientResponse(self, key, conn, status, headers, deadline, method)
        if version == "HTTP/1.0" and headers.get("connection", "").lower() != "keep-alive":
            resp._keep = False
        return resp

    async def close(self) -> None:
        for conns in self._idle.values():
            for c in conns:
                c.close()
        self._idle.clear()
