"""HTTP/1.1 on asyncio streams: the gateway's server and its upstream
client, standard library only (the port's stand-in for the reference's
aiohttp application and ``ClientSession``).

The server (``HTTPServer``) reads a request line, headers and a body
framed by ``content-length`` or chunked transfer-encoding (at most
``client_max_size`` bytes, 64 MiB as the reference's application), hands
a ``Request`` to the handler of its path (a route's ``{name}`` segment
matches one percent-decoded segment, in ``Request.match_info``, as the
reference's router does) and writes what comes back: a
``Response`` with a ``content-length``, or a ``StreamResponse`` that
sends its head on ``prepare`` and every ``write`` as one chunk, drained
before ``write`` returns, so an SSE frame leaves the gateway as soon as
it is relayed. Connections are kept alive between requests. A handler
that holds a stream open (the MCP proxy's listening stream) learns of
the client's close from ``Request.gone`` / ``Request.disconnected``.

The client (``HTTPClient``, one per gateway, as the reference keeps one
``ClientSession``) keeps a pool of idle connections per upstream
``host:port``. A request on a pooled connection that the upstream closed
while it sat idle (nothing of a reply read yet) is sent again once on a
new connection. A ``ClientResponse`` reads a body framed by
``content-length``, by chunks or by the connection's end, whole
(``read``) or piece by piece as the bytes arrive (``iter_any``), and
goes back to the pool on ``release`` when its body was read to the end
on a connection that stays open. ``Timeout`` carries the reference's
three limits: the whole request (``total``), the connect and each read;
with none (the default) a long GET, such as a cluster watch, streams
for as long as the server keeps it open. Both legs set ``TCP_NODELAY``;
the server may listen with TLS and the client may carry its own TLS
context. Failures to connect, resets and torn
bodies raise ``ClientError``; a limit raises ``asyncio.TimeoutError``.
"""

from __future__ import annotations

import asyncio
import json
import logging
import socket
import ssl as _ssl
import time
import urllib.parse
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Awaitable, Callable

logger = logging.getLogger(__name__)

#: the largest request body the server reads (the reference's
#: ``client_max_size``)
MAX_BODY = 64 * 1024 * 1024
_MAX_HEAD = 64 * 1024
_READ = 65536
_IDLE_PER_HOST = 32

_REASONS = {
    200: "OK", 202: "Accepted", 400: "Bad Request", 401: "Unauthorized",
    403: "Forbidden", 404: "Not Found",
    405: "Method Not Allowed", 409: "Conflict",
    413: "Request Entity Too Large", 429: "Too Many Requests",
    500: "Internal Server Error", 502: "Bad Gateway",
    503: "Service Unavailable", 504: "Gateway Timeout",
}


class ClientError(Exception):
    """An upstream failure: no connection, a reset or a torn body."""


class ClientConnectionError(ClientError):
    pass


class ClientPayloadError(ClientError):
    pass


def _nodelay(writer: asyncio.StreamWriter) -> None:
    sock = writer.get_extra_info("socket")
    if sock is not None and sock.family in (socket.AF_INET,
                                            socket.AF_INET6):
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)


def _parse_headers(lines: list[bytes]) -> dict[str, str]:
    out: dict[str, str] = {}
    for line in lines:
        name, sep, value = line.partition(b":")
        if not sep:
            continue
        key = name.decode("latin-1").strip().lower()
        v = value.decode("latin-1").strip()
        out[key] = f"{out[key]}, {v}" if key in out else v
    return out


def _head(first: str, headers: dict[str, str]) -> bytes:
    return (first + "\r\n" + "".join(f"{k}: {v}\r\n"
                                     for k, v in headers.items())
            + "\r\n").encode("latin-1")


async def _read_chunked(reader: asyncio.StreamReader,
                        limit: int = 0) -> bytes:
    parts = []
    size = 0
    while True:
        line = await reader.readuntil(b"\r\n")
        n = int(line.split(b";", 1)[0].strip() or b"0", 16)
        if n == 0:
            while (await reader.readuntil(b"\r\n")) != b"\r\n":
                pass  # trailers
            return b"".join(parts)
        size += n
        if limit and size > limit:
            raise ValueError("body too large")
        parts.append(await reader.readexactly(n))
        await reader.readexactly(2)


# -- server -------------------------------------------------------------------
@dataclass
class Request:
    method: str
    path: str
    query: dict[str, str]
    headers: dict[str, str]  # lower-case names
    body: bytes
    remote: str
    writer: asyncio.StreamWriter = field(repr=False)
    #: the values of the matched route's ``{name}`` segments
    match_info: dict[str, str] = field(default_factory=dict)
    reader: asyncio.StreamReader | None = field(default=None, repr=False)

    @property
    def host(self) -> str:
        return self.headers.get("host", "")

    @property
    def gone(self) -> bool:
        """The client closed its connection (a long-lived stream's
        handler polls this to stop what it holds open for the client)."""
        return (self.writer.is_closing()
                or (self.reader is not None and self.reader.at_eof()))

    async def disconnected(self, poll: float = 0.2) -> None:
        """Return once the client has closed its connection."""
        while not self.gone:
            await asyncio.sleep(poll)


class Response:
    def __init__(self, status: int = 200, body: bytes = b"",
                 content_type: str = "application/json",
                 headers: dict[str, str] | None = None):
        self.status = status
        self.body = body
        self.headers = {"content-type": content_type, **(headers or {})}


def json_response(payload: Any, status: int = 200) -> Response:
    return Response(status, json.dumps(payload).encode(),
                    "application/json; charset=utf-8")


def text_response(text: str, status: int = 200) -> Response:
    return Response(status, text.encode(), "text/plain; charset=utf-8")


class StreamResponse:
    """A chunked response: ``prepare`` sends the head, each ``write`` one
    chunk, drained before it returns; ``write_eof`` the last chunk."""

    def __init__(self, status: int = 200,
                 headers: dict[str, str] | None = None):
        self.status = status
        self.headers = dict(headers or {})
        self._writer: asyncio.StreamWriter | None = None
        self.finished = False

    async def prepare(self, request: Request) -> None:
        self._writer = request.writer
        head = dict(self.headers, **{"transfer-encoding": "chunked"})
        self._writer.write(_head(
            f"HTTP/1.1 {self.status} {_REASONS.get(self.status, '')}",
            head))
        await self._writer.drain()

    async def write(self, data: bytes) -> None:
        if not data:
            return
        self._writer.write(b"%x\r\n%s\r\n" % (len(data), data))
        await self._writer.drain()

    async def write_eof(self) -> None:
        if not self.finished:
            self.finished = True
            self._writer.write(b"0\r\n\r\n")
            await self._writer.drain()


Handler = Callable[[Request], Awaitable["Response | StreamResponse"]]


class HTTPServer:
    """Serves ``routes`` (``(method, path)`` → handler) on one port; an
    unknown path answers 404, a known path with another method 405."""

    def __init__(self, routes: dict[tuple[str, str], Handler],
                 client_max_size: int = MAX_BODY):
        self.routes = routes
        self.client_max_size = client_max_size
        self._server: asyncio.AbstractServer | None = None
        self._conns: set[asyncio.StreamWriter] = set()

    async def start(self, host: str, port: int, reuse_port: bool = False,
                    ssl: _ssl.SSLContext | None = None) -> int:
        """Listen; ``reuse_port`` binds with ``SO_REUSEPORT``, so other
        processes may bind the same port and share its connections;
        ``ssl`` (a server context) serves HTTPS."""
        self._server = await asyncio.start_server(
            self._serve, host, port, limit=_MAX_HEAD,
            reuse_port=reuse_port, ssl=ssl)
        return self._server.sockets[0].getsockname()[1]

    async def stop(self, grace: float = 0.0) -> None:
        """Stop listening, give open connections ``grace`` seconds to
        finish the request they carry, then close them."""
        if self._server is not None:
            self._server.close()
            if grace > 0 and self._conns:
                await asyncio.sleep(grace)
            for w in list(self._conns):
                w.close()
            await self._server.wait_closed()
            self._server = None

    @staticmethod
    def _match(pattern: str, path: str) -> dict[str, str] | None:
        """The ``{name}`` segments' values when ``path`` matches
        ``pattern`` (an exact path matches with none), else None."""
        if pattern == path:
            return {}
        if "{" not in pattern:
            return None
        want, got = pattern.split("/"), path.split("/")
        if len(want) != len(got):
            return None
        info = {}
        for w, g in zip(want, got):
            if w.startswith("{") and w.endswith("}"):
                if not g:
                    return None
                info[w[1:-1]] = urllib.parse.unquote(g)
            elif w != g:
                return None
        return info

    async def _dispatch(self, req: Request) -> "Response | StreamResponse":
        handler = self.routes.get((req.method, req.path))
        if handler is None:
            methods = set()
            for (method, pattern), h in self.routes.items():
                info = self._match(pattern, req.path)
                if info is None:
                    continue
                methods.add(method)
                if method == req.method:
                    handler, req.match_info = h, info
                    break
            if handler is None:
                if methods:
                    return text_response("405: Method Not Allowed", 405)
                return text_response("404: Not Found", 404)
        try:
            return await handler(req)
        except (ConnectionError, asyncio.CancelledError):
            raise
        except Exception:  # noqa: BLE001 (a handler bug is a 500)
            logger.exception("error handling %s %s", req.method, req.path)
            return text_response("500 Internal Server Error", 500)

    async def _serve(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        _nodelay(writer)
        self._conns.add(writer)
        peer = writer.get_extra_info("peername")
        remote = peer[0] if isinstance(peer, tuple) else ""
        try:
            while True:
                try:
                    head = await reader.readuntil(b"\r\n\r\n")
                except (asyncio.IncompleteReadError,
                        asyncio.LimitOverrunError, ConnectionError):
                    return
                lines = head[:-4].split(b"\r\n")
                try:
                    method, target, version = \
                        lines[0].decode("latin-1").split(" ", 2)
                except ValueError:
                    return
                headers = _parse_headers(lines[1:])
                keep = (headers.get("connection", "").lower() != "close"
                        if version == "HTTP/1.1" else
                        headers.get("connection", "").lower()
                        == "keep-alive")
                if headers.get("expect", "").lower() == "100-continue":
                    # clients that ask (curl, past 1 KiB) wait for this
                    # before they send the body
                    writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
                    await writer.drain()
                try:
                    if "chunked" in headers.get("transfer-encoding", ""):
                        body = await _read_chunked(reader,
                                                   self.client_max_size)
                    else:
                        n = int(headers.get("content-length", "0") or 0)
                        if n > self.client_max_size:
                            raise ValueError("body too large")
                        body = await reader.readexactly(n) if n else b""
                except ValueError:
                    await self._write(writer, text_response(
                        "413: Request Entity Too Large", 413), False)
                    return
                url = urllib.parse.urlsplit(target)
                req = Request(
                    method=method.upper(), path=url.path or "/",
                    query=dict(urllib.parse.parse_qsl(url.query)),
                    headers=headers, body=body, remote=remote,
                    writer=writer, reader=reader)
                resp = await self._dispatch(req)
                if isinstance(resp, StreamResponse):
                    await resp.write_eof()
                else:
                    await self._write(writer, resp, keep)
                if not keep:
                    return
        except (ConnectionError, asyncio.IncompleteReadError):
            return  # the client went away
        finally:
            self._conns.discard(writer)
            writer.close()

    @staticmethod
    async def _write(writer: asyncio.StreamWriter, resp: Response,
                     keep: bool) -> None:
        headers = dict(resp.headers)
        headers["content-length"] = str(len(resp.body))
        if not keep:
            headers["connection"] = "close"
        writer.write(_head(
            f"HTTP/1.1 {resp.status} {_REASONS.get(resp.status, '')}",
            headers) + resp.body)
        await writer.drain()


# -- client -------------------------------------------------------------------
@dataclass(frozen=True)
class Timeout:
    """The whole request (body included), the connect, and each read of
    the response; None = no limit."""

    total: float | None = None
    connect: float | None = None
    sock_read: float | None = None


class _Conn:
    def __init__(self, key: tuple, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self.key = key
        self.reader = reader
        self.writer = writer

    def close(self) -> None:
        self.writer.close()


class ClientResponse:
    def __init__(self, client: "HTTPClient", conn: _Conn, status: int,
                 headers: dict[str, str], method: str,
                 deadline: float | None, sock_read: float | None):
        self._client = client
        self._conn: _Conn | None = conn
        self.status = status
        self.headers = headers
        self._deadline = deadline
        self._sock_read = sock_read
        self._keep = headers.get("connection", "").lower() != "close"
        if method == "HEAD" or status in (204, 304) or 100 <= status < 200:
            self._mode, self._left = "length", 0
        elif "chunked" in headers.get("transfer-encoding", "").lower():
            self._mode, self._left = "chunked", 0
        elif "content-length" in headers:
            self._mode, self._left = "length", int(headers["content-length"])
        else:
            self._mode, self._left = "close", 0
            self._keep = False
        self._done = self._mode == "length" and self._left == 0

    @property
    def close_delimited(self) -> bool:
        """The body ends where the connection ends (neither a length nor
        chunks): a reset reads as its end."""
        return self._mode == "close"

    @property
    def content_type(self) -> str:
        return self.headers.get("content-type", "").split(";")[0].strip()

    async def _io(self, coro):
        limits = [t for t in (
            self._sock_read,
            None if self._deadline is None
            else self._deadline - time.monotonic()) if t is not None]
        if not limits:
            return await coro
        return await asyncio.wait_for(coro, max(0.0, min(limits)))

    async def iter_any(self) -> AsyncIterator[bytes]:
        """The body's bytes as they arrive."""
        reader = self._conn.reader if self._conn is not None else None
        try:
            while not self._done and reader is not None:
                if self._mode == "length":
                    data = await self._io(reader.read(min(self._left, _READ)))
                    if not data:
                        raise ClientPayloadError(
                            "response payload is not completed")
                    self._left -= len(data)
                    self._done = self._left == 0
                elif self._mode == "close":
                    data = await self._io(reader.read(_READ))
                    if not data:
                        self._done = True
                        return
                else:
                    if self._left == 0:
                        line = await self._io(reader.readuntil(b"\r\n"))
                        self._left = int(
                            line.split(b";", 1)[0].strip() or b"0", 16)
                        if self._left == 0:
                            while (await self._io(reader.readuntil(b"\r\n"))
                                   != b"\r\n"):
                                pass
                            self._done = True
                            return
                    data = await self._io(reader.read(min(self._left, _READ)))
                    if not data:
                        raise ClientPayloadError(
                            "response payload is not completed")
                    self._left -= len(data)
                    if self._left == 0:
                        await self._io(reader.readexactly(2))
                yield data
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError,
                ConnectionError, ValueError) as e:
            self.close()
            raise ClientPayloadError(
                f"response payload is not completed: {e!r}") from None

    async def read(self) -> bytes:
        return b"".join([d async for d in self.iter_any()])

    async def json(self) -> Any:
        return json.loads(await self.read())

    def release(self) -> None:
        """Done with the response: its connection goes back to the pool
        when the body was read to the end, and is closed otherwise."""
        conn, self._conn = self._conn, None
        if conn is None:
            return
        if self._done and self._keep:
            self._client._put(conn)
        else:
            conn.close()

    close = release  # an unfinished body always closes

    async def __aenter__(self) -> "ClientResponse":
        return self

    async def __aexit__(self, *exc) -> None:
        self.release()


class HTTPClient:
    """Upstream requests over pooled keep-alive connections. ``https``
    URLs connect with ``ssl_context`` when one is given (a cluster
    client's CA bundle, client certificate or skipped verification),
    else with the default context."""

    def __init__(self, ssl_context: _ssl.SSLContext | None = None) -> None:
        self._idle: dict[tuple, list[_Conn]] = {}
        self._ssl = ssl_context
        self.closed = False

    def _put(self, conn: _Conn) -> None:
        idle = self._idle.setdefault(conn.key, [])
        if self.closed or len(idle) >= _IDLE_PER_HOST \
                or conn.reader.at_eof():
            conn.close()
        else:
            idle.append(conn)

    async def _connect(self, key: tuple, timeout: float | None) -> _Conn:
        host, port, tls = key
        try:
            reader, writer = await asyncio.wait_for(asyncio.open_connection(
                host, port, limit=_MAX_HEAD,
                ssl=(self._ssl or _ssl.create_default_context())
                if tls else None),
                timeout)
        except OSError as e:
            raise ClientConnectionError(
                f"Cannot connect to host {host}:{port} "
                f"ssl:{'default' if tls else False} "
                f"[{e.strerror or e}]") from None
        _nodelay(writer)
        return _Conn(key, reader, writer)

    async def request(self, method: str, url: str, data: bytes = b"",
                      headers: dict[str, str] | None = None,
                      timeout: Timeout = Timeout()) -> ClientResponse:
        u = urllib.parse.urlsplit(url)
        tls = u.scheme == "https"
        key = (u.hostname or "", u.port or (443 if tls else 80), tls)
        target = (u.path or "/") + (f"?{u.query}" if u.query else "")
        head = {"host": u.netloc, **(headers or {})}
        head["content-length"] = str(len(data))
        wire = _head(f"{method} {target} HTTP/1.1", head) + data
        start = time.monotonic()
        deadline = None if timeout.total is None else start + timeout.total
        connect = min([t for t in (timeout.connect, timeout.total)
                       if t is not None], default=None)
        while True:
            idle = self._idle.get(key)
            reused = bool(idle)
            conn = idle.pop() if idle else await self._connect(key, connect)
            try:
                conn.writer.write(wire)
                await conn.writer.drain()
                read = conn.reader.readuntil(b"\r\n\r\n")
                left = None if deadline is None else \
                    max(0.0, deadline - time.monotonic())
                raw = await (asyncio.wait_for(read, left)
                             if left is not None else read)
            except (asyncio.IncompleteReadError, ConnectionError) as e:
                conn.close()
                partial = getattr(e, "partial", b"")
                if reused and not partial:
                    continue  # the upstream closed it while idle
                raise ClientConnectionError(
                    f"Server disconnected: {e!r}") from None
            except BaseException:
                conn.close()
                raise
            lines = raw[:-4].split(b"\r\n")
            try:
                status = int(lines[0].split(b" ", 2)[1])
            except (IndexError, ValueError):
                conn.close()
                raise ClientPayloadError(
                    f"bad status line {lines[0][:80]!r}") from None
            return ClientResponse(self, conn, status,
                                  _parse_headers(lines[1:]), method,
                                  deadline, timeout.sock_read)

    async def post(self, url: str, **kw: Any) -> ClientResponse:
        return await self.request("POST", url, **kw)

    async def get(self, url: str, **kw: Any) -> ClientResponse:
        return await self.request("GET", url, **kw)

    async def delete(self, url: str, **kw: Any) -> ClientResponse:
        return await self.request("DELETE", url, **kw)

    def close(self) -> None:
        self.closed = True
        for conns in self._idle.values():
            for c in conns:
                c.close()
        self._idle.clear()
