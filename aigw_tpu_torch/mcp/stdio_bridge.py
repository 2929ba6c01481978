"""Claude-Desktop-style ``mcpServers`` config + stdio→HTTP bridging (the
port's copy of ``aigw_tpu/mcp/stdio_bridge.py``, on the standard-library
HTTP of ``gateway/http.py`` instead of aiohttp).

``python -m aigw_tpu_torch run --mcp-config`` accepts the canonical MCP
client configuration (the JSON format Claude Desktop / Cursor / VS Code
use), including **stdio** servers (``command`` + ``args``): it spawns
each process and fronts it with a Streamable-HTTP endpoint, then routes
the MCP proxy at the bridged URL (the reference's
``cmd/aigw/stdio2http.go:proxyStdioMCPServers``):

- :func:`parse_mcp_servers` — canonical JSON → (http backend entries,
  stdio specs)
- :class:`StdioMCPBridge` — one child process whose newline-delimited
  JSON-RPC stdio transport is exposed as a local Streamable-HTTP
  endpoint: POST requests correlate on ``id``; notifications return
  202; a GET stream relays server-initiated messages as SSE (the
  reverse direction the MCP proxy already consumes). The child's stderr
  is drained so its pipe never fills, and ``stop`` reaps it.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
from dataclasses import dataclass, field
from typing import Any

from aigw_tpu_torch.gateway.http import (
    HTTPServer,
    Request,
    Response,
    StreamResponse,
)

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class StdioServerSpec:
    name: str
    command: str
    args: tuple[str, ...] = ()
    env: tuple[tuple[str, str], ...] = ()
    include_tools: tuple[str, ...] = ()


def parse_mcp_servers(
    text: str,
) -> tuple[list[dict[str, Any]], list[StdioServerSpec]]:
    """Canonical ``{"mcpServers": {...}}`` JSON → (native MCP backend
    dicts for http/streamable-http/sse servers, stdio specs to bridge).
    Raises ValueError on malformed input — a typo'd MCP config must not
    silently serve zero tools."""
    try:
        data = json.loads(text)
    except json.JSONDecodeError as e:
        raise ValueError(f"invalid MCP config JSON: {e}") from None
    servers = data.get("mcpServers")
    if not isinstance(servers, dict):
        raise ValueError('MCP config must carry an "mcpServers" object')
    backends: list[dict[str, Any]] = []
    stdio: list[StdioServerSpec] = []
    for name, entry in servers.items():
        if not isinstance(entry, dict):
            raise ValueError(f"mcpServers.{name}: must be an object")
        command = entry.get("command")
        if command:
            stdio.append(StdioServerSpec(
                name=name,
                command=str(command),
                args=tuple(str(a) for a in entry.get("args") or ()),
                env=tuple((str(k), str(v)) for k, v in
                          (entry.get("env") or {}).items()),
                include_tools=tuple(entry.get("includeTools") or ()),
            ))
            continue
        url = entry.get("url")
        if not url:
            raise ValueError(
                f"mcpServers.{name}: needs url (http) or command (stdio)")
        backend: dict[str, Any] = {"name": name, "url": str(url)}
        headers = entry.get("headers") or {}
        if headers:
            backend["headers"] = [
                {"name": str(k), "value": str(v)}
                for k, v in headers.items()
            ]
        include = entry.get("includeTools") or ()
        if include:
            backend["tool_filter"] = {
                "include": [str(t) for t in include]}
        backends.append(backend)
    return backends, stdio


#: per-subscriber fan-out buffer depth: a GET stream that stops reading
#: must not grow an unbounded queue inside the gateway — beyond this it
#: is dropped (it can reconnect; SSE ids make the gap visible)
_STREAM_QUEUE_MAX = 256


@dataclass
class _GetStream:
    queue: "asyncio.Queue[bytes]" = field(
        default_factory=lambda: asyncio.Queue(maxsize=_STREAM_QUEUE_MAX))
    dropped: bool = False


def _json(payload: Any, status: int = 200,
          headers: dict[str, str] | None = None) -> Response:
    return Response(status, json.dumps(payload).encode(),
                    "application/json; charset=utf-8", headers)


class StdioMCPBridge:
    """One stdio MCP child ⟷ local Streamable-HTTP endpoint."""

    def __init__(self, spec: StdioServerSpec,
                 request_timeout: float = 60.0):
        self.spec = spec
        self.request_timeout = request_timeout
        self.url = ""
        self._proc: asyncio.subprocess.Process | None = None
        self._http: HTTPServer | None = None
        # internal id → (original client id, future): client ids are
        # rewritten before reaching the child, so concurrent sessions
        # with colliding ids can't clobber each other's futures (and
        # the child never sees duplicate JSON-RPC ids from us)
        self._pending: dict[str, tuple[Any, asyncio.Future]] = {}
        self._next_id = 0
        self._streams: list[_GetStream] = []
        self._reader_task: asyncio.Task | None = None
        self._stderr_task: asyncio.Task | None = None
        self._event_seq = 0
        self._write_lock = asyncio.Lock()

    async def start(self) -> str:
        env = dict(os.environ)
        env.update(dict(self.spec.env))
        self._proc = await asyncio.create_subprocess_exec(
            self.spec.command, *self.spec.args,
            stdin=asyncio.subprocess.PIPE,
            stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.PIPE,
            env=env,
        )
        self._reader_task = asyncio.create_task(self._read_loop())
        self._stderr_task = asyncio.create_task(self._stderr_loop())
        self._http = HTTPServer({
            ("POST", "/mcp"): self._post,
            ("GET", "/mcp"): self._get,
            ("DELETE", "/mcp"): self._delete,
        })
        port = await self._http.start("127.0.0.1", 0)
        self.url = f"http://127.0.0.1:{port}/mcp"
        logger.info("stdio MCP server %r (%s) bridged at %s",
                    self.spec.name, self.spec.command, self.url)
        return self.url

    async def stop(self) -> None:
        """Stop the endpoint and reap the child (SIGTERM, then SIGKILL
        after 5 s); safe on a half-started bridge and when called
        twice."""
        for task in (self._reader_task, self._stderr_task):
            if task is not None:
                task.cancel()
        if self._proc is not None and self._proc.returncode is None:
            self._proc.terminate()
            try:
                await asyncio.wait_for(self._proc.wait(), timeout=5)
            except asyncio.TimeoutError:
                self._proc.kill()
                await self._proc.wait()
        if self._http is not None:
            await self._http.stop()
            self._http = None

    # -- child I/O --------------------------------------------------------
    async def _read_loop(self) -> None:
        assert self._proc and self._proc.stdout
        while True:
            line = await self._proc.stdout.readline()
            if not line:
                # child exited: fail every pending request loudly
                for _orig, fut in self._pending.values():
                    if not fut.done():
                        fut.set_exception(
                            ConnectionError("stdio MCP server exited"))
                self._pending.clear()
                return
            line = line.strip()
            if not line:
                continue
            try:
                msg = json.loads(line)
            except json.JSONDecodeError:
                logger.warning("stdio MCP %s: non-JSON line %r",
                               self.spec.name, line[:200])
                continue
            mid = msg.get("id") if isinstance(msg, dict) else None
            is_reply = (isinstance(msg, dict) and "method" not in msg
                        and ("result" in msg or "error" in msg))
            if is_reply and mid in self._pending:
                orig_id, fut = self._pending.pop(mid)
                if not fut.done():
                    fut.set_result(dict(msg, id=orig_id))
                continue
            # server-initiated request/notification (the child's OWN id
            # space — it must never pop our pending map) → subscribers
            self._event_seq += 1
            data = (f"id: {self._event_seq}\n"
                    f"data: {json.dumps(msg)}\n\n").encode()
            for s in list(self._streams):
                try:
                    s.queue.put_nowait(data)
                except asyncio.QueueFull:
                    # subscriber fell behind: drop IT, not the bridge —
                    # its handler notices on its next wake-up
                    s.dropped = True
                    if s in self._streams:
                        self._streams.remove(s)
                    logger.warning(
                        "stdio MCP %s: dropping slow GET subscriber "
                        "(%d events buffered)", self.spec.name,
                        s.queue.qsize())

    async def _stderr_loop(self) -> None:
        assert self._proc and self._proc.stderr
        while True:
            line = await self._proc.stderr.readline()
            if not line:
                return
            logger.debug("stdio MCP %s stderr: %s", self.spec.name,
                         line.decode(errors="replace").rstrip())

    async def _send(self, msg: dict[str, Any]) -> None:
        assert self._proc and self._proc.stdin
        async with self._write_lock:
            self._proc.stdin.write(json.dumps(msg).encode() + b"\n")
            await self._proc.stdin.drain()

    # -- HTTP surface -----------------------------------------------------
    async def _post(self, request: Request) -> Response:
        try:
            msg = json.loads(request.body)
        except json.JSONDecodeError:
            return _json(
                {"jsonrpc": "2.0", "id": None,
                 "error": {"code": -32700, "message": "parse error"}},
                status=400)
        if self._proc is None or self._proc.returncode is not None:
            return _json(
                {"jsonrpc": "2.0", "id": msg.get("id"),
                 "error": {"code": -32000,
                           "message": "stdio MCP server not running"}},
                status=502)
        mid = msg.get("id") if isinstance(msg, dict) else None
        is_request = isinstance(msg, dict) and "method" in msg
        if mid is None or not is_request:
            # notification, or the CLIENT's response to a server-
            # initiated request (id but no method — its id lives in the
            # child's id space): forward verbatim, nothing to await
            # (Streamable HTTP: 202)
            await self._send(msg)
            return Response(202, b"", "application/octet-stream")
        # rewrite the id: concurrent sessions may reuse ids freely
        self._next_id += 1
        internal = f"aigwb{self._next_id}"
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[internal] = (mid, fut)
        await self._send(dict(msg, id=internal))
        try:
            reply = await asyncio.wait_for(fut, self.request_timeout)
        except asyncio.TimeoutError:
            self._pending.pop(internal, None)
            return _json(
                {"jsonrpc": "2.0", "id": mid,
                 "error": {"code": -32000,
                           "message": "stdio MCP server timed out"}},
                status=504)
        except ConnectionError as e:
            return _json(
                {"jsonrpc": "2.0", "id": mid,
                 "error": {"code": -32000, "message": str(e)}},
                status=502)
        headers = {}
        if msg.get("method") == "initialize":
            # Streamable HTTP servers assign sessions via this header;
            # a stdio child is one session by nature, but the MCP proxy
            # (and other clients) skip backends that never presented one
            headers["mcp-session-id"] = f"stdio-{self.spec.name}"
        return _json(reply, headers=headers)

    async def _delete(self, _request: Request) -> Response:
        # session teardown: the child IS the session; nothing to drop
        return Response(200, b"", "application/octet-stream")

    async def _get(self, request: Request) -> StreamResponse:
        resp = StreamResponse(200, {"content-type": "text/event-stream",
                                    "cache-control": "no-cache"})
        await resp.prepare(request)
        stream = _GetStream()
        self._streams.append(stream)
        gone = asyncio.ensure_future(request.disconnected())
        try:
            while not stream.dropped:
                getter = asyncio.ensure_future(stream.queue.get())
                done, _ = await asyncio.wait(
                    {getter, gone}, timeout=15.0,
                    return_when=asyncio.FIRST_COMPLETED)
                if getter not in done:
                    getter.cancel()
                if gone in done:
                    break  # the subscriber closed its connection
                if getter in done:
                    await resp.write(getter.result())
                else:
                    await resp.write(b": ping\n\n")
        except ConnectionError:
            pass
        finally:
            gone.cancel()
            if stream in self._streams:
                self._streams.remove(stream)
        return resp


async def start_bridges(
    specs: list[StdioServerSpec],
) -> tuple[list[dict[str, Any]], list[StdioMCPBridge]]:
    """Spawn + bridge every stdio server; returns (native MCP backend
    dicts pointing at the bridges, the bridges for shutdown)."""
    backends: list[dict[str, Any]] = []
    bridges: list[StdioMCPBridge] = []
    for spec in specs:
        bridge = StdioMCPBridge(spec)
        try:
            url = await bridge.start()
        except Exception as e:  # noqa: BLE001 (re-raised as ValueError)
            # spawn failures (a bad command) and failures after the
            # spawn alike: the failing bridge's child and its siblings
            # are stopped, so nothing is orphaned
            for b in (*bridges, bridge):
                try:
                    await b.stop()
                except Exception:  # noqa: BLE001 (keep the cause)
                    logger.exception("stopping bridge %r after start "
                                     "failure", b.spec.name)
            raise ValueError(
                f"mcpServers.{spec.name}: cannot start "
                f"{spec.command!r}: {e}") from None
        bridges.append(bridge)
        backend: dict[str, Any] = {"name": spec.name, "url": url}
        if spec.include_tools:
            backend["tool_filter"] = {
                "include": list(spec.include_tools)}
        backends.append(backend)
    return backends, bridges
