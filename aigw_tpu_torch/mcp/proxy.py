"""MCP proxy core: JSON-RPC demux, session multiplexing and tool routing
(the port's copy of ``aigw_tpu/mcp/proxy.py``, on the standard-library
HTTP of ``gateway/http.py`` instead of aiohttp).

Parity with the reference (internal/mcpproxy/mcpproxy.go:59,
handlers.go:326-460):

- ``initialize``     — fan-out to every backend, compose the encrypted
  client session from per-backend session IDs
- ``tools/list``     — aggregate + filter, names prefixed ``backend__tool``
  (collision-free routing key, like the reference's tool→backend map)
- ``tools/call``     — strip the prefix, route to the owning backend with
  its own session ID; a backend's SSE reply is relayed with proxy event
  ids
- ``prompts/list`` / ``resources/list`` / ``resources/templates/list`` —
  aggregated (prefixing names; URIs stay globally unique and unprefixed)
- ``resources/subscribe`` / ``unsubscribe`` — routed by URI ownership
- ``ping`` / ``notifications/*`` — handled locally / broadcast
- Reverse direction (reference handlers.go:983-1100): server→client
  requests (``roots/list``, ``sampling/createMessage``,
  ``elicitation/create``) arriving on a backend stream get their ``id``
  rewritten to a routable composite; the client's JSON-RPC *response*
  POSTed back is decoded and forwarded to the owning backend. Server-
  issued ``_meta.progressToken`` values are rewritten the same way so
  client ``notifications/progress`` route back to the issuing backend.
- GET listening stream: fans out GET streams to every backend in the
  session and relays their server-initiated traffic with proxy event
  ids, heartbeats, and gateway tool-change notifications; the client's
  close cancels the backend streams and closes their connections.
  With ``Last-Event-Id`` it replays the session's buffered events
  (``mcp/replay.py``) instead.
- ``DELETE`` tears the session down on every backend;
  ``/.well-known/oauth-protected-resource`` serves the RFC 9728
  metadata while authorization is on (404 otherwise).
- Streamable-HTTP: accepts JSON responses and single-event SSE replies
  from backends (spec 2025-06-18).

``MCPProxy.routes()`` gives the gateway its handlers; ``update_config``
hot-swaps backends, filters, seeds, authorization and the replay store.
"""

from __future__ import annotations

import asyncio
import base64
import fnmatch
import json
import logging
import os
import re
import secrets
import time
from dataclasses import dataclass
from typing import Any

from aigw_tpu_torch.gateway.http import (
    ClientError,
    HTTPClient,
    Request,
    Response,
    StreamResponse,
    Timeout,
)
from aigw_tpu_torch.mcp.crypto import SessionCrypto, SessionCryptoError

logger = logging.getLogger(__name__)

PROTOCOL_VERSION = "2025-06-18"
SESSION_HEADER = "mcp-session-id"
TOOL_SEP = "__"

# Server→client request ids and server-issued progress tokens are rewritten
# to carry the owning backend so the client's reply can be routed back
# (the original value JSON-encoded, which preserves the int/str
# distinction).
S2C_ID_PREFIX = "aigw-s2c."
PROGRESS_TOKEN_PREFIX = "aigw-pt."
# Gateway-initiated pings on the listening stream; client responses to
# these ids are swallowed (reference doNotForwardResponseToBackends).
PING_ID_PREFIX = "aigw-ping-"
# Server→client request methods that expect a client response routed back.
# ``ping`` is included so a backend-initiated ping's pong finds its way
# home (and int ids from different backends can't collide at the client).
S2C_REQUEST_METHODS = (
    "roots/list",
    "sampling/createMessage",
    "elicitation/create",
    "ping",
)

#: the backend client's limit on one request, body included
_BACKEND_TIMEOUT = Timeout(total=60.0)


def _encode_routed(prefix: str, value: Any, backend: str) -> str:
    enc = (
        base64.urlsafe_b64encode(json.dumps(value).encode())
        .decode()
        .rstrip("=")
    )
    return f"{prefix}{enc}.{backend}"


def _decode_routed(prefix: str, s: Any) -> tuple[Any, str] | None:
    """Inverse of _encode_routed; None when ``s`` is not a routed value."""
    if not isinstance(s, str) or not s.startswith(prefix):
        return None
    enc, sep, backend = s[len(prefix):].partition(".")
    if not sep or not backend:
        return None
    try:
        value = json.loads(
            base64.urlsafe_b64decode(enc + "=" * (-len(enc) % 4))
        )
    except (ValueError, json.JSONDecodeError):
        return None
    return value, backend


@dataclass(frozen=True)
class MCPBackend:
    name: str
    url: str  # full MCP endpoint, e.g. http://host:port/mcp
    include_tools: tuple[str, ...] = ()  # glob patterns; empty = all
    exclude_tools: tuple[str, ...] = ()
    # regex patterns (reference MCPToolFilter includeRegex) — a tool is
    # included when it matches any glob OR any regex
    include_tools_regex: tuple[str, ...] = ()
    headers: tuple[tuple[str, str], ...] = ()

    def allows(self, tool: str) -> bool:
        if self.include_tools or self.include_tools_regex:
            globbed = any(
                fnmatch.fnmatch(tool, p) for p in self.include_tools)
            rex = any(
                re.fullmatch(p, tool) for p in self.include_tools_regex)
            if not globbed and not rex:
                return False
        return not any(fnmatch.fnmatch(tool, p) for p in self.exclude_tools)


@dataclass(frozen=True)
class MCPConfig:
    backends: tuple[MCPBackend, ...]
    path: str = "/mcp"
    # No constant default: an unset seed becomes a random per-process one
    # (sessions then don't survive restarts/replicas — set it explicitly
    # in production, as the reference requires via flags).
    session_seed: str = ""
    session_fallback_seed: str = ""
    # Shared spool directory for Last-Event-Id replay buffers: set to a
    # volume every gateway process mounts and stream resumption survives
    # reconnecting to a different one (mcp/replay.py FileReplayStore).
    # Empty = in-memory, process-local.
    replay_dir: str = ""

    # parsed MCPAuthzConfig | None
    authorization: Any = None

    @staticmethod
    def parse(value: dict[str, Any]) -> "MCPConfig":
        backends = tuple(
            MCPBackend(
                name=b["name"],
                url=b["url"],
                include_tools=tuple(
                    (b.get("tool_filter") or {}).get("include", ())
                ),
                exclude_tools=tuple(
                    (b.get("tool_filter") or {}).get("exclude", ())
                ),
                include_tools_regex=tuple(
                    (b.get("tool_filter") or {}).get("include_regex", ())
                ),
                headers=tuple(
                    (str(h["name"]).lower(), str(h["value"]))
                    for h in b.get("headers", ())
                ),
            )
            for b in value.get("backends", ())
        )
        from aigw_tpu_torch.mcp.authz import MCPAuthzConfig

        return MCPConfig(
            backends=backends,
            path=value.get("path", "/mcp"),
            # unset stays "" — MCPProxy generates a per-process random seed
            # once, so config hot-reloads don't invalidate live sessions
            session_seed=value.get("session_seed", ""),
            session_fallback_seed=value.get("session_fallback_seed", ""),
            replay_dir=value.get("replay_dir", ""),
            authorization=MCPAuthzConfig.parse(
                value.get("authorization")
            ),
        )


class _ReplayHandle:
    """Stream-lifetime view of a session's replay buffer.

    Re-resolves the underlying buffer whenever the proxy's store object
    changes (a config hot-reload swapping ``replay_dir``), and pushes the
    store's blocking file I/O off the event loop."""

    def __init__(self, proxy: "MCPProxy", token: str):
        self._proxy = proxy
        self._token = token
        self._store: Any = None
        self._buf: Any = None

    def _resolve(self):
        store = self._proxy._replay_store
        if store is not self._store:
            self._store = store
            self._buf = store.buffer(self._token)
        return self._buf

    async def append(self, encode) -> bytes:
        buf = self._resolve()
        if not self._store.blocking:
            # in-memory: inline on the loop (the loop is the only writer)
            return buf.append(encode)
        return await asyncio.to_thread(buf.append, encode)

    async def events_after(self, last_id: int) -> list[bytes]:
        buf = self._resolve()
        if not self._store.blocking:
            return buf.events_after(last_id)
        return await asyncio.to_thread(buf.events_after, last_id)


def _rpc_error(id_: Any, code: int, message: str) -> dict[str, Any]:
    return {"jsonrpc": "2.0", "id": id_,
            "error": {"code": code, "message": message}}


def _json(payload: Any, status: int = 200,
          headers: dict[str, str] | None = None) -> Response:
    return Response(status, json.dumps(payload).encode(),
                    "application/json; charset=utf-8", headers)


def _empty(status: int) -> Response:
    return Response(status, b"", "application/octet-stream")


def _sse_response() -> StreamResponse:
    return StreamResponse(200, {"content-type": "text/event-stream",
                                "cache-control": "no-cache"})


def _metric_error_type(status: int) -> str:
    """HTTP status → MCP error-type attribute (reference
    metrics.MCPErrorType values)."""
    return {
        400: "invalid_param",
        401: "unauthorized",
        403: "unauthorized",
        404: "invalid_session_id",
        413: "internal_error",
    }.get(status, "internal_error")


def _rpc_error_type(code: Any) -> str:
    """JSON-RPC error code → MCP error-type attribute (reference
    handlers.go errorType)."""
    return {
        -32601: "unsupported_method",
        -32602: "invalid_param",
        -32700: "invalid_json_rpc",
        -32600: "invalid_json_rpc",
        -32603: "internal_error",
        -32000: "invalid_session_id",
        -32001: "unauthorized",
    }.get(code, "internal_error")


class MCPProxy:
    def __init__(self, cfg: MCPConfig, metrics: Any = None):
        #: obs.metrics.MCPMetrics | None — method counts, durations,
        #: init/capability/progress instruments
        self.metrics = metrics
        self.cfg = cfg
        seed = cfg.session_seed
        if not seed:
            # AIGW_MCP_SESSION_SEED: a process-group seed, so gateway
            # processes sharing a port decrypt each other's tokens
            seed = os.environ.get("AIGW_MCP_SESSION_SEED", "")
        if not seed:
            seed = secrets.token_hex(32)
            if cfg.backends:
                logger.warning(
                    "mcp.session_seed not configured — using a random "
                    "per-process seed; sessions will not survive restarts "
                    "or span replicas"
                )
        self._seed = seed
        self._crypto = SessionCrypto(seed, cfg.session_fallback_seed)
        self._client = HTTPClient()
        self._authz = None
        if cfg.authorization is not None:
            from aigw_tpu_torch.mcp.authz import JWTValidator

            self._authz = JWTValidator(cfg.authorization)
        # listening GET streams to wake when the tool topology changes
        self._tool_change_listeners: set[asyncio.Event] = set()
        self._ping_seq = 0
        # bounded per-session replay buffers for Last-Event-Id resumption:
        # in-memory (process-local) by default, or a shared spool
        # directory when cfg.replay_dir is set (mcp/replay.py)
        from aigw_tpu_torch.mcp.replay import make_store

        self._replay_store = make_store(cfg.replay_dir)

    def routes(self) -> dict[tuple[str, str], Any]:
        """The proxy's handlers for the gateway's route table. The
        metadata route is always present so a hot reload can turn
        authorization on; it answers 404 while it is off."""
        return {
            ("POST", self.cfg.path): self.handle,
            ("GET", self.cfg.path): self.handle_get,
            ("DELETE", self.cfg.path): self.handle_delete,
            ("GET", "/.well-known/oauth-protected-resource"):
                self._protected_resource_metadata,
        }

    def close(self) -> None:
        """Close the backend connections' pool."""
        self._client.close()

    def update_config(self, cfg: MCPConfig) -> None:
        """Hot-swap backends/filters/authz. The HTTP path is fixed at
        registration time; live sessions survive unless the seed changes.
        Listening GET streams are woken with a tools/list_changed
        notification when the backend topology differs."""
        old = self.cfg
        self.cfg = cfg
        seed_changed = cfg.session_seed and cfg.session_seed != self._seed
        if (seed_changed
                or cfg.session_fallback_seed != old.session_fallback_seed):
            if seed_changed:
                self._seed = cfg.session_seed
            self._crypto = SessionCrypto(
                self._seed, cfg.session_fallback_seed
            )
        self._authz = None
        if cfg.authorization is not None:
            from aigw_tpu_torch.mcp.authz import JWTValidator

            self._authz = JWTValidator(cfg.authorization)
        if old.replay_dir != cfg.replay_dir:
            from aigw_tpu_torch.mcp.replay import make_store

            self._replay_store = make_store(cfg.replay_dir)
        if old.backends != cfg.backends:
            for ev in self._tool_change_listeners:
                ev.set()

    async def _protected_resource_metadata(self, _request: Request
                                           ) -> Response:
        """RFC 9728 protected-resource metadata (reference
        MCPRouteOAuth)."""
        if self._authz is None:
            return _empty(404)
        cfg = self.cfg.authorization
        return _json({
            "resource": cfg.resource or self.cfg.path,
            "authorization_servers": list(cfg.authorization_servers),
            "bearer_methods_supported": ["header"],
        })

    def _authenticate(self, request: Request) -> dict[str, Any] | None:
        """Returns verified claims, or None when authz is disabled."""
        if self._authz is None:
            return None
        from aigw_tpu_torch.mcp.authz import AuthzError

        auth = request.headers.get("authorization", "")
        if not auth.lower().startswith("bearer "):
            raise AuthzError("missing bearer token")
        return self._authz.validate(auth[7:])

    # -- backend I/O ------------------------------------------------------
    async def _post_backend(self, backend: MCPBackend, payload: Any,
                            session_id: str):
        headers = {
            "content-type": "application/json",
            "accept": "application/json, text/event-stream",
            "mcp-protocol-version": PROTOCOL_VERSION,
        }
        headers.update(dict(backend.headers))
        if session_id:
            headers[SESSION_HEADER] = session_id
        return await self._client.post(
            backend.url, data=json.dumps(payload).encode(),
            headers=headers, timeout=_BACKEND_TIMEOUT)

    async def _call_backend(
        self,
        backend: MCPBackend,
        payload: dict[str, Any],
        session_id: str = "",
    ) -> tuple[dict[str, Any] | None, str]:
        """POST one JSON-RPC message; returns (response-or-None, session id).

        Accepts direct JSON or a single-response SSE stream (both allowed
        by streamable HTTP)."""
        async with await self._post_backend(backend, payload,
                                            session_id) as resp:
            new_session = resp.headers.get(SESSION_HEADER, session_id)
            ctype = resp.headers.get("content-type", "")
            raw = await resp.read()
            if resp.status == 202:
                return None, new_session
            if resp.status >= 400:
                raise RuntimeError(
                    f"backend {backend.name} returned {resp.status}: "
                    f"{raw[:200]!r}"
                )
            if "text/event-stream" in ctype:
                from aigw_tpu_torch.translate.sse import SSEParser

                for ev in SSEParser().feed(raw) or []:
                    if not ev.data:
                        continue
                    msg = json.loads(ev.data)
                    if "result" in msg or "error" in msg:
                        return msg, new_session
                return None, new_session
            return (json.loads(raw) if raw else None), new_session

    def _replay_buffer(self, session_token: str):
        """Per-session replay handle with a shared id allocator (ids stay
        unique across concurrent streams on the session, and across
        gateways when the store is file-backed); None without a session
        token."""
        if not session_token:
            return None
        return _ReplayHandle(self, session_token)

    async def handle_get(self, request: Request) -> "Response | StreamResponse":
        """GET /mcp with Last-Event-Id: replay buffered stream events
        after the given id (streamable-HTTP resumption), then close so the
        client re-opens a fresh listening stream. Without the header this
        is the listening stream: a GET stream is opened to every backend
        in the session and their server-initiated traffic is relayed with
        proxy event ids, periodic heartbeat pings, and a
        ``notifications/tools/list_changed`` event when a config reload
        changes the backend topology. Backends that answer GET with 405
        (POST-only servers) are skipped; with zero live backend streams
        the response completes empty."""
        from aigw_tpu_torch.mcp.authz import AuthzError

        token = request.headers.get(SESSION_HEADER, "")
        if not token:
            return _empty(405)
        try:
            self._authenticate(request)
        except AuthzError as e:
            return _empty(e.status)
        try:
            sessions = self._decode_session(token)
        except SessionCryptoError:
            return _empty(404)
        last_header = request.headers.get("last-event-id", "")
        resp = _sse_response()
        await resp.prepare(request)
        if last_header:
            try:
                last = int(last_header)
            except ValueError:
                last = 0
            buf = self._replay_buffer(token)
            if buf is not None:
                for encoded in await buf.events_after(last):
                    await resp.write(encoded)
            await resp.write_eof()
            return resp
        await self._listen_streams(request, resp, token, sessions)
        return resp

    async def _listen_streams(
        self,
        request: Request,
        resp: StreamResponse,
        token: str,
        sessions: dict[str, str],
    ) -> None:
        from aigw_tpu_torch.translate.sse import SSEEvent, SSEParser

        queue: asyncio.Queue = asyncio.Queue()

        async def open_stream(b: MCPBackend):
            headers = {
                "accept": "text/event-stream",
                "mcp-protocol-version": PROTOCOL_VERSION,
                SESSION_HEADER: sessions[b.name],
                **dict(b.headers),
            }
            try:
                r = await self._client.get(
                    b.url, headers=headers, timeout=Timeout(connect=10.0))
            except ClientError as e:
                logger.debug("mcp GET stream to %s failed: %s", b.name, e)
                return None
            if (r.status != 200
                    or "text/event-stream"
                    not in r.headers.get("content-type", "")):
                r.release()
                return None
            return b, r

        opened = await asyncio.gather(
            *(open_stream(b) for b in self.cfg.backends
              if sessions.get(b.name))
        )
        streams = [s for s in opened if s is not None]
        if not streams:
            await resp.write_eof()
            return

        async def pump(b: MCPBackend, r) -> None:
            parser = SSEParser()
            try:
                async for chunk in r.iter_any():
                    for ev in parser.feed(chunk):
                        await queue.put((b.name, ev))
                for ev in parser.flush():
                    await queue.put((b.name, ev))
            except ClientError:
                pass
            finally:
                # an unfinished body closes its connection, so a stream
                # cut by the client's close never goes back to the pool
                r.close()
                await queue.put(None)  # stream-ended sentinel

        pumps = [asyncio.ensure_future(pump(b, r)) for b, r in streams]
        change = asyncio.Event()
        self._tool_change_listeners.add(change)
        buf = self._replay_buffer(token)

        async def write_event(
            ev, backend_name: str | None = None, replayable: bool = True
        ) -> None:
            await resp.write(
                await self._prepare_relay_event(ev, backend_name, buf,
                                                replayable=replayable)
            )

        def ping_event():
            self._ping_seq += 1
            return SSEEvent(
                event="message",
                data=json.dumps({
                    "jsonrpc": "2.0",
                    "id": f"{PING_ID_PREFIX}{self._ping_seq}",
                    "method": "ping",
                }),
            )

        try:
            heartbeat = float(
                os.environ.get("MCP_PROXY_HEARTBEAT_INTERVAL", "60") or 0
            )
        except ValueError:
            heartbeat = 60.0
        live = len(pumps)
        getter: asyncio.Task | None = None
        changed: asyncio.Task | None = None
        gone = asyncio.ensure_future(request.disconnected())
        try:
            # eager heartbeat: some clients block on the first event
            await write_event(ping_event(), replayable=False)
            while live > 0:
                if getter is None:
                    getter = asyncio.ensure_future(queue.get())
                if changed is None:
                    changed = asyncio.ensure_future(change.wait())
                done, _ = await asyncio.wait(
                    {getter, changed, gone},
                    timeout=heartbeat if heartbeat > 0 else None,
                    return_when=asyncio.FIRST_COMPLETED,
                )
                if gone in done:
                    break  # the client closed: stop the backend streams
                if changed in done:
                    change.clear()
                    changed = None
                    await write_event(SSEEvent(
                        event="message",
                        data=json.dumps({
                            "jsonrpc": "2.0",
                            "method":
                                "notifications/tools/list_changed",
                        }),
                    ))
                if getter in done:
                    item = getter.result()
                    getter = None
                    if item is None:
                        live -= 1
                        continue
                    backend_name, ev = item
                    await write_event(ev, backend_name=backend_name)
                elif not done:
                    await write_event(ping_event(),
                                      replayable=False)  # heartbeat
        except (ConnectionError, ClientError, asyncio.CancelledError):
            pass  # client went away
        finally:
            self._tool_change_listeners.discard(change)
            for t in (getter, changed, gone, *pumps):
                if t is not None:
                    t.cancel()
            await asyncio.gather(*pumps, return_exceptions=True)
        try:
            await resp.write_eof()
        except ConnectionError:
            pass

    # -- session composition ---------------------------------------------
    def _encode_session(self, sessions: dict[str, str]) -> str:
        return self._crypto.encrypt(json.dumps(sessions).encode())

    def _decode_session(self, token: str) -> dict[str, str]:
        return json.loads(self._crypto.decrypt(token))

    # -- HTTP entry -------------------------------------------------------
    async def handle(self, request: Request) -> "Response | StreamResponse":
        t0 = time.monotonic()
        resp, method = await self._handle_post(request)
        if self.metrics is None:
            return resp
        method = method or "unknown"
        # errors surface two ways: HTTP-level (4xx/5xx) and JSON-RPC
        # error envelopes riding HTTP 200 (unknown tool, backend
        # failure, internal error) — both count as errors
        status = "success"
        err_type = ""
        if resp.status >= 400:
            status = "error"
            err_type = _metric_error_type(resp.status)
        else:
            body = getattr(resp, "body", None)
            if isinstance(body, (bytes, bytearray)) and b'"error"' in body:
                try:
                    parsed = json.loads(body)
                except ValueError:
                    parsed = None
                if isinstance(parsed, dict) and parsed.get("error"):
                    status = "error"
                    err_type = _rpc_error_type(
                        (parsed["error"] or {}).get("code"))
        self.metrics.method_total.labels(method, "", status).inc()
        self.metrics.request_duration.observe(
            (method,), time.monotonic() - t0)
        if status == "error":
            self.metrics.errors_total.labels(method, err_type).inc()
        return resp

    async def _handle_post(
        self, request: Request
    ) -> "tuple[Response | StreamResponse, str]":
        """(the reply, the method the metrics count it under: a client
        response to a server request counts as ``response``)."""
        try:
            payload = json.loads(request.body)
        except json.JSONDecodeError:
            return _json(_rpc_error(None, -32700, "parse error"),
                         400), ""
        if isinstance(payload, list):
            return _json(_rpc_error(None, -32600,
                                    "batching not supported"), 400), ""
        method = payload.get("method", "")
        counted = method or ("response" if "id" in payload else "")
        msg_id = payload.get("id")
        is_notification = msg_id is None

        from aigw_tpu_torch.mcp.authz import AuthzError

        try:
            claims = self._authenticate(request)
        except AuthzError as e:
            headers = None
            if e.status == 401:
                headers = {"www-authenticate": (
                    'Bearer resource_metadata='
                    '"/.well-known/oauth-protected-resource"')}
            return _json(_rpc_error(msg_id, -32001, str(e)), e.status,
                         headers), counted

        try:
            return await self._dispatch(request, payload, method, msg_id,
                                         is_notification, claims), counted
        except Exception as e:  # noqa: BLE001 (the client's -32603)
            logger.exception("mcp request failed")
            return _json(_rpc_error(msg_id, -32603,
                                    f"internal error: {e}")), counted

    async def _dispatch(self, request, payload, method, msg_id,
                        is_notification, claims):
        from aigw_tpu_torch.mcp.authz import AuthzError

        if method == "initialize":
            result, session = await self._initialize(payload)
            return _json(result, headers={SESSION_HEADER: session})

        session_token = request.headers.get(SESSION_HEADER, "")
        try:
            sessions = (
                self._decode_session(session_token)
                if session_token
                else {}
            )
        except SessionCryptoError as e:
            return _json(_rpc_error(msg_id, -32000, str(e)), 404)

        if "method" not in payload:
            # JSON-RPC *response* from the client — the reverse leg of a
            # server→client request (reference handleClientToServerResponse)
            if not session_token:
                return _json(_rpc_error(None, -32600,
                                        "missing session ID"), 400)
            return await self._client_to_server_response(payload, sessions)
        if method == "notifications/initialized":
            # already sent per-backend during the session fan-out
            return _empty(202)
        if method == "notifications/cancelled":
            # broadcast best-effort: request ids are forwarded to
            # backends unmodified, so the owner recognizes its id and
            # aborts; others ignore it
            await self._broadcast(payload, sessions)
            return _empty(202)
        if method == "notifications/progress":
            return await self._route_progress(payload, sessions)
        if is_notification:
            await self._broadcast(payload, sessions)
            return _empty(202)
        if method == "ping":
            return _json({"jsonrpc": "2.0", "id": msg_id, "result": {}})
        if method == "tools/list":
            return _json(await self._tools_list(msg_id, sessions))
        if method == "tools/call":
            if self._authz is not None:
                full = (payload.get("params") or {}).get("name", "")
                try:
                    self._authz.authorize_tool(full, claims or {})
                except AuthzError as e:
                    return _json(_rpc_error(msg_id, -32001, str(e)),
                                 e.status)
            return await self._tools_call_streaming(
                request, payload, sessions)
        if method in ("prompts/list", "resources/list",
                      "resources/templates/list"):
            return _json(await self._aggregate_list(method, msg_id,
                                                    sessions))
        if method in ("prompts/get", "completion/complete"):
            return _json(await self._route_by_name(payload, sessions))
        if method in ("resources/read", "resources/subscribe",
                      "resources/unsubscribe"):
            return _json(await self._route_resource(payload, sessions))
        if method == "logging/setLevel":
            await self._broadcast(payload, sessions)
            return _json({"jsonrpc": "2.0", "id": msg_id, "result": {}})
        return _json(_rpc_error(msg_id, -32601,
                                f"method {method!r} not supported"))

    async def handle_delete(self, request: Request) -> Response:
        """Session teardown: best-effort DELETE to each backend."""
        token = request.headers.get(SESSION_HEADER, "")
        try:
            sessions = self._decode_session(token) if token else {}
        except SessionCryptoError:
            return _empty(404)
        for b in self.cfg.backends:
            sid = sessions.get(b.name)
            if not sid:
                continue
            try:
                # accept */* as the reference's client sends by default
                async with await self._client.delete(
                        b.url, headers={"accept": "*/*", SESSION_HEADER: sid,
                                        **dict(b.headers)},
                        timeout=_BACKEND_TIMEOUT) as r:
                    await r.read()
            except ClientError:
                pass
        return _empty(200)

    # -- methods ----------------------------------------------------------
    async def _initialize(
        self, payload: dict[str, Any]
    ) -> tuple[dict[str, Any], str]:
        t0 = time.monotonic()

        async def init_one(b: MCPBackend):
            try:
                resp, session = await self._call_backend(b, payload)
                # spec: notify initialized after the response
                await self._call_backend(
                    b,
                    {"jsonrpc": "2.0",
                     "method": "notifications/initialized"},
                    session,
                )
                return b.name, session, resp
            except (ClientError, RuntimeError) as e:
                logger.warning("mcp backend %s init failed: %s", b.name, e)
                return b.name, "", None

        results = await asyncio.gather(
            *(init_one(b) for b in self.cfg.backends)
        )
        sessions = {name: sid for name, sid, _ in results if sid}
        if self.metrics is not None:
            self.metrics.initialization_duration.observe(
                (), time.monotonic() - t0)
            client_caps = (payload.get("params") or {}).get(
                "capabilities") or {}
            for cap in client_caps:
                self.metrics.capabilities_negotiated.labels(
                    str(cap), "client").inc()
            for _, _, resp in results:
                server_caps = ((resp or {}).get("result") or {}).get(
                    "capabilities") or {}
                for cap in server_caps:
                    self.metrics.capabilities_negotiated.labels(
                        str(cap), "server").inc()
        # listChanged: the proxy emits notifications/tools/list_changed on
        # config hot-reloads (see update_config)
        caps: dict[str, Any] = {"tools": {"listChanged": True}}
        result = {
            "jsonrpc": "2.0",
            "id": payload.get("id"),
            "result": {
                "protocolVersion": PROTOCOL_VERSION,
                "capabilities": caps,
                "serverInfo": {"name": "aigw-tpu-mcp", "version": "0.1.0"},
            },
        }
        return result, self._encode_session(sessions)

    async def _broadcast(
        self, payload: dict[str, Any], sessions: dict[str, str]
    ) -> None:
        await asyncio.gather(
            *(
                self._call_backend(b, payload, sessions.get(b.name, ""))
                for b in self.cfg.backends
                if sessions.get(b.name)
            ),
            return_exceptions=True,
        )

    async def _tools_list(
        self, msg_id: Any, sessions: dict[str, str]
    ) -> dict[str, Any]:
        async def list_one(b: MCPBackend):
            sid = sessions.get(b.name, "")
            if not sid:
                return []
            try:
                resp, _ = await self._call_backend(
                    b,
                    {"jsonrpc": "2.0", "id": msg_id, "method": "tools/list"},
                    sid,
                )
            except (ClientError, RuntimeError) as e:
                logger.warning("tools/list from %s failed: %s", b.name, e)
                return []
            tools = ((resp or {}).get("result") or {}).get("tools") or []
            out = []
            for t in tools:
                name = t.get("name", "")
                if not b.allows(name):
                    continue
                out.append(dict(t, name=f"{b.name}{TOOL_SEP}{name}"))
            return out

        lists = await asyncio.gather(
            *(list_one(b) for b in self.cfg.backends)
        )
        tools = [t for sub in lists for t in sub]
        return {"jsonrpc": "2.0", "id": msg_id, "result": {"tools": tools}}

    async def _tools_call_streaming(
        self,
        request: Request,
        payload: dict[str, Any],
        sessions: dict[str, str],
    ) -> "Response | StreamResponse":
        """tools/call with streamable-HTTP support: if the backend answers
        with an SSE stream (progress notifications before the result), the
        events are relayed to the client with monotonically increasing
        event ids (the resumption contract of spec 2025-06-18)."""
        msg_id = payload.get("id")
        params = payload.get("params") or {}
        full_name = params.get("name", "")
        backend_name, sep, tool = full_name.partition(TOOL_SEP)
        backend = next(
            (b for b in self.cfg.backends if b.name == backend_name), None
        )
        if not sep or backend is None:
            return _json(_rpc_error(msg_id, -32602,
                                    f"unknown tool {full_name!r}"))
        if not backend.allows(tool):
            return _json(_rpc_error(msg_id, -32602,
                                    f"tool {full_name!r} is not allowed"))
        sid = sessions.get(backend.name, "")
        routed = dict(payload, params=dict(params, name=tool))
        async with await self._post_backend(backend, routed, sid) as resp:
            if self.metrics is not None:
                self.metrics.method_total.labels(
                    "tools/call", backend.name,
                    "success" if resp.status < 400 else "error",
                ).inc()
            ctype = resp.headers.get("content-type", "")
            if resp.status >= 400:
                raw = await resp.read()
                return _json(_rpc_error(
                    msg_id, -32603, f"backend {backend.name} returned "
                                    f"{resp.status}: {raw[:200]!r}"))
            if "text/event-stream" not in ctype:
                raw = await resp.read()
                msg = json.loads(raw) if raw else None
                return _json(msg or _rpc_error(
                    msg_id, -32603, "no response from backend"))
            # relay the stream with our own event ids
            from aigw_tpu_torch.translate.sse import SSEParser

            out = _sse_response()
            await out.prepare(request)
            parser = SSEParser()
            buf = self._replay_buffer(
                request.headers.get(SESSION_HEADER, ""))

            async def relay(ev):
                # server→client requests riding the tools/call stream
                # (elicitation, sampling, roots) need routable ids
                await out.write(
                    await self._prepare_relay_event(ev, backend.name, buf))

            async for chunk in resp.iter_any():
                for ev in parser.feed(chunk):
                    await relay(ev)
            for ev in parser.flush():
                await relay(ev)
            await out.write_eof()
            return out

    async def _route_by_name(
        self, payload: dict[str, Any], sessions: dict[str, str]
    ) -> dict[str, Any]:
        """prompts/get + completion/complete: route by the
        ``backend__name`` prefix (same contract as tools/call)."""
        msg_id = payload.get("id")
        params = payload.get("params") or {}
        # completion/complete nests the name under ref.name; resource-
        # template refs carry ref.uri instead (URIs aren't prefixed —
        # route them like resources/read)
        name = params.get("name", "")
        ref = params.get("ref") or {}
        if not name and isinstance(ref, dict):
            name = ref.get("name", "")
            if not name and ref.get("uri"):
                return await self._route_resource(payload, sessions)
        backend_name, sep, bare = name.partition(TOOL_SEP)
        backend = next(
            (b for b in self.cfg.backends if b.name == backend_name), None
        )
        if not sep or backend is None:
            return _rpc_error(msg_id, -32602, f"unknown name {name!r}")
        routed_params = dict(params)
        if params.get("name"):
            routed_params["name"] = bare
        elif isinstance(ref, dict) and ref.get("name"):
            routed_params["ref"] = dict(ref, name=bare)
        routed = dict(payload, params=routed_params)
        resp, _ = await self._call_backend(
            backend, routed, sessions.get(backend.name, "")
        )
        return resp or _rpc_error(msg_id, -32603, "no response from backend")

    async def _route_resource(
        self, payload: dict[str, Any], sessions: dict[str, str]
    ) -> dict[str, Any]:
        """resources/read + subscribe/unsubscribe: route by URI.
        Aggregated resource listings are not renamed (URIs are globally
        unique), so try each backend that has a session until one answers
        without error."""
        msg_id = payload.get("id")
        first_error: dict[str, Any] | None = None
        for b in self.cfg.backends:
            sid = sessions.get(b.name)
            if not sid:
                continue
            try:
                resp, _ = await self._call_backend(b, payload, sid)
            except (ClientError, RuntimeError):
                continue
            if resp is not None and "error" not in resp:
                return resp
            # keep the FIRST backend's error: the owner answers first with
            # a meaningful code; later backends' generic not-found must
            # not mask it
            if resp is not None and first_error is None:
                first_error = resp
        return first_error or _rpc_error(msg_id, -32602,
                                         "resource not found")

    # -- reverse direction (server→client requests) -----------------------
    async def _prepare_relay_event(
        self, ev, backend_name: str | None, buf,
        replayable: bool = True,
    ) -> bytes:
        """Shared relay path for backend stream events (tools/call SSE
        and the GET listening stream): rewrites server-initiated messages
        so replies can route back (``backend_name=None`` skips the
        rewrite — gateway-generated pings/tool-change events keep their
        ids), then allocates a replayable proxy event id. Returns the
        encoded bytes to write."""
        if backend_name is not None and ev.data:
            try:
                msg = json.loads(ev.data)
            except ValueError:
                msg = None
            if isinstance(msg, dict) and msg.get("method"):
                modified = self._modify_server_message(msg, backend_name)
                if modified is not msg:
                    ev.data = json.dumps(modified)
        # heartbeats are written without ids and never buffered — they
        # must not evict resumable events from the bounded replay buffer
        # or advance Last-Event-Id
        if replayable and buf is not None:
            def encode_with_id(event_id: int) -> bytes:
                ev.id = str(event_id)
                return ev.encode()

            return await buf.append(encode_with_id)
        return ev.encode()

    def _modify_server_message(
        self, msg: dict[str, Any], backend: str
    ) -> dict[str, Any]:
        """Rewrites a server-initiated JSON-RPC message before relaying it
        to the client: request ids for ``roots/list`` /
        ``sampling/createMessage`` / ``elicitation/create`` / ``ping``
        become routable composites, as do server-issued
        ``_meta.progressToken`` values."""
        if msg.get("method") not in S2C_REQUEST_METHODS:
            return msg
        if msg.get("id") is None:
            return msg
        msg = dict(msg, id=_encode_routed(S2C_ID_PREFIX, msg["id"], backend))
        params = msg.get("params")
        if isinstance(params, dict):
            meta = params.get("_meta")
            if isinstance(meta, dict) and "progressToken" in meta:
                token = _encode_routed(
                    PROGRESS_TOKEN_PREFIX, meta["progressToken"], backend
                )
                msg["params"] = dict(
                    params, _meta=dict(meta, progressToken=token)
                )
        return msg

    def _backend(self, name: str) -> MCPBackend | None:
        return next((b for b in self.cfg.backends if b.name == name), None)

    async def _client_to_server_response(
        self, payload: dict[str, Any], sessions: dict[str, str]
    ) -> Response:
        """Routes a client JSON-RPC response back to the backend that
        issued the server→client request."""
        rid = payload.get("id")
        if isinstance(rid, str) and rid.startswith(PING_ID_PREFIX):
            # reply to a gateway-initiated heartbeat ping — swallow
            return _empty(202)
        decoded = _decode_routed(S2C_ID_PREFIX, rid)
        if decoded is None:
            return _json(_rpc_error(None, -32600,
                                    f"invalid response ID {rid!r}"), 400)
        orig_id, backend_name = decoded
        backend = self._backend(backend_name)
        if backend is None:
            return _json(_rpc_error(None, -32602,
                                    f"unknown backend {backend_name!r}"),
                         404)
        sid = sessions.get(backend_name, "")
        if not sid:
            return _json(_rpc_error(
                None, -32602, f"no session for backend {backend_name!r}"),
                400)
        restored = dict(payload, id=orig_id)
        try:
            resp, _ = await self._call_backend(backend, restored, sid)
        except (ClientError, RuntimeError) as e:
            return _json(_rpc_error(None, -32603,
                                    f"failed to forward: {e}"), 502)
        if resp is None:
            return _empty(202)
        return _json(resp)

    async def _route_progress(
        self, payload: dict[str, Any], sessions: dict[str, str]
    ) -> Response:
        """notifications/progress from the client carries a rewritten
        progressToken naming the backend that asked for progress."""
        params = payload.get("params") or {}
        decoded = _decode_routed(
            PROGRESS_TOKEN_PREFIX, params.get("progressToken")
        )
        if decoded is None:
            return _json(_rpc_error(
                None, -32602,
                f"invalid progressToken {params.get('progressToken')!r}",
            ), 400)
        token, backend_name = decoded
        backend = self._backend(backend_name)
        sid = sessions.get(backend_name, "")
        if backend is None or not sid:
            return _json(_rpc_error(None, -32602,
                                    f"unknown backend {backend_name!r}"),
                         400)
        restored = dict(
            payload, params=dict(params, progressToken=token)
        )
        try:
            await self._call_backend(backend, restored, sid)
            if self.metrics is not None:
                # counted only once actually forwarded — rejected or
                # failed notifications must not corroborate traffic
                self.metrics.progress_notifications.labels().inc()
        except (ClientError, RuntimeError) as e:
            logger.warning("progress forward to %s failed: %s",
                           backend_name, e)
        return _empty(202)

    async def _aggregate_list(
        self, method: str, msg_id: Any, sessions: dict[str, str]
    ) -> dict[str, Any]:
        key = {
            "prompts/list": "prompts",
            "resources/list": "resources",
            "resources/templates/list": "resourceTemplates",
        }[method]

        async def one(b: MCPBackend):
            sid = sessions.get(b.name, "")
            if not sid:
                return []
            try:
                resp, _ = await self._call_backend(
                    b, {"jsonrpc": "2.0", "id": msg_id, "method": method}, sid
                )
            except (ClientError, RuntimeError):
                return []
            items = ((resp or {}).get("result") or {}).get(key) or []
            out = []
            for it in items:
                it = dict(it)
                if "name" in it:
                    it["name"] = f"{b.name}{TOOL_SEP}{it['name']}"
                out.append(it)
            return out

        lists = await asyncio.gather(*(one(b) for b in self.cfg.backends))
        return {
            "jsonrpc": "2.0",
            "id": msg_id,
            "result": {key: [x for sub in lists for x in sub]},
        }
