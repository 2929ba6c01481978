"""Provider-parity cassette record/replay harness (the port's copy of
``aigw_tpu/testing/cassettes.py``, on the gateway's standard-library
HTTP layer).

The reference's strongest translator-correctness tool is a fake OpenAI
server that replays **real recorded provider interactions** keyed by an
``X-Cassette-Name`` header (``tests/internal/testopenai/README.md:1-60``,
go-vcr v2 YAML cassettes). This module is the port's equivalent:

- ``load_cassette`` reads both the public go-vcr v2 YAML format (through
  ``yaml_subset``, the port's own reader: no pyyaml) and a native JSON
  format for new recordings; ``dump_cassette`` writes the JSON.
- ``CassetteServer`` is a fake upstream on ``gateway/http.py``'s
  ``HTTPServer`` that matches incoming requests to a cassette by the
  ``x-cassette-name`` header (fallback: request path), replays the
  recorded status/headers/body, and chunks ``text/event-stream`` bodies
  per event so streaming translators see realistic chunk boundaries.
- ``CassetteServer(record_base=...)`` proxies unmatched requests to a
  live provider through ``gateway/http.py``'s ``HTTPClient`` and writes
  a JSON cassette — the recording workflow for refreshing fixtures when
  credentials and egress exist.

Wire fixtures stay the provider's own bytes: tests assert translators
against what OpenAI/Azure actually sent, not hand-written expectations.
"""

from __future__ import annotations

import json
import logging
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

from aigw_tpu_torch.gateway.http import (
    HTTPClient,
    HTTPServer,
    Request,
    Response,
    StreamResponse,
    json_response,
)
from aigw_tpu_torch.testing import yaml_subset

logger = logging.getLogger(__name__)

CASSETTE_HEADER = "x-cassette-name"


@dataclass
class Interaction:
    method: str
    url: str
    path: str
    request_body: str
    request_headers: dict[str, str]
    status: int
    response_body: str
    response_headers: dict[str, str]

    @property
    def is_sse(self) -> bool:
        ctype = self.response_headers.get("content-type", "")
        return "text/event-stream" in ctype


@dataclass
class Cassette:
    name: str
    interactions: list[Interaction] = field(default_factory=list)


def _flatten_headers(h: dict[str, Any] | None) -> dict[str, str]:
    out: dict[str, str] = {}
    for k, v in (h or {}).items():
        if isinstance(v, list):
            if v:
                out[str(k).lower()] = str(v[0])
        else:
            out[str(k).lower()] = str(v)
    return out


def _path_of(url: str) -> str:
    m = re.match(r"https?://[^/]+(/.*)?$", url or "")
    return (m.group(1) or "/") if m else (url or "/")


def load_cassette(path: str | Path) -> Cassette:
    """Reads a go-vcr v2 YAML cassette or a native JSON cassette."""
    p = Path(path)
    raw = p.read_text()
    if p.suffix in (".yaml", ".yml"):
        doc = yaml_subset.loads(raw)
        interactions = []
        for it in doc.get("interactions") or []:
            req = it.get("request") or {}
            resp = it.get("response") or {}
            interactions.append(Interaction(
                method=req.get("method", "POST"),
                url=req.get("url", ""),
                path=_path_of(req.get("url", "")),
                request_body=req.get("body") or "",
                request_headers=_flatten_headers(req.get("headers")),
                status=int(resp.get("code", 200)),
                response_body=resp.get("body") or "",
                response_headers=_flatten_headers(resp.get("headers")),
            ))
        return Cassette(name=p.stem, interactions=interactions)
    doc = json.loads(raw)
    return Cassette(
        name=doc.get("name", p.stem),
        interactions=[Interaction(**it) for it in doc["interactions"]],
    )


def dump_cassette(cassette: Cassette, path: str | Path) -> None:
    """Writes the native JSON format."""
    Path(path).write_text(json.dumps({
        "name": cassette.name,
        "interactions": [vars(it) for it in cassette.interactions],
    }, indent=2))


# headers that must not be replayed verbatim (transfer framing is ours;
# auth material must never leak out of fixtures)
_SKIP_REPLAY_HEADERS = {
    "content-length", "transfer-encoding", "content-encoding",
    "connection", "set-cookie", "authorization",
}


class _AnyPath(HTTPServer):
    """An ``HTTPServer`` whose one handler takes every method and path
    (the reference's ``"*" /{tail:.*}`` route)."""

    def __init__(self, handler):
        super().__init__({})
        self._handler = handler

    async def _dispatch(self, req: Request):
        try:
            return await self._handler(req)
        except ConnectionError:
            raise
        except Exception:  # noqa: BLE001 (a handler bug is a 500)
            logger.exception("cassette replay of %s %s", req.method,
                             req.path)
            return Response(500, b"500 Internal Server Error",
                            "text/plain; charset=utf-8")


class CassetteServer:
    """Fake upstream replaying recorded interactions.

    Matching: the ``x-cassette-name`` header selects the cassette (like
    the reference); within it, the first interaction whose method+path
    match is replayed. Without the header, the first loaded cassette
    with a matching method+path wins (convenient for single-cassette
    gateway tests, where the gateway doesn't forward custom headers).
    """

    def __init__(self, record_base: str = "",
                 record_dir: str | Path | None = None):
        self._cassettes: dict[str, Cassette] = {}
        self._order: list[str] = []
        self._consumed: set[int] = set()
        self._record_base = record_base.rstrip("/")
        self._record_dir = Path(record_dir) if record_dir else None
        self._server = _AnyPath(self._dispatch)
        self._started = False
        self.url = ""
        self.requests: list[tuple[str, str, bytes]] = []  # observability

    def load(self, *paths: str | Path) -> "CassetteServer":
        for p in paths:
            c = load_cassette(p)
            self._cassettes[c.name] = c
            self._order.append(c.name)
        return self

    def load_dir(self, directory: str | Path,
                 pattern: str = "*.yaml") -> "CassetteServer":
        for p in sorted(Path(directory).glob(pattern)):
            if p.name == "README.md":
                continue
            self.load(p)
        return self

    def _match(self, name: str, method: str,
               path: str) -> Interaction | None:
        """First *unconsumed* method+path match — go-vcr semantics:
        multi-interaction cassettes (e.g. a recorded multi-turn
        conversation hitting the same endpoint twice) replay in order.
        When every match is consumed, the last one replays again so
        repeated identical requests stay serviceable; ``reset()``
        rearms everything."""
        names = [name] if name else self._order
        last: Interaction | None = None
        for n in names:
            c = self._cassettes.get(n)
            if c is None:
                continue
            for it in c.interactions:
                if it.method.upper() == method.upper() and it.path == path:
                    if id(it) not in self._consumed:
                        self._consumed.add(id(it))
                        return it
                    last = it
        return last

    def reset(self) -> None:
        """Rearm consumed interactions (fresh replay sequence)."""
        self._consumed.clear()

    async def _dispatch(self, request: Request):
        body = request.body
        self.requests.append((request.method, request.path, body))
        name = request.headers.get(CASSETTE_HEADER, "")
        it = self._match(name, request.method, request.path)
        if it is None and self._record_base:
            return await self._record(request, body, name)
        if it is None:
            return json_response(
                {"error": {"message":
                           f"no cassette interaction for "
                           f"{request.method} {request.path} "
                           f"(cassette {name!r})"}},
                status=404,
            )
        headers = {k: v for k, v in it.response_headers.items()
                   if k not in _SKIP_REPLAY_HEADERS}
        if it.is_sse:
            resp = StreamResponse(status=it.status, headers=headers)
            await resp.prepare(request)
            # chunk per SSE event: translators must handle realistic
            # boundaries, not one giant buffer
            for event in it.response_body.split("\n\n"):
                if not event.strip():
                    continue
                await resp.write((event + "\n\n").encode())
            await resp.write_eof()
            return resp
        # a recorded body with no content-type goes out as text, as the
        # reference's aiohttp response of a str does
        ctype = headers.pop("content-type", "text/plain; charset=utf-8")
        return Response(it.status, it.response_body.encode(), ctype,
                        headers)

    async def _record(self, request: Request, body: bytes,
                      name: str) -> Response:
        """Proxy to the live provider and persist the interaction
        (requires egress + credentials; replay-only environments never
        reach this)."""
        url = self._record_base + request.path
        headers = {k: v for k, v in request.headers.items()
                   if k.lower() not in ("host", CASSETTE_HEADER,
                                        "content-length",
                                        "transfer-encoding")}
        client = HTTPClient()
        try:
            async with await client.request(request.method, url, data=body,
                                            headers=headers) as upstream:
                resp_body = await upstream.read()
                interaction = Interaction(
                    method=request.method,
                    url=url,
                    path=request.path,
                    request_body=body.decode("utf-8", "replace"),
                    request_headers={
                        k.lower(): v for k, v in request.headers.items()
                        if k.lower() not in ("authorization",)
                    },
                    status=upstream.status,
                    response_body=resp_body.decode("utf-8", "replace"),
                    response_headers={
                        k.lower(): v
                        for k, v in upstream.headers.items()
                        if k.lower() not in _SKIP_REPLAY_HEADERS
                    },
                )
        finally:
            client.close()
        cname = name or "recorded"
        c = self._cassettes.setdefault(cname, Cassette(name=cname))
        if cname not in self._order:
            self._order.append(cname)
        c.interactions.append(interaction)
        if self._record_dir is not None:
            self._record_dir.mkdir(parents=True, exist_ok=True)
            dump_cassette(c, self._record_dir / f"{cname}.json")
        return Response(interaction.status, resp_body,
                        "application/octet-stream")

    async def start(self) -> "CassetteServer":
        port = await self._server.start("127.0.0.1", 0)
        self._started = True
        self.url = f"http://127.0.0.1:{port}"
        return self

    async def stop(self) -> None:
        if self._started:
            self._started = False
            await self._server.stop()
