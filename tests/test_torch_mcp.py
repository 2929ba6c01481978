"""The port's MCP proxy, behind the port's gateway, against the
reference's behind the reference's (aiohttp), each in front of its own
copies of the same fake MCP backends: one answering JSON, one answering
single-event SSE (and streaming ``tools/call``, server-to-client
requests and a GET listening stream), and the stdio fixture
(``tests/stdio_mcp_server.py``) behind each package's own stdio bridge.
One client script runs against each gateway: ``initialize``,
``tools/list`` with filters, ``tools/call`` unary and streamed, the
reverse direction (an elicitation's progress token and response, a
listening stream's ``sampling/createMessage`` and its response), the
prompt and resource lists, subscriptions, the listening stream woken by
a hot reload with ``list_changed`` and cut by the client (the backend's
stream then closes), ``Last-Event-Id`` replay, errors, ``DELETE`` and
the ``mcp_*`` samples. The replies, what every backend received and the
samples must be equal; session ids are compared by what they decode to.
Then: authorization (401 with the metadata pointer, 403, the RFC 9728
document, 404 with it off), a ``replay_dir`` shared by both gateways, the
stdio bridges side by side (a child that exits, ``stop`` reaping it),
and ``python -m aigw_tpu_torch run --mcp-json`` bridging the fixture,
answering ``tools/list`` and leaving no child after SIGTERM."""

import asyncio
import json
import os
import pathlib
import signal
import subprocess
import sys
import time

import aiohttp
from aiohttp import web

from aigw_tpu.config import model as jmodel
from aigw_tpu.config import runtime as jruntime
from aigw_tpu.gateway import server as jserver
from aigw_tpu.mcp import authz as jauthz
from aigw_tpu.mcp import stdio_bridge as jstdio
from aigw_tpu_torch.config import model as tmodel
from aigw_tpu_torch.config import runtime as truntime
from aigw_tpu_torch.gateway import server as tserver
from aigw_tpu_torch.mcp import proxy as tproxy
from aigw_tpu_torch.mcp import stdio_bridge as tstdio

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURE = str(ROOT / "tests" / "stdio_mcp_server.py")
INIT = {"protocolVersion": "2025-06-18",
        "capabilities": {"sampling": {}, "roots": {}}}
#: the request headers a backend's log keeps
SEEN_HEADERS = ("mcp-session-id", "mcp-protocol-version", "accept",
                "content-type", "x-key", "last-event-id")


def _run(coro, timeout=45):
    return asyncio.run(asyncio.wait_for(coro, timeout))


class FakeMCP:
    """A streamable-HTTP MCP backend with per-session state; ``sse``
    answers every POST as a single-event SSE stream and streams its
    ``tools/call`` (an elicitation request with a progress token, then
    the result). ``log`` keeps every request it received."""

    def __init__(self, name, tools, sse=False):
        self.name = name
        self.tools = tools
        self.sse = sse
        self.sessions: set[str] = set()
        self.n = 0
        self.log: list = []
        self.get_events: list = []
        self.get_open = asyncio.Event()
        self.get_closed = asyncio.Event()
        self.app = web.Application()
        self.app.router.add_post("/mcp", self._post)
        self.app.router.add_delete("/mcp", self._delete)
        if sse:
            self.app.router.add_get("/mcp", self._get)
        self.runner = None
        self.url = ""

    async def start(self):
        self.runner = web.AppRunner(self.app)
        await self.runner.setup()
        site = web.TCPSite(self.runner, "127.0.0.1", 0)
        await site.start()
        self.url = (f"http://127.0.0.1:"
                    f"{site._server.sockets[0].getsockname()[1]}/mcp")
        return self

    def _seen(self, request, what):
        self.log.append((request.method, what, {
            h: request.headers[h] for h in SEEN_HEADERS
            if h in request.headers}))

    async def _reply(self, request, msg, headers=None):
        if not self.sse:
            return web.json_response(msg, headers=headers)
        resp = web.StreamResponse(status=200, headers={
            "content-type": "text/event-stream", **(headers or {})})
        await resp.prepare(request)
        await resp.write(f"event: message\ndata: {json.dumps(msg)}\n\n"
                         .encode())
        await resp.write_eof()
        return resp

    async def _post(self, request):
        msg = json.loads(await request.read())
        self._seen(request, msg)
        method = msg.get("method")
        sid = request.headers.get("mcp-session-id", "")
        if method == "initialize":
            self.n += 1
            sid = f"{self.name}-{self.n}"
            self.sessions.add(sid)
            return await self._reply(request, {
                "jsonrpc": "2.0", "id": msg["id"], "result": {
                    "protocolVersion": "2025-06-18",
                    "capabilities": {"tools": {}, "resources": {
                        "subscribe": True}},
                    "serverInfo": {"name": self.name}}},
                headers={"mcp-session-id": sid})
        if sid not in self.sessions:
            return web.json_response({"error": "no session"}, status=404)
        if "method" not in msg or msg.get("id") is None:
            return web.Response(status=202)  # a notification or response
        rid = msg["id"]
        params = msg.get("params") or {}
        if method == "tools/list":
            return await self._reply(request, {
                "jsonrpc": "2.0", "id": rid, "result": {"tools": [
                    {"name": t, "description": f"{t} from {self.name}",
                     "inputSchema": {"type": "object"}}
                    for t in self.tools]}})
        if method == "tools/call" and self.sse:
            resp = web.StreamResponse(status=200, headers={
                "content-type": "text/event-stream"})
            await resp.prepare(request)
            elic = {"jsonrpc": "2.0", "id": "elic-1",
                    "method": "elicitation/create",
                    "params": {"message": "ok?",
                               "_meta": {"progressToken": "pt-9"}}}
            await resp.write(f"data: {json.dumps(elic)}\n\n".encode())
            final = {"jsonrpc": "2.0", "id": rid, "result": {"content": [
                {"type": "text", "text": f"{self.name} streamed "
                                         f"{params.get('name')}"}]}}
            await resp.write(f"data: {json.dumps(final)}\n\n".encode())
            await resp.write_eof()
            return resp
        if method == "tools/call":
            return await self._reply(request, {
                "jsonrpc": "2.0", "id": rid, "result": {"content": [
                    {"type": "text",
                     "text": f"{self.name} ran {params.get('name')}"}]}})
        uri = params.get("uri", "")
        own = f"{self.name}://doc"
        result = {
            "prompts/list": {"prompts": [{"name": "greet"}]},
            "prompts/get": {"messages": [{"role": "user", "content": {
                "type": "text", "text": f"prompt:{params.get('name')}"}}]},
            "resources/list": {"resources": [{"uri": own, "name": "doc"}]},
            "resources/templates/list": {"resourceTemplates": [
                {"name": f"{self.name}-tpl",
                 "uriTemplate": f"{self.name}://{{path}}"}]},
            "logging/setLevel": {},
        }.get(method)
        if method in ("resources/subscribe", "resources/unsubscribe",
                      "resources/read"):
            if uri != own:
                return await self._reply(request, {
                    "jsonrpc": "2.0", "id": rid,
                    "error": {"code": -32002, "message": "not found"}})
            result = ({"contents": [{"uri": uri, "text": "data"}]}
                      if method == "resources/read" else {})
        if result is None:
            return await self._reply(request, {
                "jsonrpc": "2.0", "id": rid,
                "error": {"code": -32601, "message": "nope"}})
        return await self._reply(request, {"jsonrpc": "2.0", "id": rid,
                                           "result": result})

    async def _get(self, request):
        self._seen(request, "GET")
        resp = web.StreamResponse(status=200, headers={
            "content-type": "text/event-stream"})
        await resp.prepare(request)
        self.get_open.set()
        try:
            for ev in self.get_events:
                await resp.write(f"data: {json.dumps(ev)}\n\n".encode())
            while True:  # a comment keeps finding out whether it is read
                await asyncio.sleep(0.05)
                await resp.write(b": keepalive\n\n")
        except (ConnectionError, RuntimeError):
            self.get_closed.set()
        return resp

    async def _delete(self, request):
        self._seen(request, "DELETE")
        self.sessions.discard(request.headers.get("mcp-session-id", ""))
        return web.Response(status=200)


async def _start_gateway(side, raw):
    if side == "ref":
        srv, runner = await jserver.run_gateway(
            jruntime.RuntimeConfig.build(jmodel.Config.parse(raw)), port=0)
        port = runner.addresses[0][1]

        async def stop():
            await runner.cleanup()
    else:
        srv = await tserver.run_gateway(
            truntime.RuntimeConfig.build(tmodel.Config.parse(raw)), port=0)
        port = srv.port
        stop = srv.stop
    return srv, f"http://127.0.0.1:{port}", stop


def _reload(side, srv, raw):
    if side == "ref":
        srv.set_runtime(jruntime.RuntimeConfig.build(jmodel.Config.parse(raw)))
    else:
        srv.set_runtime(truntime.RuntimeConfig.build(tmodel.Config.parse(raw)))


def _events(raw: bytes):
    """(event id, message) per SSE event of a body; pings dropped past
    the first (their number follows the heartbeat's timing)."""
    out = []
    for block in raw.decode().split("\n\n"):
        eid, data = None, None
        for line in block.splitlines():
            if line.startswith("id: "):
                eid = line[4:]
            elif line.startswith("data: "):
                data = json.loads(line[6:])
        if data is not None:
            out.append((eid, data))
    pings = [i for i, (_e, d) in enumerate(out) if d.get("method") == "ping"]
    return [e for i, e in enumerate(out) if i not in pings[1:]]


class _Client:
    """The script's client: every reply is kept, normalized (a session
    id header by what it decodes to)."""

    def __init__(self, s, base, proxy):
        self.s = s
        self.url = base + "/mcp"
        self.proxy = proxy
        self.session = ""
        self.replies: list = []

    def _norm(self, status, headers, raw):
        ctype = headers.get("content-type", "")
        body = (_events(raw) if "event-stream" in ctype
                else json.loads(raw) if raw and "json" in ctype else raw)
        sid = headers.get("mcp-session-id")
        return (status, body,
                self.proxy._decode_session(sid) if sid else None)

    async def post(self, payload, headers=None):
        h = {"mcp-session-id": self.session} if self.session else {}
        async with self.s.post(self.url, json=payload,
                               headers={**h, **(headers or {})}) as r:
            rec = self._norm(r.status, r.headers, await r.read())
            if r.headers.get("mcp-session-id"):
                self.session = r.headers["mcp-session-id"]
        self.replies.append(rec)
        return rec

    async def rpc(self, method, params=None, id_=1):
        p = {"jsonrpc": "2.0", "id": id_, "method": method}
        if params is not None:
            p["params"] = params
        return await self.post(p)

    async def get(self, headers):
        async with self.s.get(self.url, headers={
                "mcp-session-id": self.session, **headers}) as r:
            rec = self._norm(r.status, r.headers, await r.read())
        self.replies.append(rec)
        return rec


def _mcp_raw(fakes, seed="seed-x", extra=None):
    alpha, beta, fix = fakes
    return {"version": "v1", "mcp": {
        "session_seed": seed,
        "backends": [
            {"name": "alpha", "url": alpha.url,
             "tool_filter": {"exclude": ["secret_*"]},
             "headers": [{"name": "X-Key", "value": "k1"}]},
            {"name": "beta", "url": beta.url,
             "tool_filter": {"include": ["comp*"]}},
            {"name": "fix", "url": fix}] + (extra or [])}}


async def _script(side):
    """The client script against one side; (replies, backend logs,
    metric samples)."""
    bridge = (jstdio if side == "ref" else tstdio).StdioMCPBridge(
        jstdio.StdioServerSpec(name="fix", command=sys.executable,
                               args=(FIXTURE,))
        if side == "ref" else
        tstdio.StdioServerSpec(name="fix", command=sys.executable,
                               args=(FIXTURE,)))
    alpha = await FakeMCP("alpha", ["work", "secret_x"], sse=True).start()
    beta = await FakeMCP("beta", ["compute", "other"]).start()
    gamma = await FakeMCP("gamma", ["g"]).start()
    alpha.get_events = [
        {"jsonrpc": "2.0", "method": "notifications/resources/updated",
         "params": {"uri": "alpha://doc"}},
        {"jsonrpc": "2.0", "id": 42, "method": "sampling/createMessage",
         "params": {"messages": [], "_meta": {"progressToken": 7}}}]
    fakes = (alpha, beta, await bridge.start())
    raw = _mcp_raw(fakes)
    srv, base, stop = await _start_gateway(side, raw)
    try:
        async with aiohttp.ClientSession() as s:
            c = _Client(s, base, srv.mcp)
            await c.rpc("initialize", INIT)
            await c.post({"jsonrpc": "2.0",
                          "method": "notifications/initialized"})
            await c.rpc("tools/list", {}, 2)
            await c.rpc("tools/call", {"name": "beta__compute",
                                       "arguments": {"x": 1}}, 3)
            await c.rpc("tools/call", {"name": "fix__echo",
                                       "arguments": {"text": "hi"}}, 4)
            _st, events, _ = await c.rpc("tools/call",
                                         {"name": "alpha__work"}, 5)
            elic = next(d for _e, d in events
                        if d.get("method") == "elicitation/create")
            await c.post({"jsonrpc": "2.0",
                          "method": "notifications/progress",
                          "params": {"progressToken":
                                     elic["params"]["_meta"]
                                     ["progressToken"], "progress": 0.5}})
            await c.post({"jsonrpc": "2.0", "id": elic["id"],
                          "result": {"action": "accept"}})
            for i, (m, p) in enumerate([
                    ("tools/call", {"name": "alpha__secret_x"}),
                    ("tools/call", {"name": "beta__other"}),
                    ("tools/call", {"name": "ghost__x"}),
                    ("prompts/list", {}), ("prompts/get",
                                           {"name": "alpha__greet"}),
                    ("resources/list", {}), ("resources/templates/list", {}),
                    ("resources/read", {"uri": "beta://doc"}),
                    ("resources/subscribe", {"uri": "beta://doc"}),
                    ("resources/unsubscribe", {"uri": "beta://doc"}),
                    ("resources/subscribe", {"uri": "nope://x"}),
                    ("completion/complete",
                     {"ref": {"type": "ref/prompt", "name": "alpha__greet"},
                      "argument": {"name": "a", "value": "b"}}),
                    ("logging/setLevel", {"level": "info"}),
                    ("ping", None), ("nosuch/method", {})]):
                await c.rpc(m, p, 10 + i)
            # the listening stream: alpha's events relayed with proxy ids,
            # a reload's list_changed, then the client's close
            got = b""
            async with s.get(c.url, headers={
                    "mcp-session-id": c.session}) as r:
                assert r.status == 200
                reloaded = False
                async for chunk in r.content.iter_any():
                    got += chunk
                    if not reloaded and b"sampling/createMessage" in got:
                        reloaded = True
                        _reload(side, srv, _mcp_raw(fakes, extra=[
                            {"name": "gamma", "url": gamma.url}]))
                    if b"tools/list_changed" in got:
                        break
            c.replies.append(("listen", _events(got)))
            await asyncio.wait_for(alpha.get_closed.wait(), 10)
            sampling = next(d for _e, d in _events(got)
                            if d.get("method") == "sampling/createMessage")
            await c.post({"jsonrpc": "2.0", "id": sampling["id"],
                          "result": {"role": "assistant", "content": {
                              "type": "text", "text": "ok"}}})
            await c.get({"last-event-id": "1"})
            async with s.get(c.url) as r:  # no session: 405
                c.replies.append(("no-session", r.status))
            for bad in ({"jsonrpc": "2.0", "id": "x", "result": {}},
                        {"jsonrpc": "2.0", "id": "aigw-ping-1",
                         "result": {}},
                        {"jsonrpc": "2.0", "method": "notifications/progress",
                         "params": {"progressToken": "plain"}}):
                await c.post(bad)
            await c.rpc("tools/list", {}, 30)  # the old session
            session = c.session
            c.session = "garbage"
            await c.rpc("tools/list", {}, 31)
            c.session = ""
            await c.rpc("initialize", INIT, 32)  # sees gamma
            await c.rpc("tools/list", {}, 33)
            c.session = session
            async with s.delete(c.url, headers={
                    "mcp-session-id": session}) as r:
                c.replies.append(("delete", r.status))
            async with s.get(base + "/metrics") as r:
                metrics = await r.text()
            async with s.get(
                    base + "/.well-known/oauth-protected-resource") as r:
                c.replies.append(("metadata", r.status))
    finally:
        await stop()
        await bridge.stop()
        for f in (alpha, beta, gamma):
            await f.runner.cleanup()
    assert bridge._proc.returncode is not None  # the child is reaped
    # counters and histogram counts (durations' sums and buckets follow
    # the clock)
    samples = sorted(
        line for line in metrics.splitlines() if line.startswith("mcp_")
        and not any(k in line for k in ("_created", "_sum", "_bucket")))
    return c.replies, [alpha.log, beta.log, gamma.log], samples


def test_mcp_proxy_script_matches_reference(monkeypatch):
    monkeypatch.setenv("MCP_PROXY_HEARTBEAT_INTERVAL", "0.3")
    ref = _run(_script("ref"))
    port = _run(_script("port"))
    replies, logs, samples = port
    assert len(replies) == len(ref[0])
    for i, (got, want) in enumerate(zip(replies, ref[0])):
        assert got == want, i
    for got, want in zip(logs, ref[1]):
        assert got == want
    assert samples == ref[2]
    # what the script showed
    assert replies[0][2] == {"alpha": "alpha-1", "beta": "beta-1",
                             "fix": "stdio-fix"}
    names = [t["name"] for t in replies[2][1]["result"]["tools"]]
    assert names == ["alpha__work", "beta__compute", "fix__echo"]
    assert replies[4][1]["result"]["content"][0]["text"] == "echo: hi"
    assert [e for e, _d in replies[5][1]] == ["1", "2"]
    listen = next(r for r in replies if r[0] == "listen")[1]
    assert listen[0][1]["method"] == "ping"
    assert [d.get("method") for e, d in listen[1:]] == [
        "notifications/resources/updated", "sampling/createMessage",
        "notifications/tools/list_changed"]
    assert [e for e, _d in listen[1:]] == ["3", "4", "5"]
    assert replies[25][0] == 200  # Last-Event-Id 1: the events after it
    assert [(e, d.get("method")) for e, d in replies[25][1]] == [
        ("2", None), ("3", "notifications/resources/updated"),
        ("4", "sampling/createMessage"),
        ("5", "notifications/tools/list_changed")]
    alpha_log = logs[0]
    assert any(m == "POST" and w.get("id") == 42 and "result" in w
               for m, w, _h in alpha_log)  # the sampling reply, restored
    assert any(w.get("params", {}).get("progressToken") == "pt-9"
               for _m, w, _h in alpha_log if isinstance(w, dict))
    assert any(m == "DELETE" for m, _w, _h in alpha_log)
    assert any('mcp_method_name="tools/call",status="success"' in s
               and 'mcp_backend="alpha"' in s for s in samples)


def test_mcp_authorization_matches_reference(tmp_path):
    (tmp_path / "jwt").write_text("jwt-secret")

    async def main(side):
        alpha = await FakeMCP("alpha", ["search", "admin_reset"]).start()
        raw = {"version": "v1", "mcp": {
            "session_seed": "t",
            "backends": [{"name": "alpha", "url": alpha.url}],
            "authorization": {
                "resource": "/mcp",
                "authorization_servers": ["https://auth.example"],
                "jwt": {"hs256_secret": f"file:{tmp_path / 'jwt'}",
                        "issuer": "https://auth.example",
                        "audience": "mcp"},
                "rules": [{"tools": ["alpha__search"],
                           "claims": {"role": "user"}},
                          {"tools": ["alpha__*"],
                           "claims": {"role": "admin"}}]}}}
        srv, base, stop = await _start_gateway(side, raw)
        out = []
        claims = {"iss": "https://auth.example", "aud": "mcp"}
        user = jauthz.sign_hs256(dict(claims, role="user"), "jwt-secret")
        admin = jauthz.sign_hs256(dict(claims, role="admin"), "jwt-secret")
        forged = jauthz.sign_hs256(dict(claims, role="admin"), "nope")
        try:
            async with aiohttp.ClientSession() as s:
                c = _Client(s, base, srv.mcp)
                out.append(await c.rpc("ping"))
                out.append(await c.post(
                    {"jsonrpc": "2.0", "id": 1, "method": "initialize",
                     "params": INIT},
                    {"authorization": f"Bearer {user}"}))
                for tok, tool in ((forged, "alpha__search"),
                                  (user, "alpha__search"),
                                  (user, "alpha__admin_reset"),
                                  (admin, "alpha__admin_reset"),
                                  ("x.y.z", "alpha__search")):
                    out.append(await c.post(
                        {"jsonrpc": "2.0", "id": 2, "method": "tools/call",
                         "params": {"name": tool}},
                        {"authorization": f"Bearer {tok}"}))
                async with s.post(c.url, json={"jsonrpc": "2.0", "id": 3,
                                               "method": "ping"}) as r:
                    out.append(r.headers.get("www-authenticate"))
                for h in ({}, {"authorization": f"Bearer {user}"}):
                    out.append(await c.get({"last-event-id": "0", **h}))
                async with s.get(
                        base + "/.well-known/oauth-protected-resource") as r:
                    out.append((r.status, await r.json()))
                # a reload turns authorization off: the metadata is 404
                _reload(side, srv, {"version": "v1", "mcp": {
                    "session_seed": "t",
                    "backends": [{"name": "alpha", "url": alpha.url}]}})
                async with s.get(
                        base + "/.well-known/oauth-protected-resource") as r:
                    out.append(r.status)
                out.append(await c.rpc("ping", id_=9))
        finally:
            await stop()
            await alpha.runner.cleanup()
        return out, alpha.log

    ref, port = _run(main("ref")), _run(main("port"))
    assert port == ref
    out = port[0]
    assert [r[0] for r in out[:7]] == [401, 200, 401, 200, 403, 200, 401]
    assert out[4][1]["error"]["message"] == \
        "tool 'alpha__admin_reset' not permitted for this principal"
    assert 'resource_metadata="/.well-known/oauth-protected-resource"' \
        in out[7]
    assert [r[0] for r in out[8:10]] == [401, 200]
    assert out[10] == (200, {"resource": "/mcp",
                             "authorization_servers": [
                                 "https://auth.example"],
                             "bearer_methods_supported": ["header"]})
    assert out[11] == 404 and out[12][0] == 200


def test_replay_dir_shared_across_gateways(tmp_path):
    """A stream served by the reference's gateway replays from the
    port's, and one served by the port's from the reference's, given one
    seed and one ``replay_dir``."""

    async def main():
        alpha = await FakeMCP("alpha", ["work"], sse=True).start()
        raw = {"version": "v1", "mcp": {
            "session_seed": "shared", "replay_dir": str(tmp_path),
            "backends": [{"name": "alpha", "url": alpha.url}]}}
        gws = {side: await _start_gateway(side, raw)
               for side in ("ref", "port")}
        out = {}
        try:
            async with aiohttp.ClientSession() as s:
                for serve, replay in (("ref", "port"), ("port", "ref")):
                    a = _Client(s, gws[serve][1], gws[serve][0].mcp)
                    await a.rpc("initialize", INIT)
                    _st, events, _ = await a.rpc(
                        "tools/call", {"name": "alpha__work"}, 2)
                    b = _Client(s, gws[replay][1], gws[replay][0].mcp)
                    b.session = a.session
                    out[serve] = (events, (await b.get(
                        {"last-event-id": "0"}))[1])
        finally:
            for _srv, _base, stop in gws.values():
                await stop()
            await alpha.runner.cleanup()
        return out

    out = _run(main())
    for events, replayed in out.values():
        assert [e for e, _d in events] == ["1", "2"]
        assert replayed == events


def test_stdio_bridges_match_reference():
    async def main(mod):
        bridge = mod.StdioMCPBridge(mod.StdioServerSpec(
            name="fix", command=sys.executable, args=(FIXTURE,)))
        url = await bridge.start()
        dead = mod.StdioMCPBridge(mod.StdioServerSpec(
            name="dead", command=sys.executable, args=("-c", "pass")))
        dead_url = await dead.start()
        out = []
        try:
            async with aiohttp.ClientSession() as s:
                async def post(u, payload, raw=None):
                    async with s.post(u, data=raw or json.dumps(payload),
                                      headers={"content-type":
                                               "application/json"}) as r:
                        body = await r.read()
                        out.append((r.status, r.headers.get(
                            "mcp-session-id"), json.loads(body)
                            if body else None))

                async with s.get(url) as g:
                    await post(url, {"jsonrpc": "2.0", "id": 1,
                                     "method": "initialize",
                                     "params": INIT})
                    await post(url, {"jsonrpc": "2.0",
                                     "method": "notifications/initialized"})
                    first = await asyncio.wait_for(
                        g.content.readuntil(b"\n\n"), 10)
                    out.append(first)
                for i, (m, p) in enumerate([
                        ("tools/list", {}),
                        ("tools/call", {"name": "echo",
                                        "arguments": {"text": "x"}}),
                        ("ping", {})]):
                    await post(url, {"jsonrpc": "2.0", "id": i + 2,
                                     "method": m, "params": p})
                await post(url, None, b"{bad")
                for _ in range(50):  # the child has exited
                    if dead._proc.returncode is not None:
                        break
                    await asyncio.sleep(0.05)
                await post(dead_url, {"jsonrpc": "2.0", "id": 1,
                                      "method": "ping"})
        finally:
            if mod is jstdio:
                # the reference bridge's GET handler sees the closed
                # subscriber at its 15 s ping; its server's shutdown
                # would wait that long for it
                bridge._runner._shutdown_timeout = 0.5
            await bridge.stop()
            await dead.stop()
        assert bridge._proc.returncode is not None
        return out

    ref, port = _run(main(jstdio)), _run(main(tstdio))
    assert port == ref
    assert port[0][1] == "stdio-fix"
    assert b"hello-from-stdio" in port[2] and port[2].startswith(b"id: 1\n")
    assert port[4][2]["result"]["content"][0]["text"] == "echo: x"
    assert port[-1][0] == 502


def _children(pid: int) -> list[int]:
    out = []
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/stat") as f:
                    if int(f.read().rsplit(")", 1)[1].split()[1]) == pid:
                        out.append(int(d))
            except (OSError, ValueError, IndexError):
                pass
    return out


def test_cli_bridges_mcp_json_and_reaps_the_child(tmp_path):
    cfg = tmp_path / "gw.json"
    cfg.write_text(json.dumps({"version": "v1"}))
    servers = json.dumps({"mcpServers": {"fix": {
        "command": sys.executable, "args": [FIXTURE]}}})
    proc = subprocess.Popen(
        [sys.executable, "-m", "aigw_tpu_torch", "run", str(cfg),
         "--port", "0", "--watch-interval", "0.2", "--mcp-json", servers],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        lines = []
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            lines.append(line)
            if line.startswith("gateway listening on"):
                break
        assert lines[0].strip() == "mcp: 1 server(s): fix (1 stdio-bridged)"
        base = lines[-1].split()[-1]
        kids = _children(proc.pid)
        assert kids  # the bridged child

        async def main():
            async with aiohttp.ClientSession() as s:
                async with s.post(base + "/mcp", json={
                        "jsonrpc": "2.0", "id": 1, "method": "initialize",
                        "params": INIT}) as r:
                    sid = r.headers["mcp-session-id"]
                async with s.post(base + "/mcp", json={
                        "jsonrpc": "2.0", "id": 2, "method": "tools/list"},
                        headers={"mcp-session-id": sid}) as r:
                    return await r.json()

        body = _run(main())
        assert [t["name"] for t in body["result"]["tools"]] == ["fix__echo"]
        # a reload of the file keeps the bridged backend
        cfg.write_text(json.dumps({"version": "v1", "uuid": "u2"}))
        time.sleep(0.6)
        assert _run(main())["result"]["tools"][0]["name"] == "fix__echo"
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
    assert rc == 0
    for pid in kids:
        assert not os.path.exists(f"/proc/{pid}")
    assert tproxy.SESSION_HEADER == "mcp-session-id"


def test_chip_smoke_mcp_turn_onto_a_port_replica():
    """chip_smoke's MCP block on the CPU, every gate: gateway C (``python
    -m aigw_tpu_torch run`` with tracing, the access log, the debug
    routes, an ``mcp`` block and ``--mcp-json``) beside the port's
    gateway B, onto a tiny-random port replica."""
    import threading

    import chip_smoke as cs
    from aigw_tpu_torch.tpuserve.engine import EngineConfig
    from aigw_tpu_torch.tpuserve.server import TPUServeServer

    rep = TPUServeServer(
        "tiny-random", EngineConfig(max_batch_size=4, max_seq_len=256,
                                    page_size=16, enable_prefix_cache=False),
        device="cpu", port=0, param_dtype="float32")
    rep.start()
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    def on(coro):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(60)

    b = on(tserver.run_gateway(truntime.RuntimeConfig.build(
        tmodel.Config.parse({"version": "v1", "backends": [
            {"name": "pool", "schema": "TPUServe",
             "endpoints": [f"127.0.0.1:{rep.port}"]}],
            "routes": [{"name": "r", "rules": [{"backends": ["pool"]}]}]})),
        port=0))
    try:
        out = cs._gw_mcp(b.port, [rep], model="tiny-random")
    finally:
        on(b.stop())
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=10)
        loop.close()
        rep.stop()
    assert out["startup"] == ["mcp: 1 server(s): notes (1 stdio-bridged)"]
    assert out["tools"] == ["kb__lookup", "notes__recall"]
    assert (out["no_jwt"], out["wrong_claim"], out["delete"]) == \
        (401, 403, 200)
    assert out["access_log_lines"] == 6 and out["chat_tokens"] == 8
    assert out["debug"]["leaked"] == [] and out["debug"]["threads"] > 1
    assert out["mcp_methods"] == ["initialize", "tools/call", "tools/list"]
    assert set(out["ttft_p50_ms"]) == {"direct", "b", "c"}


def test_client_close_ends_backend_streams_reference_fact(monkeypatch):
    """A listening stream's client closes: the port's proxy closes its
    backend GET stream at once (``Request.disconnected``), and its stdio
    bridge drops the subscriber; the reference's notice only at their
    next write, the proxy's heartbeat (``MCP_PROXY_HEARTBEAT_INTERVAL``,
    60 s by default, 30 here) and the bridge's 15 s ping. Both sides
    asserted."""
    monkeypatch.setenv("MCP_PROXY_HEARTBEAT_INTERVAL", "30")

    async def main(side):
        mod = jstdio if side == "ref" else tstdio
        bridge = mod.StdioMCPBridge(mod.StdioServerSpec(
            name="fix", command=sys.executable, args=(FIXTURE,)))
        alpha = await FakeMCP("alpha", ["t"], sse=True).start()
        raw = {"version": "v1", "mcp": {"session_seed": "s", "backends": [
            {"name": "alpha", "url": alpha.url}]}}
        if side == "ref":
            srv, runner = await jserver.run_gateway(
                jruntime.RuntimeConfig.build(jmodel.Config.parse(raw)),
                port=0)
            base = f"http://127.0.0.1:{runner.addresses[0][1]}"
            # its listening handler ends at the next heartbeat: the
            # shutdown cancels it instead of waiting that long
            runner._shutdown_timeout = 0.5
            stop = runner.cleanup
        else:
            srv, base, stop = await _start_gateway(side, raw)
        try:
            url = await bridge.start()
            async with aiohttp.ClientSession() as s:
                c = _Client(s, base, srv.mcp)
                await c.rpc("initialize", INIT)
                r = await s.get(c.url, headers={"mcp-session-id": c.session})
                await asyncio.wait_for(alpha.get_open.wait(), 10)
                g = await s.get(url)
                r.close()
                g.close()
                await asyncio.sleep(1.0)
                return alpha.get_closed.is_set(), len(bridge._streams)
        finally:
            if side == "ref":
                bridge._runner._shutdown_timeout = 0.5
            await stop()
            await bridge.stop()
            await alpha.runner.cleanup()

    assert _run(main("port")) == (True, 0)
    assert _run(main("ref")) == (False, 1)
