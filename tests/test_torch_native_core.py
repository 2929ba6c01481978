"""The port's native proxy core (``aigw_tpu_torch/native/proxy_core.cpp``,
built by ``aigw_tpu_torch.native.core_binary()``) against standard-library
fake upstreams: routing, auth injection, keep-alive, weighted and
priority failover, SSE flushed per event, fallback relays (GET, HEAD, the
fallback's own statuses), ``Expect: 100-continue``, key-file rotation,
TLS upstreams (the dlopen'd ``libssl.so.3``, verified, SNI) and the
JSON-lines access log with the request's span identity — the reference's
``tests/test_native_core.py`` cases, with the reference's aiohttp fakes
replaced by ``http.server`` ones."""

from __future__ import annotations

import json
import os
import socket
import ssl
import subprocess
import threading
import time
from http.client import HTTPConnection
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from aigw_tpu_torch import native as nbuild


@pytest.fixture(scope="module")
def core_bin():
    return str(nbuild.core_binary())


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Handler(BaseHTTPRequestHandler):
    """The reference's fake upstream: echoes a marker and the request's
    details with token usage; streams three SSE events flushed 20 ms
    apart then ``[DONE]`` when the body asks for a stream; answers
    ``fail_status`` to everything when set."""

    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    def _body(self) -> bytes:
        n = int(self.headers.get("content-length") or 0)
        return self.rfile.read(n) if n else b""

    def _json(self, status: int, obj, head_only: bool = False) -> None:
        raw = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("content-type", "application/json")
        self.send_header("content-length", str(len(raw)))
        self.end_headers()
        if not head_only:
            self.wfile.write(raw)

    def _chunk(self, data: bytes) -> None:
        self.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))
        self.wfile.flush()

    def _serve(self, head_only: bool = False) -> None:
        srv = self.server
        body = self._body()
        srv.seen.append({"method": self.command, "path": self.path,
                         "headers": {k.lower(): v for k, v
                                     in self.headers.items()},
                         "body": body})
        if srv.handler is not None:
            srv.handler(self, body)
            return
        if srv.fail_status:
            self._json(srv.fail_status, {"error": "down"}, head_only)
            return
        try:
            parsed = json.loads(body) if body else {}
        except (ValueError, RecursionError):
            self._json(500, {"error": "bad json"})
            return
        if isinstance(parsed, dict) and parsed.get("stream"):
            self.send_response(200)
            self.send_header("content-type", "text/event-stream")
            self.send_header("transfer-encoding", "chunked")
            self.end_headers()
            for i in range(3):
                frame = json.dumps({"marker": srv.marker, "i": i})
                self._chunk(f"data: {frame}\n\n".encode())
                time.sleep(0.02)
            self._chunk(b"data: [DONE]\n\n")
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()
            return
        self._json(200, {
            "marker": srv.marker,
            "model": parsed.get("model") if isinstance(parsed, dict)
            else None,
            "auth": self.headers.get("authorization", ""),
            "xkey": self.headers.get("x-extra", ""),
            "host": self.headers.get("host", ""),
            "path": self.path,
            "usage": {"prompt_tokens": 3, "completion_tokens": 4,
                      "total_tokens": 7},
        }, head_only)

    def do_POST(self):  # noqa: N802
        self._serve()

    def do_GET(self):  # noqa: N802
        self._serve()

    def do_HEAD(self):  # noqa: N802
        self._serve(head_only=True)


class Upstream(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, marker: str, port: int, fail_status: int = 0,
                 ssl_ctx: ssl.SSLContext | None = None, handler=None):
        super().__init__(("127.0.0.1", port), _Handler)
        self.marker = marker
        self.fail_status = fail_status
        self.handler = handler
        self.seen: list = []
        if ssl_ctx is not None:
            self.socket = ssl_ctx.wrap_socket(self.socket, server_side=True)
        threading.Thread(target=self.serve_forever, daemon=True).start()

    def close(self) -> None:
        self.shutdown()
        self.server_close()


@pytest.fixture
def servers():
    """Fake upstreams started by the test, closed after it."""
    made: list = []

    def start(*a, **kw) -> Upstream:
        up = Upstream(*a, **kw)
        made.append(up)
        return up

    yield start
    for up in made:
        up.close()


@pytest.fixture
def start_core(core_bin, tmp_path):
    procs: list = []

    def start(cfg: dict, env: dict | None = None) -> subprocess.Popen:
        path = tmp_path / f"core-{len(procs)}.json"
        path.write_text(json.dumps(cfg))
        proc = subprocess.Popen([core_bin, str(path)],
                                stderr=subprocess.PIPE, text=True,
                                env={**os.environ, **(env or {})})
        procs.append(proc)
        line = proc.stderr.readline()
        assert "listening" in line, line
        return proc

    yield start
    for p in procs:
        p.kill()
        p.wait(timeout=10)


def make_self_signed(tmp_path) -> tuple[str, str]:
    cert, key = tmp_path / "cert.pem", tmp_path / "key.pem"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-keyout",
         str(key), "-out", str(cert), "-days", "1", "-nodes", "-subj",
         "/CN=localhost", "-addext",
         "subjectAltName=DNS:localhost,IP:127.0.0.1"],
        check=True, capture_output=True)
    return str(cert), str(key)


def request(port_or_conn, method: str, path: str, body=None,
            headers: dict | None = None, timeout: float = 10.0):
    """(status, lower-cased headers, body) over a fresh connection or
    the one given (keep-alive)."""
    conn = (port_or_conn if isinstance(port_or_conn, HTTPConnection)
            else HTTPConnection("127.0.0.1", port_or_conn, timeout=timeout))
    data = body if isinstance(body, bytes) or body is None \
        else json.dumps(body).encode()
    conn.request(method, path, body=data, headers={
        "content-type": "application/json", **(headers or {})})
    r = conn.getresponse()
    raw = r.read()
    out = r.status, {k.lower(): v for k, v in r.getheaders()}, raw
    if not isinstance(port_or_conn, HTTPConnection):
        conn.close()
    return out


def stats(port: int) -> dict:
    return json.loads(request(port, "GET", "/aigw-core/stats")[2])


@pytest.fixture
def ports():
    return {k: free_port() for k in
            ("core", "up_a", "up_b", "up_fail", "fallback")}


@pytest.fixture
def core_cfg(ports, tmp_path):
    key_file = tmp_path / "apikey"
    key_file.write_text("sk-native-test\n")
    return {
        "listen_host": "127.0.0.1",
        "listen_port": ports["core"],
        "fallback_host": "127.0.0.1",
        "fallback_port": ports["fallback"],
        "endpoints": ["/v1/chat/completions", "/v1/completions",
                      "/v1/embeddings"],
        "rules": [
            {"model_exact": "m-a", "backends": [{
                "name": "a", "host": "127.0.0.1", "port": ports["up_a"],
                "weight": 1, "priority": 0,
                "auth_headers": [{"name": "authorization",
                                  "prefix": "Bearer ",
                                  "value_file": str(key_file)}],
                "set_headers": [{"name": "x-extra", "value": "on"}]}]},
            {"model_prefix": "pfx-", "backends": [{
                "name": "b", "host": "127.0.0.1", "port": ports["up_b"],
                "weight": 1, "priority": 0}]},
            {"model_exact": "m-failover", "backends": [
                {"name": "bad", "host": "127.0.0.1",
                 "port": ports["up_fail"], "priority": 0},
                {"name": "good", "host": "127.0.0.1",
                 "port": ports["up_b"], "priority": 1}]},
        ],
    }


CHAT = "/v1/chat/completions"


def test_routing_auth_and_keepalive(ports, core_cfg, servers, start_core):
    up = servers("A", ports["up_a"])
    start_core(core_cfg)
    conn = HTTPConnection("127.0.0.1", ports["core"], timeout=10)
    try:
        for _ in range(2):  # two requests over one client connection
            status, _h, body = request(conn, "POST", CHAT, {"model": "m-a"})
            assert status == 200
            got = json.loads(body)
            assert got["marker"] == "A"
            assert got["auth"] == "Bearer sk-native-test"
            assert got["xkey"] == "on"
    finally:
        conn.close()
    assert len(up.seen) == 2
    assert stats(ports["core"])["accepted"] == 2  # one client connection


def test_model_prefix_and_header_override(ports, core_cfg, servers,
                                          start_core):
    servers("B", ports["up_b"])
    servers("PY", ports["fallback"])
    start_core(core_cfg)
    status, _h, body = request(ports["core"], "POST", "/v1/completions",
                               {"model": "pfx-anything"})
    assert status == 200 and json.loads(body)["marker"] == "B"
    # a client's x-aigw-model header is not trusted: the body's model
    # decides, so this one goes to the fallback
    status, _h, body = request(ports["core"], "POST", "/v1/completions",
                               {"model": "nomatch"},
                               headers={"x-aigw-model": "pfx-h"})
    assert status == 200 and json.loads(body)["marker"] == "PY"


def test_priority_failover(ports, core_cfg, servers, start_core):
    servers("F", ports["up_fail"], fail_status=503)
    servers("B", ports["up_b"])
    start_core(core_cfg)
    status, _h, body = request(ports["core"], "POST", CHAT,
                               {"model": "m-failover"})
    assert status == 200 and json.loads(body)["marker"] == "B"
    st = stats(ports["core"])
    assert st["retries"] >= 1 and st["native_requests"] >= 1


def test_unmatched_and_gets_fall_back(ports, core_cfg, servers, start_core):
    fb = servers("PY", ports["fallback"])
    start_core(core_cfg)
    status, _h, body = request(ports["core"], "POST", CHAT,
                               {"model": "unknown"},
                               headers={"host": "api.example.com"})
    assert status == 200
    got = json.loads(body)
    assert got["marker"] == "PY"
    assert got["host"] == "api.example.com"  # the client's Host survives
    status, _h, body = request(ports["core"], "GET", "/v1/models")
    assert status == 200 and json.loads(body)["marker"] == "PY"
    assert [s["method"] for s in fb.seen] == ["POST", "GET"]
    st = stats(ports["core"])
    assert st["fallback_requests"] == 2 and st["native_requests"] == 0


def test_deeply_nested_body_survives(ports, core_cfg, servers, start_core):
    servers("A", ports["up_a"])
    servers("PY", ports["fallback"])
    start_core(core_cfg)
    # a ~100 KB depth bomb must not overflow the parse stack and kill the
    # listener; model extraction fails, so it falls back
    bomb = ('{"a":' + "[" * 25000 + "]" * 25000 + "}").encode()
    status, h, _body = request(ports["core"], "POST", CHAT, bomb)
    assert h.get("server", "").startswith("BaseHTTP")  # the fallback's
    assert status == 500  # the fake's own parser refuses it
    status, _h, body = request(ports["core"], "POST", CHAT, {"model": "m-a"})
    assert status == 200 and json.loads(body)["marker"] == "A"


def test_sse_streaming_relay(ports, core_cfg, servers, start_core):
    servers("A", ports["up_a"])
    start_core(core_cfg)
    conn = HTTPConnection("127.0.0.1", ports["core"], timeout=10)
    conn.request("POST", CHAT, body=json.dumps(
        {"model": "m-a", "stream": True}))
    r = conn.getresponse()
    assert r.status == 200
    assert "text/event-stream" in r.getheader("content-type")
    # the events arrive as the upstream flushes them, not at its end
    first = r.readline()
    t_first = time.monotonic()
    text = (first + r.read()).decode()
    assert time.monotonic() - t_first > 0.03
    conn.close()
    events = [e for e in text.split("\n\n") if e.strip()]
    assert len(events) == 4 and events[-1] == "data: [DONE]"


def test_key_file_rotation(ports, core_cfg, servers, start_core, tmp_path):
    servers("A", ports["up_a"])
    start_core(core_cfg)
    _s, _h, body = request(ports["core"], "POST", CHAT, {"model": "m-a"})
    assert json.loads(body)["auth"] == "Bearer sk-native-test"
    key_file = tmp_path / "apikey"
    key_file.write_text("sk-rotated\n")
    st = key_file.stat()  # a distinct mtime even on coarse filesystems
    os.utime(key_file, (st.st_atime, st.st_mtime + 2))
    _s, _h, body = request(ports["core"], "POST", CHAT, {"model": "m-a"})
    assert json.loads(body)["auth"] == "Bearer sk-rotated"


def test_all_backends_down_503(ports, core_cfg, start_core):
    start_core(core_cfg)  # nothing listens on up_a's port
    status, _h, body = request(ports["core"], "POST", CHAT, {"model": "m-a"})
    assert status == 503 and b"no upstream available" in body
    assert stats(ports["core"])["upstream_errors"] == 1


def test_exhausted_retries_relay_real_error(ports, core_cfg, servers,
                                            start_core):
    """Every candidate answers 429: the client gets the upstream's real
    429 body, not a made-up 503."""
    servers("F", ports["up_a"], fail_status=429)
    start_core(core_cfg)
    status, _h, body = request(ports["core"], "POST", CHAT, {"model": "m-a"})
    assert status == 429 and json.loads(body)["error"] == "down"


def test_fallback_statuses_are_authoritative(ports, core_cfg, servers,
                                             start_core):
    """The Python gateway's 429 reaches the client untouched: the core
    neither fails over nor masks it."""
    fb = servers("PY", ports["fallback"], fail_status=429)
    start_core(core_cfg)
    status, _h, body = request(ports["core"], "POST", CHAT,
                               {"model": "unrouted"})
    assert status == 429 and json.loads(body)["error"] == "down"
    assert len(fb.seen) == 1


def test_head_request_via_fallback(ports, core_cfg, servers, start_core):
    """A HEAD response carries a content-length but no body: the relay
    must not wait for bytes that never come."""
    servers("PY", ports["fallback"])
    start_core(core_cfg)
    t0 = time.monotonic()
    status, h, body = request(ports["core"], "HEAD", "/v1/models",
                              timeout=10)
    assert status == 200 and body == b""
    assert int(h["content-length"]) > 0
    assert time.monotonic() - t0 < 5


def test_expect_100_continue(ports, core_cfg, servers, start_core):
    servers("A", ports["up_a"])
    start_core(core_cfg)
    body = json.dumps({"model": "m-a"}).encode()
    with socket.create_connection(("127.0.0.1", ports["core"]),
                                  timeout=10) as s:
        s.sendall(b"POST %s HTTP/1.1\r\nhost: x\r\ncontent-type: "
                  b"application/json\r\ncontent-length: %d\r\nexpect: "
                  b"100-continue\r\n\r\n" % (CHAT.encode(), len(body)))
        interim = s.recv(4096)
        assert interim.startswith(b"HTTP/1.1 100 Continue\r\n\r\n")
        s.sendall(body)
        raw = b""
        while b"\r\n\r\n" not in raw:
            raw += s.recv(65536)
        head, _, rest = raw.partition(b"\r\n\r\n")
        n = int([ln.split(b":")[1] for ln in head.split(b"\r\n")
                 if ln.lower().startswith(b"content-length")][0])
        while len(rest) < n:
            rest += s.recv(65536)
    assert head.startswith(b"HTTP/1.1 200")
    assert json.loads(rest[:n])["marker"] == "A"


def test_drained_backend_gets_no_traffic(ports, servers, start_core):
    up_a = servers("A", ports["up_a"])
    servers("B", ports["up_b"])
    start_core({
        "listen_host": "127.0.0.1", "listen_port": ports["core"],
        "fallback_host": "127.0.0.1", "fallback_port": ports["fallback"],
        "endpoints": [CHAT],
        "rules": [{"model_exact": "m", "backends": [
            {"name": "drained", "host": "127.0.0.1",
             "port": ports["up_a"], "weight": 0},
            {"name": "live", "host": "127.0.0.1", "port": ports["up_b"],
             "weight": 1}]}]})
    for _ in range(8):
        status, _h, body = request(ports["core"], "POST", CHAT,
                                   {"model": "m"})
        assert status == 200 and json.loads(body)["marker"] == "B"
    assert up_a.seen == []


def test_weights_split_traffic(ports, servers, start_core):
    """Weights 1:3 over two live backends: both serve, the heavier more
    often (the core's weighted pick)."""
    a, b = servers("A", ports["up_a"]), servers("B", ports["up_b"])
    start_core({
        "listen_host": "127.0.0.1", "listen_port": ports["core"],
        "fallback_host": "127.0.0.1", "fallback_port": ports["fallback"],
        "endpoints": [CHAT],
        "rules": [{"model_exact": "m", "backends": [
            {"name": "a", "host": "127.0.0.1", "port": ports["up_a"],
             "weight": 1},
            {"name": "b", "host": "127.0.0.1", "port": ports["up_b"],
             "weight": 3}]}]})
    for _ in range(80):
        assert request(ports["core"], "POST", CHAT, {"model": "m"})[0] == 200
    assert len(a.seen) + len(b.seen) == 80
    assert 0 < len(a.seen) < len(b.seen)
    per = stats(ports["core"])["backends"]
    assert per["a"]["requests"] == len(a.seen)
    assert per["b"]["2xx"] == len(b.seen)


# -- TLS and the access log ----------------------------------------------


def _tls_cfg(core_port: int, tls_port: int, log=None) -> dict:
    cfg = {
        "listen_host": "127.0.0.1", "listen_port": core_port,
        "fallback_host": "127.0.0.1",
        "fallback_port": free_port(),  # nothing there: must not matter
        "endpoints": [CHAT],
        "rules": [{"model_exact": "m-tls", "backends": [{
            "name": "secure", "host": "127.0.0.1", "port": tls_port,
            "tls": True, "sni": "localhost"}]}],
    }
    if log is not None:
        cfg["access_log_path"] = str(log)
    return cfg


def test_tls_upstream_served_natively_with_usage(tmp_path, servers,
                                                 start_core):
    cert, key = make_self_signed(tmp_path)
    tls_port, core_port = free_port(), free_port()
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert, key)
    servers("TLS", tls_port, ssl_ctx=ctx)
    log = tmp_path / "core-access.log"
    start_core(_tls_cfg(core_port, tls_port, log),
               env={"AIGW_CORE_CA_FILE": cert})
    conn = HTTPConnection("127.0.0.1", core_port, timeout=10)
    for _ in range(2):  # keep-alive reuse of the TLS connection
        status, _h, body = request(conn, "POST", CHAT, {"model": "m-tls"})
        assert status == 200 and json.loads(body)["marker"] == "TLS"
    status, _h, body = request(conn, "POST", CHAT,
                               {"model": "m-tls", "stream": True})
    conn.close()
    assert status == 200 and body.decode().strip().endswith("data: [DONE]")
    st = stats(core_port)
    assert st["tls_available"] is True
    assert st["native_requests"] >= 3
    assert st["usage"]["total_tokens"] >= 14  # 2 x 7
    be = st["backends"]["secure"]
    assert be["requests"] >= 3 and be["2xx"] >= 3
    assert be["total_tokens"] >= 14
    lines = [json.loads(ln) for ln in log.read_text().splitlines()]
    assert len(lines) >= 3
    first = lines[0]
    assert first["native"] is True and first["model"] == "m-tls"
    assert first["backend"] == "secure" and first["status"] == 200
    assert first["usage"]["total_tokens"] == 7
    assert "duration_ms" in first


def test_bad_ca_fails_closed(tmp_path, servers, start_core):
    """TLS verification is real: without the CA the handshake fails and
    the request fails over to nothing (no insecure fallback)."""
    cert, key = make_self_signed(tmp_path)
    tls_port, core_port = free_port(), free_port()
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert, key)
    up = servers("TLS", tls_port, ssl_ctx=ctx)
    start_core(_tls_cfg(core_port, tls_port))
    status, _h, _b = request(core_port, "POST", CHAT, {"model": "m-tls"})
    assert status == 503
    assert up.seen == []


def _wait_entry(log, n: int = 1, timeout: float = 5.0) -> list:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if log.exists():
            lines = log.read_text().strip().splitlines()
            if len(lines) >= n:
                return [json.loads(x) for x in lines]
        time.sleep(0.02)
    raise AssertionError(f"fewer than {n} access-log lines")


def _log_cfg(ports, log) -> dict:
    return {
        "listen_host": "127.0.0.1", "listen_port": ports["core"],
        "fallback_host": "127.0.0.1", "fallback_port": ports["fallback"],
        "endpoints": [CHAT], "access_log_path": str(log),
        "rules": [{"model_exact": "m-a", "backends": [{
            "name": "a", "host": "127.0.0.1", "port": ports["up_a"],
            "weight": 1, "priority": 0}]}],
    }


def test_span_identity_and_result_in_log(ports, tmp_path, servers,
                                         start_core):
    def handler(h, _body):
        h._json(200, {"ok": True, "usage": {
            "prompt_tokens": 3, "completion_tokens": 4, "total_tokens": 7}})

    up = servers("A", ports["up_a"], handler=handler)
    log = tmp_path / "core-access.log"
    start_core(_log_cfg(ports, log))
    trace, parent = "ab" * 16, "cd" * 8
    status, _h, _b = request(ports["core"], "POST", CHAT, {"model": "m-a"},
                             headers={"traceparent":
                                      f"00-{trace}-{parent}-01"})
    assert status == 200
    entry = _wait_entry(log)[-1]
    # same trace, a new span, the request's span as its parent; the
    # upstream got the core's span as its parent
    assert entry["trace_id"] == trace and entry["parent_span_id"] == parent
    assert len(entry["span_id"]) == 16 and entry["span_id"] != parent
    assert entry["result"] == "complete" and entry["start_unix_ns"] > 0
    assert up.seen[0]["headers"]["traceparent"] == \
        f"00-{trace}-{entry['span_id']}-01"
    assert entry["usage"]["total_tokens"] == 7


def test_usage_scoped_to_usage_object(ports, tmp_path, servers, start_core):
    """Content that mentions ``"prompt_tokens": 999`` does not override
    the real usage object."""
    def handler(h, _body):
        h._json(200, {
            "choices": [{"message": {"content":
                         'the usage was {"prompt_tokens": 999, '
                         '"completion_tokens": 888, "total_tokens": 1887}'}}],
            "usage": {"prompt_tokens": 3, "completion_tokens": 4,
                      "total_tokens": 7}})

    servers("A", ports["up_a"], handler=handler)
    log = tmp_path / "core-access.log"
    start_core(_log_cfg(ports, log))
    assert request(ports["core"], "POST", CHAT, {"model": "m-a"})[0] == 200
    assert _wait_entry(log)[-1]["usage"] == {
        "prompt_tokens": 3, "completion_tokens": 4, "total_tokens": 7}


def test_anthropic_split_usage_mined(ports, tmp_path, servers, start_core):
    """Anthropic's stream puts input_tokens in message_start's usage and
    output_tokens alone in message_delta's: both are recovered."""
    def handler(h, _body):
        h.send_response(200)
        h.send_header("content-type", "text/event-stream")
        h.send_header("transfer-encoding", "chunked")
        h.end_headers()
        h._chunk(b'event: message_start\ndata: {"type":"message_start",'
                 b'"message":{"usage":{"input_tokens":11,'
                 b'"output_tokens":1}}}\n\n')
        h._chunk(b'event: message_delta\ndata: {"type":"message_delta",'
                 b'"usage":{"output_tokens":9}}\n\n')
        h.wfile.write(b"0\r\n\r\n")
        h.wfile.flush()

    servers("A", ports["up_a"], handler=handler)
    log = tmp_path / "core-access.log"
    start_core(_log_cfg(ports, log))
    assert request(ports["core"], "POST", CHAT, {"model": "m-a"})[0] == 200
    usage = _wait_entry(log)[-1]["usage"]
    assert usage == {"prompt_tokens": 11, "completion_tokens": 9,
                     "total_tokens": 20}


def test_untraced_request_gets_a_fresh_trace(ports, tmp_path, servers,
                                             start_core):
    up = servers("A", ports["up_a"])
    log = tmp_path / "core-access.log"
    start_core(_log_cfg(ports, log))
    for _ in range(2):
        assert request(ports["core"], "POST", CHAT,
                       {"model": "m-a"})[0] == 200
    a, b = _wait_entry(log, 2)[-2:]
    assert len(a["trace_id"]) == 32 and a["trace_id"] != b["trace_id"]
    assert "parent_span_id" not in a  # no parent to name
    assert up.seen[0]["headers"]["traceparent"] == \
        f"00-{a['trace_id']}-{a['span_id']}-01"
