"""The gateway's client fronts onto port replicas: the port's gateway and
the reference's (aiohttp) over the same tiny-random CPU port replicas
and the same standard-library fake media upstream, with one config and
one request script. Held equal with ids and timestamps masked:
``/v1/messages`` and ``/v1/responses`` streamed and not (a stream's
token deltas merged, since how many tokens a replica frame carries
follows its emit timing), ``previous_response_id`` chains in memory and
over one ``AIGW_RESPONSES_DIR`` shared by both gateways, ``/tokenize``,
image generation, speech, the multipart audio routes (the model part
rewritten for a backend's model override) and ``/v2/rerank``, and the
files/batches proxy end to end. Then the replica's HTTP repairs: its
accepted sockets set ``TCP_NODELAY``, its SSE body is chunked and its
connection kept, and the gateway streams over pooled connections."""

import asyncio
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from aigw_tpu.config import model as jmodel
from aigw_tpu.config import runtime as jruntime
from aigw_tpu.gateway import server as jserver
from aigw_tpu.translate import responses as jresponses
from aigw_tpu_torch.config import model as tmodel
from aigw_tpu_torch.config import runtime as truntime
from aigw_tpu_torch.gateway import server as tserver
from aigw_tpu_torch.translate import responses as tresponses

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = "tiny-random"


def _replica():
    from aigw_tpu_torch.tpuserve.engine import EngineConfig
    from aigw_tpu_torch.tpuserve.server import TPUServeServer

    srv = TPUServeServer(
        MODEL, EngineConfig(max_batch_size=4, max_seq_len=256, page_size=16,
                            enable_prefix_cache=False),
        device="cpu", port=0, param_dtype="float32")
    srv.start()
    return srv


class _Media(BaseHTTPRequestHandler):
    """A self-hosted OpenAI- and Cohere-schema media upstream: images,
    speech, the two multipart audio routes and rerank; every request is
    kept in ``server.seen`` as (path, content type, body)."""

    protocol_version = "HTTP/1.1"

    def do_POST(self):
        raw = self.rfile.read(int(self.headers.get("content-length", 0)))
        self.server.seen.append(
            (self.path, self.headers.get("content-type", ""), raw))
        ctype = "application/json"
        if self.path == "/v1/images/generations":
            body = json.dumps({"created": 1, "data": [
                {"url": "http://img/1", "revised_prompt": "a cat"}]})
        elif self.path == "/v1/audio/speech":
            body, ctype = b"\x00\x01binary-mp3", "audio/mpeg"
        elif self.path.startswith("/v1/audio/"):
            body = json.dumps({"text": "hello world"})
        elif self.path == "/v1/chat/completions":
            # a chat reply whose usage cannot be a Responses usage
            body = json.dumps({"model": "broken", "choices": [
                {"index": 0, "message": {"role": "assistant",
                                         "content": "hi"},
                 "finish_reason": "stop"}],
                "usage": {"prompt_tokens": -5, "completion_tokens": 1}})
        elif self.path == "/v2/rerank":
            body = json.dumps({"id": "rr-1", "results": [
                {"index": 1, "relevance_score": 0.9},
                {"index": 0, "relevance_score": 0.2}],
                "meta": {"billed_units": {"input_tokens": 7}}})
        else:
            body = json.dumps({"error": "no route"})
        body = body if isinstance(body, bytes) else body.encode()
        self.send_response(200)
        self.send_header("content-type", ctype)
        self.send_header("content-length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


@pytest.fixture(scope="module")
def replicas():
    a, b = _replica(), _replica()
    yield a, b
    a.stop()
    b.stop()


@pytest.fixture(scope="module")
def media():
    fake = ThreadingHTTPServer(("127.0.0.1", 0), _Media)
    fake.seen = []
    threading.Thread(target=fake.serve_forever, daemon=True).start()
    yield fake
    fake.shutdown()
    fake.server_close()


@pytest.fixture(scope="module")
def loop():
    lp = asyncio.new_event_loop()
    t = threading.Thread(target=lp.run_forever, daemon=True)
    t.start()
    yield lp
    lp.call_soon_threadsafe(lp.stop)
    t.join(timeout=10)


def _on(loop, coro, timeout=60):
    return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout)


class _Gateways:
    """Both gateways on one config, in the test's event loop thread."""

    def __init__(self, loop, raw):
        self.loop = loop

        async def start():
            jsrv, runner = await jserver.run_gateway(
                jruntime.RuntimeConfig.build(jmodel.Config.parse(raw)),
                port=0)
            tsrv = await tserver.run_gateway(
                truntime.RuntimeConfig.build(tmodel.Config.parse(raw)),
                port=0)
            return jsrv, runner, tsrv

        self.jsrv, self.runner, self.tsrv = _on(loop, start())
        self.ports = {"ref": self.runner.addresses[0][1],
                      "port": self.tsrv.port}

    def close(self):
        async def stop():
            await self.runner.cleanup()
            await self.tsrv.stop()

        _on(self.loop, stop())


def _config(addrs, media_port):
    media_url = f"http://127.0.0.1:{media_port}"
    return {
        "version": "v1",
        "backends": [
            {"name": "pool", "schema": "TPUServe",
             "endpoints": [{"address": a, "slice": "s0"} for a in addrs],
             "picker_poll_interval": 0.1, "picker_content_affinity": True},
            {"name": "media", "schema": "OpenAI", "url": media_url},
            {"name": "media-big", "schema": "OpenAI", "url": media_url,
             "model_name_override": "whisper-large"},
            {"name": "rr", "schema": "Cohere", "url": media_url},
            {"name": "broken", "schema": "TPUServe", "url": media_url},
        ],
        "routes": [{"name": "r", "rules": [
            {"model_prefixes": ["tiny"], "backends": ["pool"]},
            {"models": ["dall-e-3", "tts-1", "whisper-1"],
             "backends": ["media"]},
            {"models": ["whisper-2"], "backends": ["media-big"]},
            {"models": ["rerank-v3"], "backends": ["rr"]},
            {"models": ["broken-model"], "backends": ["broken"]}]}],
        "models": [MODEL],
    }


def _http(port, path, body=None, headers=None, method=None, raw=None):
    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, method=method,
        headers={"content-type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


_MASKED = ("id", "created", "created_at", "sequence_number",
           "in_progress_at", "completed_at", "finalizing_at",
           "expires_at", "input_file_id", "output_file_id",
           "error_file_id", "request_id", "tool_call_id", "call_id",
           "hbm_page_byte_s", "host_page_byte_s", "t0", "t1", "ts")


def _mask(obj):
    if isinstance(obj, dict):
        return {k: "*" if k in _MASKED else _mask(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_mask(v) for v in obj]
    return obj


def _events(raw):
    """An SSE body as (event name, masked payload) pairs, each run of
    text deltas (Anthropic ``text_delta``, Responses
    ``response.output_text.delta``, chat content) merged into one."""
    out = []
    for frame in raw.decode().split("\n\n"):
        if not frame.strip():
            continue
        name, data = "", []
        for line in frame.splitlines():
            k, _, v = line.partition(": ")
            if k == "event":
                name = v
            elif k == "data":
                data.append(v)
        text = "\n".join(data)
        payload = text if text == "[DONE]" else _mask(json.loads(text))
        prev = out[-1] if out else None
        if prev is not None and prev[0] == name and _merge(prev[1], payload):
            continue
        out.append((name, payload))
    return out


def _merge(into, ev) -> bool:
    """Fold delta event ``ev`` into the previous one of its kind."""
    if not isinstance(ev, dict) or not isinstance(into, dict):
        return False
    if ev.get("type") == "content_block_delta" and \
            ev["delta"].get("type") == "text_delta" and \
            into.get("index") == ev.get("index"):
        into["delta"]["text"] += ev["delta"]["text"]
        return True
    if ev.get("type") == "response.output_text.delta":
        into["delta"] += ev["delta"]
        return True
    return False


def _reply(status, headers, raw):
    ctype = {k.lower(): v for k, v in headers.items()}.get("content-type",
                                                            "")
    if "text/event-stream" in ctype:
        return status, "sse", _events(raw)
    try:
        return status, "json", _mask(json.loads(raw))
    except ValueError:
        return status, ctype.split(";")[0], raw


def _fleet_ready(gw, n):
    end = time.monotonic() + 30
    while time.monotonic() < end:
        ok = True
        for port in gw.ports.values():
            st = json.loads(_http(port, "/fleet/state")[2])
            reps = st["backends"]["pool"]["replicas"]
            ok &= sum(r["health"]["state"] == "up"
                      for r in reps.values()) >= n
        if ok:
            return
        time.sleep(0.05)
    raise AssertionError("replicas not up on both gateways")


@pytest.fixture(scope="module")
def gw(replicas, media, loop):
    addrs = [f"127.0.0.1:{r.port}" for r in replicas]
    g = _Gateways(loop, _config(addrs, media.server_address[1]))
    _fleet_ready(g, 2)
    yield g
    g.close()


def _messages(**kw):
    return {"model": MODEL, "max_tokens": 6, "temperature": 0,
            "system": "be brief",
            "messages": [{"role": "user", "content": "hello there"}], **kw}


def _responses(**kw):
    return {"model": MODEL, "input": "hello there",
            "instructions": "be brief", "max_output_tokens": 6,
            "temperature": 0, **kw}


MESSAGES = "/v1/messages"
RESPONSES = "/v1/responses"
SCRIPT = [
    (MESSAGES, _messages()),
    (MESSAGES, _messages(stream=True)),
    (MESSAGES, _messages(stop_sequences=["zz"], messages=[
        {"role": "user", "content": [{"type": "text", "text": "a"}]},
        {"role": "assistant", "content": "b"},
        {"role": "user", "content": "c"}])),
    (RESPONSES, _responses()),
    (RESPONSES, _responses(stream=True)),
    (RESPONSES, _responses(input=[
        {"role": "user", "content": [{"type": "input_text",
                                      "text": "hi"}]}], store=False)),
    ("/tokenize", {"model": MODEL, "prompt": "hello there"}),
    ("/tokenize", {"model": MODEL, "messages": [
        {"role": "user", "content": "hello"}]}),
    # refusals: the Anthropic envelope, the typed Responses checks, an
    # unknown previous response (404), an unrouted model
    (MESSAGES, {"model": MODEL, "messages": [
        {"role": "user", "content": "x"}]}),
    (MESSAGES, _messages(model="claude-nope")),
    (RESPONSES, _responses(temperature=5)),
    (RESPONSES, _responses(previous_response_id="resp_nope")),
    ("/tokenize", {"model": MODEL, "prompt": "a", "messages": []}),
]


def test_fronts_match_reference_gateway(gw):
    got = {n: [_reply(*_http(p, path, body)) for path, body in SCRIPT]
           for n, p in gw.ports.items()}
    for i, (want, have) in enumerate(zip(got["ref"], got["port"])):
        assert have == want, (i, SCRIPT[i][0])
    statuses = [s for s, _k, _b in got["port"]]
    assert statuses == [200] * 8 + [400, 404, 400, 404, 400]
    # the Anthropic stream's event order, merged
    names = [e for e, _p in got["port"][1][2]]
    assert names == ["message_start", "content_block_start",
                     "content_block_delta", "content_block_stop",
                     "message_delta", "message_stop"]
    assert got["port"][8][2]["type"] == "error"
    mt = {n: _http(p, "/metrics")[2].decode() for n, p in gw.ports.items()}
    ops = {n: sorted(set(re.findall(r'gen_ai_operation_name="(\w+)"', t)))
           for n, t in mt.items()}
    assert ops["port"] == ops["ref"]
    assert {"chat", "responses", "tokenize"} <= set(ops["port"])


def test_messages_and_responses_equal_chat(gw):
    """Through the port's gateway, a Messages and a Responses request
    carry the text and usage of the same prompt sent as chat."""
    port = gw.ports["port"]
    chat = json.loads(_http(port, "/v1/chat/completions", {
        "model": MODEL, "max_tokens": 6, "temperature": 0, "messages": [
            {"role": "system", "content": "be brief"},
            {"role": "user", "content": "hello there"}]})[2])
    text = chat["choices"][0]["message"]["content"]
    msg = json.loads(_http(port, MESSAGES, _messages())[2])
    assert msg["content"] == [{"type": "text", "text": text}]
    assert msg["usage"] == {
        "input_tokens": chat["usage"]["prompt_tokens"],
        "output_tokens": chat["usage"]["completion_tokens"]}
    resp = json.loads(_http(port, RESPONSES, _responses())[2])
    assert resp["output_text"] == text
    assert resp["usage"]["output_tokens"] == \
        chat["usage"]["completion_tokens"]


def _completed(raw):
    """The ``response`` of a Responses stream's ``response.completed``."""
    for frame in raw.decode().split("\n\n"):
        if "event: response.completed" in frame:
            data = frame.split("data: ", 1)[1]
            return json.loads(data)["response"]
    raise AssertionError(raw)


def _chain(port, first_body):
    """Turn one (streamed or not), then turn two by
    ``previous_response_id``."""
    raw = _http(port, RESPONSES, first_body)[2]
    one = _completed(raw) if first_body.get("stream") else json.loads(raw)
    two = _http(port, RESPONSES, _responses(
        input="and then?", previous_response_id=one["id"]))
    return one, two


@pytest.mark.parametrize("stream", [False, True],
                         ids=["unary", "streamed-first"])
def test_previous_response_id_chain(gw, stream):
    got = {}
    for name, port in gw.ports.items():
        one, two = _chain(port, _responses(stream=stream))
        assert two[0] == 200, two
        got[name] = (_mask(one), _reply(*two))
    assert got["port"] == got["ref"]
    # turn two equals the chat with turn one's transcript spelled out
    port = gw.ports["port"]
    text1 = got["port"][0]["output_text"]
    chat = json.loads(_http(port, "/v1/chat/completions", {
        "model": MODEL, "max_tokens": 6, "temperature": 0, "messages": [
            {"role": "system", "content": "be brief"},
            {"role": "user", "content": "hello there"},
            {"role": "assistant", "content": text1},
            {"role": "user", "content": "and then?"}]})[2])
    assert got["port"][1][2]["output_text"] == \
        chat["choices"][0]["message"]["content"]


@pytest.fixture
def shared_dir(tmp_path):
    """Both packages' transcript stores on one directory, as two
    gateways given one ``AIGW_RESPONSES_DIR``."""
    saved = (jresponses.RESPONSE_STORE._impl,
             tresponses.RESPONSE_STORE._impl)
    jresponses.RESPONSE_STORE._impl = jresponses.FileResponseStore(
        str(tmp_path))
    tresponses.RESPONSE_STORE._impl = tresponses.FileResponseStore(
        str(tmp_path))
    yield tmp_path
    jresponses.RESPONSE_STORE._impl, tresponses.RESPONSE_STORE._impl = saved


@pytest.mark.parametrize("first,second", [("ref", "port"), ("port", "ref")])
def test_shared_responses_dir_continues_across_packages(gw, shared_dir,
                                                        first, second):
    one = json.loads(_http(gw.ports[first], RESPONSES, _responses())[2])
    assert (shared_dir / f"{one['id']}.json").exists()
    s, h, raw = _http(gw.ports[second], RESPONSES, _responses(
        input="and then?", previous_response_id=one["id"]))
    assert s == 200, raw
    mine = _chain(gw.ports[second], _responses())[1]
    assert _reply(s, h, raw) == _reply(*mine)
    # store: false leaves no file; an unknown id is a 404 on both
    off = json.loads(_http(gw.ports[first], RESPONSES,
                           _responses(store=False))[2])
    assert not (shared_dir / f"{off['id']}.json").exists()
    assert _http(gw.ports[second], RESPONSES, _responses(
        previous_response_id=off["id"]))[0] == 404


def test_malformed_responses_reply_rolls_back_its_transcript(gw, shared_dir):
    """An upstream chat reply that maps to a malformed Responses body is
    a 502 on both gateways, and the transcript stored under the id the
    client never saw is deleted."""
    got = {n: _reply(*_http(p, RESPONSES, _responses(model="broken-model")))
           for n, p in gw.ports.items()}
    assert got["port"] == got["ref"]
    assert got["port"][0] == 502
    assert "input_tokens" in got["port"][2]["error"]["message"]
    assert list(shared_dir.iterdir()) == []


def _multipart(model, boundary="XyZ"):
    b = boundary.encode()
    return (b"--" + b + b'\r\nContent-Disposition: form-data; name="model"'
            b"\r\n\r\n" + model.encode() + b"\r\n--" + b
            + b'\r\nContent-Disposition: form-data; name="file"; '
            b'filename="a.wav"\r\nContent-Type: audio/wav\r\n\r\n'
            b"RIFF....fake-audio\x00\xff\r\n--" + b + b"--\r\n",
            f"multipart/form-data; boundary={boundary}")


MEDIA = [
    ("/v1/images/generations", {"model": "dall-e-3", "prompt": "a cat"}),
    ("/v1/audio/speech", {"model": "tts-1", "input": "hi",
                          "voice": "alloy"}),
    ("/v1/audio/transcriptions", _multipart("whisper-1")),
    ("/v1/audio/translations", _multipart("whisper-2")),
    ("/v2/rerank", {"model": "rerank-v3", "query": "q",
                    "documents": ["a", {"text": "b"}], "top_n": 2}),
    # refusals: a typed check each, a multipart body with no model part
    ("/v1/images/generations", {"model": "dall-e-3", "prompt": "",
                                "n": 11}),
    ("/v2/rerank", {"model": "rerank-v3", "query": "q",
                    "documents": []}),
    ("/v1/audio/transcriptions", (b"not-multipart",
                                  "multipart/form-data; boundary=xyz")),
]


def test_media_routes_match_reference(gw, media):
    got = {}
    seen = {}
    for name, port in gw.ports.items():
        media.seen.clear()
        got[name] = []
        for path, body in MEDIA:
            if isinstance(body, tuple):
                r = _http(port, path, raw=body[0],
                          headers={"content-type": body[1]})
            else:
                r = _http(port, path, body)
            got[name].append(_reply(*r))
        seen[name] = list(media.seen)
    assert got["port"] == got["ref"]
    assert [s for s, _k, _b in got["port"]] == [200] * 5 + [400] * 3
    assert got["port"][1] == (200, "audio/mpeg", b"\x00\x01binary-mp3")
    # the upstream saw the same requests: the multipart bytes verbatim,
    # the model part rewritten for the backend's override
    assert seen["port"] == seen["ref"]
    paths = [p for p, _c, _b in seen["port"]]
    assert paths == [p for p, _b in MEDIA[:5]]
    assert seen["port"][2][2] == MEDIA[2][1][0]
    assert b"whisper-large" in seen["port"][3][2]
    assert b"whisper-2" not in seen["port"][3][2]
    mt = {n: _http(p, "/metrics")[2].decode() for n, p in gw.ports.items()}
    ops = {n: sorted(set(re.findall(r'gen_ai_operation_name="(\w+)"', t)))
           for n, t in mt.items()}
    assert ops["port"] == ops["ref"]
    assert {"image_generation", "audio_speech", "audio_transcription",
            "audio_translation", "rerank"} <= set(ops["port"])


def _jsonl(n):
    return b"\n".join(json.dumps({
        "custom_id": f"c{i}", "method": "POST",
        "url": "/v1/chat/completions",
        "body": {"model": MODEL, "max_tokens": 4, "temperature": 0,
                 "messages": [{"role": "user", "content": f"line {i}"}]}
    }).encode() for i in range(n))


def _batch_run(port, replicas):
    """Upload, create, poll to the end, fetch: (the replies masked, the
    batch's replica, the output lines)."""
    out = []
    s, _h, raw = _http(port, "/v1/files", raw=_jsonl(2),
                       headers={"content-type": "application/jsonl"})
    out.append((s, _mask(json.loads(raw))))
    fid = json.loads(raw)["id"]
    s, _h, raw = _http(port, "/v1/batches", {
        "input_file_id": fid, "endpoint": "/v1/chat/completions"})
    out.append((s, _mask(json.loads(raw))))
    bid = json.loads(raw)["id"]
    end = time.monotonic() + 120
    while True:
        s, _h, raw = _http(port, f"/v1/batches/{bid}")
        b = json.loads(raw)
        if b["status"] in ("completed", "failed", "cancelled") \
                or time.monotonic() > end:
            break
        time.sleep(0.1)
    out.append((s, _mask(b)))
    s, _h, content = _http(port, f"/v1/files/{b['output_file_id']}/content")
    lines = [json.loads(x) for x in content.splitlines() if x.strip()]
    out.append((s, _mask(lines)))
    # the batch lives on one replica: the poll and the fetch landed there
    holders = [r for r in replicas
               if _http(r.port, f"/v1/batches/{bid}")[0] == 200]
    out.append(_mask(json.loads(_http(
        port, f"/v1/batches/{bid}/cancel", {})[2])))
    return out, holders, lines


def test_batch_proxy_matches_reference(gw, replicas):
    got = {}
    for name, port in gw.ports.items():
        got[name], holders, lines = _batch_run(port, replicas)
        assert len(holders) == 1, name
        assert [x["custom_id"] for x in lines] == ["c0", "c1"]
        assert got[name][2][1]["status"] == "completed"
    assert got["port"] == got["ref"]
    # each line equals the same request served directly
    direct = json.loads(_http(replicas[0].port, "/v1/chat/completions", {
        "model": MODEL, "max_tokens": 4, "temperature": 0,
        "messages": [{"role": "user", "content": "line 0"}]})[2])
    assert lines[0]["response"]["body"]["choices"] == direct["choices"]
    # an unknown id: the port's gateway answers 404 in the OpenAI
    # envelope; the reference's batch handlers name an unbound
    # ``error_body`` there and answer aiohttp's 500
    for path, method in (("/v1/batches/batch_nope", "GET"),
                         ("/v1/batches/batch_nope/cancel", "POST"),
                         ("/v1/files/file-nope/content", "GET")):
        s, _h, raw = _http(gw.ports["port"], path, method=method,
                           raw=b"{}" if method == "POST" else None)
        assert s == 404 and "unknown batch object" in \
            json.loads(raw)["error"]["message"], path
        assert _http(gw.ports["ref"], path, method=method,
                     raw=b"{}" if method == "POST" else None)[0] == 500


def test_batch_proxy_without_a_pool_is_503(loop):
    raw = {"version": "v1",
           "backends": [{"name": "a", "schema": "OpenAI",
                         "url": "http://127.0.0.1:1"}],
           "routes": [{"name": "r", "rules": [{"backends": ["a"]}]}]}
    g = _Gateways(loop, raw)
    try:
        for path in ("/v1/files", "/v1/batches"):
            s, _h, body = _http(g.ports["port"], path, raw=b"{}")
            assert s == 503, path
            assert json.loads(body)["error"]["type"] == "server_error"
            # the reference's NameError, as above
            assert _http(g.ports["ref"], path, raw=b"{}")[0] == 500
    finally:
        g.close()


# -- the replica's HTTP repairs ---------------------------------------------
def _accepts(monkeypatch, srv):
    """Every connection the replica accepts, with its TCP_NODELAY."""
    handler = srv.httpd.RequestHandlerClass
    setup = handler.setup
    seen = []

    def counted(self):
        setup(self)
        seen.append(self.connection.getsockopt(socket.IPPROTO_TCP,
                                               socket.TCP_NODELAY))

    monkeypatch.setattr(handler, "setup", counted)
    return seen


def test_replica_sets_nodelay_and_keepalive_is_fast(replicas, monkeypatch):
    import http.client

    a, _b = replicas
    seen = _accepts(monkeypatch, a)
    conn = http.client.HTTPConnection("127.0.0.1", a.port, timeout=30)
    times = []
    for _ in range(20):
        t = time.perf_counter()
        conn.request("GET", "/health")
        r = conn.getresponse()
        assert r.status == 200
        r.read()
        times.append(time.perf_counter() - t)
    conn.close()
    assert seen == [1]  # one connection, TCP_NODELAY set
    times.sort()
    # with Nagle on, the body waited for the delayed ACK: ~40 ms a reply
    assert times[len(times) // 2] < 0.02, times


def _read_chunked(sock_file):
    """(the chunk payloads, the bytes after the last chunk's CRLF)."""
    chunks = []
    while True:
        size = int(sock_file.readline().split(b";")[0], 16)
        if size == 0:
            assert sock_file.readline() == b"\r\n"
            return chunks
        chunks.append(sock_file.read(size))
        assert sock_file.read(2) == b"\r\n"


def test_replica_stream_is_chunked_and_keeps_its_connection(replicas):
    """Two streamed requests and a GET on one socket: each stream's head
    names chunked transfer and no close, each chunk holds whole SSE
    frames, the last chunk ends the body, and the connection answers the
    next request."""
    a, _b = replicas
    body = json.dumps({"model": MODEL, "max_tokens": 5, "stream": True,
                       "messages": [{"role": "user", "content": "hi"}]})
    sock = socket.create_connection(("127.0.0.1", a.port), timeout=60)
    f = sock.makefile("rb")
    try:
        for path in ("/v1/chat/completions", "/v1/completions"):
            b = body if path.endswith("chat/completions") else json.dumps(
                {"model": MODEL, "max_tokens": 5, "stream": True,
                 "prompt": "hi"})
            sock.sendall(
                f"POST {path} HTTP/1.1\r\nhost: x\r\n"
                f"content-type: application/json\r\n"
                f"content-length: {len(b)}\r\n\r\n".encode() + b.encode())
            head = b""
            while not head.endswith(b"\r\n\r\n"):
                head += f.readline()
            low = head.lower()
            assert b"transfer-encoding: chunked" in low
            assert b"connection: close" not in low
            chunks = _read_chunked(f)
            assert all(c.endswith(b"\n\n") and c.startswith(b"data: ")
                       for c in chunks)
            assert b"".join(chunks).endswith(b"data: [DONE]\n\n")
        sock.sendall(b"GET /health HTTP/1.1\r\nhost: x\r\n\r\n")
        assert f.readline().startswith(b"HTTP/1.1 200")
    finally:
        f.close()
        sock.close()


def test_replica_stream_to_http10_client_ends_with_the_close(replicas):
    """An HTTP/1.0 client reads no chunks: its stream's head names no
    chunked transfer and asks to close, the body is the raw SSE frames
    ending in ``[DONE]``, and the replica closes the connection after
    it."""
    a, _b = replicas
    b = json.dumps({"model": MODEL, "max_tokens": 5, "stream": True,
                    "messages": [{"role": "user", "content": "hi"}]})
    sock = socket.create_connection(("127.0.0.1", a.port), timeout=60)
    try:
        sock.sendall(
            f"POST /v1/chat/completions HTTP/1.0\r\nhost: x\r\n"
            f"content-type: application/json\r\n"
            f"content-length: {len(b)}\r\n\r\n".encode() + b.encode())
        raw = b""
        while chunk := sock.recv(65536):  # to the replica's close
            raw += chunk
    finally:
        sock.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    low = head.lower()
    assert low.split(b"\r\n")[0].endswith(b" 200 ok")
    assert b"transfer-encoding" not in low
    assert b"connection: close" in low
    frames = [f for f in body.split(b"\n\n") if f]
    assert frames and all(f.startswith(b"data: ") for f in frames)
    assert body.endswith(b"data: [DONE]\n\n")


def test_gateway_streams_reuse_pooled_connections(replicas, loop,
                                                  monkeypatch):
    """Eight streamed requests through the port's gateway open at most
    two connections to the replica (they reuse the pooled one)."""
    a, _b = replicas
    g = _Gateways(loop, _config([f"127.0.0.1:{a.port}"], 1))
    try:
        _fleet_ready(g, 1)
        seen = _accepts(monkeypatch, a)
        for i in range(8):
            s, _h, raw = _http(g.ports["port"], "/v1/chat/completions", {
                "model": MODEL, "max_tokens": 3, "stream": True,
                "messages": [{"role": "user", "content": f"q{i}"}]})
            assert s == 200 and raw.endswith(b"data: [DONE]\n\n")
        assert 1 <= len(seen) <= 2, seen
    finally:
        g.close()


class _TornChunked(BaseHTTPRequestHandler):
    """An upstream whose chunked SSE body stops before its last chunk:
    two frames, then the connection closes."""

    protocol_version = "HTTP/1.1"

    def do_POST(self):
        self.rfile.read(int(self.headers.get("content-length", 0)))
        self.send_response(200)
        self.send_header("content-type", "text/event-stream")
        self.send_header("transfer-encoding", "chunked")
        self.end_headers()
        for frame in self.server.frames:
            self.wfile.write(b"%x\r\n%s\r\n" % (len(frame), frame))
        self.close_connection = True

    def log_message(self, *a):
        pass


@pytest.mark.parametrize("path,body", [
    ("/v1/chat/completions", {"model": "m", "stream": True, "messages": [
        {"role": "user", "content": "x"}]}),
    (MESSAGES, {"model": "m", "stream": True, "max_tokens": 4,
                "messages": [{"role": "user", "content": "x"}]}),
], ids=["chat", "messages"])
def test_torn_chunked_stream_ends_with_the_error_event(loop, path, body):
    """A chunked upstream stream torn before its last chunk (a replica
    killed mid-stream) ends with the front schema's error event on both
    gateways, never as a finished stream."""
    chunk = {"id": "c", "object": "chat.completion.chunk", "created": 1,
             "model": "m", "choices": [{"index": 0, "delta": {
                 "content": "hi"}, "finish_reason": None}]}
    fake = ThreadingHTTPServer(("127.0.0.1", 0), _TornChunked)
    fake.frames = [b"data: " + json.dumps(chunk).encode() + b"\n\n"] * 2
    threading.Thread(target=fake.serve_forever, daemon=True).start()
    raw = {"version": "v1",
           "backends": [{"name": "up", "schema": "TPUServe",
                         "url": f"http://127.0.0.1:{fake.server_address[1]}"}],
           "routes": [{"name": "r", "rules": [{"backends": ["up"]}]}]}
    g = _Gateways(loop, raw)
    try:
        got = {n: _http(p, path, body) for n, p in g.ports.items()}
        assert _reply(*got["port"]) == _reply(*got["ref"])
        text = got["port"][2]
        assert text.count(b"upstream stream interrupted") == 1, text
        assert b"[DONE]" not in text and b"message_stop" not in text
    finally:
        g.close()
        fake.shutdown()
        fake.server_close()


def test_cli_run_serves_the_fronts(replicas, media, tmp_path):
    """``python -m aigw_tpu_torch run`` accepts a config routing the new
    endpoints and serves Messages, Responses and a batch upload."""
    a, _b = replicas
    cfg = tmp_path / "gw.json"
    cfg.write_text(json.dumps(_config([f"127.0.0.1:{a.port}"],
                                      media.server_address[1])))
    env = dict(os.environ, AIGW_DRAIN_SECONDS="0")
    proc = subprocess.Popen(
        [sys.executable, "-m", "aigw_tpu_torch", "run", str(cfg),
         "--port", "0"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        m = re.search(r"gateway listening on http://[\d.]+:(\d+)", line)
        assert m, (line, proc.stderr.read() if proc.poll() else "")
        port = int(m.group(1))
        end = time.monotonic() + 30
        while json.loads(_http(port, "/fleet/state")[2])["backends"][
                "pool"]["rollup"]["replicas_up"] < 1:
            assert time.monotonic() < end
            time.sleep(0.05)
        s, _h, raw = _http(port, MESSAGES, _messages())
        assert s == 200 and json.loads(raw)["type"] == "message"
        s, _h, raw = _http(port, RESPONSES, _responses(stream=True))
        assert s == 200 and b"response.completed" in raw
        s, _h, raw = _http(port, "/v1/files", raw=_jsonl(1))
        assert s == 200 and json.loads(raw)["id"]
    finally:
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        proc.stdout.close()
        proc.stderr.close()
