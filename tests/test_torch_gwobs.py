"""The gateway's observability against the JAX package's: the OpenInference
builders under every ``OPENINFERENCE_HIDE_*`` knob, ``StreamAccumulator``
on SSE split at seeded byte points, ``AccessLogger``'s lines, the header
attribute mapping and the error types; then both gateways, tracing on and
exporting OTLP ``http/json`` to one standard-library collector, in front
of one traced CPU port replica: for chat, completions, embeddings and
Messages, streamed and not, each gateway's span (name, attributes, parent
link, status) and the replica's span as its child, the access-log lines
(rejections included) joined to the spans by their ids, ``/debug/config``
and ``/debug/stacks`` under ``AIGW_ENABLE_DEBUG`` and 404 without; with
tracing off the caller's trace context still reaches the replica."""

import asyncio
import json
import random
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from aigw_tpu.config import model as jmodel
from aigw_tpu.config import runtime as jruntime
from aigw_tpu.gateway import server as jserver
from aigw_tpu.obs import accesslog as jaccess
from aigw_tpu.obs import openinference as joi
from aigw_tpu.obs import tracing as jtracing
from aigw_tpu_torch.config import model as tmodel
from aigw_tpu_torch.config import runtime as truntime
from aigw_tpu_torch.gateway import server as tserver
from aigw_tpu_torch.obs import accesslog as taccess
from aigw_tpu_torch.obs import openinference as toi
from aigw_tpu_torch.obs import tracing as ttracing

MODEL = "tiny-random"

# -- the builders ---------------------------------------------------------------
CHAT_REQ = {
    "model": "m", "temperature": 0.5, "stream": False,
    "messages": [
        {"role": "system", "content": "be helpful"},
        {"role": "user", "content": [
            {"type": "text", "text": "what is this?"},
            {"type": "image_url", "image_url": {"url": "https://x/i.png"}},
            {"type": "image_url",
             "image_url": {"url": "data:image/png;base64," + "A" * 64}}]},
        {"role": "assistant", "tool_calls": [
            {"id": "call_1", "type": "function",
             "function": {"name": "f", "arguments": "{\"a\":1}"}}]},
        "not a message"],
    "tools": [{"type": "function", "function": {"name": "f",
                                                "parameters": {}}}]}
CHAT_RESP = {
    "id": "c1", "model": "m-2024", "choices": [
        {"index": 0, "message": {"role": "assistant", "content": "hi",
                                 "tool_calls": [{"id": "t1", "function": {
                                     "name": "g", "arguments": "{}"}}]},
         "finish_reason": "stop"},
        {"index": 1, "message": {"role": "assistant", "content": ""}}],
    "usage": {"prompt_tokens": 5, "completion_tokens": 2,
              "prompt_tokens_details": {"cached_tokens": 3,
                                        "audio_tokens": 1},
              "completion_tokens_details": {"reasoning_tokens": 1}}}
ANTH_REQ = {"model": "claude", "max_tokens": 8, "system": "s",
            "messages": [{"role": "user", "content": "hello"}]}
ANTH_RESP = {
    "id": "msg_1", "model": "claude", "role": "assistant", "content": [
        {"type": "text", "text": "a"}, {"type": "text", "text": "b"},
        {"type": "tool_use", "id": "tu1", "name": "f", "input": {"x": 1}}],
    "usage": {"input_tokens": 4, "output_tokens": 3,
              "cache_read_input_tokens": 2,
              "cache_creation_input_tokens": 1}}
EMB_REQ = {"model": "e", "input": ["a", 7, "b"], "dimensions": 8}
EMB_RESP = {"model": "e", "data": [{"embedding": [0.5, 1]},
                                   {"embedding": []}],
            "usage": {"prompt_tokens": 3, "total_tokens": 3}}
TEXT_REQ = {"model": "m", "prompt": ["one", "two", 3], "max_tokens": 4}
TEXT_RESP = {"model": "m", "choices": [{"index": 0, "text": "x"},
                                       {"index": 1, "text": ""}],
             "usage": {"prompt_tokens": 2, "completion_tokens": 1,
                       "total_tokens": 3}}
RERANK_REQ = {"model": "r", "query": "q", "top_n": 2,
              "documents": ["d0", {"text": "d1"}, 5, ""]}
RERANK_RESP = {"results": [{"index": 1, "relevance_score": 0.9},
                           {"index": 0}],
               "meta": {"tokens": {"input_tokens": 6, "output_tokens": 0}}}

KNOBS = ["", "LLM_INVOCATION_PARAMETERS", "INPUTS", "OUTPUTS",
         "INPUT_MESSAGES", "OUTPUT_MESSAGES", "INPUT_IMAGES", "INPUT_TEXT",
         "OUTPUT_TEXT", "EMBEDDINGS_TEXT", "EMBEDDINGS_VECTORS", "PROMPTS",
         "CHOICES", "BASE64_IMAGE_MAX_LENGTH", "BAD_IMAGE_LENGTH"]


def _builder_outputs(oi, cfg):
    out = {}
    for name, args in (
            ("chat_req", (CHAT_REQ, json.dumps(CHAT_REQ).encode())),
            ("anth_req", (ANTH_REQ, json.dumps(ANTH_REQ))),
            ("emb_req", (EMB_REQ, json.dumps(EMB_REQ))),
            ("text_req", (TEXT_REQ, json.dumps(TEXT_REQ))),
            ("rerank_req", (RERANK_REQ, json.dumps(RERANK_REQ)))):
        fn = {"chat_req": oi.chat_request_attributes,
              "anth_req": oi.chat_request_attributes,
              "emb_req": oi.embeddings_request_attributes,
              "text_req": oi.completion_request_attributes,
              "rerank_req": oi.rerank_request_attributes}[name]
        extra = ({"system": oi.LLM_SYSTEM_ANTHROPIC}
                 if name == "anth_req" else {})
        out[name] = fn(*args, cfg, **extra)
    out["chat_resp"] = oi.chat_response_attributes(CHAT_RESP, cfg)
    out["anth_resp"] = oi.anthropic_response_attributes(ANTH_RESP, cfg)
    out["emb_resp"] = oi.embeddings_response_attributes(EMB_RESP, cfg)
    out["text_resp"] = oi.completion_response_attributes(TEXT_RESP, cfg)
    out["rerank_resp"] = oi.rerank_response_attributes(RERANK_RESP, cfg)
    return out


@pytest.mark.parametrize("knob", KNOBS, ids=[k or "defaults" for k in KNOBS])
def test_openinference_builders_match_reference(knob, monkeypatch):
    for k in KNOBS[1:]:
        monkeypatch.delenv(f"OPENINFERENCE_HIDE_{k}", raising=False)
    monkeypatch.delenv("OPENINFERENCE_BASE64_IMAGE_MAX_LENGTH",
                       raising=False)
    if knob == "BASE64_IMAGE_MAX_LENGTH":
        monkeypatch.setenv("OPENINFERENCE_BASE64_IMAGE_MAX_LENGTH", "40")
    elif knob == "BAD_IMAGE_LENGTH":
        monkeypatch.setenv("OPENINFERENCE_BASE64_IMAGE_MAX_LENGTH", "x")
    elif knob:
        monkeypatch.setenv(f"OPENINFERENCE_HIDE_{knob}", "true")
    jcfg, tcfg = joi.TraceConfig.from_env(), toi.TraceConfig.from_env()
    assert tcfg.__dict__ == jcfg.__dict__
    got, want = _builder_outputs(toi, tcfg), _builder_outputs(joi, jcfg)
    assert got == want
    if knob == "INPUTS":
        assert got["chat_req"][toi.INPUT_VALUE] == toi.REDACTED


def test_error_types_and_header_attributes_match_reference():
    for status in (200, 400, 401, 403, 404, 418, 429, 500, 503):
        assert toi.error_type_for_status(status) == \
            joi.error_type_for_status(status)
    assert ttracing.DEFAULT_HEADER_ATTRIBUTES == \
        jtracing.DEFAULT_HEADER_ATTRIBUTES
    headers = {"agent-session-id": "s1", "x-team": "a", "x-b": "b"}
    for spec in ("", ttracing.DEFAULT_HEADER_ATTRIBUTES,
                 " X-Team : team.id ,x-b:b.attr,bad,:x,y:, ,",
                 "agent-session-id:session.id,x-missing:m"):
        m = ttracing.parse_header_attribute_mapping(spec)
        assert m == jtracing.parse_header_attribute_mapping(spec)
        assert ttracing.header_attributes(headers, m) == \
            jtracing.header_attributes(headers, m)


def _sse(frames, anthropic=False):
    out = b""
    for f in frames:
        if anthropic:
            out += f"event: {f['type']}\n".encode()
        out += b"data: " + json.dumps(f).encode() + b"\n\n"
    return out + (b"" if anthropic else b"data: [DONE]\n\n")


STREAMS = {
    "chat": _sse([
        {"model": "m", "choices": [{"index": 0, "delta": {
            "role": "assistant", "content": "he"}}]},
        {"model": "m", "choices": [{"index": 0, "delta": {
            "content": "llo", "tool_calls": [{"index": 0, "id": "t",
                                              "function": {"name": "f",
                                                           "arguments": "{"}}]}}]},
        {"model": "m", "choices": [{"index": 0, "delta": {"tool_calls": [
            {"index": 0, "function": {"arguments": "}"}}]},
            "finish_reason": "stop"}]},
        {"model": "m", "choices": [], "usage": {"prompt_tokens": 3,
                                                "completion_tokens": 2}}]),
    "completion": _sse([
        {"model": "m", "choices": [{"index": 0, "text": "a"}]},
        {"model": "m", "choices": [{"index": 1, "text": "b",
                                    "finish_reason": "length"}]}]),
    "anthropic": _sse([
        {"type": "message_start", "message": {
            "model": "c", "role": "assistant", "usage": {"input_tokens": 4}}},
        {"type": "content_block_start", "index": 0,
         "content_block": {"type": "text", "text": ""}},
        {"type": "content_block_delta", "index": 0,
         "delta": {"type": "text_delta", "text": "hi"}},
        {"type": "content_block_start", "index": 1, "content_block": {
            "type": "tool_use", "id": "tu", "name": "f", "input": {}}},
        {"type": "content_block_delta", "index": 1, "delta": {
            "type": "input_json_delta", "partial_json": "{\"x\""}},
        {"type": "content_block_delta", "index": 1, "delta": {
            "type": "input_json_delta", "partial_json": ": 1}"}},
        {"type": "message_delta", "usage": {"output_tokens": 5}},
        {"type": "message_stop"}], anthropic=True),
    "malformed": b"data: {nope\n\ndata: [1, 2]\n\n: c\n\n",
}


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("kind", sorted(STREAMS))
def test_stream_accumulator_matches_reference(kind, seed):
    raw = STREAMS[kind]
    rng = random.Random(seed)
    cuts = sorted(rng.sample(range(1, len(raw)), min(6, len(raw) - 1)))
    pieces = [raw[a:b] for a, b in zip([0] + cuts, cuts + [len(raw)])]
    j, t, whole = joi.StreamAccumulator(), toi.StreamAccumulator(), \
        toi.StreamAccumulator()
    for p in pieces:
        j.feed(p)
        t.feed(p)
    whole.feed(raw)
    assert t.response() == j.response() == whole.response()
    cfg = toi.TraceConfig()
    if kind != "malformed":
        assert t.response() is not None
    if kind == "chat":
        attrs = toi.chat_response_attributes(t.response(), cfg)
        assert attrs[toi.output_message_attr(0, toi.MESSAGE_CONTENT)] == \
            "hello"


LOG_CASES = [
    dict(method="POST", path="/v1/chat/completions", status=200,
         duration_ms=12.3456, route="r", backend="b", model="m",
         response_model="m-2", stream=True, input_tokens=3,
         output_tokens=2, total_tokens=5, cached_tokens=1,
         costs={"t": 5}, client="127.0.0.1", trace_id="ab" * 16,
         span_id="cd" * 8, request_id="x", upstream_request_id="u",
         attempts=2, decision={"chosen": "h:1", "pick": {
             "sticky": True, "kv_fleet_hit": False}, "migrated_to": "h:2"}),
    dict(method="POST", path="/v1/embeddings", status=404, duration_ms=0.1,
         model="m", response_model="m", error_type="model_not_found"),
    dict(method="GET", path="/x", status=500, duration_ms=1,
         decision={"shed": True}),
]


def test_access_log_lines_match_reference(tmp_path):
    paths = {k: tmp_path / f"{k}.jsonl" for k in ("ref", "port")}
    loggers = {"ref": jaccess.AccessLogger(str(paths["ref"])),
               "port": taccess.AccessLogger(str(paths["port"]))}
    for case in LOG_CASES:
        for lg in loggers.values():
            lg.log(**case)
    for lg in loggers.values():
        lg.drain()
    lines = {k: [json.loads(x) for x in p.read_text().splitlines()]
             for k, p in paths.items()}
    for got, want in zip(lines["port"], lines["ref"]):
        assert list(got) == list(want)  # the keys in their order
        got.pop("ts"), want.pop("ts")
        assert got == want
    assert len(lines["port"]) == len(LOG_CASES)
    off = taccess.AccessLogger("off")
    assert not off.enabled and not taccess.AccessLogger("").enabled
    off.log(method="GET", path="/", status=200, duration_ms=1)
    off.drain()


# -- the traced gateways --------------------------------------------------------
class _Collector(BaseHTTPRequestHandler):
    payloads: list = []

    def do_POST(self):  # noqa: N802
        n = int(self.headers["content-length"])
        self.payloads.append(json.loads(self.rfile.read(n)))
        self.send_response(200)
        self.send_header("content-length", "0")
        self.end_headers()

    def log_message(self, *a):
        pass


def _value(v):
    for k in ("stringValue", "boolValue", "doubleValue"):
        if k in v:
            return v[k]
    return int(v["intValue"])


def _collected():
    """(service, span) per exported span, attributes as a dict."""
    out = []
    for p in list(_Collector.payloads):
        for rs in p["resourceSpans"]:
            svc = rs["resource"]["attributes"][0]["value"]["stringValue"]
            for ss in rs["scopeSpans"]:
                for sp in ss["spans"]:
                    sp = dict(sp, attributes={a["key"]: _value(a["value"])
                                              for a in sp["attributes"]})
                    out.append((svc, sp))
    return out


def _replica():
    from aigw_tpu_torch.tpuserve.engine import EngineConfig
    from aigw_tpu_torch.tpuserve.server import TPUServeServer

    srv = TPUServeServer(
        MODEL, EngineConfig(max_batch_size=4, max_seq_len=256, page_size=16,
                            enable_prefix_cache=False),
        device="cpu", port=0, param_dtype="float32")
    srv.start()
    return srv


@pytest.fixture(scope="module")
def collector():
    sink = ThreadingHTTPServer(("127.0.0.1", 0), _Collector)
    threading.Thread(target=sink.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{sink.server_address[1]}"
    sink.shutdown()
    sink.server_close()


@pytest.fixture(scope="module")
def replica(collector):
    mp = pytest.MonkeyPatch()
    mp.setenv("OTEL_TRACES_EXPORTER", "otlp")
    mp.setenv("OTEL_EXPORTER_OTLP_ENDPOINT", collector)
    mp.setenv("OTEL_EXPORTER_OTLP_PROTOCOL", "http/json")
    mp.delenv("OTEL_EXPORTER_OTLP_TRACES_PROTOCOL", raising=False)
    mp.delenv("OTEL_SDK_DISABLED", raising=False)
    srv = _replica()
    yield srv
    srv.stop()
    mp.undo()


@pytest.fixture(scope="module")
def loop():
    lp = asyncio.new_event_loop()
    t = threading.Thread(target=lp.run_forever, daemon=True)
    t.start()
    yield lp
    lp.call_soon_threadsafe(lp.stop)
    t.join(timeout=10)
    lp.close()


def _on(loop, coro, timeout=60):
    return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout)


def _config(replica, tmp_path):
    (tmp_path / "jwt").write_text("jwt-secret")
    return {
        "version": "v1",
        "backends": [
            {"name": "pool", "schema": "TPUServe",
             "endpoints": [f"127.0.0.1:{replica.port}"]},
            {"name": "hosted", "schema": "OpenAI",
             "url": "http://127.0.0.1:1",
             "auth": {"kind": "APIKey", "api_key": "sk-secret"}}],
        "routes": [{"name": "r", "rules": [
            {"models": [MODEL], "backends": ["pool"]}]}],
        "llm_request_costs": [{"metadata_key": "total",
                               "type": "TotalToken"}],
        "mcp": {"session_seed": "seed-secret", "backends": [],
                "authorization": {"jwt": {
                    "hs256_secret": f"file:{tmp_path / 'jwt'}"}}},
    }


async def _start(side, raw, tracer):
    if side == "ref":
        srv, runner = await jserver.run_gateway(
            jruntime.RuntimeConfig.build(jmodel.Config.parse(raw)), port=0,
            tracer=tracer)
        return srv, runner.addresses[0][1], runner.cleanup
    srv = await tserver.run_gateway(
        truntime.RuntimeConfig.build(tmodel.Config.parse(raw)), port=0,
        tracer=tracer)
    return srv, srv.port, srv.stop


def _http(port, path, body=None, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"content-type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _wait_polled(port, replica, timeout=30.0):
    """Until the gateway's picker has polled the replica (before it, a
    pick is a blind round-robin whose ``aigw.pick.*`` keys differ)."""
    addr = f"127.0.0.1:{replica.port}"
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        st = json.loads(_http(port, "/fleet/state")[2])
        rep = st["backends"]["pool"]["replicas"].get(addr) or {}
        if (rep.get("health") or {}).get("state") == "up":
            return
        time.sleep(0.05)
    raise AssertionError(f"the gateway on {port} never polled {addr}")


def _chat(stream):
    return {"model": MODEL, "max_tokens": 4, "temperature": 0,
            "stream": stream,
            "messages": [{"role": "user", "content": "hello there"}]}


#: (path, body, replica span expected)
REQUESTS = [
    ("/v1/chat/completions", _chat(False), True),
    ("/v1/chat/completions", _chat(True), True),
    ("/v1/completions", {"model": MODEL, "prompt": "abc", "max_tokens": 3,
                         "temperature": 0}, True),
    ("/v1/completions", {"model": MODEL, "prompt": "abc", "max_tokens": 3,
                         "temperature": 0, "stream": True}, True),
    ("/v1/embeddings", {"model": MODEL, "input": ["x", "yz"]}, False),
    ("/v1/messages", {"model": MODEL, "max_tokens": 4, "temperature": 0,
                      "messages": [{"role": "user", "content": "hi"}]},
     True),
    ("/v1/messages", {"model": MODEL, "max_tokens": 4, "temperature": 0,
                      "stream": True,
                      "messages": [{"role": "user", "content": "hi"}]},
     True),
    ("/v1/chat/completions", {"model": "nope", "messages": [
        {"role": "user", "content": "x"}]}, False),   # 404
    ("/v1/chat/completions", {"model": MODEL, "messages": "bad"}, False),
]

_MASKED = ("id", "created", "hbm_page_byte_s", "host_page_byte_s", "t0",
           "t1", "ts", "system_fingerprint")


def _mask(obj):
    if isinstance(obj, dict):
        return {k: "*" if k in _MASKED else _mask(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_mask(v) for v in obj]
    return obj


def _span_view(sp):
    attrs = {}
    for k, v in sp["attributes"].items():
        if k.startswith("aigw.pick."):
            v = "*"  # the pick's scores follow the polled telemetry
        elif k == "output.value":
            v = _mask(json.loads(v))
        attrs[k] = v
    return sp["name"], attrs, sp["status"]


def _trace(side: int, i: int) -> str:
    return f"{side + 1:02x}{i + 1:030x}"


PARENT = "00f067aa0ba902b7"


def test_traced_gateways_match_reference(replica, loop, collector, tmp_path,
                                         monkeypatch):
    monkeypatch.setenv("OTEL_EXPORTER_OTLP_ENDPOINT", collector)
    monkeypatch.setenv("OTEL_EXPORTER_OTLP_PROTOCOL", "http/json")
    monkeypatch.setenv("AIGW_ENABLE_DEBUG", "true")
    monkeypatch.setenv("AIGW_HEADER_ATTRIBUTES",
                       "agent-session-id:session.id,x-team:team")
    raw = _config(replica, tmp_path)
    results = {}
    for n, side in enumerate(("ref", "port")):
        monkeypatch.setenv("AIGW_ACCESS_LOG", str(tmp_path / f"{side}.log"))
        mod = jtracing if side == "ref" else ttracing
        srv, port, stop = _on(loop, _start(
            side, raw, mod.Tracer(exporter="otlp",
                                  service_name=f"{side}-gw")))
        try:
            _wait_polled(port, replica)
            replies = []
            for i, (path, body, _r) in enumerate(REQUESTS):
                s, h, b = _http(port, path, body, {
                    "traceparent": f"00-{_trace(n, i)}-{PARENT}-01",
                    "agent-session-id": f"s{i}", "x-request-id": f"q{i}"})
                replies.append((s, h.get("x-aigw-request-id", "")))
            dbg = {p: _http(port, p) for p in ("/debug/config",
                                               "/debug/stacks")}
            srv.access_log.drain()
        finally:
            _on(loop, stop())
        log = [json.loads(x) for x in
               (tmp_path / f"{side}.log").read_text().splitlines()]
        results[side] = (replies, dbg, log)
    # every expected span has arrived: each side's gateway span per
    # request and the replica's, which leave on their exporters' own
    # flush loops (a count of all spans could be met by others first)
    expected = {(f"{side}-gw", _trace(n, i))
                for n, side in enumerate(("ref", "port"))
                for i in range(7)}
    expected |= {("tpuserve", _trace(n, i)) for n in range(2)
                 for i, (_p, _b, r) in enumerate(REQUESTS[:7]) if r}
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and not expected <= {
            (svc, sp["traceId"]) for svc, sp in _collected()}:
        time.sleep(0.05)
    spans = _collected()
    for n, side in enumerate(("ref", "port")):
        assert [s for s, _u in results[side][0]] == \
            [200] * 7 + [404, 400]
    views = {}
    for n, side in enumerate(("ref", "port")):
        views[side] = []
        for i, (path, _body, replica_span) in enumerate(REQUESTS[:7]):
            trace = _trace(n, i)
            gw = [sp for svc, sp in spans
                  if svc == f"{side}-gw" and sp["traceId"] == trace]
            assert len(gw) == 1, (side, path)
            gw = gw[0]
            assert gw["parentSpanId"] == PARENT
            kids = [sp for svc, sp in spans if svc == "tpuserve"
                    and sp["traceId"] == trace
                    and sp["parentSpanId"] == gw["spanId"]]
            assert len(kids) == (1 if replica_span else 0), (side, path)
            views[side].append(_span_view(gw))
            line = results[side][2][i]
            assert (line["trace_id"], line["span_id"]) == \
                (trace, gw["spanId"])
            assert line.get("upstream_request_id", "") == \
                results[side][0][i][1]
    for i, (got, want_) in enumerate(zip(views["port"], views["ref"])):
        assert got == want_, REQUESTS[i][0]
    name, attrs, _st = views["port"][1]
    assert name == f"chat {MODEL}" and attrs["session.id"] == "s1"
    assert attrs["aigw.endpoint"] == f"127.0.0.1:{replica.port}"
    assert "llm.output_messages.0.message.role" in attrs  # accumulated
    assert "llm.output_messages.0.message.role" in views["port"][6][1]
    # the access log: one line per request, rejections included
    lines = {}
    for side in ("ref", "port"):
        lines[side] = []
        for line in results[side][2]:
            assert list(line)[:8] == ["ts", "method", "path", "status",
                                      "duration_ms", "route", "backend",
                                      "model"]
            lines[side].append({k: v for k, v in line.items() if k not in (
                "ts", "duration_ms", "trace_id", "span_id",
                "upstream_request_id")})
    assert lines["port"] == lines["ref"]
    assert len(lines["port"]) == len(REQUESTS)
    assert lines["port"][0]["costs"]["total"] > 0
    assert lines["port"][7]["error"] == "model_not_found"
    assert lines["port"][8]["error"] == "invalid_request"
    # the debug routes
    cfgs = {s: json.loads(results[s][1]["/debug/config"][2])
            for s in results}
    assert cfgs["port"] == cfgs["ref"]
    text = json.dumps(cfgs["port"])
    for secret in ("sk-secret", "seed-secret"):
        assert secret not in text
    assert cfgs["port"]["backends"][1]["auth"]["credentials"] == "[REDACTED]"
    stacks = results["port"][1]["/debug/stacks"]
    assert stacks[0] == 200 and b"--- thread" in stacks[2]
    assert b"accesslog.py" in stacks[2]  # the writer thread is listed


def test_debug_routes_off_and_untraced_relay(replica, loop, tmp_path,
                                             monkeypatch):
    """Without ``AIGW_ENABLE_DEBUG`` both debug routes are 404 on both
    gateways; with tracing off the caller's trace id reaches the
    replica's flight entry through either."""
    monkeypatch.delenv("AIGW_ENABLE_DEBUG", raising=False)
    monkeypatch.delenv("AIGW_ACCESS_LOG", raising=False)
    raw = _config(replica, tmp_path)
    for n, side in enumerate(("ref", "port")):
        mod = jtracing if side == "ref" else ttracing
        srv, port, stop = _on(loop, _start(side, raw,
                                           mod.Tracer(exporter="none")))
        try:
            assert not srv.tracer.enabled and not srv.access_log.enabled
            for p in ("/debug/config", "/debug/stacks"):
                assert _http(port, p)[0] == 404, (side, p)
            trace = f"{n + 0xa:02x}" + "fe" * 15
            s, h, _b = _http(port, "/v1/chat/completions", _chat(False),
                             {"traceparent": f"00-{trace}-{PARENT}-01"})
            assert s == 200
            rid = h["x-aigw-request-id"]
            s, _h, body = _http(replica.port, f"/debug/requests/{rid}")
            assert s == 200 and json.loads(body)["trace_id"] == trace
        finally:
            _on(loop, stop())


def test_grpc_export_reaches_a_collector(monkeypatch):
    """``OTEL_EXPORTER_OTLP_PROTOCOL=grpc``: the flusher sends the
    reference's ExportTraceServiceRequest bytes as a
    ``TraceService/Export`` unary call to a gRPC collector."""
    from concurrent import futures

    import grpc

    from aigw_tpu.obs import otlp_proto as jproto

    got = []

    def export(request, _context):
        got.append(request)
        return b""

    handler = grpc.method_handlers_generic_handler(
        "opentelemetry.proto.collector.trace.v1.TraceService",
        {"Export": grpc.unary_unary_rpc_method_handler(
            export, request_deserializer=lambda b: b,
            response_serializer=lambda b: b)})
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
    server.add_generic_rpc_handlers((handler,))
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    try:
        monkeypatch.setenv("OTEL_EXPORTER_OTLP_ENDPOINT",
                           f"http://127.0.0.1:{port}")
        monkeypatch.setenv("OTEL_EXPORTER_OTLP_PROTOCOL", "grpc")
        monkeypatch.delenv("OTEL_EXPORTER_OTLP_TRACES_PROTOCOL",
                           raising=False)
        tracer = ttracing.Tracer(exporter="otlp", service_name="g")
        span = tracer.start_span("chat m")
        span.set("gen_ai.request.model", "m")
        span.end()
        deadline = time.monotonic() + 20
        while not got and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        server.stop(0)
    assert got == [jproto.encode_traces([span], "g")]


def test_debug_config_shows_a_literal_jwt_secret_reference_fact(
        loop, monkeypatch):
    """``/debug/config`` masks backend credentials and the MCP session
    seeds, not ``mcp.authorization.jwt.hs256_secret``: a literal secret
    is shown (a ``file:`` one shows its path), by both gateways."""
    monkeypatch.setenv("AIGW_ENABLE_DEBUG", "true")
    monkeypatch.delenv("AIGW_ACCESS_LOG", raising=False)
    raw = {"version": "v1", "mcp": {
        "session_seed": "seed-1", "session_fallback_seed": "seed-0",
        "backends": [], "authorization": {"jwt": {
            "hs256_secret": "literal-jwt-secret"}}}}
    got = {}
    for side in ("ref", "port"):
        mod = jtracing if side == "ref" else ttracing
        _srv, port, stop = _on(loop, _start(side, raw,
                                            mod.Tracer(exporter="none")))
        try:
            got[side] = json.loads(_http(port, "/debug/config")[2])
        finally:
            _on(loop, stop())
    assert got["port"] == got["ref"]
    assert "session_seed" not in got["port"]["mcp"]
    assert "session_fallback_seed" not in got["port"]["mcp"]
    assert got["port"]["mcp"]["authorization"]["jwt"]["hs256_secret"] == \
        "literal-jwt-secret"
