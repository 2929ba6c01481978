"""The port's cassette harness (``aigw_tpu_torch/testing``): go-vcr v2
YAML read by the port's own YAML reader (``testing/yaml_subset.py``,
held against pyyaml's ``safe_load``), the native JSON format, go-vcr's
replay order, ``CassetteServer`` on ``gateway/http.py`` (matched by
``x-cassette-name``, else by path; SSE chunked per event) held against
the reference's ``aigw_tpu.testing.cassettes`` replay, the port's gateway
and translators fed the recorded bytes, and recording through a local
stub provider (no egress).

The reference replays the upstream project's recorded cassettes, which
this checkout does not hold; these cassettes are written here in
go-vcr's own layout (what ``gopkg.in/yaml.v3`` emits for a recording)
with provider-shaped payloads."""

from __future__ import annotations

import asyncio
import json
import random

import pytest
import yaml

from aigw_tpu_torch.config.model import Config
from aigw_tpu_torch.config.runtime import RuntimeConfig
from aigw_tpu_torch.gateway.http import HTTPClient, HTTPServer, json_response
from aigw_tpu_torch.gateway.server import run_gateway
from aigw_tpu_torch.testing import CassetteServer, load_cassette
from aigw_tpu_torch.testing import cassettes as tcas
from aigw_tpu_torch.testing import yaml_subset

OPENAI = "https://api.openai.com"


def _sq(s: str) -> str:
    return "'" + s.replace("'", "''") + "'"


def _block(s: str, indent: str) -> str:
    """A literal block scalar as yaml.v3 writes one (``|-`` without a
    final newline, ``|+`` keeping several)."""
    chomp = "-" if not s.endswith("\n") else (
        "+" if s.endswith("\n\n") else "")
    body = s[:-1] if s.endswith("\n") and chomp == "" else s
    lines = body.split("\n")
    if chomp == "+":
        lines = s.split("\n")[:-1]
    return "|" + chomp + "\n" + "\n".join(
        (indent + ln) if ln else "" for ln in lines)


def _headers(h: dict, indent: str) -> str:
    out = []
    for k, v in h.items():
        out.append(f"{indent}{k}:")
        val = _sq(v) if v[:1].isdigit() or v in ("true", "false") else v
        out.append(f"{indent}    - {val}")
    return "\n".join(out)


def vcr(interactions: list[dict]) -> str:
    """go-vcr v2 YAML for ``interactions`` (request body, url, method,
    request headers; response code, body, headers)."""
    out = ["---", "version: 2", "interactions:"]
    for n, it in enumerate(interactions):
        host = it["url"].split("/")[2]
        resp = it["response_body"]
        rbody = _block(resp, " " * 12) if "\n" in resp else _sq(resp)
        out += [
            f"    - id: {n}",
            "      request:",
            "        proto: HTTP/1.1",
            "        proto_major: 1",
            "        proto_minor: 1",
            f"        content_length: {len(it['request_body'])}",
            "        transfer_encoding: []",
            "        trailer: {}",
            f"        host: {host}",
            '        remote_addr: ""',
            '        request_uri: ""',
            f"        body: {_sq(it['request_body'])}",
            "        form: {}",
            "        headers:",
            _headers({"Accept-Encoding": "gzip",
                      "Content-Type": "application/json",
                      **it.get("request_headers", {})}, " " * 12),
            f"        url: {it['url']}",
            f"        method: {it.get('method', 'POST')}",
            "      response:",
            "        proto: HTTP/2.0",
            "        proto_major: 2",
            "        proto_minor: 0",
            "        transfer_encoding: []",
            "        trailer: {}",
            "        content_length: -1",
            "        uncompressed: true",
            f"        body: {rbody}",
            "        headers:",
            _headers(it["response_headers"], " " * 12),
            f"        status: {it.get('code', 200)} "
            f"{'OK' if it.get('code', 200) == 200 else 'Not Found'}",
            f"        code: {it.get('code', 200)}",
            "        duration: 1.234567s",
        ]
    return "\n".join(out) + "\n"


def _json_headers(extra=None) -> dict:
    return {"Content-Type": "application/json",
            "Openai-Processing-Ms": "345", "X-Request-Id": "req_abc123",
            "Set-Cookie": "__cf_bm=made-up; path=/", **(extra or {})}


def _chat(model: str, message: dict, usage: dict, **kw) -> str:
    return json.dumps({
        "id": "chatcmpl-Bf1", "object": "chat.completion",
        "created": 1749000000, "model": model,
        "choices": [{"index": 0, "message": message,
                     "finish_reason": kw.get("finish", "stop")}],
        "usage": usage, "service_tier": "default",
        "system_fingerprint": None}, indent=2)


_USAGE = {"prompt_tokens": 12, "completion_tokens": 9, "total_tokens": 21}
_DETAILED = {**_USAGE,
             "prompt_tokens_details": {"cached_tokens": 0,
                                       "audio_tokens": 0},
             "completion_tokens_details": {
                 "reasoning_tokens": 64, "audio_tokens": 0,
                 "accepted_prediction_tokens": 0,
                 "rejected_prediction_tokens": 0}}
_TOOL = {"type": "function", "function": {
    "name": "get_current_weather",
    "parameters": {"type": "object", "properties": {
        "location": {"type": "string"}}, "required": ["location"]}}}


def _call(i: int, city: str) -> dict:
    return {"id": f"call_{i}", "type": "function", "function": {
        "name": "get_current_weather",
        "arguments": json.dumps({"location": city})}}


def _stream_body(model: str, pieces: list[str], usage: dict | None) -> str:
    frames = [{"id": "chatcmpl-S1", "object": "chat.completion.chunk",
               "created": 1749000001, "model": model,
               "choices": [{"index": 0, "delta": {"role": "assistant",
                                                  "content": "",
                                                  "refusal": None},
                            "finish_reason": None}],
               "obfuscation": "xY"}]
    for p in pieces:
        frames.append({"id": "chatcmpl-S1", "object": "chat.completion.chunk",
                       "created": 1749000001, "model": model,
                       "choices": [{"index": 0, "delta": {"content": p},
                                    "finish_reason": None}],
                       "obfuscation": "q"})
    frames.append({"id": "chatcmpl-S1", "object": "chat.completion.chunk",
                   "created": 1749000001, "model": model,
                   "choices": [{"index": 0, "delta": {},
                                "finish_reason": "stop"}]})
    if usage is not None:
        frames.append({"id": "chatcmpl-S1", "object": "chat.completion.chunk",
                       "created": 1749000001, "model": model, "choices": [],
                       "usage": usage})
    return "".join(f"data: {json.dumps(f)}\n\n" for f in frames) \
        + "data: [DONE]\n\n"


def _req(model: str, **kw) -> str:
    body = {"messages": [{"role": "user", "content": "Say this is a test"}],
            "model": model, **kw}
    return json.dumps(body, separators=(",", ":"))


#: name → interactions
CASSETTES = {
    "chat-basic": [dict(
        url=f"{OPENAI}/v1/chat/completions", request_body=_req("gpt-5-nano"),
        response_body=_chat("gpt-5-nano-2025-08-07", {
            "role": "assistant", "content": "This is a test.",
            "refusal": None, "annotations": []}, _USAGE),
        response_headers=_json_headers())],
    "chat-detailed-usage": [dict(
        url=f"{OPENAI}/v1/chat/completions", request_body=_req("gpt-5-nano"),
        response_body=_chat("gpt-5-nano-2025-08-07", {
            "role": "assistant", "content": "Done: it's a test"},
            _DETAILED),
        response_headers=_json_headers())],
    "chat-tools": [dict(
        url=f"{OPENAI}/v1/chat/completions",
        request_body=_req("gpt-5-nano", tools=[_TOOL]),
        response_body=_chat("gpt-5-nano-2025-08-07", {
            "role": "assistant", "content": None,
            "tool_calls": [_call(1, "Boston, MA")]}, _USAGE,
            finish="tool_calls"),
        response_headers=_json_headers())],
    "chat-multiturn": [dict(
        url=f"{OPENAI}/v1/chat/completions",
        request_body=_req("gpt-5-nano"),
        response_body=_chat("gpt-5-nano-2025-08-07", {
            "role": "assistant", "content": f"turn {i}"}, _USAGE),
        response_headers=_json_headers()) for i in (1, 2)],
    "chat-parallel-tools": [dict(
        url=f"{OPENAI}/v1/chat/completions",
        request_body=_req("gpt-5-nano", tools=[_TOOL],
                          parallel_tool_calls=True),
        response_body=_chat("gpt-5-nano-2025-08-07", {
            "role": "assistant", "content": None,
            "tool_calls": [_call(1, "Paris"), _call(2, "Tokyo")]},
            _USAGE, finish="tool_calls"),
        response_headers=_json_headers())],
    "chat-json-mode": [dict(
        url=f"{OPENAI}/v1/chat/completions",
        request_body=_req("gpt-5-nano",
                          response_format={"type": "json_object"}),
        response_body=_chat("gpt-5-nano-2025-08-07", {
            "role": "assistant", "content": '{"answer": "a test"}'},
            _USAGE),
        response_headers=_json_headers())],
    "embeddings-basic": [dict(
        url=f"{OPENAI}/v1/embeddings",
        request_body=json.dumps({"input": "hello", "model":
                                 "text-embedding-3-small"}),
        response_body=json.dumps({
            "object": "list", "model": "text-embedding-3-small",
            "data": [{"object": "embedding", "index": 0,
                      "embedding": [0.0023, -0.0093, 0.0158, -0.0071]}],
            "usage": {"prompt_tokens": 1, "total_tokens": 1}}, indent=2),
        response_headers=_json_headers())],
    "embeddings-base64": [dict(
        url=f"{OPENAI}/v1/embeddings",
        request_body=json.dumps({"input": "hello", "model":
                                 "text-embedding-3-small",
                                 "encoding_format": "base64"}),
        response_body=json.dumps({
            "object": "list", "model": "text-embedding-3-small",
            "data": [{"object": "embedding", "index": 0,
                      "embedding": "AACAPwAAAEAAAEBA"}],
            "usage": {"prompt_tokens": 1, "total_tokens": 1}}, indent=2),
        response_headers=_json_headers())],
    "completion-basic": [dict(
        url=f"{OPENAI}/v1/completions",
        request_body=json.dumps({"model": "gpt-3.5-turbo-instruct",
                                 "prompt": "Say this is a test",
                                 "max_tokens": 7}),
        response_body=json.dumps({
            "id": "cmpl-1", "object": "text_completion", "created": 1,
            "model": "gpt-3.5-turbo-instruct",
            "choices": [{"text": "\n\nThis is a test", "index": 0,
                         "logprobs": None, "finish_reason": "length"}],
            "usage": {"prompt_tokens": 5, "completion_tokens": 7,
                      "total_tokens": 12}}, indent=2),
        response_headers=_json_headers())],
    "chat-streaming": [dict(
        url=f"{OPENAI}/v1/chat/completions",
        request_body=_req("gpt-5-nano", stream=True),
        response_body=_stream_body("gpt-5-nano-2025-08-07",
                                   ["This", " is", " a", " test", "."],
                                   None),
        response_headers={"Content-Type": "text/event-stream; "
                          "charset=utf-8", "X-Request-Id": "req_s1"})],
    "chat-streaming-detailed-usage": [dict(
        url=f"{OPENAI}/v1/chat/completions",
        request_body=_req("gpt-5-nano", stream=True,
                          stream_options={"include_usage": True}),
        response_body=_stream_body("gpt-5-nano-2025-08-07",
                                   ["A", " test"], _DETAILED),
        response_headers={"Content-Type": "text/event-stream; "
                          "charset=utf-8"})],
    "azure-chat-basic": [dict(
        url="https://made-up.openai.azure.com/openai/deployments/"
            "gpt-5-nano/chat/completions",
        request_body=_req("gpt-5-nano"),
        response_body=_chat("gpt-5-nano-2025-08-07", {
            "role": "assistant", "content": "Azure says: a test."},
            _USAGE),
        response_headers=_json_headers({"Apim-Request-Id": "a-1"}))],
    "chat-unknown-model": [dict(
        url=f"{OPENAI}/v1/chat/completions",
        request_body=_req("gpt-made-up"),
        response_body=json.dumps({"error": {
            "message": "The model `gpt-made-up` does not exist or you do "
                       "not have access to it.",
            "type": "invalid_request_error", "param": None,
            "code": "model_not_found"}}, indent=4),
        response_headers=_json_headers(), code=404)],
}


@pytest.fixture(scope="module")
def cassette_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cassettes")
    for name, its in CASSETTES.items():
        (d / f"{name}.yaml").write_text(vcr(its))
    return d


def _cassette(cassette_dir, name: str):
    return load_cassette(cassette_dir / f"{name}.yaml")


# -- the loader -----------------------------------------------------------


def test_go_vcr_format(cassette_dir):
    c = _cassette(cassette_dir, "chat-basic")
    it = c.interactions[0]
    assert (it.method, it.path, it.status) == (
        "POST", "/v1/chat/completions", 200)
    assert json.loads(it.request_body)["model"] == "gpt-5-nano"
    assert json.loads(it.response_body)["object"] == "chat.completion"
    assert it.response_headers["openai-processing-ms"] == "345"


def test_sse_detection(cassette_dir):
    assert _cassette(cassette_dir, "chat-streaming").interactions[0].is_sse
    assert not _cassette(cassette_dir, "chat-basic").interactions[0].is_sse


@pytest.mark.parametrize("name", sorted(CASSETTES))
def test_loader_equals_the_reference(cassette_dir, name):
    """The port's reader gives the reference's (pyyaml) interactions,
    and the YAML document equals pyyaml's ``safe_load`` of it."""
    from aigw_tpu.testing.cassettes import load_cassette as jload

    path = cassette_dir / f"{name}.yaml"
    assert yaml_subset.loads(path.read_text()) == yaml.safe_load(
        path.read_text())
    got, want = load_cassette(path), jload(path)
    assert got.name == want.name == name
    assert [vars(i) for i in got.interactions] == \
        [vars(i) for i in want.interactions]
    assert got.interactions[-1].response_body == \
        CASSETTES[name][-1]["response_body"]


def test_json_roundtrip(cassette_dir, tmp_path):
    c = _cassette(cassette_dir, "chat-basic")
    tcas.dump_cassette(c, tmp_path / "x.json")
    c2 = load_cassette(tmp_path / "x.json")
    assert c2.name == "chat-basic"
    assert vars(c2.interactions[0]) == vars(c.interactions[0])
    from aigw_tpu.testing.cassettes import load_cassette as jload

    assert vars(jload(tmp_path / "x.json").interactions[0]) == \
        vars(c.interactions[0])


@pytest.mark.parametrize("seed", range(4))
def test_yaml_subset_equals_pyyaml_on_every_scalar_style(seed):
    """Documents of strings, numbers and nests dumped by pyyaml in each
    style (plain, both quotes, literal, folded; widths that fold): the
    port's reader gives pyyaml's ``safe_load``."""
    rng = random.Random(seed)
    alphabet = list("abc xyz:#-'\"\\\n\t{}[],&*!|>%@`?~é") + [
        "data: ", "\n\n", "  ", "true", "0x1f", "1.5", "null", "- "]

    def text():
        return "".join(rng.choice(alphabet)
                       for _ in range(rng.randint(0, 30)))

    def value(depth=0, strings=False):
        r = rng.random()
        if depth > 3 or r < 0.5:
            c = rng.random()
            if c < 0.6 or strings:
                return text()
            return rng.choice([rng.randint(-10**6, 10**6), True, None,
                               rng.uniform(-1e3, 1e3)])
        if r < 0.75:
            return [value(depth + 1, strings)
                    for _ in range(rng.randint(0, 4))]
        return {rng.choice(["body", "k1", "Content-Type", "a b", "true",
                            "-x", "é", "q'x"]): value(depth + 1, strings)
                for _ in range(rng.randint(0, 4))}

    for _ in range(300):
        style = rng.choice([None, None, '"', "'", "|", ">"])
        doc = value(strings=style is not None)
        dumped = yaml.safe_dump(doc, default_style=style,
                                default_flow_style=False,
                                width=rng.choice([20, 80, 1000]),
                                indent=rng.choice([2, 4]),
                                allow_unicode=rng.choice([True, False]))
        assert yaml_subset.loads(dumped) == yaml.safe_load(dumped), dumped


@pytest.mark.parametrize("text", [
    "a: &x 1\nb: *x\n", "? complex\n: key\n", "a: !!str 1\n",
    "a: [1,\n  2]\n"])
def test_yaml_subset_refuses_what_it_does_not_read(text):
    with pytest.raises(ValueError):
        yaml_subset.loads(text)


# -- the server -----------------------------------------------------------


async def _fetch(client: HTTPClient, method: str, url: str, body=b"",
                 headers=None):
    r = await client.request(method, url, data=body, headers=headers or {})
    chunks = [c async for c in r.iter_any()]
    r.release()
    return r.status, r.headers, chunks


def test_multi_interaction_consumed_in_order(tmp_path):
    """go-vcr semantics: two recordings of one endpoint replay in order;
    once both are consumed the last replays again; ``reset()`` rearms."""
    c = tcas.Cassette(name="turns", interactions=[
        tcas.Interaction(method="POST", url="u", path="/v1/x",
                         request_body="", request_headers={}, status=200,
                         response_body=json.dumps({"turn": i}),
                         response_headers={
                             "content-type": "application/json"})
        for i in (1, 2)])
    tcas.dump_cassette(c, tmp_path / "turns.json")

    async def main():
        server = await CassetteServer().load(tmp_path / "turns.json").start()
        client = HTTPClient()
        try:
            seen = []
            for _ in range(3):
                _s, _h, chunks = await _fetch(client, "POST",
                                              server.url + "/v1/x")
                seen.append(json.loads(b"".join(chunks))["turn"])
            assert seen == [1, 2, 2]
            server.reset()
            _s, _h, chunks = await _fetch(client, "POST",
                                          server.url + "/v1/x")
            assert json.loads(b"".join(chunks))["turn"] == 1
            assert [r[:2] for r in server.requests] == [("POST", "/v1/x")] * 4
        finally:
            client.close()
            await server.stop()

    asyncio.run(main())


async def _replay(server_cls, cassette_dir, calls) -> list:
    """Each call (method, path, headers) against a server of
    ``server_cls`` holding every cassette: status, content type, the
    body's chunks (SSE: one per event), and the headers replayed."""
    server = await server_cls().load_dir(cassette_dir).start()
    out = []
    try:
        if server_cls is CassetteServer:
            client = HTTPClient()
            try:
                for method, path, headers in calls:
                    s, h, chunks = await _fetch(client, method,
                                                server.url + path,
                                                b"{}", headers)
                    out.append(_view(s, h, chunks))
            finally:
                client.close()
        else:
            import aiohttp

            async with aiohttp.ClientSession() as sess:
                for method, path, headers in calls:
                    async with sess.request(method, server.url + path,
                                            data=b"{}",
                                            headers=headers) as r:
                        chunks = [c async for c in r.content.iter_any()]
                        out.append(_view(r.status, {
                            k.lower(): v for k, v in r.headers.items()},
                            chunks))
    finally:
        await server.stop()
    return out


def _view(status, headers, chunks) -> tuple:
    body = b"".join(chunks)
    kept = {k: v for k, v in headers.items()
            if k in ("content-type", "openai-processing-ms", "x-request-id",
                     "apim-request-id", "set-cookie")}
    sse = headers.get("content-type", "").startswith("text/event-stream")
    return status, kept, body, [c for c in body.split(b"\n\n") if c] \
        if sse else None


def test_replay_equals_the_reference(cassette_dir):
    """The same calls against the port's server and the reference's
    (aiohttp): the same statuses, bodies, content types and replayed
    headers (``set-cookie`` dropped), SSE split into the same events;
    ``x-cassette-name`` picks the cassette, the path alone the first
    loaded, an unknown path 404s."""
    from aigw_tpu.testing.cassettes import CassetteServer as JServer

    calls = [("POST", "/v1/chat/completions",
              {"x-cassette-name": name})
             for name in sorted(CASSETTES) if "azure" not in name]
    calls += [("POST", "/v1/embeddings", {}),
              ("POST", "/openai/deployments/gpt-5-nano/chat/completions",
               {}),
              ("GET", "/v1/models", {}),
              ("POST", "/v1/chat/completions",
               {"x-cassette-name": "no-such"})]
    got = asyncio.run(_replay(CassetteServer, cassette_dir, calls))
    want = asyncio.run(_replay(JServer, cassette_dir, calls))
    assert got == want
    by_name = dict(zip([c[2].get("x-cassette-name") for c in calls], got))
    assert by_name["chat-unknown-model"][0] == 404
    # the role frame, five content frames, the finish frame, [DONE]
    assert len(by_name["chat-streaming"][3]) == 8
    assert all("set-cookie" not in g[1] for g in got)
    assert got[-2][0] == 404 and got[-1][0] == 404


@pytest.fixture(scope="module")
def gateway_run(cassette_dir):
    """Replays through the port's gateway: (status, body) per cassette,
    each cassette's recorded request sent to a gateway whose one route
    sends its model to the cassette server."""

    async def one(name: str):
        it = _cassette(cassette_dir, name).interactions[0]
        req = json.loads(it.request_body)
        server = await CassetteServer().load(
            cassette_dir / f"{name}.yaml").start()
        schema = ({"name": "AzureOpenAI", "version": "2025-01-01-preview"}
                  if name.startswith("azure") else "OpenAI")
        cfg = Config.parse({
            "version": "v1",
            "backends": [{"name": "up", "schema": schema,
                          "url": server.url}],
            "routes": [{"name": "r", "rules": [
                {"models": [req["model"]], "backends": ["up"]}]}]})
        gw = await run_gateway(RuntimeConfig.build(cfg), port=0)
        client = HTTPClient()
        try:
            outs = []
            for _ in range(len(_cassette(cassette_dir,
                                         name).interactions)):
                front = ("/v1/chat/completions" if name.startswith("azure")
                         else it.path)
                status, _h, chunks = await _fetch(
                    client, "POST", f"http://127.0.0.1:{gw.port}{front}",
                    json.dumps(req).encode(),
                    {"content-type": "application/json"})
                outs.append((status, b"".join(chunks)))
            return outs, [r[1] for r in server.requests]
        finally:
            client.close()
            await gw.stop()
            await server.stop()

    async def main():
        return {name: await one(name) for name in sorted(CASSETTES)}

    return asyncio.run(main())


def _sse_text(raw: bytes) -> tuple[str, list]:
    text, usages = "", []
    for block in raw.decode().split("\n\n"):
        for line in block.splitlines():
            if line.startswith("data: ") and "[DONE]" not in line:
                msg = json.loads(line[6:])
                for ch in msg.get("choices", ()):
                    text += (ch.get("delta") or {}).get("content") or ""
                if msg.get("usage"):
                    usages.append(msg["usage"])
    return text, usages


@pytest.mark.parametrize("name", [
    "chat-basic", "chat-detailed-usage", "chat-tools", "chat-parallel-tools",
    "chat-json-mode", "embeddings-basic", "embeddings-base64",
    "completion-basic"])
def test_gateway_passes_the_recorded_reply_through(gateway_run, name):
    (status, body), = gateway_run[name][0]
    assert status == 200
    assert json.loads(body) == json.loads(
        CASSETTES[name][0]["response_body"])


def test_gateway_multiturn_replays_in_order(gateway_run):
    outs, paths = gateway_run["chat-multiturn"]
    assert [json.loads(b)["choices"][0]["message"]["content"]
            for _s, b in outs] == ["turn 1", "turn 2"]
    assert paths == ["/v1/chat/completions"] * 2


@pytest.mark.parametrize("name", ["chat-streaming",
                                  "chat-streaming-detailed-usage"])
def test_gateway_relays_the_recorded_stream(gateway_run, name):
    (status, body), = gateway_run[name][0]
    assert status == 200
    got, usages = _sse_text(body)
    want, want_usages = _sse_text(
        CASSETTES[name][0]["response_body"].encode())
    assert got == want and want
    assert usages == want_usages
    if name.endswith("usage"):
        assert usages[-1]["total_tokens"] == 21


def test_azure_chat_via_translator(gateway_run):
    """OpenAI front, Azure backend: the translator's deployment path is
    the recording's, and the recorded reply flows back."""
    (status, body), = gateway_run["azure-chat-basic"][0]
    assert status == 200
    assert json.loads(body)["choices"][0]["message"]["content"] == \
        "Azure says: a test."
    assert gateway_run["azure-chat-basic"][1] == [
        "/openai/deployments/gpt-5-nano/chat/completions"]


def test_unknown_model_error_passthrough(gateway_run):
    """The provider's 404 comes back as a 404 carrying the recorded
    error, not one the gateway made up."""
    (status, body), = gateway_run["chat-unknown-model"][0]
    assert status == 404
    err = json.loads(body)["error"]
    assert "model_not_found" in err["message"]
    assert "`gpt-made-up` does not exist" in err["message"]


# -- translators on the recorded payloads ---------------------------------


def test_recorded_chat_to_anthropic(cassette_dir):
    from aigw_tpu_torch.config.model import APISchemaName
    from aigw_tpu_torch.translate import Endpoint, get_translator

    it = _cassette(cassette_dir, "chat-tools").interactions[0]
    tx = get_translator(Endpoint.MESSAGES, APISchemaName.ANTHROPIC,
                        APISchemaName.OPENAI)
    tx.request({"model": "gpt-5-nano", "max_tokens": 128,
                "messages": [{"role": "user", "content": "weather?"}]})
    out = json.loads(tx.response_body(it.response_body.encode(), True).body)
    tools = [b for b in out["content"] if b["type"] == "tool_use"]
    assert tools[0]["name"] == "get_current_weather"
    assert tools[0]["input"] == {"location": "Boston, MA"}
    assert out["usage"]["input_tokens"] == 12


def test_recorded_stream_through_the_accumulator(cassette_dir):
    from aigw_tpu_torch.obs.openinference import StreamAccumulator

    it = _cassette(cassette_dir, "chat-streaming").interactions[0]
    acc = StreamAccumulator()
    for block in it.response_body.split("\n\n"):
        if block.strip():
            acc.feed((block + "\n\n").encode())
    assert acc.response()["choices"][0]["message"]["content"] == \
        "This is a test."


# -- recording ------------------------------------------------------------


def test_records_unmatched_to_json(tmp_path):
    """Recording proxies an unmatched request to the provider base (a
    local stub here: no egress) through the port's HTTP client and
    writes a JSON cassette that replays."""

    async def main():
        async def provider(request):
            assert request.headers.get("authorization") == "Bearer sk-x"
            return json_response({"ok": True, "id": "live-1"})

        stub = HTTPServer({("POST", "/v1/chat/completions"): provider})
        port = await stub.start("127.0.0.1", 0)
        server = await CassetteServer(
            record_base=f"http://127.0.0.1:{port}",
            record_dir=tmp_path).start()
        client = HTTPClient()
        try:
            status, _h, chunks = await _fetch(
                client, "POST", f"{server.url}/v1/chat/completions",
                json.dumps({"model": "m"}).encode(),
                {"x-cassette-name": "my-rec",
                 "authorization": "Bearer sk-x"})
            assert status == 200
            assert json.loads(b"".join(chunks))["id"] == "live-1"
            rec = json.loads((tmp_path / "my-rec.json").read_text())
            it = rec["interactions"][0]
            assert "authorization" not in it["request_headers"]
            replay = await CassetteServer().load(
                tmp_path / "my-rec.json").start()
            try:
                _s, _h, chunks = await _fetch(
                    client, "POST", f"{replay.url}/v1/chat/completions")
                assert json.loads(b"".join(chunks))["id"] == "live-1"
            finally:
                await replay.stop()
        finally:
            client.close()
            await server.stop()
            await stub.stop()

    asyncio.run(main())
