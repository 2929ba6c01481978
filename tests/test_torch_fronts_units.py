"""The client fronts' units held against the reference's: the same
scripted inputs through each reference function and its port, outputs
compared with ids and timestamps masked. The Anthropic front's request
mapping (system prompts, tools, stop sequences, image and tool-result
blocks), its response mapping and its stream re-encoder fed a scripted
OpenAI stream cut at every byte; the Responses front's request, response
and stream mapping with tools, its transcript stores (in memory and on
disk, the two packages on one directory), ``store: false`` and the
rollback; the multipart helpers; the rerank passthrough; the typed
request and response checks; and the translator registry."""

import dataclasses
import json
import os
import re

import pytest

from aigw_tpu.config.model import APISchemaName as JS
from aigw_tpu.gateway import server as jserver
from aigw_tpu.schemas import anthropic as janth
from aigw_tpu.schemas import openai as joai
from aigw_tpu.schemas import typed as jtyped
from aigw_tpu.schemas import typed_response as jtr
from aigw_tpu.translate import Endpoint as JE
from aigw_tpu.translate import base as jbase
from aigw_tpu.translate import multipart as jmp
from aigw_tpu.translate import responses as jresp
from aigw_tpu_torch.config.model import APISchemaName as TS
from aigw_tpu_torch.gateway import server as tserver
from aigw_tpu_torch.schemas import anthropic as tanth
from aigw_tpu_torch.schemas import openai as toai
from aigw_tpu_torch.schemas import typed as ttyped
from aigw_tpu_torch.schemas import typed_response as ttr
from aigw_tpu_torch.translate import Endpoint as TE
from aigw_tpu_torch.translate import base as tbase
from aigw_tpu_torch.translate import multipart as tmp
from aigw_tpu_torch.translate import responses as tresp

SIDES = {"ref": (jbase, JE, JS, joai), "port": (tbase, TE, TS, toai)}
_IDS = re.compile(r"(msg|fc|resp)_[0-9a-f]{24}")


def _scrub(b: bytes) -> bytes:
    return _IDS.sub(r"\1_*", b.decode()).encode()


def _plain(x):
    """Values of either package's classes made comparable: a dataclass
    (``TokenUsage``) as its fields."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, dataclasses.astuple(x))
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


def _outcome(fn):
    """(the value, or the error's type name, status and message)."""
    try:
        return ("ok", _plain(fn()))
    except Exception as e:  # noqa: BLE001 — the outcome is compared
        return ("err", type(e).__name__, getattr(e, "status", None),
                str(e))


def _both(fn):
    return {side: _outcome(lambda: fn(*mods))
            for side, mods in SIDES.items()}


# -- the registry ---------------------------------------------------------------
#: every backend schema: the hosted providers' translators are ported too
CARRIED = {s.value for s in TS}
_PORT_PAIRS = sorted((e.value, i.value, o.value)
                     for e, i, o in tbase.supported_pairs())


def test_supported_pairs_are_the_references_on_carried_schemas():
    ref = {(e.value, i.value, o.value) for e, i, o in jbase.supported_pairs()}
    want = {p for p in ref if p[2] in CARRIED} | {
        ("/v1/messages", "Anthropic", "Anthropic")}
    assert set(_PORT_PAIRS) == want
    assert CARRIED == {s.value for s in JS}


@pytest.mark.parametrize("pair", _PORT_PAIRS, ids=["|".join(p)
                                                   for p in _PORT_PAIRS])
def test_each_pair_builds_the_references_translator(pair):
    names = {}
    for side, (base, E, S, _o) in SIDES.items():
        t = base.get_translator(E(pair[0]), S(pair[1]), S(pair[2]))
        names[side] = type(t).__name__
    assert names["port"] == names["ref"]


# -- the Anthropic front --------------------------------------------------------
_TOOL = {"name": "get_weather", "description": "weather",
         "input_schema": {"type": "object", "properties": {
             "city": {"type": "string"}}}}
ANTHROPIC_REQUESTS = {
    "plain": {"model": "m", "max_tokens": 8,
              "messages": [{"role": "user", "content": "hi"}]},
    "system-string": {"model": "m", "max_tokens": 8, "system": "be kind",
                      "temperature": 0.3, "top_p": 0.9,
                      "messages": [{"role": "user", "content": "hi"}]},
    "system-blocks": {"model": "m", "max_tokens": 8, "system": [
        {"type": "text", "text": "a"}, {"type": "text", "text": "b",
                                        "cache_control": {}}],
        "messages": [{"role": "user", "content": "hi"}]},
    "mid-system": {"model": "m", "max_tokens": 8, "messages": [
        {"role": "user", "content": "hi"},
        {"role": "system", "content": "now formal"},
        {"role": "assistant", "content": [{"type": "text", "text": "ok"}]},
        {"role": "user", "content": "more"}]},
    "stop-stream": {"model": "m", "max_tokens": 8, "stream": True,
                    "stop_sequences": ["END", "\n\n"],
                    "messages": [{"role": "user", "content": "hi"}]},
    "tools-auto": {"model": "m", "max_tokens": 8, "tools": [_TOOL],
                   "tool_choice": {"type": "auto"},
                   "messages": [{"role": "user", "content": "weather?"}]},
    "tools-any": {"model": "m", "max_tokens": 8, "tools": [_TOOL],
                  "tool_choice": {"type": "any"},
                  "messages": [{"role": "user", "content": "weather?"}]},
    "tools-named": {"model": "m", "max_tokens": 8,
                    "tools": [dict(_TOOL, input_schema=None)],
                    "tool_choice": {"type": "tool", "name": "get_weather"},
                    "messages": [{"role": "user", "content": "weather?"}]},
    "tools-none": {"model": "m", "max_tokens": 8, "tools": [_TOOL],
                   "tool_choice": {"type": "none"},
                   "messages": [{"role": "user", "content": "x"}]},
    "tool-roundtrip": {"model": "m", "max_tokens": 8, "tools": [_TOOL],
                       "messages": [
        {"role": "user", "content": "weather in Paris?"},
        {"role": "assistant", "content": [
            {"type": "text", "text": "let me check"},
            {"type": "tool_use", "id": "tu_1", "name": "get_weather",
             "input": {"city": "Paris"}}]},
        {"role": "user", "content": [
            {"type": "tool_result", "tool_use_id": "tu_1",
             "content": [{"type": "text", "text": "sunny"}]},
            {"type": "text", "text": "thanks"}]}]},
    "images": {"model": "m", "max_tokens": 8, "messages": [
        {"role": "user", "content": [
            {"type": "image", "source": {"type": "base64",
                                         "media_type": "image/jpeg",
                                         "data": "AAAA"}},
            {"type": "image", "source": {"type": "url",
                                         "url": "https://x/y.png"}},
            {"type": "text", "text": "what is this?"}]}]},
    # refusals
    "no-max-tokens": {"model": "m",
                      "messages": [{"role": "user", "content": "x"}]},
    "bad-role": {"model": "m", "max_tokens": 8,
                 "messages": [{"role": "tool", "content": "x"}]},
    "bad-content": {"model": "m", "max_tokens": 8,
                    "messages": [{"role": "user", "content": 7}]},
    "no-messages": {"model": "m", "max_tokens": 8, "messages": []},
}


@pytest.mark.parametrize("name", sorted(ANTHROPIC_REQUESTS))
@pytest.mark.parametrize("target", ["OpenAI", "TPUServe"])
def test_anthropic_request_maps_as_reference(name, target):
    body = ANTHROPIC_REQUESTS[name]

    def run(base, E, S, _o):
        t = base.get_translator(E.MESSAGES, S.ANTHROPIC, S(target),
                                model_name_override="over"
                                if name == "plain" else "")
        tx = t.request(body)
        return json.loads(tx.body), tx.path, tx.stream

    got = _both(run)
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("name", sorted(ANTHROPIC_REQUESTS))
def test_anthropic_schema_helpers_match_reference(name):
    body = ANTHROPIC_REQUESTS[name]
    got = {side: (_outcome(lambda: a.validate_messages_request(body)),
                  _outcome(lambda: a.promote_system_messages(body)))
           for side, a in (("ref", janth), ("port", tanth))}
    assert got["port"] == got["ref"]


def _chat_body(content="hello", tool_calls=None, finish="stop",
               usage=(5, 3)):
    msg = {"role": "assistant", "content": content}
    if tool_calls:
        msg["tool_calls"] = tool_calls
    return {"id": "chatcmpl-1", "object": "chat.completion", "created": 1,
            "model": "tiny", "choices": [
                {"index": 0, "message": msg, "finish_reason": finish}],
            "usage": {"prompt_tokens": usage[0],
                      "completion_tokens": usage[1],
                      "total_tokens": sum(usage)}}


_CALLS = [{"id": "call_1", "type": "function", "function": {
    "name": "get_weather", "arguments": '{"city": "Paris"}'}},
    {"id": "call_2", "type": "function", "function": {
        "name": "noop", "arguments": "not json"}}]
CHAT_BODIES = {
    "text": _chat_body(),
    "length": _chat_body(finish="length"),
    "tools": _chat_body(content=None, tool_calls=_CALLS,
                        finish="tool_calls"),
    "text-and-tools": _chat_body(tool_calls=_CALLS[:1]),
    "empty": _chat_body(content="", usage=(4, 0)),
    "filtered": _chat_body(finish="content_filter"),
}


@pytest.mark.parametrize("name", sorted(CHAT_BODIES))
def test_anthropic_response_maps_as_reference(name):
    raw = json.dumps(CHAT_BODIES[name]).encode()

    def run(base, E, S, _o):
        t = base.get_translator(E.MESSAGES, S.ANTHROPIC, S.TPUSERVE)
        t.request(ANTHROPIC_REQUESTS["plain"])
        t._id = "msg_fixed"
        rx = t.response_body(raw, True)
        return json.loads(rx.body), rx.usage, rx.model

    got = _both(run)
    assert got["port"] == got["ref"]
    assert got["port"][0] == "ok"


def _sse(*events):
    return b"".join(b"data: " + (e if isinstance(e, bytes)
                                 else json.dumps(e).encode()) + b"\n\n"
                    for e in events)


def _chunk(delta=None, finish=None, usage=None):
    d = {"id": "chatcmpl-1", "object": "chat.completion.chunk",
         "created": 1, "model": "tiny", "choices": []}
    if delta is not None or finish is not None:
        d["choices"] = [{"index": 0, "delta": delta or {},
                         "finish_reason": finish}]
    if usage is not None:
        d["usage"] = usage
    return d


_U = {"prompt_tokens": 7, "completion_tokens": 3, "total_tokens": 10}
STREAMS = {
    "text": _sse(_chunk({"role": "assistant", "content": ""}),
                 _chunk({"content": "Hel"}), _chunk({"content": "lo é"}),
                 _chunk(finish="length"), _chunk(usage=_U), b"[DONE]"),
    "tools": _sse(
        _chunk({"role": "assistant", "content": "checking"}),
        _chunk({"tool_calls": [{"index": 0, "id": "call_1",
                                "type": "function", "function": {
                                    "name": "get_weather",
                                    "arguments": ""}}]}),
        _chunk({"tool_calls": [{"index": 0, "function": {
            "arguments": '{"city": '}}]}),
        _chunk({"tool_calls": [{"index": 0, "function": {
            "arguments": '"Paris"}'}}]}),
        _chunk({"tool_calls": [{"index": 1, "function": {
            "arguments": "{}"}}]}),
        _chunk({"tool_calls": [{"index": 1, "id": "call_2",
                                "function": {"name": "noop"}}]}),
        _chunk(finish="tool_calls"), _chunk(usage=_U), b"[DONE]"),
    "no-done": _sse(_chunk({"content": "cut"}), _chunk(usage=_U)),
    "crlf": _sse(_chunk({"content": "a"})).replace(b"\n", b"\r\n")
    + b": comment\n\n" + _sse(_chunk({"content": "b"}), b"[DONE]"),
}


def _feed(t, pieces):
    out, usage, toks, model = b"", None, 0, ""
    for i, p in enumerate(pieces):
        rx = t.response_body(p, i == len(pieces) - 1)
        out += rx.body
        usage = rx.usage if usage is None else usage.merge_override(rx.usage)
        toks += rx.tokens_emitted
        model = rx.model or model
    return out, usage, toks, model


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_anthropic_stream_reencodes_as_reference_at_every_cut(name):
    """The scripted OpenAI stream split in two at every byte, then whole
    and byte by byte: the same Anthropic event bytes, usage and token
    counts on both sides."""
    raw = STREAMS[name]
    cuts = [[raw[:k], raw[k:], b""] for k in range(len(raw) + 1)]
    cuts += [[raw[i:i + 1] for i in range(len(raw))] + [b""]]

    def run(base, E, S, _o):
        outs = []
        for pieces in cuts:
            t = base.get_translator(E.MESSAGES, S.ANTHROPIC, S.TPUSERVE)
            t.request(dict(ANTHROPIC_REQUESTS["plain"], stream=True))
            t._id = "msg_fixed"
            outs.append(_feed(t, pieces))
        return outs

    got = _both(run)
    assert got["port"] == got["ref"]
    bodies = {o[0] for o in got["port"][1]}
    assert len(bodies) == 1  # the cut never shows in the events
    assert b"event: message_stop" in bodies.pop()


def test_anthropic_error_body_and_usage_match_reference():
    for a in (janth, tanth):
        assert a.error_body("x", "api_error") == janth.error_body(
            "x", "api_error")
    body = {"usage": {"input_tokens": 3, "output_tokens": 4,
                      "cache_read_input_tokens": 2,
                      "cache_creation_input_tokens": 1}}
    for b in (body, {}):
        assert _plain(tanth.extract_usage(b)) == \
            _plain(janth.extract_usage(b))


# -- the Responses front --------------------------------------------------------
_RTOOL = {"type": "function", "name": "get_weather", "parameters": {
    "type": "object"}, "strict": True, "description": "d"}
RESPONSES_REQUESTS = {
    "string": {"model": "m", "input": "plain string"},
    "instructions": {"model": "m", "instructions": "be kind",
                     "max_output_tokens": 50, "temperature": 0.2,
                     "top_p": 0.5, "stream": True, "input": [
                         {"type": "message", "role": "user", "content": [
                             {"type": "input_text", "text": "hel"},
                             {"type": "input_text", "text": "lo"}]}]},
    "bare-items": {"model": "m", "input": [
        {"role": "user", "content": "q"},
        {"role": "assistant", "content": [
            {"type": "output_text", "text": "a"}]}]},
    "tools": {"model": "m", "input": "weather?", "tools": [_RTOOL],
              "tool_choice": {"type": "function", "name": "get_weather"},
              "parallel_tool_calls": False},
    "tool-choice-string": {"model": "m", "input": "x",
                           "tools": [_RTOOL], "tool_choice": "required"},
    "function-io": {"model": "m", "input": [
        {"role": "user", "content": "weather in Paris and Rome?"},
        {"type": "function_call", "call_id": "c1", "name": "get_weather",
         "arguments": '{"city": "Paris"}'},
        {"type": "function_call", "call_id": "c2", "name": "get_weather",
         "arguments": ""},
        {"type": "function_call_output", "call_id": "c1",
         "output": "sunny"},
        {"type": "function_call_output", "call_id": "c2",
         "output": {"temp": 20}}]},
    # refusals
    "web-search-tool": {"model": "m", "input": "x",
                        "tools": [{"type": "web_search"}]},
    "bad-parts": {"model": "m", "input": [
        {"type": "message", "role": "user", "content": ["x"]}]},
    "unknown-item": {"model": "m", "input": [{"type": "reasoning"}]},
    "no-input": {"model": "m"},
    "unknown-previous": {"model": "m", "input": "x",
                         "previous_response_id": "resp_nope"},
}


@pytest.fixture
def stores(tmp_path):
    """Fresh transcript stores for both packages, restored after."""
    saved = (jresp.RESPONSE_STORE._impl, tresp.RESPONSE_STORE._impl)
    jresp.RESPONSE_STORE._impl = jresp.ResponseStore()
    tresp.RESPONSE_STORE._impl = tresp.ResponseStore()
    yield tmp_path
    jresp.RESPONSE_STORE._impl, tresp.RESPONSE_STORE._impl = saved


def _resp_translator(base, E, S, out="TPUServe"):
    return base.get_translator(E.RESPONSES, S.OPENAI, S(out))


@pytest.mark.parametrize("name", sorted(RESPONSES_REQUESTS))
def test_responses_request_maps_as_reference(name, stores):
    body = RESPONSES_REQUESTS[name]

    def run(base, E, S, _o):
        tx = _resp_translator(base, E, S).request(body)
        return json.loads(tx.body), tx.path, tx.stream

    got = _both(run)
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("name", sorted(CHAT_BODIES))
def test_responses_response_maps_as_reference(name, stores):
    raw = json.dumps(CHAT_BODIES[name]).encode()

    def run(base, E, S, _o):
        t = _resp_translator(base, E, S)
        t.request({"model": "m", "input": "hi"})
        t._id, t._created = "resp_fixed", 1
        rx = t.response_body(raw, True)
        return _scrub(rx.body), rx.usage, rx.model

    got = _both(run)
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_responses_stream_reencodes_as_reference(name, stores):
    raw = STREAMS[name]
    cuts = [[raw[:k], raw[k:], b""] for k in range(0, len(raw) + 1, 7)]

    def run(base, E, S, _o):
        outs = []
        for pieces in cuts:
            t = _resp_translator(base, E, S)
            t.request({"model": "m", "input": "hi", "stream": True})
            t._id, t._created = "resp_fixed", 1
            body, usage, toks, model = _feed(t, pieces)
            outs.append((_scrub(body), usage, toks, model))
        return outs

    got = _both(run)
    assert got["port"] == got["ref"]
    assert len({o[0] for o in got["port"][1]}) == 1
    # the stored transcript of the streamed turn
    assert (tresp.RESPONSE_STORE.get("resp_fixed")
            == jresp.RESPONSE_STORE.get("resp_fixed"))


def _turn(rid, base, E, S, body, chat):
    t = _resp_translator(base, E, S)
    t._id = rid
    tx = t.request(body)
    rx = t.response_body(json.dumps(chat).encode(), True)
    return t._id, json.loads(tx.body), json.loads(rx.body)


def test_responses_multi_turn_store_false_and_rollback(stores):
    """Turn two by ``previous_response_id`` sends the stored transcript
    (system messages dropped, new instructions first); ``store: false``
    keeps nothing; a deleted id is a 404 on both sides."""
    got = {}
    for side, (base, E, S, _o) in SIDES.items():
        mod = jresp if side == "ref" else tresp
        rid, _req1, _r1 = _turn("resp_one", base, E, S, {
            "model": "m", "instructions": "old", "input": "hi"},
            CHAT_BODIES["tools"])
        _rid2, req2, _r2 = _turn("resp_two", base, E, S, {
            "model": "m", "instructions": "new", "previous_response_id": rid,
            "input": [{"type": "function_call_output", "call_id": "call_1",
                       "output": "sunny"}]}, CHAT_BODIES["text"])
        off, _q, _r = _turn("resp_off", base, E, S, {
            "model": "m", "input": "x", "store": False}, CHAT_BODIES["text"])
        kept = mod.RESPONSE_STORE.get(off)
        mod.RESPONSE_STORE.delete(rid)
        gone = _outcome(lambda: _resp_translator(base, E, S).request({
            "model": "m", "input": "x", "previous_response_id": rid}))
        got[side] = (req2, kept, gone)
    assert got["port"] == got["ref"]
    assert got["port"][0]["messages"][0] == {"role": "system",
                                             "content": "new"}
    assert got["port"][1] is None
    assert got["port"][2][:3] == ("err", "NotFoundError", 404)


def test_file_stores_share_one_directory(tmp_path):
    """A transcript one package writes, the other reads, in the same
    bytes; ids outside the safe charset never touch the disk; TTL and
    count garbage collection and the router's choice match."""
    msgs = [{"role": "user", "content": "hi é"},
            {"role": "assistant", "content": None, "tool_calls": []}]
    ref = jresp.FileResponseStore(str(tmp_path / "a"))
    port = tresp.FileResponseStore(str(tmp_path / "a"))
    ref.put("resp_ref", msgs)
    port.put("resp_port", msgs)
    assert port.get("resp_ref") == ref.get("resp_port") == msgs
    assert (tmp_path / "a" / "resp_ref.json").read_bytes() == \
        (tmp_path / "a" / "resp_port.json").read_bytes()
    for bad in ("../x", "", "a" * 200, "a/b"):
        assert port._safe(bad) is None and ref._safe(bad) is None
        port.put(bad, msgs)
        assert port.get(bad) is None
    port.delete("resp_ref")
    assert ref.get("resp_ref") is None
    # count bound: the oldest go first, on both
    for mod, d in ((jresp, "j"), (tresp, "t")):
        s = mod.FileResponseStore(str(tmp_path / d), max_entries=3)
        for i in range(6):
            s.put(f"resp_{i}", msgs)
            os.utime(tmp_path / d / f"resp_{i}.json", (1e9 + i, 1e9 + i))
        s._ttl = 1e12
        s._gc()
        assert sorted(p.name for p in (tmp_path / d).iterdir()) == [
            "resp_3.json", "resp_4.json", "resp_5.json"]


def test_store_router_reads_the_env_at_first_use(tmp_path, monkeypatch):
    monkeypatch.setenv("AIGW_RESPONSES_DIR", str(tmp_path))
    r = tresp._StoreRouter()
    assert r.blocking and isinstance(r._impl, tresp.FileResponseStore)
    monkeypatch.delenv("AIGW_RESPONSES_DIR")
    r = tresp._StoreRouter()
    assert not r.blocking and isinstance(r._impl, tresp.ResponseStore)
    mem = tresp.ResponseStore(max_entries=2, ttl_s=3600)
    for i in range(3):
        mem.put(f"r{i}", [{"role": "user", "content": str(i)}])
    assert mem.get("r0") is None and mem.get("r2") is not None


# -- multipart, rerank ----------------------------------------------------------
def _form(model=b"whisper-1", boundary=b"XyZ", quoted=False, name=b'"model"'):
    ctype = ("multipart/form-data; boundary="
             + (f'"{boundary.decode()}"' if quoted else boundary.decode()))
    raw = (b"--" + boundary + b"\r\nContent-Disposition: form-data; name="
           + name + b"\r\n\r\n" + model + b"\r\n--" + boundary
           + b'\r\nContent-Disposition: form-data; name="file"; '
           b'filename="a.wav"\r\n\r\nRIFF\x00\xff--\r\n--' + boundary
           + b"--\r\n")
    return raw, ctype


MULTIPART = {
    "plain": _form(),
    "quoted": _form(quoted=True, boundary=b"a-b_c"),
    "unquoted-name": _form(name=b"model"),
    "no-model": _form(name=b'"prompt"'),
    "no-boundary": (_form()[0], "multipart/form-data"),
    "not-multipart": (b'{"model": "x"}', "application/json"),
    "truncated": (_form()[0][:60], _form()[1]),
}


@pytest.mark.parametrize("name", sorted(MULTIPART))
def test_multipart_helpers_match_reference(name):
    raw, ctype = MULTIPART[name]
    got = {side: (m.parse_multipart_boundary(ctype),
                  m.rewrite_multipart_model(raw, ctype, "whisper-large"),
                  s._multipart_model(raw, ctype))
           for side, m, s in (("ref", jmp, jserver), ("port", tmp, tserver))}
    assert got["port"] == got["ref"]


RERANK = {
    "ok": {"model": "rr", "query": "q", "documents": ["a", {"text": "b"}]},
    "no-query": {"model": "rr", "documents": ["a"]},
    "no-documents": {"model": "rr", "query": "q", "documents": []},
}


@pytest.mark.parametrize("name", sorted(RERANK))
@pytest.mark.parametrize("override", ["", "rerank-big"])
def test_rerank_passthrough_matches_reference(name, override):
    upstream = json.dumps({"id": "x", "model": "rr", "results": [
        {"index": 0, "relevance_score": 0.5}],
        "meta": {"billed_units": {"input_tokens": 9,
                                  "output_tokens": 1}}}).encode()

    def run(base, E, S, _o):
        t = base.get_translator(E.RERANK, S.COHERE, S.COHERE,
                                model_name_override=override)
        tx = t.request(RERANK[name])
        rx = t.response_body(upstream, True)
        mid = t.response_body(b"part", False)
        return json.loads(tx.body), tx.path, rx.body, rx.usage, rx.model, \
            mid.body

    got = _both(run)
    assert got["port"] == got["ref"]


# -- typed checks -----------------------------------------------------------------
TYPED_REQUESTS = [
    ("/v1/images/generations", {"prompt": "a cat", "n": 2,
                                "size": "1024x1024", "quality": "hd"}),
    ("/v1/images/generations", {"prompt": ""}),
    ("/v1/images/generations", {"prompt": "x", "n": 11}),
    ("/v1/images/generations", {"prompt": "x", "style": "odd"}),
    ("/v2/rerank", {"model": "r", "query": "q", "documents": ["a"]}),
    ("/v2/rerank", {"model": "r", "query": "q", "documents": [{"x": 1}]}),
    ("/v2/rerank", {"model": "r", "query": "q", "documents": [],
                    "top_n": 0}),
    ("/v1/audio/speech", {"model": "t", "input": "hi", "voice": "alloy",
                          "speed": 1.5}),
    ("/v1/audio/speech", {"model": "t", "input": "hi", "voice": "a",
                          "speed": 9}),
    ("/v1/audio/speech", {"model": "t", "input": "hi"}),
    ("/tokenize", {"model": "m", "prompt": "p"}),
    ("/tokenize", {"model": "m", "messages": [{"role": "user"}]}),
    ("/tokenize", {"model": "m", "prompt": "p", "messages": []}),
    ("/tokenize", {"model": "m", "messages": ["x"]}),
    ("/v1/responses", {"model": "m", "input": "x"}),
    ("/v1/responses", {"model": "m", "input": [
        {"role": "user", "content": "hi"},
        {"type": "message", "role": "assistant", "content": [
            {"type": "output_text", "text": "a", "annotations": []}]},
        {"type": "function_call", "call_id": "c", "name": "f",
         "arguments": "{}"},
        {"type": "function_call_output", "call_id": "c", "output": "o"},
        {"type": "reasoning", "summary": [{"type": "summary_text"}]},
        {"type": "item_reference", "id": "i"},
        {"type": "future_kind"}],
        "tools": [_RTOOL, {"type": "web_search"}],
        "reasoning": {"effort": "low"}, "truncation": "auto"}),
    ("/v1/responses", {"model": "m", "input": [{"role": "bot",
                                                "content": "x"}]}),
    ("/v1/responses", {"model": "m", "input": [{"type": "function_call",
                                                "name": "f"}]}),
    ("/v1/responses", {"model": "m", "input": [{"role": "user",
                                                "content": []}]}),
    ("/v1/responses", {"model": "m", "input": [{"role": "user",
                                                "content": [{}]}]}),
    ("/v1/responses", {"model": "m", "input": [
        {"role": "user", "content": [{"type": "input_image",
                                      "detail": "huge"}]}]}),
    ("/v1/responses", {"model": "m", "input": "x", "temperature": 3}),
    ("/v1/responses", {"model": "m", "input": "x",
                       "tools": [{"type": "function"}]}),
    ("/v1/responses", {"model": "m", "input": "x",
                       "reasoning": {"effort": "max"}}),
    ("/v1/responses", {"model": "m", "input": 5}),
]


@pytest.mark.parametrize("path,body", TYPED_REQUESTS,
                         ids=[f"{p}-{i}" for i, (p, _b)
                              in enumerate(TYPED_REQUESTS)])
def test_typed_request_checks_match_reference(path, body):
    got = {side: _outcome(lambda: typed.validate_request(path, body))
           for side, typed in (("ref", jtyped), ("port", ttyped))}
    assert got["port"] == got["ref"]


TYPED_RESPONSES = [
    ("RERANK", {"results": [{"index": 0, "relevance_score": 0.5}]}),
    ("RERANK", {"results": [{"index": 0}]}),
    ("RERANK", {"results": [{"index": 0, "relevance_score": 0.5,
                             "document": {"text": 3}}]}),
    ("IMAGES_GENERATIONS", {"data": [{"url": "https://x"}]}),
    ("IMAGES_GENERATIONS", {"data": [{"b64_json": "aGk="}]}),
    ("IMAGES_GENERATIONS", {"data": [{}]}),
    ("TOKENIZE", {"count": 3, "tokens": [1, 2, 3]}),
    ("TOKENIZE", {"tokens": []}),
    ("TOKENIZE", {"count": 1, "tokens": ["a"]}),
    ("MESSAGES", {"content": [
        {"type": "text", "text": "hi"},
        {"type": "thinking", "thinking": "...", "signature": "s"},
        {"type": "some_future_block"}]}),
    ("MESSAGES", {"content": [{"type": "text"}]}),
    ("MESSAGES", {"content": [{"type": "tool_use", "id": "t",
                               "name": "f"}]}),
    ("MESSAGES", {"content": [{}]}),
    ("MESSAGES", {"content": [], "usage": {"input_tokens": -1}}),
    ("RESPONSES", {"id": "resp_1", "status": "completed", "output": [
        {"type": "message", "role": "assistant", "content": [
            {"type": "output_text", "text": "hi", "annotations": []}]},
        {"type": "function_call", "call_id": "c1", "name": "f",
         "arguments": "{}"},
        {"type": "reasoning", "summary": [{"type": "summary_text",
                                           "text": "t"}]},
        {"type": "future_item_kind"}],
        "usage": {"input_tokens": 1, "output_tokens": 2,
                  "total_tokens": 3}}),
    ("RESPONSES", {"output": []}),
    ("RESPONSES", {"id": "r", "output": [{"type": "function_call",
                                          "name": "f", "arguments": "{}"}]}),
    ("RESPONSES", {"id": "r", "output": [{"type": "message", "content": [
        {"type": "output_text"}]}]}),
    ("RESPONSES", {"id": "r", "status": "odd", "output": []}),
    ("RESPONSES", {"id": "r", "output": [],
                   "usage": {"input_tokens": -5}}),
    ("CHAT_COMPLETIONS", {"choices": "nope"}),
    ("AUDIO_SPEECH", {"anything": 1}),
]


@pytest.mark.parametrize("ep,body", TYPED_RESPONSES,
                         ids=[f"{e}-{i}" for i, (e, _b)
                              in enumerate(TYPED_RESPONSES)])
def test_typed_response_checks_match_reference(ep, body):
    got = {side: _outcome(lambda: tr.validate_response(E[ep], body))
           for side, tr, E in (("ref", jtr, JE), ("port", ttr, TE))}
    assert got["port"] == got["ref"]


STREAM_EVENTS = [
    ("MESSAGES", {"type": "content_block_delta", "index": 0,
                  "delta": {"type": "text_delta", "text": "x"}}),
    ("MESSAGES", {"type": "content_block_delta", "delta": {}}),
    ("MESSAGES", {"type": "message_start", "message": {}}),
    ("MESSAGES", {"type": "message_start"}),
    ("MESSAGES", {"type": "message_delta", "delta": {"stop_reason": "x"},
                  "usage": {"output_tokens": 1}}),
    ("MESSAGES", {"type": "error", "error": None}),
    ("MESSAGES", {"type": "ping"}),
    ("MESSAGES", {"no": "type"}),
    ("MESSAGES", ["not", "an", "object"]),
    ("RESPONSES", {"type": "response.output_text.delta", "delta": "x"}),
    ("RESPONSES", {"type": "response.output_text.delta", "delta": 3}),
    ("RESPONSES", {"type": "response.created", "response": {"id": "r"}}),
    ("RESPONSES", {"type": "response.completed", "response": {
        "id": "r", "output": []}}),
    ("RESPONSES", {"type": "response.completed", "response": {
        "output": []}}),
    ("RESPONSES", {"type": "response.output_item.added",
                   "output_index": 0, "item": {"type": "function_call",
                                               "name": "f"}}),
    ("RESPONSES", {"type": "response.future.event"}),
    ("RESPONSES", {"type": ""}),
    ("CHAT_COMPLETIONS", {"choices": [{"index": 0, "delta": "x"}]}),
    ("CHAT_COMPLETIONS", {"choices": [{"index": 0,
                                       "finish_reason": "stop"}]}),
]


@pytest.mark.parametrize("ep,event", STREAM_EVENTS,
                         ids=[f"{e}-{i}" for i, (e, _b)
                              in enumerate(STREAM_EVENTS)])
def test_typed_stream_event_checks_match_reference(ep, event):
    got = {side: _outcome(lambda: tr.validate_stream_event(E[ep], event))
           for side, tr, E in (("ref", jtr, JE), ("port", ttr, TE))}
    assert got["port"] == got["ref"]


def test_every_endpoint_has_the_references_specs():
    for e in JE:
        t = TE(e.value)
        assert ttr.has_spec(t) == jtr.has_spec(e), e
        assert ttr.has_stream_spec(t) == jtr.has_stream_spec(e), e


def test_gateway_registers_every_reference_endpoint():
    """The port's ``_ENDPOINTS`` is the reference's table, and its
    server routes the five batch routes beside them."""
    ref = {p: (e.value, s.value, op)
           for p, (e, s, op) in jserver._ENDPOINTS.items()}
    port = {p: (e.value, s.value, op)
            for p, (e, s, op) in tserver._ENDPOINTS.items()}
    assert port == ref and len(port) == 11
    assert {e.value for e in tserver._MULTIPART_ENDPOINTS} == \
        {e.value for e in jserver._MULTIPART_ENDPOINTS}
    from aigw_tpu_torch.config import model as tmodel
    from aigw_tpu_torch.config import runtime as truntime

    rc = truntime.RuntimeConfig.build(tmodel.Config.parse({
        "version": "v1", "backends": [{"name": "a", "schema": "OpenAI",
                                       "url": "http://127.0.0.1:1"}]}))
    routes = tserver.GatewayServer(rc).http.routes
    for key in [("POST", p) for p in ref] + [
            ("POST", "/v1/files"), ("GET", "/v1/files/{fid}/content"),
            ("POST", "/v1/batches"), ("GET", "/v1/batches/{bid}"),
            ("POST", "/v1/batches/{bid}/cancel")]:
        assert key in routes, key
