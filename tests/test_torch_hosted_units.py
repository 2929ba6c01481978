"""The upstream credentials and the hosted-provider translators held
against the reference's: every pair of the translator registry fed the
same requests and the same scripted upstream replies (non-streamed, and
streamed under seeded random chunkings that cut SSE lines and AWS
event-stream frames anywhere), with the uuid and the clock frozen in
both packages; the event-stream codec; every auth handler kind (SigV4
with its clock frozen), ``file:`` secrets on rewrite and when empty;
the OIDC exchangers and the credential rotator against one
standard-library fake IdP/STS; redaction, the Gemini schema converter
and the vendor-field helpers."""

import asyncio
import base64
import contextlib
import dataclasses
import datetime
import http.server
import inspect
import json
import os
import stat
import struct
import threading
import time
import types
import uuid
import zlib
from unittest import mock

import numpy as np
import pytest

from aigw_tpu.config import model as jmodel
from aigw_tpu.gateway.auth import handlers as jauth
from aigw_tpu.gateway.auth import oidc as joidc
from aigw_tpu.translate import base as jbase
from aigw_tpu.translate import eventstream as jes
from aigw_tpu.translate import openai_awsbedrock as jbr
from aigw_tpu.translate import structured as jst
from aigw_tpu.translate import vendor_fields as jvf
from aigw_tpu.utils import redaction as jred
from aigw_tpu_torch.config import model as tmodel
from aigw_tpu_torch.gateway.auth import handlers as tauth
from aigw_tpu_torch.gateway.auth import oidc as toidc
from aigw_tpu_torch.gateway.http import HTTPClient
from aigw_tpu_torch.translate import base as tbase
from aigw_tpu_torch.translate import eventstream as tes
from aigw_tpu_torch.translate import openai_awsbedrock as tbr
from aigw_tpu_torch.translate import structured as tst
from aigw_tpu_torch.translate import vendor_fields as tvf
from aigw_tpu_torch.utils import redaction as tred

SIDES = {"ref": (jbase, jmodel), "port": (tbase, tmodel)}
FROZEN_TIME = 1_700_000_000.0


def _plain(x):
    """Values of either package's classes made comparable."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, _plain(dataclasses.asdict(x)))
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


def _outcome(fn):
    try:
        return ("ok", _plain(fn()))
    except Exception as e:  # noqa: BLE001 — the outcome is compared
        return ("err", type(e).__name__, getattr(e, "status", None), str(e))


@contextlib.contextmanager
def _frozen():
    """uuid4 counts from 1 and the wall clock stands still, so two
    translators built in turn emit the same ids and timestamps."""
    n = iter(range(1, 1 << 30))
    with mock.patch.object(uuid, "uuid4", lambda: uuid.UUID(int=next(n))), \
            mock.patch.object(time, "time", lambda: FROZEN_TIME):
        yield


# -- upstream replies, by backend schema ----------------------------------------
def _sse(events) -> bytes:
    return b"".join(
        (f"event: {name}\n" if name else "").encode()
        + f"data: {json.dumps(d) if not isinstance(d, str) else d}\n\n"
        .encode() for name, d in events)


def _frame(etype: str, payload: dict) -> bytes:
    return jes.encode_message(
        {":message-type": "event", ":event-type": etype,
         ":content-type": "application/json"}, json.dumps(payload).encode())


OAI_CHAT = {"id": "chatcmpl-up", "object": "chat.completion", "created": 1,
            "model": "up-model", "choices": [{
                "index": 0, "message": {"role": "assistant",
                                        "content": "hello there"},
                "finish_reason": "stop"}],
            "usage": {"prompt_tokens": 3, "completion_tokens": 2,
                      "total_tokens": 5}}
OAI_CHAT_SSE = _sse([
    (None, {"id": "c1", "object": "chat.completion.chunk", "created": 1,
            "model": "up-model", "choices": [{"index": 0, "delta": {
                "role": "assistant", "content": "hel"},
                "finish_reason": None}]}),
    (None, {"id": "c1", "object": "chat.completion.chunk", "created": 1,
            "model": "up-model", "choices": [{"index": 0, "delta": {
                "content": "lo"}, "finish_reason": "stop"}]}),
    (None, {"id": "c1", "object": "chat.completion.chunk", "created": 1,
            "model": "up-model", "choices": [], "usage": {
                "prompt_tokens": 3, "completion_tokens": 2,
                "total_tokens": 5}}),
    (None, "[DONE]")])
ANTH_MSG = {"id": "msg_up", "type": "message", "role": "assistant",
            "model": "sonnet-up", "content": [
                {"type": "thinking", "thinking": "let me see",
                 "signature": "sig-1"},
                {"type": "redacted_thinking", "data": "opaque"},
                {"type": "text", "text": "It is sunny."},
                {"type": "tool_use", "id": "toolu_1", "name": "get_weather",
                 "input": {"city": "SF"}}],
            "stop_reason": "tool_use", "stop_sequence": None,
            "usage": {"input_tokens": 12, "output_tokens": 7,
                      "cache_read_input_tokens": 4,
                      "cache_creation_input_tokens": 2}}
ANTH_EVENTS = [
    ("message_start", {"type": "message_start", "message": {
        "id": "msg_up", "type": "message", "role": "assistant",
        "model": "sonnet-up", "content": [], "stop_reason": None,
        "usage": {"input_tokens": 12, "output_tokens": 1,
                  "cache_read_input_tokens": 4,
                  "cache_creation_input_tokens": 2}}}),
    ("ping", {"type": "ping"}),
    ("content_block_start", {"type": "content_block_start", "index": 0,
                             "content_block": {"type": "thinking",
                                               "thinking": ""}}),
    ("content_block_delta", {"type": "content_block_delta", "index": 0,
                             "delta": {"type": "thinking_delta",
                                       "thinking": "let me "}}),
    ("content_block_delta", {"type": "content_block_delta", "index": 0,
                             "delta": {"type": "thinking_delta",
                                       "thinking": "see"}}),
    ("content_block_delta", {"type": "content_block_delta", "index": 0,
                             "delta": {"type": "signature_delta",
                                       "signature": "sig-1"}}),
    ("content_block_stop", {"type": "content_block_stop", "index": 0}),
    ("content_block_start", {"type": "content_block_start", "index": 1,
                             "content_block": {"type": "redacted_thinking",
                                               "data": "opaque"}}),
    ("content_block_stop", {"type": "content_block_stop", "index": 1}),
    ("content_block_start", {"type": "content_block_start", "index": 2,
                             "content_block": {"type": "text", "text": ""}}),
    ("content_block_delta", {"type": "content_block_delta", "index": 2,
                             "delta": {"type": "text_delta",
                                       "text": "It is "}}),
    ("content_block_delta", {"type": "content_block_delta", "index": 2,
                             "delta": {"type": "text_delta",
                                       "text": "sunny. é✓"}}),
    ("content_block_stop", {"type": "content_block_stop", "index": 2}),
    ("content_block_start", {"type": "content_block_start", "index": 3,
                             "content_block": {"type": "tool_use",
                                               "id": "toolu_1",
                                               "name": "get_weather",
                                               "input": {}}}),
    ("content_block_delta", {"type": "content_block_delta", "index": 3,
                             "delta": {"type": "input_json_delta",
                                       "partial_json": "{\"city\": "}}),
    ("content_block_delta", {"type": "content_block_delta", "index": 3,
                             "delta": {"type": "input_json_delta",
                                       "partial_json": "\"SF\"}"}}),
    ("content_block_stop", {"type": "content_block_stop", "index": 3}),
    ("message_delta", {"type": "message_delta", "delta": {
        "stop_reason": "tool_use", "stop_sequence": None},
        "usage": {"output_tokens": 7}}),
    ("message_stop", {"type": "message_stop"}),
]
ANTH_SSE = _sse(ANTH_EVENTS)
BEDROCK_ANTH_STREAM = b"".join(
    _frame("chunk", {"bytes": base64.b64encode(
        json.dumps(d).encode()).decode()}) for _n, d in ANTH_EVENTS)
CONVERSE = {"output": {"message": {"role": "assistant", "content": [
    {"reasoningContent": {"reasoningText": {"text": "think",
                                            "signature": "s1"}}},
    {"text": "hola"},
    {"toolUse": {"toolUseId": "t1", "name": "get_weather",
                 "input": {"city": "SF"}}}]}},
    "stopReason": "tool_use",
    "usage": {"inputTokens": 7, "outputTokens": 3, "totalTokens": 10,
              "cacheReadInputTokens": 2, "cacheWriteInputTokens": 1}}
CONVERSE_STREAM = (
    _frame("messageStart", {"role": "assistant"})
    + _frame("contentBlockDelta", {"contentBlockIndex": 0, "delta": {
        "reasoningContent": {"text": "thi"}}})
    + _frame("contentBlockDelta", {"contentBlockIndex": 0, "delta": {
        "reasoningContent": {"text": "nk"}}})
    + _frame("contentBlockDelta", {"contentBlockIndex": 0, "delta": {
        "reasoningContent": {"signature": "s1"}}})
    + _frame("contentBlockStop", {"contentBlockIndex": 0})
    + _frame("contentBlockDelta", {"contentBlockIndex": 1, "delta": {
        "text": "bon"}})
    + _frame("contentBlockDelta", {"contentBlockIndex": 1, "delta": {
        "text": "jour ✓"}})
    + _frame("contentBlockStop", {"contentBlockIndex": 1})
    + _frame("contentBlockStart", {"contentBlockIndex": 2, "start": {
        "toolUse": {"toolUseId": "t1", "name": "get_weather"}}})
    + _frame("contentBlockDelta", {"contentBlockIndex": 2, "delta": {
        "toolUse": {"input": "{\"city\":"}}})
    + _frame("contentBlockDelta", {"contentBlockIndex": 2, "delta": {
        "toolUse": {"input": "\"SF\"}"}}})
    + _frame("contentBlockStop", {"contentBlockIndex": 2})
    + _frame("messageStop", {"stopReason": "tool_use"})
    + _frame("metadata", {"usage": {"inputTokens": 7, "outputTokens": 3,
                                    "totalTokens": 10,
                                    "cacheReadInputTokens": 2},
                          "metrics": {"latencyMs": 5}}))
GEMINI = {"candidates": [{"content": {"role": "model", "parts": [
    {"text": "pondering", "thought": True, "thoughtSignature": "c2ln"},
    {"text": "ciao"},
    {"functionCall": {"name": "get_weather", "args": {"city": "SF"}}}]},
    "finishReason": "STOP"}],
    "usageMetadata": {"promptTokenCount": 6, "candidatesTokenCount": 2,
                      "totalTokenCount": 11, "thoughtsTokenCount": 3,
                      "cachedContentTokenCount": 1},
    "modelVersion": "gemini-up"}
GEMINI_SSE = _sse([
    (None, {"candidates": [{"content": {"role": "model", "parts": [
        {"text": "pon", "thought": True}]}}]}),
    (None, {"candidates": [{"content": {"role": "model", "parts": [
        {"text": "dering", "thought": True, "thoughtSignature": "c2ln"}]}}],
        "modelVersion": "gemini-up"}),
    (None, {"candidates": [{"content": {"role": "model", "parts": [
        {"text": "ci"}]}}]}),
    (None, {"candidates": [{"content": {"role": "model", "parts": [
        {"text": "ao ✓"},
        {"functionCall": {"name": "get_weather", "args": {"city": "SF"}}}]},
        "finishReason": "STOP"}],
        "usageMetadata": {"promptTokenCount": 6, "candidatesTokenCount": 2,
                          "totalTokenCount": 11, "thoughtsTokenCount": 3}}),
])
OAI_COMPLETION = {"id": "cmpl-up", "object": "text_completion", "created": 1,
                  "model": "up-model", "choices": [{
                      "index": 0, "text": "abc", "finish_reason": "length"}],
                  "usage": {"prompt_tokens": 2, "completion_tokens": 3,
                            "total_tokens": 5}}
OAI_COMPLETION_SSE = _sse([
    (None, {"id": "cmpl-up", "object": "text_completion", "created": 1,
            "model": "up-model", "choices": [{"index": 0, "text": "ab",
                                              "finish_reason": None}]}),
    (None, {"id": "cmpl-up", "object": "text_completion", "created": 1,
            "model": "up-model", "choices": [{"index": 0, "text": "c",
                                              "finish_reason": "length"}],
            "usage": {"prompt_tokens": 2, "completion_tokens": 3,
                      "total_tokens": 5}}),
    (None, "[DONE]")])
OAI_EMBEDDINGS = {"object": "list", "model": "emb-up", "data": [
    {"object": "embedding", "index": 0, "embedding": [0.1, -0.2]},
    {"object": "embedding", "index": 1, "embedding": [0.3, 0.4]}],
    "usage": {"prompt_tokens": 4, "total_tokens": 4}}
VERTEX_EMBEDDINGS = {"predictions": [
    {"embeddings": {"values": [0.1, 0.2],
                    "statistics": {"token_count": 2, "truncated": False}}},
    {"embeddings": {"values": [0.3, 0.4],
                    "statistics": {"token_count": 3, "truncated": False}}}]}
TITAN = {"embedding": [1.0, 2.0, 3.0], "inputTextTokenCount": 4}
OAI_RESPONSES = {"id": "resp_up", "object": "response", "created_at": 1,
                 "status": "completed", "model": "up-model", "output": [{
                     "type": "message", "id": "msg_up", "role": "assistant",
                     "status": "completed", "content": [{
                         "type": "output_text", "text": "hi",
                         "annotations": []}]}],
                 "usage": {"input_tokens": 3, "output_tokens": 1,
                           "total_tokens": 4}}

#: (endpoint, backend schema, streamed) → (content-type, reply bytes)
_OAI = ("application/json", OAI_CHAT)
REPLIES = {
    ("chat", "OpenAI", False): _OAI, ("chat", "TPUServe", False): _OAI,
    ("chat", "AzureOpenAI", False): _OAI,
    ("chat", "OpenAI", True): ("text/event-stream", OAI_CHAT_SSE),
    ("chat", "TPUServe", True): ("text/event-stream", OAI_CHAT_SSE),
    ("chat", "AzureOpenAI", True): ("text/event-stream", OAI_CHAT_SSE),
    ("chat", "Anthropic", False): ("application/json", ANTH_MSG),
    ("chat", "GCPAnthropic", False): ("application/json", ANTH_MSG),
    ("chat", "AWSAnthropic", False): ("application/json", ANTH_MSG),
    ("chat", "Anthropic", True): ("text/event-stream", ANTH_SSE),
    ("chat", "GCPAnthropic", True): ("text/event-stream", ANTH_SSE),
    ("chat", "AWSAnthropic", True): (
        "application/vnd.amazon.eventstream", BEDROCK_ANTH_STREAM),
    ("chat", "AWSBedrock", False): ("application/json", CONVERSE),
    ("chat", "AWSBedrock", True): (
        "application/vnd.amazon.eventstream", CONVERSE_STREAM),
    ("chat", "GCPVertexAI", False): ("application/json", GEMINI),
    ("chat", "GCPVertexAI", True): ("text/event-stream", GEMINI_SSE),
    ("completions", None, False): ("application/json", OAI_COMPLETION),
    ("completions", None, True): ("text/event-stream", OAI_COMPLETION_SSE),
    ("embeddings", "GCPVertexAI", False): (
        "application/json", VERTEX_EMBEDDINGS),
    ("embeddings", "AWSBedrock", False): ("application/json", TITAN),
    ("embeddings", None, False): ("application/json", OAI_EMBEDDINGS),
    ("tokenize", "Anthropic", False): ("application/json",
                                       {"input_tokens": 11}),
    ("tokenize", "GCPAnthropic", False): ("application/json",
                                          {"input_tokens": 11}),
    ("tokenize", "AWSAnthropic", False): ("application/json",
                                          {"inputTokens": 9}),
    ("tokenize", "GCPVertexAI", False): ("application/json",
                                         {"totalTokens": 7}),
    ("tokenize", None, False): ("application/json", {
        "count": 2, "max_model_len": 64, "tokens": [104, 105]}),
    ("images", None, False): ("application/json", {
        "created": 1, "data": [{"url": "https://img/1"}]}),
    ("speech", None, False): ("audio/mpeg", b"ID3\x00\x01binary"),
    ("transcriptions", None, False): ("application/json", {"text": "hi"}),
    ("rerank", None, False): ("application/json", {
        "id": "r1", "results": [{"index": 1, "relevance_score": 0.9}],
        "meta": {"billed_units": {"search_units": 1}}}),
    ("responses", "OpenAI", False): ("application/json", OAI_RESPONSES),
    ("responses", "OpenAI", True): ("text/event-stream", _sse([
        ("response.created", {"type": "response.created", "response": dict(
            OAI_RESPONSES, status="in_progress", output=[])}),
        ("response.output_text.delta", {
            "type": "response.output_text.delta", "item_id": "msg_up",
            "output_index": 0, "content_index": 0, "delta": "hi"}),
        ("response.completed", {"type": "response.completed",
                                "response": OAI_RESPONSES})])),
}
#: the Messages and Responses fronts reach the backend's chat reply
_CHAT_LIKE = {"/v1/messages", "/v1/responses"}
_EP_KEY = {"/v1/chat/completions": "chat", "/v1/completions": "completions",
           "/v1/embeddings": "embeddings", "/tokenize": "tokenize",
           "/v1/images/generations": "images", "/v1/audio/speech": "speech",
           "/v1/audio/transcriptions": "transcriptions",
           "/v1/audio/translations": "transcriptions",
           "/v2/rerank": "rerank", "/v1/messages": "chat",
           "/v1/responses": "chat"}


def reply_for(ep: str, front: str, back: str, stream: bool):
    key = _EP_KEY[ep]
    if ep == "/v1/responses" and back == "OpenAI":
        key = "responses"
    if ep == "/v1/messages" and back == "TPUServe" or (
            ep == "/v1/messages" and back == "OpenAI"):
        back = "OpenAI"
    for k in ((key, back, stream), (key, None, stream)):
        if k in REPLIES:
            ctype, payload = REPLIES[k]
            raw = payload if isinstance(payload, bytes) else \
                json.dumps(payload).encode()
            return ctype, raw
    raise KeyError((ep, back, stream))


# -- client requests, by endpoint -----------------------------------------------
_TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "description": "get weather",
    "parameters": {"type": "object", "properties": {
        "city": {"type": "string"}}, "required": ["city"]}}}]
CHAT_REQUESTS = {
    "plain": {"model": "m-1", "messages": [
        {"role": "system", "content": "be brief"},
        {"role": "user", "content": "hi"}],
        "max_tokens": 64, "temperature": 0.5, "top_p": 0.9,
        "stop": ["END"]},
    "tools": {"model": "m-1", "messages": [
        {"role": "user", "content": "weather in SF?"},
        {"role": "assistant", "content": None, "tool_calls": [{
            "id": "call_1", "type": "function", "function": {
                "name": "get_weather", "arguments": "{\"city\": \"SF\"}"}}]},
        {"role": "tool", "tool_call_id": "call_1", "content": "sunny"}],
        "tools": _TOOLS, "tool_choice": "auto", "max_tokens": 32},
    "thinking": {"model": "sonnet-4", "messages": [
        {"role": "user", "content": [
            {"type": "text", "text": "think"},
            {"type": "image_url", "image_url": {
                "url": "data:image/png;base64,iVBORw0KGgo="}}]},
        {"role": "assistant", "content": "ok", "thinking_blocks": [
            {"type": "thinking", "thinking": "prior", "signature": "sg"}]},
        {"role": "user", "content": "again"}],
        "thinking": {"type": "enabled", "budget_tokens": 1024},
        "max_completion_tokens": 2048},
    "schema": {"model": "gemini-2.5-flash", "messages": [
        {"role": "user", "content": "json please"}],
        "response_format": {"type": "json_schema", "json_schema": {
            "name": "w", "schema": {"type": "object", "properties": {
                "t": {"type": ["number", "null"]},
                "tags": {"type": "array", "items": {"$ref": "#/$defs/tag"}}},
                "$defs": {"tag": {"type": "string"}}}}},
        "reasoning_effort": "low"},
    "bad-role": {"model": "m-1", "messages": [
        {"role": "robot", "content": "x"}]},
}
MESSAGES_REQUESTS = {
    "plain": {"model": "sonnet-up", "max_tokens": 16, "system": "be kind",
              "messages": [{"role": "user", "content": "hi"}]},
    "tools": {"model": "us.anthropic.sonnet-up", "max_tokens": 16,
              "temperature": 0.2, "top_k": 5, "stop_sequences": ["X"],
              "thinking": {"type": "enabled", "budget_tokens": 1024},
              "tools": [{"name": "get_weather", "description": "w",
                         "input_schema": {"type": "object"}}],
              "tool_choice": {"type": "auto"}, "messages": [
                  {"role": "user", "content": "weather?"},
                  {"role": "assistant", "content": [
                      {"type": "thinking", "thinking": "t",
                       "signature": "s"},
                      {"type": "tool_use", "id": "t1", "name": "get_weather",
                       "input": {"city": "SF"}}]},
                  {"role": "user", "content": [
                      {"type": "tool_result", "tool_use_id": "t1",
                       "content": "sunny"}]}]},
}
RESPONSES_REQUESTS = {
    "plain": {"model": "m-1", "input": "hi", "instructions": "be brief",
              "max_output_tokens": 16},
    "tools": {"model": "m-1", "input": [
        {"type": "message", "role": "user", "content": "weather?"}],
        "tools": [{"type": "function", "name": "get_weather",
                   "parameters": {"type": "object"}}], "store": False},
}
OTHER_REQUESTS = {
    "/v1/completions": {"plain": {"model": "m-1", "prompt": "hi",
                                  "max_tokens": 4}},
    "/v1/embeddings": {
        "list": {"model": "text-emb", "input": ["a", "b"]},
        "titan": {"model": "amazon.titan-embed-text-v2:0", "input": "hi",
                  "dimensions": 256, "encoding_format": "float"},
        "tasks": {"model": "text-emb", "input": "a", "dimensions": 8,
                  "task_type": "RETRIEVAL_QUERY", "title": "t",
                  "auto_truncate": False}},
    "/tokenize": {
        "prompt": {"model": "us.anthropic.sonnet-up", "prompt": "hello"},
        "messages": {"model": "c", "messages": [
            {"role": "system", "content": "s"},
            {"role": "user", "content": "hello"}]}},
    "/v1/images/generations": {"plain": {"model": "dall-e", "prompt": "cat"}},
    "/v1/audio/speech": {"plain": {"model": "tts", "input": "hi",
                                   "voice": "alloy"}},
    "/v1/audio/transcriptions": {"plain": {"model": "whisper"}},
    "/v1/audio/translations": {"plain": {"model": "whisper"}},
    "/v2/rerank": {"plain": {"model": "rerank", "query": "q",
                             "documents": ["a", "b"]}},
}


def requests_for(ep: str) -> dict[str, dict]:
    if ep == "/v1/chat/completions":
        return CHAT_REQUESTS
    if ep == "/v1/messages":
        return MESSAGES_REQUESTS
    if ep == "/v1/responses":
        return RESPONSES_REQUESTS
    return OTHER_REQUESTS[ep]


_PAIRS = [(e.value, i.value, o.value) for e, i, o in tbase.supported_pairs()]
CASES = []
for _ep, _front, _back in _PAIRS:
    for _name, _req in requests_for(_ep).items():
        CASES.append((_ep, _front, _back, _name, _req))


def _translate(side, ep, front, back, req, chunks, *, status=200,
               override="", version="", ctype=""):
    """Drive one translator as the gateway does: the request, then the
    reply's head and body (whole, or chunk by chunk with a final empty
    end), or the error body. Returns everything the gateway would send
    upstream and to the client."""
    base, model = SIDES[side]
    S = model.APISchemaName
    with _frozen():
        t = base.get_translator(base.Endpoint(ep), S(front), S(back),
                                model_name_override=override,
                                out_version=version)
        got = _outcome(lambda: t.request(json.loads(json.dumps(req))))
        if got[0] == "err":
            return {"request": got}
        tx = got[1][1]
        out = {"path": tx["path"], "headers": tx["headers"],
               "stream": tx["stream"],
               "body": json.loads(tx["body"]) if tx["body"] else None}
        if chunks is None:
            return out
        if status >= 400:
            out["error"] = _outcome(
                lambda: t.response_error(status, b"".join(chunks)))
            return out
        t.response_headers(status, {"content-type": ctype})
        client, usage, model_seen, emitted = b"", [], [], 0
        steps = [(c, False) for c in chunks] + [(b"", True)] \
            if tx["stream"] else [(b"".join(chunks), True)]
        for chunk, end in steps:
            rx = _outcome(lambda: t.response_body(chunk, end))
            if rx[0] == "err":
                out["response_error"] = rx
                break
            r = rx[1][1]
            client += r["body"]
            usage.append(r["usage"])
            model_seen.append(r["model"])
            emitted += r["tokens_emitted"]
        out.update(client=client, usage=usage, model=model_seen,
                   emitted=emitted)
        return out


def _chunkings(raw: bytes, seed: int, n: int = 3) -> list[list[bytes]]:
    """Whole, then ``n`` seeded random cuttings of ``raw`` into 2-12
    pieces at arbitrary byte offsets."""
    rng = np.random.default_rng(seed)
    out = [[raw]]
    for _ in range(n):
        k = int(rng.integers(1, min(12, len(raw) - 1)))
        cuts = sorted(rng.choice(np.arange(1, len(raw)), size=k,
                                 replace=False).tolist())
        edges = [0] + cuts + [len(raw)]
        out.append([raw[a:b] for a, b in zip(edges, edges[1:])])
    return out


def _both(*args, **kw):
    ref = _translate("ref", *args, **kw)
    port = _translate("port", *args, **kw)
    assert port == ref
    return ref


# -- the registry ---------------------------------------------------------------
def test_supported_pairs_are_the_same_list():
    ref = [(e.value, i.value, o.value) for e, i, o in jbase.supported_pairs()]
    assert _PAIRS == ref
    assert len(ref) == 66


# -- every pair: request, reply and stream --------------------------------------
@pytest.mark.parametrize("ep,front,back,name,req", CASES,
                         ids=[f"{e}|{f}|{b}|{n}"
                              for e, f, b, n, _r in CASES])
def test_pair_matches_reference(ep, front, back, name, req):
    """The same request gives the same upstream body, path and headers;
    the same reply the same client bytes, usage and model, whole and
    under seeded chunkings when streamed; the streamed twin of the
    request too."""
    seed = zlib.crc32(f"{ep}{front}{back}{name}".encode())
    got = _both(ep, front, back, req, None)
    if "request" in got:
        return
    ctype, raw = reply_for(ep, front, back, False)
    _both(ep, front, back, req, [raw], ctype=ctype)
    streamable = ep in ("/v1/chat/completions", "/v1/completions",
                        "/v1/messages", "/v1/responses")
    if not streamable:
        return
    sreq = dict(req, stream=True)
    if ep == "/v1/chat/completions":
        sreq["stream_options"] = {"include_usage": True}
    got = _both(ep, front, back, sreq, None)
    if "request" in got or not got["stream"]:
        return
    ctype, raw = reply_for(ep, front, back, True)
    for chunks in _chunkings(raw, seed):
        _both(ep, front, back, sreq, chunks, ctype=ctype)


ERRORS = {
    "Anthropic": (429, {"type": "error", "error": {
        "type": "rate_limit_error", "message": "slow down"}}),
    "GCPAnthropic": (400, {"type": "error", "error": {
        "type": "invalid_request_error", "message": "bad"}}),
    "AWSAnthropic": (403, {"message": "not authorized"}),
    "AWSBedrock": (400, {"message": "ValidationException: bad"}),
    "GCPVertexAI": (500, {"error": {"code": 500, "message": "boom",
                                    "status": "INTERNAL"}}),
    "AzureOpenAI": (401, {"error": {"message": "bad key",
                                    "type": "invalid_request_error"}}),
    "OpenAI": (503, b"upstream <html> not json"),
    "TPUServe": (404, {"error": {"message": "no model"}}),
    "Cohere": (422, {"message": "bad docs"}),
}


@pytest.mark.parametrize("pair", _PAIRS, ids=["|".join(p) for p in _PAIRS])
def test_upstream_error_matches_reference(pair):
    """An upstream 4xx/5xx body becomes the same client error envelope."""
    ep, front, back = pair
    status, body = ERRORS[back]
    raw = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = next(iter(requests_for(ep).values()))
    _both(ep, front, back, req, [raw], status=status)


@pytest.mark.parametrize("ep,back,override,version", [
    ("/v1/chat/completions", "AzureOpenAI", "my deploy/1", "2024-10-21"),
    ("/v1/audio/speech", "AzureOpenAI", "", "2024-06-01"),
    ("/v1/embeddings", "AzureOpenAI", "", ""),
    ("/v1/chat/completions", "AWSBedrock", "us.anthropic.sonnet:0/x", ""),
    ("/v1/chat/completions", "GCPVertexAI", "gemini-2.5-pro", ""),
    ("/v1/chat/completions", "AWSAnthropic", "anthropic.sonnet-v2:1", ""),
    ("/v1/embeddings", "AWSBedrock", "amazon.titan-embed-g1:0", ""),
    ("/tokenize", "AWSAnthropic", "eu.anthropic.sonnet-x:0", ""),
])
def test_override_and_version_paths_match_reference(ep, back, override,
                                                    version):
    """The model override and the schema version shape the upstream path
    (Azure's deployment and ``api-version``, Bedrock's quoted model id)
    and the body as the reference does."""
    req = next(iter(requests_for(ep).values()))
    got = _both(ep, "OpenAI", back, req, None, override=override,
                version=version)
    if back == "AzureOpenAI":
        assert "?api-version=" in got["path"]


def test_bedrock_converse_usage_matches_reference():
    for u in ({}, {"inputTokens": 3, "outputTokens": 2},
              {"inputTokens": 3, "outputTokens": 2, "totalTokens": 9,
               "cacheReadInputTokens": 4, "cacheWriteInputTokens": 1}):
        assert _plain(tbr.converse_usage(u)) == _plain(jbr.converse_usage(u))


# -- AWS event-stream -----------------------------------------------------------
def _raw_frame(headers: bytes, payload: bytes) -> bytes:
    total = 12 + len(headers) + len(payload) + 4
    prelude = struct.pack(">II", total, len(headers))
    body = prelude + struct.pack(">I", zlib.crc32(prelude)) + headers \
        + payload
    return body + struct.pack(">I", zlib.crc32(body))


def _typed_headers() -> bytes:
    """One header of every event-stream value type."""
    def name(n: str) -> bytes:
        return bytes([len(n)]) + n.encode()
    return (name("t") + b"\x00" + name("f") + b"\x01"
            + name("b") + b"\x02" + bytes([7])
            + name("s") + b"\x03" + struct.pack(">h", -3)
            + name("i") + b"\x04" + struct.pack(">i", 70000)
            + name("l") + b"\x05" + struct.pack(">q", -(1 << 40))
            + name("ba") + b"\x06" + struct.pack(">H", 3) + b"xyz"
            + name("str") + b"\x07" + struct.pack(">H", 2) + "é".encode()
            + name("ts") + b"\x08" + struct.pack(">q", 1_700_000_000_000)
            + name("u") + b"\x09" + bytes(range(16)))


def test_eventstream_codec_matches_reference():
    """Frames encode to the same bytes and parse to the same messages in
    both packages, fed whole, byte by byte and under seeded cuttings;
    every header value type parses the same."""
    heads = {":event-type": "chunk", ":content-type": "application/json"}
    frames = [tes.encode_message(heads, b'{"n": %d}' % i) for i in range(4)]
    assert frames == [jes.encode_message(heads, b'{"n": %d}' % i)
                      for i in range(4)]
    raw = b"".join(frames) + _raw_frame(_typed_headers(), b"payload") \
        + CONVERSE_STREAM
    for chunks in _chunkings(raw, 7, n=6) + [
            [raw[i:i + 1] for i in range(len(raw))]]:
        got = {}
        for side, mod in (("ref", jes), ("port", tes)):
            p = mod.EventStreamParser()
            got[side] = [(m.headers, m.payload, m.event_type,
                          m.exception_type)
                         for c in chunks for m in p.feed(c)]
        assert got["port"] == got["ref"]
        assert len(got["port"]) == 5 + CONVERSE_STREAM.count(b":event-type")


@pytest.mark.parametrize("where", ["prelude", "message", "header-type"])
def test_eventstream_bad_frame_raises_in_both(where):
    good = tes.encode_message({":event-type": "x"}, b"{}")
    if where == "prelude":
        bad = good[:8] + bytes([good[8] ^ 1]) + good[9:]
    elif where == "message":
        bad = good[:-5] + bytes([good[-5] ^ 1]) + good[-4:]
    else:
        bad = _raw_frame(b"\x01a\x0b", b"")
    for mod in (jes, tes):
        with pytest.raises(ValueError) as e:
            mod.EventStreamParser().feed(bad)
        assert str(e.value) == {
            "prelude": "event-stream prelude CRC mismatch",
            "message": "event-stream message CRC mismatch",
            "header-type": "unknown event-stream header type 11"}[where]


# -- auth handlers --------------------------------------------------------------
class _FrozenDateTime(datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return datetime.datetime(2026, 3, 4, 5, 6, 7, tzinfo=tz)


@pytest.fixture
def frozen_sigv4_clock(monkeypatch):
    clock = types.SimpleNamespace(datetime=_FrozenDateTime,
                                  timezone=datetime.timezone)
    for mod in (jauth, tauth):
        monkeypatch.setattr(mod, "datetime", clock)


AUTHS = {
    "none": {"kind": "None"},
    "apikey": {"kind": "APIKey", "api_key": "sk-abc"},
    "anthropic": {"kind": "AnthropicAPIKey", "api_key": "ak-1",
                  "anthropic_version": "2023-01-01"},
    "azure-key": {"kind": "AzureAPIKey", "azure_api_key": "az-1"},
    "azure-key-fallback": {"kind": "AzureAPIKey", "api_key": "az-2"},
    "azure-token": {"kind": "AzureToken", "azure_access_token": "tok"},
    "gcp": {"kind": "GCPToken", "gcp_access_token": "ya29",
            "gcp_project": "proj-1", "gcp_region": "us-east5"},
    "sigv4": {"kind": "AWSSigV4", "aws_access_key_id": "AKIDEXAMPLE",
              "aws_secret_access_key": "wJalrXUtnFEMI/K7MDENG",
              "aws_region": "us-east-1"},
    "sigv4-session": {"kind": "AWSSigV4", "aws_access_key_id": "ASIA",
                      "aws_secret_access_key": "s3",
                      "aws_session_token": "sess/tok==",
                      "aws_region": "eu-west-2",
                      "aws_service": "bedrock-runtime"},
    "apikey-empty": {"kind": "APIKey", "api_key": ""},
    "sigv4-empty": {"kind": "AWSSigV4", "aws_access_key_id": "A",
                    "aws_region": "us-east-1"},
}
AUTH_PATHS = [
    "/v1/chat/completions",
    "/v1/projects/{GCP_PROJECT}/locations/{GCP_REGION}/publishers/google/"
    "models/gemini:streamGenerateContent?alt=sse",
    "/model/us.anthropic.sonnet%3A0%2Fx/converse-stream",
    "/openai/deployments/d/chat/completions?api-version=2024-10-21&b=a%20b",
]


@pytest.mark.parametrize("kind", AUTHS, ids=list(AUTHS))
def test_auth_handler_matches_reference(kind, frozen_sigv4_clock):
    """Every kind sets the same headers and path as the reference's, on
    every upstream path shape; SigV4, with the clock frozen in both
    modules, gives the same signature byte for byte, and one that moves
    with the body and the host."""
    cfg = AUTHS[kind]
    handlers = {"ref": jauth.new_handler(jmodel.AuthConfig.parse(cfg)),
                "port": tauth.new_handler(tmodel.AuthConfig.parse(cfg))}
    for path in AUTH_PATHS:
        for body in (b"", b'{"a": 1}', "é".encode()):
            got = {}
            for side, h in handlers.items():
                headers = {"host": "bedrock.example:443",
                           "content-type": "application/json",
                           "authorization": "Bearer client"}
                got[side] = _outcome(lambda: h.apply(headers, body, path))
            assert got["port"] == got["ref"]
    if kind == "sigv4":
        h = handlers["port"]
        a = h.apply({"host": "h1"}, b"x", AUTH_PATHS[2])[0]["authorization"]
        b = h.apply({"host": "h1"}, b"y", AUTH_PATHS[2])[0]["authorization"]
        c = h.apply({"host": "h2"}, b"x", AUTH_PATHS[2])[0]["authorization"]
        assert len({a, b, c}) == 3


def test_auth_config_parse_and_errors_match_reference():
    for cfg in list(AUTHS.values()) + [None, {}]:
        assert tmodel.AuthConfig.parse(cfg).to_dict() == \
            jmodel.AuthConfig.parse(cfg).to_dict()
    for bad in ({"kind": "APIKey", "apikey": "x"}, {"kind": "Basic"}):
        got = [_outcome(lambda m=m: m.AuthConfig.parse(bad))
               for m in (jmodel, tmodel)]
        assert got[1][1:] == got[0][1:] and got[0][0] == "err"


def test_file_secret_refreshes_on_rewrite_and_empty_raises(tmp_path):
    """A ``file:`` key is read at the first request, re-read when the
    file changes, and an empty or missing file raises ``AuthError`` in
    both packages, never sending an empty key."""
    key = tmp_path / "key"
    key.write_text("k-one\n")
    cfg = {"kind": "AnthropicAPIKey", "api_key": f"file:{key}"}
    hs = {"ref": jauth.new_handler(jmodel.AuthConfig.parse(cfg)),
          "port": tauth.new_handler(tmodel.AuthConfig.parse(cfg))}

    def apply_all():
        return {side: _outcome(lambda: h.apply({}, b"", "/v1/messages"))
                for side, h in hs.items()}

    got = apply_all()
    assert got["port"] == got["ref"]
    assert got["port"][1][0]["x-api-key"] == "k-one"
    key.write_text("k-two")
    os.utime(key, (1, 1))  # a distinct mtime, however fast the rewrite
    got = apply_all()
    assert got["port"] == got["ref"]
    assert got["port"][1][0]["x-api-key"] == "k-two"
    key.write_text("")
    os.utime(key, (2, 2))
    got = apply_all()
    assert got["port"] == got["ref"]
    assert got["port"][:2] == ("err", "AuthError")
    key.write_text("k-three")
    os.utime(key, (3, 3))
    got = apply_all()
    assert got["port"][1][0]["x-api-key"] == "k-three"
    key.unlink()
    got = apply_all()
    assert got["port"][:2] == ("err", "AuthError")
    assert got["port"][2:] == got["ref"][2:]


# -- OIDC exchange and rotation -------------------------------------------------
class _FakeIdP(http.server.ThreadingHTTPServer):
    """OIDC token endpoint, AWS STS, GCP STS, SA impersonation and an
    AAD token endpoint on the standard library; records every request's
    path, content type, authorization and body."""

    daemon_threads = True

    def __init__(self):
        self.seen: list[tuple] = []
        outer = self

        class H(http.server.BaseHTTPRequestHandler):
            def log_message(self, *_a):
                pass

            def do_POST(self):
                body = self.rfile.read(int(self.headers["content-length"]))
                outer.seen.append((self.path,
                                   self.headers.get("content-type"),
                                   self.headers.get("authorization"), body))
                status, ctype, out = outer.answer(self.path, body,
                                                  self.headers)
                self.send_response(status)
                self.send_header("content-type", ctype)
                self.send_header("content-length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)

        super().__init__(("127.0.0.1", 0), H)
        self.url = f"http://127.0.0.1:{self.server_address[1]}"
        threading.Thread(target=self.serve_forever, daemon=True).start()

    @staticmethod
    def answer(path, body, headers):
        import urllib.parse

        j = "application/json"
        if path in ("/oauth/token", "/azure/token"):
            form = dict(urllib.parse.parse_qsl(body.decode()))
            if form.get("client_secret") != "s3cret":
                return 401, j, b'{"error": "invalid_client"}'
            return 200, j, json.dumps({
                "id_token" if path == "/oauth/token" else "access_token":
                "oidc-jwt-123", "expires_in": 120}).encode()
        if path == "/aws-sts/":
            form = dict(urllib.parse.parse_qsl(body.decode()))
            if form.get("WebIdentityToken") != "oidc-jwt-123":
                return 403, "text/xml", b"<Error/>"
            return 200, "text/xml", (
                b"<AssumeRoleWithWebIdentityResponse><Credentials>"
                b"<AccessKeyId>ASIATEST</AccessKeyId>"
                b"<SecretAccessKey>awsSecret</SecretAccessKey>"
                b"<SessionToken>awsSession</SessionToken>"
                b"<Expiration>2099-01-01T00:00:00Z</Expiration>"
                b"</Credentials></AssumeRoleWithWebIdentityResponse>")
        if path == "/gcp-sts":
            if json.loads(body).get("subjectToken") != "oidc-jwt-123":
                return 403, j, b"{}"
            return 200, j, b'{"access_token": "gcp-fed", "expires_in": 300}'
        if path == "/impersonate":
            if headers.get("authorization") != "Bearer gcp-fed":
                return 403, j, b"{}"
            return 200, j, (b'{"accessToken": "gcp-sa", '
                            b'"expireTime": "2099-01-01T00:00:00Z"}')
        return 404, j, b"{}"


@pytest.fixture(scope="module")
def idp():
    srv = _FakeIdP()
    yield srv
    srv.shutdown()
    srv.server_close()


def _exchangers(mod, url, secret="s3cret"):
    prov = mod.OIDCTokenProvider(url + "/oauth/token", "cid", secret)
    return {
        "oidc": prov,
        "aws": mod.AWSOIDCExchanger(prov, "arn:aws:iam::1:role/r",
                                    sts_url=url + "/aws-sts"),
        "gcp": mod.GCPOIDCExchanger(prov, "//iam/pool",
                                    sts_url=url + "/gcp-sts"),
        "gcp-sa": mod.GCPOIDCExchanger(prov, "//iam/pool",
                                       sts_url=url + "/gcp-sts",
                                       impersonate_url=url + "/impersonate"),
        "azure": mod.AzureOIDCExchanger(url + "/azure/token", "cid", secret),
    }


async def _ref_fetch(ex):
    import aiohttp

    async with aiohttp.ClientSession() as session:
        return await ex.fetch(session)


async def _port_fetch(ex):
    client = HTTPClient()
    try:
        return await ex.fetch(client)
    finally:
        client.close()


@pytest.mark.parametrize("flow", ["oidc", "aws", "gcp", "gcp-sa", "azure"])
@pytest.mark.parametrize("secret", ["s3cret", "wrong"])
def test_oidc_exchange_matches_reference(idp, flow, secret, monkeypatch):
    """Each exchanger, on the port's own client, sends the IdP/STS the
    same requests as the reference's on aiohttp (form and JSON bodies,
    content types, the impersonation bearer) and returns the same
    credential and expiry, or the same error."""
    clock = types.SimpleNamespace(time=lambda: FROZEN_TIME)
    got, seen = {}, {}
    for side, mod, fetch in (("ref", joidc, _ref_fetch),
                             ("port", toidc, _port_fetch)):
        monkeypatch.setattr(mod, "time", clock)
        idp.seen.clear()
        ex = _exchangers(mod, idp.url, secret)[flow]
        got[side] = _outcome(lambda: asyncio.run(fetch(ex)))
        seen[side] = list(idp.seen)
    assert got["port"] == got["ref"]
    assert seen["port"] == seen["ref"]
    assert got["port"][0] == ("ok" if secret == "s3cret" else "err")


def test_rotator_writes_the_same_files_0600_in_order(idp, tmp_path):
    """``refresh_once`` writes each credential atomically with mode 0600,
    the AWS key id last, the same bytes as the reference's rotator; the
    port's rotator runs as a task on the caller's loop and keeps the
    last good credential when a refresh fails."""
    keys = ("aws_access_key_id", "aws_secret_access_key",
            "aws_session_token")
    files, order = {}, {}
    for side, mod, fetch_client in (("ref", joidc, None),
                                    ("port", toidc, HTTPClient)):
        d = tmp_path / side
        d.mkdir()
        paths = {k: str(d / k) for k in keys}
        rot = mod.CredentialRotator(_exchangers(mod, idp.url)["aws"], paths)
        written = []
        orig = rot._write_secret
        rot._write_secret = lambda p, v, o=orig, w=written: (
            w.append(os.path.basename(p)), o(p, v))

        async def once(rot=rot):
            if fetch_client is None:
                import aiohttp

                async with aiohttp.ClientSession() as s:
                    await rot.refresh_once(s)
            else:
                client = fetch_client()
                try:
                    await rot.refresh_once(client)
                finally:
                    client.close()

        asyncio.run(once())
        files[side] = {k: (open(p).read(),
                           stat.S_IMODE(os.stat(p).st_mode))
                       for k, p in paths.items()}
        order[side] = written
        assert not [f for f in os.listdir(d) if f.endswith(".tmp")]
    assert files["port"] == files["ref"]
    # the key id goes last; the others keep the mapping's order (the
    # reference's comment says "session token, secret", its stable sort
    # writes them as the mapping lists them)
    assert order["port"] == order["ref"] == [
        "aws_secret_access_key", "aws_session_token", "aws_access_key_id"]
    assert {m for _v, m in files["port"].values()} == {0o600}
    assert files["port"]["aws_access_key_id"][0] == "ASIATEST"

    async def run_task():
        out = str(tmp_path / "azure-token")
        rot = toidc.CredentialRotator(
            _exchangers(toidc, idp.url)["azure"],
            {"azure_access_token": out}, min_interval=0.05)
        await rot.start()
        for _ in range(200):
            if os.path.exists(out):
                break
            await asyncio.sleep(0.01)
        first = rot.current
        rot.exchanger = _exchangers(toidc, idp.url, "wrong")["azure"]
        await asyncio.sleep(0.2)
        await rot.stop()
        return open(out).read(), first, rot.current

    text, first, last = asyncio.run(run_task())
    assert text == "oidc-jwt-123"
    assert last is first  # a failed refresh keeps the last good one


# -- redaction, the Gemini schema and vendor fields ------------------------------
@pytest.mark.parametrize("sensitive", ["", "true"])
def test_redaction_matches_reference(sensitive, monkeypatch):
    monkeypatch.setenv("AIGW_LOG_SENSITIVE", sensitive)
    headers = {"Authorization": "Bearer x", "x-api-key": "k",
               "api-key": "a", "X-Amz-Security-Token": "t",
               "content-type": "application/json", "cookie": "c",
               "mcp-session-id": "m", "proxy-authorization": "p"}
    assert tred.redact_headers(headers) == jred.redact_headers(headers)
    assert tred.SENSITIVE_HEADERS == jred.SENSITIVE_HEADERS
    for body in ({"model": "m", "messages": [1, 2], "prompt": "abc",
                  "input": {"x": 1}, "system": "s", "documents": [],
                  "query": "q", "contents": [3]}, "raw", None, [1]):
        assert tred.redact_body(body) == jred.redact_body(body)
    assert tred.log_sensitive_allowed() == jred.log_sensitive_allowed()


GEMINI_SCHEMAS = [
    {"type": "object", "properties": {
        "a": {"type": ["string", "null"], "description": "d",
              "unknownField": 1},
        "b": {"anyOf": [{"type": "integer"}, {"type": "null"}]},
        "c": {"allOf": [{"type": "number", "minimum": 0}]},
        "d": {"$ref": "#/$defs/d"}},
        "required": ["a"], "$defs": {"d": {"type": "array",
                                            "items": {"type": "boolean"}}}},
    {"type": ["string", "integer"]},
    {"type": ["null", "null"]},
    {"type": 3},
    {"items": [1]},
    {"properties": []},
    {"properties": {"x": 1}},
    {"allOf": [{"type": "a"}, {"type": "b"}]},
    {"allOf": []},
    {"anyOf": [1]},
    {"$ref": "#/$defs/missing"},
    {"type": ["string"]},
    [],
]


@pytest.mark.parametrize("i", range(len(GEMINI_SCHEMAS)))
def test_gemini_schema_matches_reference(i):
    s = GEMINI_SCHEMAS[i]
    got = [_outcome(lambda m=m: m.to_gemini_schema(json.loads(json.dumps(s))))
           for m in (jst, tst)]
    assert got[1][1:] == got[0][1:] if got[0][0] == "err" else \
        got[1] == got[0]


VENDOR_BODIES = [
    {}, {"thinking": {"type": "enabled", "budget_tokens": 100,
                      "display": "summarized"}},
    {"thinking": {"type": "adaptive"}}, {"thinking": {"type": "disabled"}},
    {"thinking": {"type": "enabled", "budget_tokens": 5},
     "generationConfig": {"temperature": 0.1, "thinkingConfig": {
         "includeThoughts": True}},
     "safetySettings": [{"category": "x", "threshold": "y"}]},
    {"task_type": "RETRIEVAL", "title": "t", "auto_truncate": True},
    {"messages": [{"role": "user", "content": [
        {"type": "text", "text": "a",
         "cache_control": {"type": "ephemeral"}}]}]},
]


@pytest.mark.parametrize("i", range(len(VENDOR_BODIES)))
def test_vendor_fields_match_reference(i):
    body = VENDOR_BODIES[i]
    fns = [n for n in dir(jvf) if not n.startswith("_")
           and callable(getattr(jvf, n))
           and getattr(getattr(jvf, n), "__module__", "") == jvf.__name__]
    assert fns and sorted(fns) == sorted(
        n for n in dir(tvf) if not n.startswith("_")
        and callable(getattr(tvf, n))
        and getattr(getattr(tvf, n), "__module__", "") == tvf.__name__)
    for n in fns:
        args = list(inspect.signature(getattr(jvf, n)).parameters)
        if len(args) != 1:
            continue
        ref = _outcome(lambda: getattr(jvf, n)(json.loads(json.dumps(body))))
        port = _outcome(lambda: getattr(tvf, n)(json.loads(json.dumps(body))))
        assert port == ref, n


def test_message_delta_input_tokens_reference_fact():
    """An Anthropic stream whose ``message_start`` carries zero usage and
    whose ``message_delta`` carries the input count (what an Anthropic
    front over an OpenAI-schema upstream sends, the port's and the
    reference's alike): the reference's OpenAI → Anthropic translator
    reads only ``output_tokens`` there and bills 0 prompt tokens; the
    port's reads the cumulative input count. Every other byte is the
    reference's."""
    raw = _sse([
        ("message_start", {"type": "message_start", "message": {
            "id": "m", "type": "message", "role": "assistant", "model": "x",
            "content": [], "usage": {"input_tokens": 0,
                                     "output_tokens": 0}}}),
        ("content_block_start", {"type": "content_block_start", "index": 0,
                                 "content_block": {"type": "text",
                                                   "text": ""}}),
        ("content_block_delta", {"type": "content_block_delta", "index": 0,
                                 "delta": {"type": "text_delta",
                                           "text": "aa"}}),
        ("content_block_stop", {"type": "content_block_stop", "index": 0}),
        ("message_delta", {"type": "message_delta", "delta": {
            "stop_reason": "max_tokens", "stop_sequence": None},
            "usage": {"input_tokens": 66, "output_tokens": 2}}),
        ("message_stop", {"type": "message_stop"})])
    req = dict(CHAT_REQUESTS["plain"], stream=True,
               stream_options={"include_usage": True})
    got = {side: _translate(side, "/v1/chat/completions", "OpenAI",
                            "Anthropic", req, [raw],
                            ctype="text/event-stream")
           for side in SIDES}

    def last_usage(out):
        frames = [json.loads(ln[6:]) for ln in out["client"].decode()
                  .split("\n") if ln.startswith("data: {")]
        return frames[-1]["usage"]

    assert last_usage(got["ref"]) == {"prompt_tokens": 0,
                                      "completion_tokens": 2,
                                      "total_tokens": 2}
    assert last_usage(got["port"]) == {"prompt_tokens": 66,
                                       "completion_tokens": 2,
                                       "total_tokens": 68}
    strip = [{k: v for k, v in o.items() if k not in ("client", "usage")}
             for o in (got["ref"], got["port"])]
    assert strip[0] == strip[1]
    assert got["ref"]["client"].replace(b'"prompt_tokens": 0',
                                        b'"prompt_tokens": 66').replace(
        b'"total_tokens": 2}', b'"total_tokens": 68}') == got["port"]["client"]
