"""OpenAI request/response helpers for the replica server (the port's
own copy of the subset of ``aigw_tpu/schemas/openai.py`` it serves):
body parsing and validation for chat and completions, the response and
stream-chunk shapes, the embeddings response, ``/v1/models`` and error
envelopes."""

from __future__ import annotations

import json
import time
import uuid
from dataclasses import dataclass
from typing import Any, Iterable


class SchemaError(ValueError):
    """Client-facing 400: malformed request body."""

    status = 400


#: the engine's MeterRecord fields (one record per request lifetime,
#: ``Engine._meter_emit``), as the reference's ``gateway/costs.py`` meter
#: surface and its usage ledger read them off ``usage.aigw_meter``
METER_FIELDS: tuple[str, ...] = (
    "schema", "finish", "prefill_real", "prefill_padded", "prefix_reused",
    "decode_tokens", "spec_drafted", "spec_accepted", "hbm_page_byte_s",
    "host_page_byte_s", "segments", "tenant", "priority",
)


def meter_to_tuple(record: dict) -> tuple:
    """A MeterRecord dict → a hashable, order-stable tuple of ``(key,
    value)`` pairs for ``TokenUsage.meter`` (the port's copy of
    ``aigw_tpu/gateway/costs.py``'s ``meter_to_tuple``)."""
    return tuple(sorted((str(k), v) for k, v in record.items()))


@dataclass(frozen=True)
class TokenUsage:
    input_tokens: int = 0
    output_tokens: int = 0
    total_tokens: int = 0
    # prompt tokens whose KV came from the prefix cache
    cached_input_tokens: int = 0
    # the engine's MeterRecord as ``meter_to_tuple`` pairs (rendered as
    # ``usage.aigw_meter``); () = none
    meter: tuple = ()


def parse_json_body(body: bytes) -> dict[str, Any]:
    try:
        data = json.loads(body)
    except json.JSONDecodeError as e:
        raise SchemaError(f"invalid JSON body: {e}") from None
    if not isinstance(data, dict):
        raise SchemaError("request body must be a JSON object")
    return data


def request_model(body: dict[str, Any]) -> str:
    model = body.get("model")
    if not isinstance(model, str) or not model:
        raise SchemaError("missing required field: model")
    return model


def include_stream_usage(body: dict[str, Any]) -> bool:
    opts = body.get("stream_options") or {}
    return bool(opts.get("include_usage", False))


def message_content_text(content: Any) -> str:
    """Flatten the string-or-parts content union to text."""
    if content is None:
        return ""
    if isinstance(content, str):
        return content
    if isinstance(content, list):
        out = []
        for part in content:
            if isinstance(part, dict) and part.get("type") == "text":
                out.append(str(part.get("text", "")))
        return "".join(out)
    raise SchemaError(f"invalid message content type {type(content).__name__}")


def _validate_sampling_fields(body: dict[str, Any]) -> None:
    for key, lo, hi in (("temperature", 0.0, 2.0), ("top_p", 0.0, 1.0),
                        ("presence_penalty", -2.0, 2.0),
                        ("frequency_penalty", -2.0, 2.0)):
        v = body.get(key)
        if v is None:
            continue
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            raise SchemaError(f"{key} must be a number")
        if not (lo <= float(v) <= hi):
            raise SchemaError(f"{key} must be between {lo} and {hi}")
    n = body.get("n")
    if n is not None and (isinstance(n, bool) or not isinstance(n, int)
                          or n < 1):
        raise SchemaError("n must be a positive integer")
    stop = body.get("stop")
    if stop is not None and not isinstance(stop, str):
        if not isinstance(stop, list) or \
                any(not isinstance(s, str) for s in stop):
            raise SchemaError(
                "stop must be a string or an array of strings")
    opts = body.get("stream_options")
    if opts is not None:
        if not isinstance(opts, dict):
            raise SchemaError("stream_options must be an object")
        if not body.get("stream"):
            raise SchemaError(
                "stream_options is only allowed when stream is true")


def validate_chat_request(body: dict[str, Any]) -> None:
    """Edge validation of a chat body (model, messages, sampling
    fields); 400 on anything malformed."""
    request_model(body)
    messages = body.get("messages")
    if not isinstance(messages, list) or not messages:
        raise SchemaError("messages must be a non-empty array")
    for i, m in enumerate(messages):
        if not isinstance(m, dict):
            raise SchemaError(f"messages[{i}] must be an object")
        role = m.get("role")
        if role not in ("system", "developer", "user", "assistant", "tool"):
            raise SchemaError(f"messages[{i}] has invalid role {role!r}")
        message_content_text(m.get("content"))
    _validate_sampling_fields(body)


def usage_dict(usage: TokenUsage) -> dict[str, Any]:
    d: dict[str, Any] = {
        "prompt_tokens": usage.input_tokens,
        "completion_tokens": usage.output_tokens,
        "total_tokens": usage.total_tokens
        or usage.input_tokens + usage.output_tokens,
    }
    if usage.cached_input_tokens:
        d["prompt_tokens_details"] = {
            "cached_tokens": usage.cached_input_tokens}
    if usage.meter:
        d["aigw_meter"] = dict(usage.meter)
    return d


def chat_completion_response(*, model: str, content: str,
                             finish_reason: str = "stop",
                             usage: TokenUsage | None = None,
                             response_id: str = "",
                             tool_calls: list[dict[str, Any]] | None = None
                             ) -> dict[str, Any]:
    message: dict[str, Any] = {"role": "assistant", "content": content}
    if tool_calls:
        message["tool_calls"] = tool_calls
        if not content:
            message["content"] = None
    return {
        "id": response_id or f"chatcmpl-{uuid.uuid4().hex[:24]}",
        "object": "chat.completion",
        "created": int(time.time()),
        "model": model,
        "choices": [{"index": 0, "message": message,
                     "finish_reason": finish_reason}],
        "usage": usage_dict(usage or TokenUsage()),
    }


def completion_response(*, model: str, text: str, finish_reason: str,
                        usage: TokenUsage, response_id: str,
                        created: int) -> dict[str, Any]:
    return {
        "id": response_id,
        "object": "text_completion",
        "created": created,
        "model": model,
        "choices": [{"index": 0, "text": text,
                     "finish_reason": finish_reason}],
        "usage": usage_dict(usage),
    }


def sse(data: str) -> bytes:
    """One server-sent event carrying ``data``."""
    return ("".join(f"data: {line}\n" for line in data.split("\n"))
            + "\n").encode()


def stream_chunk_sse(*, response_id: str, model: str, created: int,
                     delta: dict[str, Any] | None = None,
                     finish_reason: str | None = None,
                     usage: TokenUsage | None = None,
                     logprobs: dict[str, Any] | None = None,
                     index: int = 0) -> bytes:
    """One ``chat.completion.chunk`` as an SSE event: choice ``index``
    (with its ``logprobs`` when given), or no choice when there is
    neither a delta nor a finish (a usage chunk)."""
    chunk: dict[str, Any] = {
        "id": response_id,
        "object": "chat.completion.chunk",
        "created": created or int(time.time()),
        "model": model,
        "choices": [],
    }
    if delta is not None or finish_reason is not None:
        choice: dict[str, Any] = {
            "index": index, "delta": delta if delta is not None else {},
            "finish_reason": finish_reason}
        if logprobs is not None:
            choice["logprobs"] = logprobs
        chunk["choices"] = [choice]
    if usage is not None:
        chunk["usage"] = usage_dict(usage)
    return sse(json.dumps(chunk))


def completion_chunk_sse(*, response_id: str, model: str, created: int,
                         text: str | None, finish_reason: str | None = None,
                         usage: TokenUsage | None = None,
                         logprobs: dict[str, Any] | None = None,
                         index: int = 0) -> bytes:
    """One legacy ``text_completion`` stream event: choice ``index``
    (with its legacy ``logprobs`` when given), or ``choices: []`` when
    ``text`` is None (an ``n > 1`` stream's usage event)."""
    choices: list[dict[str, Any]] = []
    if text is not None:
        choices.append({"index": index, "text": text,
                        "finish_reason": finish_reason})
        if logprobs is not None:
            choices[0]["logprobs"] = logprobs
    ev: dict[str, Any] = {
        "id": response_id, "object": "text_completion", "created": created,
        "model": model, "choices": choices,
    }
    if usage is not None:
        ev["usage"] = usage_dict(usage)
    return sse(json.dumps(ev))


def embeddings_response(*, model: str, vectors: Iterable[list[float]],
                        usage: TokenUsage) -> dict[str, Any]:
    """The ``/v1/embeddings`` body: one indexed entry per input, and a
    usage with prompt tokens only."""
    return {
        "object": "list",
        "model": model,
        "data": [{"object": "embedding", "index": i, "embedding": v}
                 for i, v in enumerate(vectors)],
        "usage": {
            "prompt_tokens": usage.input_tokens,
            "total_tokens": usage.total_tokens or usage.input_tokens,
        },
    }


def models_response(models: Iterable[tuple]) -> dict[str, Any]:
    """(name, owned_by, created[, extra]) tuples → /v1/models body; a
    non-empty ``extra`` dict merges into the entry (the replica's
    ``capabilities``)."""
    data = []
    for item in models:
        name, owned_by, created = item[:3]
        entry: dict[str, Any] = {"id": name, "object": "model",
                                 "created": created or int(time.time()),
                                 "owned_by": owned_by}
        if len(item) > 3 and item[3]:
            entry.update(item[3])
        data.append(entry)
    return {"object": "list", "data": data}


def error_body(message: str, type_: str = "invalid_request_error",
               code: Any = None) -> bytes:
    """OpenAI-format error envelope."""
    return json.dumps(
        {"error": {"message": message, "type": type_, "code": code}}
    ).encode()
