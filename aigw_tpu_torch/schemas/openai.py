"""OpenAI request/response helpers (the port's own copy of the parts of
``aigw_tpu/schemas/openai.py`` it serves): body parsing and validation
for chat and completions, the response and stream-chunk shapes, the
embeddings response, ``/v1/models`` and error envelopes for the
replica; for the gateway, the reference's stricter edge checks of a
chat body (``validate_gateway_chat_request``) and ``extract_usage``,
which reads token usage and the engine's MeterRecord off a response or
a stream chunk."""

from __future__ import annotations

import json
import time
import uuid
from typing import Any, Iterable

from aigw_tpu_torch.gateway.costs import (  # noqa: F401 (re-exported)
    METER_FIELDS,
    TokenUsage,
    meter_to_tuple,
)


class SchemaError(ValueError):
    """Client-facing 400: malformed request body."""

    status = 400


class NotFoundError(SchemaError):
    """Client-facing 404: a referenced resource does not exist (an
    unknown ``previous_response_id``; OpenAI answers 404 for these, and
    SDK retry logic branches on 404 against 400)."""

    status = 404


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


# -- the gateway's edge checks ----------------------------------------------
#: content-part types accepted in user messages
_USER_CONTENT_PART_TYPES = ("text", "image_url", "input_audio", "file")


def _validate_content(i: int, role: str, content: Any) -> None:
    if content is None or isinstance(content, str):
        return
    if not isinstance(content, list):
        raise SchemaError(
            f"messages[{i}].content must be a string or an array of "
            f"content parts, got {type(content).__name__}")
    for j, part in enumerate(content):
        if not isinstance(part, dict):
            raise SchemaError(
                f"messages[{i}].content[{j}] must be an object")
        ptype = part.get("type")
        if role == "user":
            if ptype not in _USER_CONTENT_PART_TYPES:
                raise SchemaError(
                    f"messages[{i}].content[{j}] has invalid type "
                    f"{ptype!r}")
            if ptype == "text" and not isinstance(part.get("text"), str):
                raise SchemaError(
                    f"messages[{i}].content[{j}].text must be a string")
            if ptype == "image_url" and not isinstance(
                    part.get("image_url"), dict):
                raise SchemaError(
                    f"messages[{i}].content[{j}].image_url must be an "
                    "object")
        else:  # assistant/system/developer/tool: text, plus assistant
            # refusal and replayed thinking/redacted_thinking parts
            if ptype == "refusal" and role == "assistant":
                if not isinstance(part.get("refusal"), str):
                    raise SchemaError(
                        f"messages[{i}].content[{j}].refusal must be a "
                        "string")
                continue
            if ptype == "thinking" and role == "assistant":
                text = part.get("text", part.get("thinking"))
                if not isinstance(text, str):
                    raise SchemaError(
                        f"messages[{i}].content[{j}] thinking parts "
                        "need a string text (or thinking) field")
                sig = part.get("signature")
                if sig is not None and not isinstance(sig, str):
                    raise SchemaError(
                        f"messages[{i}].content[{j}].signature must be "
                        "a string")
                continue
            if ptype == "redacted_thinking" and role == "assistant":
                data = part.get("redactedContent", part.get("data"))
                if not isinstance(data, str):
                    raise SchemaError(
                        f"messages[{i}].content[{j}] redacted_thinking "
                        "parts need a string redactedContent (or data) "
                        "field")
                continue
            if ptype != "text":
                raise SchemaError(
                    f"messages[{i}].content[{j}] has invalid type "
                    f"{ptype!r} for role {role!r}")
            if not isinstance(part.get("text"), str):
                raise SchemaError(
                    f"messages[{i}].content[{j}].text must be a string")


def _validate_tool_calls(i: int, tool_calls: Any) -> None:
    if tool_calls is None:
        return
    if not isinstance(tool_calls, list):
        raise SchemaError(f"messages[{i}].tool_calls must be an array")
    for j, tc in enumerate(tool_calls):
        if not isinstance(tc, dict):
            raise SchemaError(
                f"messages[{i}].tool_calls[{j}] must be an object")
        ttype = tc.get("type")
        if ttype == "custom":
            cu = tc.get("custom")
            if not isinstance(cu, dict) or not isinstance(
                    cu.get("name"), str):
                raise SchemaError(
                    f"messages[{i}].tool_calls[{j}].custom.name is "
                    "required")
            continue
        if ttype != "function":
            raise SchemaError(
                f"messages[{i}].tool_calls[{j}].type must be 'function' "
                "or 'custom'")
        fn = tc.get("function")
        if not isinstance(fn, dict) or not isinstance(fn.get("name"), str):
            raise SchemaError(
                f"messages[{i}].tool_calls[{j}].function.name is required")
        args = fn.get("arguments")
        if args is not None and not isinstance(args, str):
            raise SchemaError(
                f"messages[{i}].tool_calls[{j}].function.arguments must "
                "be a string")


def _validate_tools(body: dict[str, Any]) -> None:
    tools = body.get("tools")
    if tools is None:
        return
    if not isinstance(tools, list):
        raise SchemaError("tools must be an array")
    for i, t in enumerate(tools):
        if not isinstance(t, dict):
            raise SchemaError(f"tools[{i}] must be an object")
        ttype = t.get("type")
        # built-in Gemini tools ride the same list; translators decide
        if ttype in ("google_search", "enterprise_search",
                     "image_generation"):
            gs = t.get("google_search")
            if gs is not None:
                if not isinstance(gs, dict):
                    raise SchemaError(
                        f"tools[{i}].google_search must be an object")
                ed = gs.get("exclude_domains")
                if ed is not None and (
                        not isinstance(ed, list)
                        or not all(isinstance(d, str) for d in ed)):
                    raise SchemaError(
                        f"tools[{i}].google_search.exclude_domains must "
                        "be an array of strings")
                v = gs.get("blocking_confidence")
                if v is not None and not isinstance(v, str):
                    raise SchemaError(
                        f"tools[{i}].google_search.blocking_confidence "
                        "must be a string")
                trf = gs.get("time_range_filter")
                if trf is not None and not isinstance(trf, dict):
                    raise SchemaError(
                        f"tools[{i}].google_search.time_range_filter "
                        "must be an object")
            continue
        if ttype != "function":
            raise SchemaError(
                f"tools[{i}].type must be 'function', 'google_search', "
                f"'enterprise_search' or 'image_generation', got "
                f"{ttype!r}")
        fn = t.get("function")
        if not isinstance(fn, dict):
            raise SchemaError(f"tools[{i}].function must be an object")
        if not isinstance(fn.get("name"), str) or not fn.get("name"):
            raise SchemaError(f"tools[{i}].function.name is required")
        params = fn.get("parameters")
        if params is not None and not isinstance(params, dict):
            raise SchemaError(
                f"tools[{i}].function.parameters must be an object")


def _validate_tool_choice(body: dict[str, Any]) -> None:
    choice = body.get("tool_choice")
    if choice is None:
        return
    if isinstance(choice, str):
        if choice not in ("none", "auto", "required"):
            raise SchemaError(
                f"tool_choice must be 'none', 'auto', 'required' or a "
                f"named-tool object, got {choice!r}")
        return
    if not isinstance(choice, dict):
        raise SchemaError("tool_choice must be a string or an object")
    if choice.get("type") != "function":
        raise SchemaError("tool_choice.type must be 'function'")
    fn = choice.get("function")
    if not isinstance(fn, dict) or not isinstance(fn.get("name"), str) \
            or not fn.get("name"):
        raise SchemaError("tool_choice.function.name is required")
    if body.get("tools") in (None, []):
        raise SchemaError(
            "tool_choice requires a non-empty tools array")


def _validate_stream_options(body: dict[str, Any]) -> None:
    opts = body.get("stream_options")
    if opts is None:
        return
    if not isinstance(opts, dict):
        raise SchemaError("stream_options must be an object")
    if not body.get("stream"):
        raise SchemaError(
            "stream_options is only allowed when stream is true")
    iu = opts.get("include_usage")
    if iu is not None and not isinstance(iu, bool):
        raise SchemaError("stream_options.include_usage must be a boolean")


def _validate_gateway_sampling_fields(body: dict[str, Any]) -> None:
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
    lp = body.get("logprobs")
    if lp is not None and not isinstance(lp, bool):
        raise SchemaError("logprobs must be a boolean")
    tlp = body.get("top_logprobs")
    if tlp is not None:
        if isinstance(tlp, bool) or not isinstance(tlp, int) \
                or not (0 <= tlp <= 20):
            raise SchemaError("top_logprobs must be an integer in [0, 20]")
    stop = body.get("stop")
    if stop is not None and not isinstance(stop, str):
        if not isinstance(stop, list) or \
                any(not isinstance(s, str) for s in stop):
            raise SchemaError(
                "stop must be a string or an array of strings")


def validate_gateway_chat_request(body: dict[str, Any]) -> None:
    """The reference's ``validate_chat_request`` as its gateway runs it
    at the edge, stricter than the replica's ``validate_chat_request``
    above: content parts by role, tool calls, tools and tool choice,
    ``stream_options``, the logprobs fields and ``response_format``."""
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
        _validate_content(i, role, m.get("content"))
        if role == "assistant":
            _validate_tool_calls(i, m.get("tool_calls"))
        if role == "tool" and not isinstance(m.get("tool_call_id"), str):
            raise SchemaError(
                f"messages[{i}] with role 'tool' requires tool_call_id")
    _validate_tools(body)
    _validate_tool_choice(body)
    _validate_stream_options(body)
    _validate_gateway_sampling_fields(body)
    from aigw_tpu_torch.translate.structured import (
        JSONSchemaError,
        parse_response_format,
    )

    try:
        parse_response_format(body)
    except JSONSchemaError as e:
        raise SchemaError(str(e)) from None


def extract_usage(body: dict[str, Any]) -> TokenUsage:
    """An OpenAI ``usage`` object → TokenUsage, with its details fields
    and ``usage.aigw_meter``, the MeterRecord a replica attaches."""
    u = body.get("usage")
    if not isinstance(u, dict):
        return TokenUsage()
    prompt_details = u.get("prompt_tokens_details") or {}
    completion_details = u.get("completion_tokens_details") or {}
    meter = u.get("aigw_meter")
    return TokenUsage(
        input_tokens=int(u.get("prompt_tokens", 0) or 0),
        output_tokens=int(u.get("completion_tokens", 0) or 0),
        total_tokens=int(u.get("total_tokens", 0) or 0),
        cached_input_tokens=int(prompt_details.get("cached_tokens", 0) or 0),
        reasoning_tokens=int(
            completion_details.get("reasoning_tokens", 0) or 0),
        meter=meter_to_tuple(meter) if isinstance(meter, dict) else (),
    )


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
    if usage.reasoning_tokens:
        d["completion_tokens_details"] = {
            "reasoning_tokens": usage.reasoning_tokens}
    if usage.meter:
        d["aigw_meter"] = dict(usage.meter)
    return d


def chat_completion_response(*, model: str, content: str,
                             finish_reason: str = "stop",
                             usage: TokenUsage | None = None,
                             response_id: str = "",
                             tool_calls: list[dict[str, Any]] | None = None,
                             reasoning_content: str = "",
                             thinking_blocks: list[dict[str, Any]] | None
                             = None) -> dict[str, Any]:
    """A ``chat.completion``; a hosted model's reasoning rides as
    ``reasoning_content`` and the signed ``thinking_blocks`` a client
    replays on its next turn."""
    message: dict[str, Any] = {"role": "assistant", "content": content}
    if tool_calls:
        message["tool_calls"] = tool_calls
        if not content:
            message["content"] = None
    if reasoning_content:
        message["reasoning_content"] = reasoning_content
    if thinking_blocks:
        message["thinking_blocks"] = thinking_blocks
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


def chat_completion_chunk(*, response_id: str, model: str,
                          delta: dict[str, Any] | None = None,
                          finish_reason: str | None = None,
                          usage: TokenUsage | None = None,
                          created: int = 0,
                          logprobs: dict[str, Any] | None = None,
                          index: int = 0) -> dict[str, Any]:
    """One ``chat.completion.chunk``: choice ``index`` (with its
    ``logprobs`` when given), or no choice when there is neither a delta
    nor a finish (a usage chunk)."""
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
    return chunk


def stream_chunk_sse(*, response_id: str, model: str, created: int,
                     delta: dict[str, Any] | None = None,
                     finish_reason: str | None = None,
                     usage: TokenUsage | None = None,
                     logprobs: dict[str, Any] | None = None,
                     index: int = 0) -> bytes:
    """``chat_completion_chunk`` as one SSE event."""
    return sse(json.dumps(chat_completion_chunk(
        response_id=response_id, model=model, delta=delta,
        finish_reason=finish_reason, usage=usage, created=created,
        logprobs=logprobs, index=index)))


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
