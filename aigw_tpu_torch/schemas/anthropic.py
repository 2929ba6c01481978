"""Anthropic Messages API schema helpers (the port's copy of
``aigw_tpu/schemas/anthropic.py``): request validation, system-message
promotion, content blocks, usage, the response and the error envelope.
"""

from __future__ import annotations

import uuid
from typing import Any

from aigw_tpu_torch.gateway.costs import TokenUsage
from aigw_tpu_torch.schemas.openai import SchemaError

#: Anthropic stop_reason → OpenAI finish_reason
STOP_REASON_TO_OPENAI = {
    "end_turn": "stop",
    "stop_sequence": "stop",
    "max_tokens": "length",
    "tool_use": "tool_calls",
    "refusal": "content_filter",
}
#: OpenAI finish_reason → Anthropic stop_reason
FINISH_REASON_TO_ANTHROPIC = {
    "stop": "end_turn",
    "length": "max_tokens",
    "tool_calls": "tool_use",
    "content_filter": "refusal",
    "function_call": "tool_use",
}

DEFAULT_MAX_TOKENS = 4096  # Anthropic requires max_tokens; OpenAI does not.


def validate_messages_request(body: dict[str, Any]) -> None:
    if not isinstance(body.get("model"), str) or not body["model"]:
        raise SchemaError("missing required field: model")
    if not isinstance(body.get("messages"), list) or not body["messages"]:
        raise SchemaError("messages must be a non-empty array")
    if not isinstance(body.get("max_tokens"), int):
        raise SchemaError("missing required field: max_tokens")
    for i, m in enumerate(body["messages"]):
        # "system" is permitted in the array (mid-conversation system
        # prompts; some clients send them as messages rather than the
        # top-level parameter — reference
        # promoteAnthropicSystemMessagesToParam)
        if not isinstance(m, dict) or m.get("role") not in (
                "user", "assistant", "system"):
            raise SchemaError(
                f"messages[{i}] must have role user|assistant|system")


def promote_system_messages(body: dict[str, Any]) -> dict[str, Any]:
    """Return a new request body with any role:"system" messages removed
    from the array and their text folded into the top-level ``system``
    parameter (reference promoteAnthropicSystemMessagesToParam — the
    Anthropic upstream itself rejects role:system in messages, so
    passthrough backends need the promotion too). No-op (same dict) when
    no system messages are present."""
    messages = body.get("messages")
    if not isinstance(messages, list) or not any(
        isinstance(m, dict) and m.get("role") == "system" for m in messages
    ):
        return body
    promoted: list[str] = []
    kept: list[Any] = []
    for m in messages:
        if isinstance(m, dict) and m.get("role") == "system":
            content = m.get("content")
            text = (content if isinstance(content, str)
                    else text_of_blocks(content_blocks(content)))
            if text:
                promoted.append(text)
        else:
            kept.append(m)
    out = dict(body, messages=kept)
    sys_param = body.get("system")
    if isinstance(sys_param, list):
        # block-form system param: preserve the original blocks verbatim
        # (cache_control etc. must survive) and append promoted text as
        # new blocks
        out["system"] = list(sys_param) + [
            {"type": "text", "text": t} for t in promoted
        ]
    else:
        parts = ([sys_param] if isinstance(sys_param, str) and sys_param
                 else []) + promoted
        system = "\n".join(parts)
        if system:
            out["system"] = system
    return out


def content_blocks(content: Any) -> list[dict[str, Any]]:
    """Normalize the string-or-blocks content union to a block list."""
    if isinstance(content, str):
        return [{"type": "text", "text": content}]
    if isinstance(content, list):
        return [b for b in content if isinstance(b, dict)]
    raise SchemaError(f"invalid content type {type(content).__name__}")


def text_of_blocks(blocks: list[dict[str, Any]]) -> str:
    return "".join(b.get("text", "") for b in blocks if b.get("type") == "text")


def extract_usage(body: dict[str, Any]) -> TokenUsage:
    u = body.get("usage")
    if not isinstance(u, dict):
        return TokenUsage()
    inp = int(u.get("input_tokens", 0) or 0)
    out = int(u.get("output_tokens", 0) or 0)
    cached = int(u.get("cache_read_input_tokens", 0) or 0)
    cache_creation = int(u.get("cache_creation_input_tokens", 0) or 0)
    return TokenUsage(
        input_tokens=inp,
        output_tokens=out,
        total_tokens=(inp + out) if (inp or out) else 0,
        cached_input_tokens=cached,
        cache_creation_input_tokens=cache_creation,
    )


def messages_response(
    *,
    model: str,
    content: list[dict[str, Any]],
    stop_reason: str = "end_turn",
    usage: TokenUsage | None = None,
    response_id: str = "",
) -> dict[str, Any]:
    usage = usage or TokenUsage()
    return {
        "id": response_id or f"msg_{uuid.uuid4().hex[:24]}",
        "type": "message",
        "role": "assistant",
        "model": model,
        "content": content,
        "stop_reason": stop_reason,
        "stop_sequence": None,
        "usage": {
            "input_tokens": usage.input_tokens,
            "output_tokens": usage.output_tokens,
        },
    }


def error_body(message: str, type_: str = "invalid_request_error") -> bytes:
    import json

    return json.dumps(
        {"type": "error", "error": {"type": type_, "message": message}}
    ).encode()
