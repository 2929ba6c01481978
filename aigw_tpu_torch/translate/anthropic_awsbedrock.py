"""Anthropic /v1/messages front → AWS Bedrock **Converse** backend.

Upstream pair: internal/translator/anthropic_awsbedrock.go:1-832. This is
distinct from the AWS-*Anthropic* invoke path (anthropic_hosted.py): here
the upstream speaks the provider-neutral Converse/ConverseStream API, so
Anthropic-native clients can be served by Converse-only models (Nova,
Titan, Llama-on-Bedrock, …).

Request: Anthropic messages → ConverseInput (system promotion, tool_use/
tool_result/image/thinking block mapping, inferenceConfig, top_k+thinking
via additionalModelRequestFields, toolConfig). Response: ConverseResponse →
Anthropic message envelope; ConverseStream event-stream frames → Anthropic
SSE (message_start/content_block_*/message_delta/message_stop), with
text-vs-thinking block starts deferred until the first delta (Bedrock does
not distinguish them at block start). message_delta/message_stop are
emitted once usage metadata arrives (or at end-of-stream) so output token
counts are always correct.

The port's copy of ``aigw_tpu/translate/anthropic_awsbedrock.py``.
"""

from __future__ import annotations

import json
import urllib.parse
import uuid
from typing import Any

from aigw_tpu_torch.config.model import APISchemaName
from aigw_tpu_torch.gateway.costs import TokenUsage
from aigw_tpu_torch.schemas import anthropic as anth
from aigw_tpu_torch.translate.base import (
    Endpoint,
    RequestTx,
    ResponseTx,
    TranslationError,
    Translator,
    register_translator,
)
from aigw_tpu_torch.translate.eventstream import EventStreamParser
from aigw_tpu_torch.translate.openai_awsbedrock import converse_usage

_BEDROCK_STOP_TO_ANTHROPIC = {
    "end_turn": "end_turn",
    "max_tokens": "max_tokens",
    "stop_sequence": "stop_sequence",
    "tool_use": "tool_use",
    "content_filtered": "end_turn",  # best effort (upstream :769)
    "guardrail_intervened": "end_turn",
}

_IMAGE_MEDIA_TO_FORMAT = {
    "image/jpeg": "jpeg",
    "image/png": "png",
    "image/gif": "gif",
    "image/webp": "webp",
}


def _tool_result_block(block: dict[str, Any]) -> dict[str, Any]:
    tr: dict[str, Any] = {"toolUseId": block.get("tool_use_id", "")}
    if block.get("is_error"):
        tr["status"] = "error"
    content = block.get("content")
    if isinstance(content, str):
        tr["content"] = [{"text": content}]
    elif isinstance(content, list):
        tr["content"] = [
            {"text": c.get("text", "")}
            for c in content
            if isinstance(c, dict) and c.get("type") == "text"
        ]
    # Converse requires the content member; Anthropic permits omitting it
    # (void tools) — represent an absent/filtered-out result as empty text
    if not tr.get("content"):
        tr["content"] = [{"text": ""}]
    return {"toolResult": tr}


def _image_block(block: dict[str, Any]) -> dict[str, Any]:
    source = block.get("source") or {}
    if source.get("type") != "base64":
        raise TranslationError(
            "only base64 image sources are supported by Bedrock Converse")
    media = source.get("media_type", "")
    fmt = _IMAGE_MEDIA_TO_FORMAT.get(media)
    if fmt is None:
        raise TranslationError(f"unsupported image format {media!r}")
    return {"image": {"format": fmt,
                      "source": {"bytes": source.get("data", "")}}}


def _user_blocks(blocks: list[dict[str, Any]]) -> list[dict[str, Any]]:
    out: list[dict[str, Any]] = []
    for b in blocks:
        btype = b.get("type")
        if btype == "text":
            out.append({"text": b.get("text", "")})
        elif btype == "image":
            out.append(_image_block(b))
        elif btype == "tool_result":
            out.append(_tool_result_block(b))
        # other block types are dropped (upstream convertUserMessage)
    return out


def _assistant_blocks(blocks: list[dict[str, Any]]) -> list[dict[str, Any]]:
    out: list[dict[str, Any]] = []
    for b in blocks:
        btype = b.get("type")
        if btype == "text":
            out.append({"text": b.get("text", "")})
        elif btype == "tool_use":
            out.append({"toolUse": {
                "toolUseId": b.get("id", ""),
                "name": b.get("name", ""),
                "input": b.get("input", {}),
            }})
        elif btype == "thinking":
            out.append({"reasoningContent": {"reasoningText": {
                "text": b.get("thinking", ""),
                "signature": b.get("signature", ""),
            }}})
        elif btype == "redacted_thinking":
            out.append({"reasoningContent": {
                "redactedContent": b.get("data", "")}})
    return out


def anthropic_messages_to_converse(
    body: dict[str, Any],
) -> tuple[list[dict[str, Any]], list[dict[str, Any]]]:
    """Anthropic request → (Converse system blocks, Converse messages).

    role:"system" messages in the array are promoted to the system
    parameter (upstream promoteAnthropicSystemMessagesToParam:167 —
    some clients send mid-conversation system prompts as messages)."""
    system: list[dict[str, Any]] = []
    sys_param = body.get("system")
    if isinstance(sys_param, str) and sys_param:
        system.append({"text": sys_param})
    elif isinstance(sys_param, list):
        system.extend(
            {"text": b.get("text", "")}
            for b in sys_param
            if isinstance(b, dict) and b.get("type") == "text"
        )
    out: list[dict[str, Any]] = []

    def push(role: str, blocks: list[dict[str, Any]]) -> None:
        # Converse requires strict role alternation; Anthropic permits
        # consecutive same-role turns (assistant prefill, separate
        # tool-result messages) — coalesce both roles
        if not blocks:
            return
        if out and out[-1]["role"] == role:
            out[-1]["content"].extend(blocks)
        else:
            out.append({"role": role, "content": blocks})

    for m in body.get("messages") or ():
        role = m.get("role")
        blocks = anth.content_blocks(m.get("content"))
        if role == "system":
            text = anth.text_of_blocks(blocks) or (
                m.get("content") if isinstance(m.get("content"), str)
                else "")
            if text:
                system.append({"text": text})
        elif role == "user":
            push("user", _user_blocks(blocks))
        elif role == "assistant":
            push("assistant", _assistant_blocks(blocks))
        else:
            raise TranslationError(f"unexpected role: {role}")
    return system, out


class AnthropicToBedrockConverse(Translator):
    def __init__(self, *, model_name_override: str = "",
                 stream: bool = False, **_: object):
        self._override = model_name_override
        self._stream = stream
        self._es = EventStreamParser()
        self._id = f"msg_{uuid.uuid4().hex[:24]}"
        self._model = ""
        self._usage = TokenUsage()
        self._stop_reason: str | None = None
        self._open_blocks: set[int] = set()
        self._saw_message_start = False
        self._saw_message_stop = False
        self._sent_message_stop = False

    # -- request ----------------------------------------------------------
    def request(self, body: dict[str, Any]) -> RequestTx:
        anth_body = body
        self._stream = bool(anth_body.get("stream", False))
        self._model = self._override or str(anth_body.get("model", ""))
        system, messages = anthropic_messages_to_converse(anth_body)
        out: dict[str, Any] = {"messages": messages}
        if system:
            out["system"] = system
        inference: dict[str, Any] = {
            "maxTokens": int(anth_body.get("max_tokens")
                             or anth.DEFAULT_MAX_TOKENS),
        }
        if anth_body.get("temperature") is not None:
            inference["temperature"] = float(anth_body["temperature"])
        if anth_body.get("top_p") is not None:
            inference["topP"] = float(anth_body["top_p"])
        if anth_body.get("stop_sequences"):
            inference["stopSequences"] = list(anth_body["stop_sequences"])
        out["inferenceConfig"] = inference
        extra: dict[str, Any] = {}
        if anth_body.get("top_k") is not None:
            extra["top_k"] = int(anth_body["top_k"])
        thinking = anth_body.get("thinking")
        if isinstance(thinking, dict):
            if thinking.get("type") == "enabled":
                extra["thinking"] = {
                    "type": "enabled",
                    "budget_tokens": thinking.get("budget_tokens", 0),
                }
            elif thinking.get("type") == "disabled":
                extra["thinking"] = {"type": "disabled"}
        if extra:
            out["additionalModelRequestFields"] = extra
        tools = anth_body.get("tools")
        if tools:
            tool_config: dict[str, Any] = {"tools": [
                {"toolSpec": {
                    "name": t.get("name", ""),
                    **({"description": t["description"]}
                       if t.get("description") else {}),
                    "inputSchema": {
                        "json": t.get("input_schema", {"type": "object"})},
                }}
                for t in tools
                if isinstance(t, dict)
            ]}
            choice = anth_body.get("tool_choice")
            if isinstance(choice, dict):
                ctype = choice.get("type")
                if ctype == "auto":
                    tool_config["toolChoice"] = {"auto": {}}
                elif ctype == "any":
                    tool_config["toolChoice"] = {"any": {}}
                elif ctype == "tool":
                    tool_config["toolChoice"] = {
                        "tool": {"name": choice.get("name", "")}}
                # "none" has no Converse equivalent: skip (upstream :414)
            out["toolConfig"] = tool_config
        verb = "converse-stream" if self._stream else "converse"
        model_id = urllib.parse.quote(self._model, safe="")
        return RequestTx(
            body=json.dumps(out).encode(),
            path=f"/model/{model_id}/{verb}",
            stream=self._stream,
        )

    # -- response ---------------------------------------------------------
    def response_body(self, chunk: bytes, end_of_stream: bool) -> ResponseTx:
        if self._stream:
            return self._stream_chunk(chunk, end_of_stream)
        if not end_of_stream:
            return ResponseTx()
        try:
            data = json.loads(chunk)
        except json.JSONDecodeError as e:
            raise TranslationError(f"invalid upstream JSON: {e}") from None
        usage = converse_usage(data.get("usage") or {})
        content: list[dict[str, Any]] = []
        msg = (data.get("output") or {}).get("message") or {}
        for block in msg.get("content") or ():
            if "text" in block:
                content.append({"type": "text", "text": block["text"]})
            elif "toolUse" in block:
                tu = block["toolUse"]
                content.append({
                    "type": "tool_use",
                    "id": tu.get("toolUseId", ""),
                    "name": tu.get("name", ""),
                    "input": tu.get("input", {}),
                })
            elif "reasoningContent" in block:
                from aigw_tpu_torch.translate.openai_awsbedrock import (
                    converse_reasoning_to_thinking,
                )

                tb = converse_reasoning_to_thinking(block)
                if tb is not None:
                    content.append(tb)
        stop = _BEDROCK_STOP_TO_ANTHROPIC.get(
            data.get("stopReason") or "end_turn", "end_turn")
        out = anth.messages_response(
            model=self._model,
            content=content,
            stop_reason=stop,
            usage=usage,
            response_id=self._id,
        )
        if usage.cached_input_tokens:
            out["usage"]["cache_read_input_tokens"] = \
                usage.cached_input_tokens
        if usage.cache_creation_input_tokens:
            out["usage"]["cache_creation_input_tokens"] = \
                usage.cache_creation_input_tokens
        return ResponseTx(
            body=json.dumps(out).encode(), usage=usage, model=self._model
        )

    def _sse(self, event_type: str, data: dict[str, Any],
             out: bytearray) -> None:
        out += b"event: " + event_type.encode() + b"\n"
        out += b"data: " + json.dumps(data).encode() + b"\n\n"

    def _open_block(self, idx: int, block_type: str,
                    out: bytearray) -> None:
        """Lazily emit content_block_start on the first delta for an
        unopened index. Real ConverseStream output omits
        contentBlockStart entirely for non-toolUse blocks (the event's
        start union only carries toolUse), and even when present the
        event cannot distinguish text from thinking — so the block type
        is resolved from the first delta (≈ upstream
        flushPendingBlockStart:725, made event-optional)."""
        if idx in self._open_blocks:
            return
        self._open_blocks.add(idx)
        cb: dict[str, Any] = {"type": block_type}
        if block_type == "text":
            cb["text"] = ""
        elif block_type == "thinking":
            cb["thinking"] = ""
        self._sse("content_block_start",
                  {"type": "content_block_start", "index": idx,
                   "content_block": cb}, out)

    def _emit_message_close(self, out: bytearray) -> None:
        if self._sent_message_stop:
            return
        self._sent_message_stop = True
        usage: dict[str, Any] = {
            "output_tokens": self._usage.output_tokens}
        if self._usage.input_tokens:
            # message_start could not report it (metadata arrives last in
            # ConverseStream); surface it here so streaming clients can
            # account tokens
            usage["input_tokens"] = self._usage.input_tokens
        self._sse("message_delta", {
            "type": "message_delta",
            "delta": {
                "stop_reason": self._stop_reason or "end_turn",
                "stop_sequence": None,
            },
            "usage": usage,
        }, out)
        self._sse("message_stop", {"type": "message_stop"}, out)

    def _stream_chunk(self, chunk: bytes, end_of_stream: bool) -> ResponseTx:
        out = bytearray()
        usage = TokenUsage()
        tokens = 0
        for msg in self._es.feed(chunk):
            if msg.exception_type:
                self._sse("error", {
                    "type": "error",
                    "error": {
                        "type": msg.exception_type,
                        "message": msg.payload.decode(
                            "utf-8", errors="replace"),
                    },
                }, out)
                continue
            try:
                data = json.loads(msg.payload) if msg.payload else {}
            except json.JSONDecodeError:
                continue
            etype = msg.event_type
            if etype == "messageStart":
                self._saw_message_start = True
                self._sse("message_start", {
                    "type": "message_start",
                    "message": {
                        "id": self._id,
                        "type": "message",
                        "role": data.get("role") or "assistant",
                        "content": [],
                        "model": self._model,
                        "stop_reason": None,
                        "stop_sequence": None,
                        "usage": {"input_tokens": 0, "output_tokens": 0},
                    },
                }, out)
            elif etype == "contentBlockStart":
                idx = int(data.get("contentBlockIndex", 0) or 0)
                start = (data.get("start") or {}).get("toolUse")
                if start:
                    self._open_blocks.add(idx)
                    self._sse("content_block_start", {
                        "type": "content_block_start",
                        "index": idx,
                        "content_block": {
                            "type": "tool_use",
                            "id": start.get("toolUseId", ""),
                            "name": start.get("name", ""),
                            "input": {},
                        },
                    }, out)
                # non-toolUse starts carry no type information: the block
                # opens lazily on its first delta
            elif etype == "contentBlockDelta":
                idx = int(data.get("contentBlockIndex", 0) or 0)
                delta = data.get("delta") or {}
                if "text" in delta:
                    self._open_block(idx, "text", out)
                    tokens += 1
                    self._sse("content_block_delta", {
                        "type": "content_block_delta", "index": idx,
                        "delta": {"type": "text_delta",
                                  "text": delta["text"]},
                    }, out)
                elif "toolUse" in delta:
                    self._open_block(idx, "tool_use", out)
                    self._sse("content_block_delta", {
                        "type": "content_block_delta", "index": idx,
                        "delta": {"type": "input_json_delta",
                                  "partial_json":
                                      delta["toolUse"].get("input", "")},
                    }, out)
                elif "reasoningContent" in delta:
                    rc = delta["reasoningContent"]
                    self._open_block(idx, "thinking", out)
                    if rc.get("text"):
                        tokens += 1
                        self._sse("content_block_delta", {
                            "type": "content_block_delta", "index": idx,
                            "delta": {"type": "thinking_delta",
                                      "thinking": rc["text"]},
                        }, out)
                    if rc.get("signature"):
                        self._sse("content_block_delta", {
                            "type": "content_block_delta", "index": idx,
                            "delta": {"type": "signature_delta",
                                      "signature": rc["signature"]},
                        }, out)
            elif etype == "contentBlockStop":
                idx = int(data.get("contentBlockIndex", 0) or 0)
                # a block that produced no deltas still needs its start
                self._open_block(idx, "text", out)
                self._sse("content_block_stop", {
                    "type": "content_block_stop", "index": idx}, out)
            elif etype == "messageStop":
                self._stop_reason = _BEDROCK_STOP_TO_ANTHROPIC.get(
                    data.get("stopReason") or "end_turn", "end_turn")
                # defer message_delta/message_stop until usage metadata
                # arrives (Converse sends metadata after messageStop) or
                # the stream ends — output token counts stay correct
                self._saw_message_stop = True
            elif etype == "metadata":
                if data.get("usage"):
                    self._usage = self._usage.merge_override(
                        converse_usage(data["usage"]))
                    usage = usage.merge_override(self._usage)
                if self._saw_message_stop:
                    self._emit_message_close(out)
        if end_of_stream and self._saw_message_start:
            # close unconditionally once the message opened — a stream
            # truncated before messageStop must still terminate with
            # message_delta/message_stop or SDK accumulators hang
            usage = usage.merge_override(self._usage)
            self._emit_message_close(out)
        return ResponseTx(
            body=bytes(out), usage=usage, model=self._model,
            tokens_emitted=tokens,
        )

    def response_error(self, status: int, body: bytes) -> bytes:
        """Bedrock error → Anthropic error envelope (upstream
        ResponseError:776, httpStatusToAnthropicErrorType:813)."""
        type_ = {
            400: "invalid_request_error",
            401: "authentication_error",
            403: "permission_error",
            404: "not_found_error",
            413: "request_too_large",
            429: "rate_limit_error",
            500: "api_error",
            529: "overloaded_error",
        }.get(status, "api_error")
        message = body.decode("utf-8", errors="replace")[:4096]
        try:
            parsed = json.loads(body)
            if isinstance(parsed, dict) and parsed.get("message"):
                message = str(parsed["message"])
        except json.JSONDecodeError:
            pass
        return anth.error_body(message, type_=type_)


register_translator(
    Endpoint.MESSAGES,
    APISchemaName.ANTHROPIC,
    APISchemaName.AWS_BEDROCK,
    AnthropicToBedrockConverse,
)
