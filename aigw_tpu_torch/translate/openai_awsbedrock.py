"""OpenAI chat/completions front → AWS Bedrock Converse backend.

Upstream pair: internal/translator openai→awsbedrock (Converse /
ConverseStream APIs, apischema/awsbedrock.go). Streaming responses arrive
as AWS event-stream frames and are re-encoded to OpenAI SSE chunks.

The port's copy of ``aigw_tpu/translate/openai_awsbedrock.py``.
"""

from __future__ import annotations

import json
import time
import urllib.parse
import uuid
from typing import Any

from aigw_tpu_torch.config.model import APISchemaName
from aigw_tpu_torch.gateway.costs import TokenUsage
from aigw_tpu_torch.schemas import openai as oai
from aigw_tpu_torch.translate.base import (
    Endpoint,
    RequestTx,
    ResponseTx,
    TranslationError,
    Translator,
    register_translator,
)
from aigw_tpu_torch.translate import vendor_fields
from aigw_tpu_torch.translate.eventstream import EventStreamParser
from aigw_tpu_torch.translate.sse import SSEEvent
from aigw_tpu_torch.translate.structured import (
    JSONSchemaError,
    dereference,
    parse_response_format,
)

_STOP_TO_OPENAI = {
    "end_turn": "stop",
    "stop_sequence": "stop",
    "max_tokens": "length",
    "tool_use": "tool_calls",
    "content_filtered": "content_filter",
    "guardrail_intervened": "content_filter",
}


def converse_reasoning_to_thinking(block: dict[str, Any]) -> dict[str, Any] | None:
    """One Converse ``reasoningContent`` block → Anthropic-shaped
    thinking block (shared by the OpenAI and Anthropic fronts so the
    two mappings can't drift). Returns None for an empty block."""
    rc = block.get("reasoningContent") or {}
    rt = rc.get("reasoningText")
    if rt is not None:
        return {
            "type": "thinking",
            "thinking": rt.get("text", ""),
            "signature": rt.get("signature", ""),
        }
    if rc.get("redactedContent"):
        return {"type": "redacted_thinking",
                "data": str(rc["redactedContent"])}
    return None


def _cache_point(part: dict[str, Any]) -> dict[str, Any] | None:
    """cache_control on the OpenAI surface → a Converse cachePoint block
    appended after the cached content (openai_awsbedrock.go:92-99)."""
    if vendor_fields.cache_control_marker(part) is not None:
        return {"cachePoint": {"type": "default"}}
    return None


def _assistant_blocks(content) -> list[dict[str, Any]]:
    """Assistant content union → Converse blocks. Array parts carry
    replayed thinking/redacted_thinking blocks
    (openai_awsbedrock.go:362-399: thinking → reasoningContent.
    reasoningText{text, signature}; redacted → redactedContent);
    refusal parts become text."""
    if content is None:
        return []
    if isinstance(content, str):
        return [{"text": content}] if content else []
    if isinstance(content, dict):
        content = [content]
    if not isinstance(content, list):
        raise oai.SchemaError(
            "assistant content must be a string or an array of parts")
    blocks: list[dict[str, Any]] = []
    for part in content:
        if not isinstance(part, dict):
            continue  # same tolerance as message_content_text
        ptype = part.get("type")
        if ptype == "text":
            if part.get("text"):
                blocks.append({"text": part["text"]})
                if (cp := _cache_point(part)) is not None:
                    blocks.append(cp)
        elif ptype == "refusal":
            if part.get("refusal"):
                blocks.append({"text": part["refusal"]})
        elif ptype == "thinking":
            text = part.get("text") or part.get("thinking")
            if text:
                rt: dict[str, Any] = {"text": text}
                if part.get("signature"):
                    rt["signature"] = part["signature"]
                blocks.append(
                    {"reasoningContent": {"reasoningText": rt}})
        elif ptype == "redacted_thinking":
            data = part.get("redactedContent") or part.get("data")
            if isinstance(data, str):
                blocks.append(
                    {"reasoningContent": {"redactedContent": data}})
        else:
            raise TranslationError(
                f"unsupported assistant content part {ptype!r}")
    return blocks


def openai_messages_to_converse(
    messages: list[dict[str, Any]],
) -> tuple[list[dict[str, Any]], list[dict[str, Any]]]:
    """OpenAI messages → (system blocks, Converse messages)."""
    system: list[dict[str, Any]] = []
    out: list[dict[str, Any]] = []

    def push(role: str, blocks: list[dict[str, Any]]) -> None:
        if not blocks:
            return
        if out and out[-1]["role"] == role:
            out[-1]["content"].extend(blocks)
        else:
            out.append({"role": role, "content": list(blocks)})

    for m in messages:
        role = m.get("role")
        if role in ("system", "developer"):
            content = m.get("content")
            if isinstance(content, list):
                for part in content:
                    if not isinstance(part, dict) or \
                            part.get("type") != "text" or \
                            not part.get("text"):
                        continue
                    system.append({"text": part["text"]})
                    if (cp := _cache_point(part)) is not None:
                        system.append(cp)
            else:
                text = oai.message_content_text(content)
                if text:
                    system.append({"text": text})
        elif role == "user":
            push("user", _user_blocks(m.get("content")))
        elif role == "assistant":
            blocks: list[dict[str, Any]] = _assistant_blocks(
                m.get("content"))
            if not any("reasoningContent" in b for b in blocks):
                blocks = _assistant_blocks(
                    m.get("thinking_blocks")) + blocks
            for tc in m.get("tool_calls") or ():
                fn = tc.get("function") or {}
                try:
                    args = json.loads(fn.get("arguments") or "{}")
                except json.JSONDecodeError:
                    args = {}
                blocks.append(
                    {
                        "toolUse": {
                            "toolUseId": tc.get("id", ""),
                            "name": fn.get("name", ""),
                            "input": args,
                        }
                    }
                )
                if (cp := _cache_point(tc)) is not None:
                    blocks.append(cp)
            if blocks:
                push("assistant", blocks)
        elif role == "tool":
            result_blocks: list[dict[str, Any]] = [
                {
                    "toolResult": {
                        "toolUseId": m.get("tool_call_id", ""),
                        "content": [
                            {
                                "text": oai.message_content_text(
                                    m.get("content")
                                )
                            }
                        ],
                    }
                }
            ]
            cc = _cache_point(m)
            if cc is None and isinstance(m.get("content"), list):
                for part in m["content"]:
                    if isinstance(part, dict) and \
                            (cc := _cache_point(part)) is not None:
                        break
            if cc is not None:
                result_blocks.append(cc)
            push("user", result_blocks)
        else:
            raise TranslationError(f"unsupported message role {role!r}")
    return system, out


def _user_blocks(content: Any) -> list[dict[str, Any]]:
    """User content union → Converse blocks (text + base64 images)."""
    if content is None:
        return []
    if isinstance(content, str):
        return [{"text": content}] if content else []
    blocks: list[dict[str, Any]] = []
    for part in content:
        ptype = part.get("type")
        if ptype == "text":
            if part.get("text"):
                blocks.append({"text": part["text"]})
                if (cp := _cache_point(part)) is not None:
                    blocks.append(cp)
        elif ptype == "image_url":
            url = (part.get("image_url") or {}).get("url", "")
            if not url.startswith("data:"):
                raise TranslationError(
                    "Bedrock Converse requires base64 data: image URLs"
                )
            media, _, b64 = url[len("data:") :].partition(";base64,")
            fmt = media.rpartition("/")[2] or "png"
            blocks.append(
                {"image": {"format": fmt, "source": {"bytes": b64}}}
            )
            if (cp := _cache_point(part)) is not None:
                blocks.append(cp)
        else:
            raise TranslationError(f"unsupported content part {ptype!r}")
    return blocks


def converse_usage(u: dict[str, Any]) -> TokenUsage:
    inp = int(u.get("inputTokens", 0) or 0)
    out = int(u.get("outputTokens", 0) or 0)
    return TokenUsage(
        input_tokens=inp,
        output_tokens=out,
        total_tokens=int(u.get("totalTokens", 0) or 0) or inp + out,
        cached_input_tokens=int(u.get("cacheReadInputTokens", 0) or 0),
        cache_creation_input_tokens=int(u.get("cacheWriteInputTokens", 0) or 0),
    )


class OpenAIToBedrockChat(Translator):
    def __init__(self, *, model_name_override: str = "", stream: bool = False,
                 **_: object):
        self._override = model_name_override
        self._stream = stream
        self._include_usage = False
        self._es = EventStreamParser()
        self._id = f"chatcmpl-{uuid.uuid4().hex[:24]}"
        self._created = int(time.time())
        self._model = ""
        self._usage = TokenUsage()
        self._tool_idx = -1
        self._finish: str | None = None
        self._sent_done = False
        #: name of the synthetic structured-output tool ("" = none); set
        #: when response_format json_schema is requested — Converse has no
        #: native structured output, so the schema rides a forced tool
        #: whose toolUse input is converted back into message content
        self._json_tool = ""
        self._in_json_block = False

    def request(self, body: dict[str, Any]) -> RequestTx:
        oai.validate_gateway_chat_request(body)
        self._stream = bool(body.get("stream", False))
        self._include_usage = oai.include_stream_usage(body)
        self._model = self._override or body["model"]
        system, messages = openai_messages_to_converse(body["messages"])
        out: dict[str, Any] = {"messages": messages}
        if system:
            out["system"] = system
        inference: dict[str, Any] = {}
        max_tokens = body.get("max_completion_tokens") or body.get("max_tokens")
        if max_tokens:
            inference["maxTokens"] = int(max_tokens)
        if body.get("temperature") is not None:
            inference["temperature"] = float(body["temperature"])
        if body.get("top_p") is not None:
            inference["topP"] = float(body["top_p"])
        stop = body.get("stop")
        if stop:
            inference["stopSequences"] = [stop] if isinstance(stop, str) else list(stop)
        if inference:
            out["inferenceConfig"] = inference
        # proposal-004 vendor field: thinking union → Converse
        # additionalModelRequestFields (openai_awsbedrock.go:57-90,:142-146)
        amrf = vendor_fields.thinking_to_bedrock(body)
        # reasoning_effort forwards as reasoning_config for GLM/Nova and
        # other Bedrock-hosted reasoning models (openai_awsbedrock.go:149-154)
        effort = body.get("reasoning_effort")
        if effort is not None:
            if not isinstance(effort, str):
                # the upstream gateway's typed unmarshal 400s this at the edge
                # (openai.go:1016 string alias)
                raise TranslationError(
                    "reasoning_effort must be a string")
            amrf = dict(amrf or {})
            amrf["reasoning_config"] = effort
        if amrf is not None:
            out["additionalModelRequestFields"] = amrf
        tools = body.get("tools")
        # tool_choice "none" means the model must not call tools; Converse
        # has no NONE mode, so omit toolConfig entirely.
        if body.get("tool_choice") == "none":
            tools = None
        if tools:
            tool_entries: list[dict[str, Any]] = []
            for t in tools:
                if t.get("type") != "function":
                    raise TranslationError(
                        f"tool type {t.get('type')!r} is not supported "
                        "by Bedrock backends")
                fn = t.get("function") or {}
                tool_entries.append({
                    "toolSpec": {
                        "name": fn.get("name", ""),
                        "description": fn.get("description", ""),
                        "inputSchema": {
                            "json": fn.get("parameters",
                                           {"type": "object"})
                        },
                    }
                })
                # cached tool definitions → a cachePoint tool entry
                # right after (openai_awsbedrock.go:203)
                if (cp := _cache_point(fn)) is not None:
                    tool_entries.append(cp)
            tool_config: dict[str, Any] = {"tools": tool_entries}
            choice = body.get("tool_choice")
            if choice == "required":
                tool_config["toolChoice"] = {"any": {}}
            elif choice == "auto":
                tool_config["toolChoice"] = {"auto": {}}
            elif isinstance(choice, dict) and choice.get("type") == "function":
                tool_config["toolChoice"] = {
                    "tool": {"name": (choice.get("function") or {}).get("name", "")}
                }
            out["toolConfig"] = tool_config
        rf = parse_response_format(body)
        if rf is not None and rf.kind == "json_schema" \
                and rf.schema is not None:
            if tools:
                raise TranslationError(
                    "response_format json_schema cannot be combined with "
                    "tools for AWS Bedrock backends")
            name = rf.name or "json_response"
            try:
                schema = dereference(rf.schema)
            except JSONSchemaError as e:
                raise TranslationError(
                    f"invalid JSON schema: {e}") from None
            out["toolConfig"] = {
                "tools": [{
                    "toolSpec": {
                        "name": name,
                        "description":
                            "Respond with JSON matching this schema.",
                        "inputSchema": {"json": schema},
                    }
                }],
                "toolChoice": {"tool": {"name": name}},
            }
            self._json_tool = name
        verb = "converse-stream" if self._stream else "converse"
        model_id = urllib.parse.quote(self._model, safe="")
        return RequestTx(
            body=json.dumps(out).encode(),
            path=f"/model/{model_id}/{verb}",
            stream=self._stream,
        )

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
        msg = (data.get("output") or {}).get("message") or {}
        text_parts: list[str] = []
        tool_calls: list[dict[str, Any]] = []
        reasoning_parts: list[str] = []
        thinking_blocks: list[dict[str, Any]] = []
        for block in msg.get("content") or ():
            if "reasoningContent" in block:
                # Converse reasoning → reasoning_content +
                # replayable thinking_blocks (openai_awsbedrock.go:836)
                tb = converse_reasoning_to_thinking(block)
                if tb is not None:
                    thinking_blocks.append(tb)
                    if tb.get("thinking"):
                        reasoning_parts.append(tb["thinking"])
            elif "text" in block:
                text_parts.append(block["text"])
            elif "toolUse" in block:
                tu = block["toolUse"]
                if self._json_tool and tu.get("name") == self._json_tool:
                    # structured output rode the forced tool: the input IS
                    # the JSON response
                    text_parts.append(json.dumps(tu.get("input", {})))
                    continue
                tool_calls.append(
                    {
                        "id": tu.get("toolUseId", ""),
                        "type": "function",
                        "function": {
                            "name": tu.get("name", ""),
                            "arguments": json.dumps(tu.get("input", {})),
                        },
                    }
                )
        finish = _STOP_TO_OPENAI.get(data.get("stopReason") or "end_turn", "stop")
        if self._json_tool and not tool_calls and finish == "tool_calls":
            finish = "stop"
        out = oai.chat_completion_response(
            model=self._model,
            content="".join(text_parts),
            finish_reason=finish,
            usage=usage,
            tool_calls=tool_calls or None,
            response_id=self._id,
            reasoning_content="".join(reasoning_parts),
            thinking_blocks=thinking_blocks or None,
        )
        return ResponseTx(
            body=json.dumps(out).encode(), usage=usage, model=self._model
        )

    def _stream_chunk(self, chunk: bytes, end_of_stream: bool) -> ResponseTx:
        out = bytearray()
        usage = TokenUsage()
        tokens = 0
        for msg in self._es.feed(chunk):
            if msg.exception_type:
                out += SSEEvent(
                    data=json.dumps(
                        {
                            "error": {
                                "message": msg.payload.decode(
                                    "utf-8", errors="replace"
                                ),
                                "type": msg.exception_type,
                                "code": None,
                            }
                        }
                    )
                ).encode()
                continue
            try:
                data = json.loads(msg.payload) if msg.payload else {}
            except json.JSONDecodeError:
                continue
            etype = msg.event_type
            if etype == "messageStart":
                out += self._emit({"role": "assistant", "content": ""})
            elif etype == "contentBlockStart":
                start = (data.get("start") or {}).get("toolUse")
                if start and self._json_tool \
                        and start.get("name") == self._json_tool:
                    self._in_json_block = True
                elif start:
                    self._tool_idx += 1
                    out += self._emit(
                        {
                            "tool_calls": [
                                {
                                    "index": self._tool_idx,
                                    "id": start.get("toolUseId", ""),
                                    "type": "function",
                                    "function": {
                                        "name": start.get("name", ""),
                                        "arguments": "",
                                    },
                                }
                            ]
                        }
                    )
            elif etype == "contentBlockDelta":
                delta = data.get("delta") or {}
                if "text" in delta:
                    tokens += 1
                    out += self._emit({"content": delta["text"]})
                elif "toolUse" in delta:
                    if self._in_json_block:
                        # structured-output tool: stream the JSON as
                        # content deltas
                        tokens += 1
                        out += self._emit(
                            {"content": delta["toolUse"].get("input", "")})
                    else:
                        out += self._emit(
                            {
                                "tool_calls": [
                                    {
                                        "index": self._tool_idx,
                                        "function": {
                                            "arguments": delta["toolUse"].get(
                                                "input", ""
                                            )
                                        },
                                    }
                                ]
                            }
                        )
                elif "reasoningContent" in delta:
                    rc = delta["reasoningContent"]
                    if rc.get("text"):
                        tokens += 1
                        out += self._emit({"reasoning_content": rc["text"]})
            elif etype == "messageStop":
                self._finish = _STOP_TO_OPENAI.get(
                    data.get("stopReason") or "end_turn", "stop"
                )
                if self._json_tool and self._finish == "tool_calls" \
                        and self._tool_idx < 0:
                    self._finish = "stop"
            elif etype == "metadata":
                self._usage = self._usage.merge_override(
                    converse_usage(data.get("usage") or {})
                )
                usage = usage.merge_override(self._usage)
                out += SSEEvent(
                    data=json.dumps(
                        oai.chat_completion_chunk(
                            response_id=self._id,
                            model=self._model,
                            delta={},
                            finish_reason=self._finish or "stop",
                            usage=self._usage if self._include_usage else None,
                            created=self._created,
                        )
                    )
                ).encode()
                out += SSEEvent(data="[DONE]").encode()
                self._sent_done = True
        if end_of_stream and not self._sent_done:
            out += SSEEvent(data="[DONE]").encode()
            self._sent_done = True
        return ResponseTx(
            body=bytes(out), usage=usage, model=self._model, tokens_emitted=tokens
        )

    def _emit(self, delta: dict[str, Any]) -> bytes:
        return oai.stream_chunk_sse(
            response_id=self._id, model=self._model, created=self._created,
            delta=delta,
        )


register_translator(
    Endpoint.CHAT_COMPLETIONS,
    APISchemaName.OPENAI,
    APISchemaName.AWS_BEDROCK,
    OpenAIToBedrockChat,
)
