"""Anthropic /v1/messages front → OpenAI chat/completions backend (the
port's copy of ``aigw_tpu/translate/anthropic_openai.py``). Lets
Anthropic-SDK clients reach OpenAI-schema backends and the port's
replicas: the request becomes a chat request, the chat response (or its
SSE chunks) becomes a Messages response (or ``message_start`` /
``content_block_*`` / ``message_delta`` / ``message_stop`` events).
"""

from __future__ import annotations

import json
import uuid
from typing import Any

from aigw_tpu_torch.config.model import APISchemaName
from aigw_tpu_torch.gateway.costs import TokenUsage
from aigw_tpu_torch.schemas import anthropic as anth
from aigw_tpu_torch.schemas import openai as oai
from aigw_tpu_torch.translate.base import (
    Endpoint,
    RequestTx,
    ResponseTx,
    TranslationError,
    Translator,
    register_translator,
)
from aigw_tpu_torch.translate.sse import SSEEvent, SSEParser


def anthropic_messages_to_openai(
    system: Any, messages: list[dict[str, Any]]
) -> list[dict[str, Any]]:
    out: list[dict[str, Any]] = []
    if system:
        text = (
            system
            if isinstance(system, str)
            else anth.text_of_blocks(anth.content_blocks(system))
        )
        if text:
            out.append({"role": "system", "content": text})
    for m in messages:
        role = m.get("role")
        blocks = anth.content_blocks(m.get("content"))
        if role == "system":
            # mid-conversation system message → OpenAI system message in
            # place (array position preserved)
            text = anth.text_of_blocks(blocks)
            if text:
                out.append({"role": "system", "content": text})
        elif role == "user":
            texts: list[str] = []
            for b in blocks:
                btype = b.get("type")
                if btype == "text":
                    texts.append(b.get("text", ""))
                elif btype == "tool_result":
                    content = b.get("content")
                    if isinstance(content, list):
                        content = anth.text_of_blocks(content)
                    out.append(
                        {
                            "role": "tool",
                            "tool_call_id": b.get("tool_use_id", ""),
                            "content": content or "",
                        }
                    )
                elif btype == "image":
                    src = b.get("source") or {}
                    if src.get("type") == "base64":
                        url = (
                            f"data:{src.get('media_type', 'image/png')};base64,"
                            f"{src.get('data', '')}"
                        )
                    else:
                        url = src.get("url", "")
                    out.append(
                        {
                            "role": "user",
                            "content": [
                                {"type": "image_url", "image_url": {"url": url}}
                            ],
                        }
                    )
            if texts:
                out.append({"role": "user", "content": "".join(texts)})
        elif role == "assistant":
            msg: dict[str, Any] = {"role": "assistant"}
            text = anth.text_of_blocks(blocks)
            msg["content"] = text or None
            tool_calls = [
                {
                    "id": b.get("id", ""),
                    "type": "function",
                    "function": {
                        "name": b.get("name", ""),
                        "arguments": json.dumps(b.get("input", {})),
                    },
                }
                for b in blocks
                if b.get("type") == "tool_use"
            ]
            if tool_calls:
                msg["tool_calls"] = tool_calls
            out.append(msg)
        else:
            raise TranslationError(f"unsupported role {role!r}")
    return out


class AnthropicToOpenAIChat(Translator):
    def __init__(self, *, model_name_override: str = "", stream: bool = False):
        self._override = model_name_override
        self._stream = stream
        self._parser = SSEParser()
        self._id = f"msg_{uuid.uuid4().hex[:24]}"
        self._model = ""
        self._usage = TokenUsage()
        # streaming state machine
        self._started = False  # message_start sent
        self._text_block_open = False
        self._tool_block_open = False
        self._block_idx = -1
        self._finish: str | None = None
        self._done = False

    def request(self, body: dict[str, Any]) -> RequestTx:
        anth.validate_messages_request(body)
        self._stream = bool(body.get("stream", False))
        out: dict[str, Any] = {
            "model": self._override or body["model"],
            "messages": anthropic_messages_to_openai(
                body.get("system"), body["messages"]
            ),
            "max_tokens": int(body["max_tokens"]),
        }
        if body.get("temperature") is not None:
            out["temperature"] = float(body["temperature"])
        if body.get("top_p") is not None:
            out["top_p"] = float(body["top_p"])
        if body.get("stop_sequences"):
            out["stop"] = list(body["stop_sequences"])
        tools = body.get("tools")
        if tools:
            out["tools"] = [
                {
                    "type": "function",
                    "function": {
                        "name": t.get("name", ""),
                        "description": t.get("description", ""),
                        "parameters": t.get("input_schema", {"type": "object"}),
                    },
                }
                for t in tools
            ]
        choice = body.get("tool_choice")
        if isinstance(choice, dict):
            ctype = choice.get("type")
            if ctype == "auto":
                out["tool_choice"] = "auto"
            elif ctype == "any":
                out["tool_choice"] = "required"
            elif ctype == "none":
                out["tool_choice"] = "none"
            elif ctype == "tool":
                out["tool_choice"] = {
                    "type": "function",
                    "function": {"name": choice.get("name", "")},
                }
        if self._stream:
            out["stream"] = True
            out["stream_options"] = {"include_usage": True}
        return RequestTx(
            body=json.dumps(out).encode(),
            path=Endpoint.CHAT_COMPLETIONS.value,
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
        usage = oai.extract_usage(data)
        choice = (data.get("choices") or [{}])[0]
        msg = choice.get("message") or {}
        blocks: list[dict[str, Any]] = []
        if msg.get("content"):
            blocks.append({"type": "text", "text": msg["content"]})
        for tc in msg.get("tool_calls") or ():
            fn = tc.get("function") or {}
            try:
                args = json.loads(fn.get("arguments") or "{}")
            except json.JSONDecodeError:
                args = {}
            blocks.append(
                {
                    "type": "tool_use",
                    "id": tc.get("id", ""),
                    "name": fn.get("name", ""),
                    "input": args,
                }
            )
        stop_reason = anth.FINISH_REASON_TO_ANTHROPIC.get(
            choice.get("finish_reason") or "stop", "end_turn"
        )
        model = str(data.get("model", "") or "")
        # Anthropic input_tokens excludes cached; ours came from OpenAI where
        # prompt includes cached — report prompt as-is (cache fields zero).
        out = anth.messages_response(
            model=model,
            content=blocks,
            stop_reason=stop_reason,
            usage=usage,
            response_id=self._id,
        )
        return ResponseTx(body=json.dumps(out).encode(), usage=usage, model=model)

    def _stream_chunk(self, chunk: bytes, end_of_stream: bool) -> ResponseTx:
        events = self._parser.feed(chunk)
        if end_of_stream:
            events += self._parser.flush()
        out = bytearray()
        tokens = 0
        for ev in events:
            if not ev.data:
                continue
            if ev.data.strip() == "[DONE]":
                out += self._finalize()
                continue
            try:
                data = json.loads(ev.data)
            except json.JSONDecodeError:
                continue
            self._model = str(data.get("model", "") or "") or self._model
            if data.get("usage"):
                self._usage = self._usage.merge_override(oai.extract_usage(data))
            if not self._started:
                out += self._event(
                    "message_start",
                    {
                        "type": "message_start",
                        "message": anth.messages_response(
                            model=self._model,
                            content=[],
                            stop_reason=None,  # type: ignore[arg-type]
                            usage=self._usage,
                            response_id=self._id,
                        ),
                    },
                )
                self._started = True
            for choice in data.get("choices", ()):
                delta = choice.get("delta") or {}
                if delta.get("content"):
                    if self._tool_block_open:
                        out += self._close_block()
                    if not self._text_block_open:
                        self._block_idx += 1
                        self._text_block_open = True
                        out += self._event(
                            "content_block_start",
                            {
                                "type": "content_block_start",
                                "index": self._block_idx,
                                "content_block": {"type": "text", "text": ""},
                            },
                        )
                    tokens += 1
                    out += self._event(
                        "content_block_delta",
                        {
                            "type": "content_block_delta",
                            "index": self._block_idx,
                            "delta": {
                                "type": "text_delta",
                                "text": delta["content"],
                            },
                        },
                    )
                for tc in delta.get("tool_calls") or ():
                    fn = tc.get("function") or {}
                    if fn.get("name") or tc.get("id"):
                        out += self._close_block()
                        self._block_idx += 1
                        self._tool_block_open = True
                        out += self._event(
                            "content_block_start",
                            {
                                "type": "content_block_start",
                                "index": self._block_idx,
                                "content_block": {
                                    "type": "tool_use",
                                    "id": tc.get("id", ""),
                                    "name": fn.get("name", ""),
                                    "input": {},
                                },
                            },
                        )
                    if fn.get("arguments"):
                        out += self._event(
                            "content_block_delta",
                            {
                                "type": "content_block_delta",
                                "index": self._block_idx,
                                "delta": {
                                    "type": "input_json_delta",
                                    "partial_json": fn["arguments"],
                                },
                            },
                        )
                if choice.get("finish_reason"):
                    self._finish = anth.FINISH_REASON_TO_ANTHROPIC.get(
                        choice["finish_reason"], "end_turn"
                    )
        if end_of_stream and not self._done:
            out += self._finalize()
        usage = TokenUsage()
        if self._done:
            usage = self._usage
        return ResponseTx(
            body=bytes(out), usage=usage, model=self._model, tokens_emitted=tokens
        )

    def _close_block(self) -> bytes:
        if not (self._text_block_open or self._tool_block_open):
            return b""
        self._text_block_open = self._tool_block_open = False
        return self._event(
            "content_block_stop",
            {"type": "content_block_stop", "index": self._block_idx},
        )

    def _finalize(self) -> bytes:
        if self._done:
            return b""
        self._done = True
        out = bytearray()
        out += self._close_block()
        out += self._event(
            "message_delta",
            {
                "type": "message_delta",
                "delta": {
                    "stop_reason": self._finish or "end_turn",
                    "stop_sequence": None,
                },
                # include input_tokens so streaming clients can bill
            # correctly even though usage arrives at end-of-stream from
            # the OpenAI upstream (message_start carried zeros).
            "usage": {
                "input_tokens": self._usage.input_tokens,
                "output_tokens": self._usage.output_tokens,
            },
            },
        )
        out += self._event("message_stop", {"type": "message_stop"})
        return bytes(out)

    def _event(self, name: str, payload: dict[str, Any]) -> bytes:
        return SSEEvent(event=name, data=json.dumps(payload)).encode()

    def response_error(self, status: int, body: bytes) -> bytes:
        text = body.decode("utf-8", errors="replace")[:4096]
        return anth.error_body(
            f"upstream error (status {status}): {text}", type_="api_error"
        )


def _factory(*, model_name_override: str = "", stream: bool = False, **_: object):
    return AnthropicToOpenAIChat(
        model_name_override=model_name_override, stream=stream
    )


register_translator(
    Endpoint.MESSAGES, APISchemaName.ANTHROPIC, APISchemaName.OPENAI, _factory
)
# The replica speaks the OpenAI surface; Anthropic-front traffic to it goes
# through the same mapping.
register_translator(
    Endpoint.MESSAGES, APISchemaName.ANTHROPIC, APISchemaName.TPUSERVE, _factory
)
