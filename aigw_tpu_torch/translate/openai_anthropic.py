"""OpenAI chat/completions front → Anthropic /v1/messages backend.

The upstream gateway's pair: internal/translator openai→anthropic via
anthropic_helper.go (1408 LoC). Handles message/tool-call mapping in both
directions and re-encodes the Anthropic SSE event stream into OpenAI
chat.completion.chunk SSE.

The port's copy of ``aigw_tpu/translate/openai_anthropic.py``.
"""

from __future__ import annotations

import json
import time
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
from aigw_tpu_torch.translate import vendor_fields
from aigw_tpu_torch.translate.sse import SSEEvent, SSEParser
from aigw_tpu_torch.translate.structured import parse_response_format


def openai_messages_to_anthropic(
    messages: list[dict[str, Any]],
) -> tuple["str | list[dict[str, Any]]", list[dict[str, Any]]]:
    """OpenAI messages → (system, anthropic messages).

    - system/developer roles concatenate into the system parameter —
      returned as a plain string normally, or as a list of text blocks
      when any system part carries a cache_control marker (the block
      form is how Anthropic caches system prompts)
    - assistant tool_calls → tool_use blocks
    - role:"tool" results → user tool_result blocks
    - consecutive same-role messages merge (Anthropic wants alternation)
    """
    system_blocks: list[dict[str, Any]] = []
    out: list[dict[str, Any]] = []

    def push(role: str, blocks: list[dict[str, Any]]) -> None:
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
                    block = {"type": "text", "text": part["text"]}
                    if (cc := _cache_control(part)) is not None:
                        block["cache_control"] = cc
                    system_blocks.append(block)
            else:
                text = oai.message_content_text(content)
                if text:
                    system_blocks.append({"type": "text", "text": text})
        elif role == "user":
            push("user", _user_content_blocks(m.get("content")))
        elif role == "assistant":
            blocks: list[dict[str, Any]] = _assistant_content_blocks(
                m.get("content"))
            # LiteLLM-convention message-level thinking_blocks (the
            # shape our responses emit): convert when the content parts
            # didn't already carry thinking
            if not any(b.get("type") in ("thinking", "redacted_thinking")
                       for b in blocks):
                blocks = _assistant_content_blocks(
                    m.get("thinking_blocks")) + blocks
            for tc in m.get("tool_calls") or ():
                fn = tc.get("function") or {}
                try:
                    args = json.loads(fn.get("arguments") or "{}")
                except json.JSONDecodeError:
                    args = {}
                tool_use = {
                    "type": "tool_use",
                    "id": tc.get("id", ""),
                    "name": fn.get("name", ""),
                    "input": args,
                }
                if (cc := _cache_control(tc)) is not None:
                    tool_use["cache_control"] = cc
                blocks.append(tool_use)
            if blocks:
                push("assistant", blocks)
        elif role == "tool":
            result = {
                "type": "tool_result",
                "tool_use_id": m.get("tool_call_id", ""),
                "content": oai.message_content_text(m.get("content")),
            }
            # agent loops put the cache breakpoint after the last tool
            # result — honor the marker at message level or on any part
            cc = _cache_control(m)
            if cc is None and isinstance(m.get("content"), list):
                for part in m["content"]:
                    if isinstance(part, dict) and \
                            (cc := _cache_control(part)) is not None:
                        break
            if cc is not None:
                result["cache_control"] = cc
            push("user", [result])
        else:
            raise TranslationError(f"unsupported message role {role!r}")
    # plain string when nothing carries a cache marker (back-compat and
    # byte-stable goldens); block form otherwise — a cached system
    # prompt is THE primary prompt-caching use case and must survive
    if any("cache_control" in b for b in system_blocks):
        return system_blocks, out
    return "\n".join(b["text"] for b in system_blocks), out


def _assistant_content_blocks(content: Any) -> list[dict[str, Any]]:
    """Assistant content union → Anthropic blocks. Beyond plain text,
    the array form carries thinking/redacted_thinking parts that clients
    replay from a previous turn (anthropic_helper.go:368-399
    processAssistantContent): thinking needs BOTH text and signature —
    Anthropic rejects unsigned thinking blocks when thinking is on —
    and refusal parts become text."""
    if content is None:
        return []
    if isinstance(content, str):
        return [{"type": "text", "text": content}] if content else []
    if isinstance(content, dict):
        content = [content]
    if not isinstance(content, list):
        # unvalidated callers (/tokenize) reach here with raw bodies —
        # malformed content must 400, not 500
        raise oai.SchemaError(
            "assistant content must be a string or an array of parts")
    blocks: list[dict[str, Any]] = []
    for part in content:
        if not isinstance(part, dict):
            continue  # same tolerance as message_content_text
        ptype = part.get("type")
        if ptype == "text":
            if part.get("text"):
                block = {"type": "text", "text": part["text"]}
                if (cc := _cache_control(part)) is not None:
                    block["cache_control"] = cc
                blocks.append(block)
        elif ptype == "refusal":
            if part.get("refusal"):
                blocks.append({"type": "text", "text": part["refusal"]})
        elif ptype == "thinking":
            # accept both the OpenAI-content-part spelling ("text") and
            # the shape this gateway emits in thinking_blocks
            # ("thinking") so responses round-trip verbatim
            text = part.get("text") or part.get("thinking")
            if text and part.get("signature"):
                blocks.append({
                    "type": "thinking",
                    "thinking": text,
                    "signature": part["signature"],
                })
        elif ptype == "redacted_thinking":
            data = part.get("redactedContent") or part.get("data")
            if isinstance(data, str):
                blocks.append({"type": "redacted_thinking", "data": data})
        else:
            raise TranslationError(
                f"unsupported assistant content part {ptype!r}")
    return blocks


_cache_control = vendor_fields.cache_control_marker


def _user_content_blocks(content: Any) -> list[dict[str, Any]]:
    if content is None:
        return []
    if isinstance(content, str):
        return [{"type": "text", "text": content}]
    blocks: list[dict[str, Any]] = []
    for part in content:
        ptype = part.get("type")
        if ptype == "text":
            if not part.get("text"):
                continue  # Anthropic rejects empty text blocks
            block = {"type": "text", "text": part["text"]}
            if (cc := _cache_control(part)) is not None:
                block["cache_control"] = cc
            blocks.append(block)
            continue
        if ptype == "image_url":
            url = (part.get("image_url") or {}).get("url", "")
            if url.startswith("data:"):
                media, _, b64 = url[len("data:") :].partition(";base64,")
                block = {
                    "type": "image",
                    "source": {
                        "type": "base64",
                        "media_type": media or "image/png",
                        "data": b64,
                    },
                }
            else:
                block = {"type": "image",
                         "source": {"type": "url", "url": url}}
            if (cc := _cache_control(part)) is not None:
                block["cache_control"] = cc
            blocks.append(block)
        else:
            raise TranslationError(f"unsupported content part {ptype!r}")
    return blocks


def openai_tools_to_anthropic(body: dict[str, Any]) -> dict[str, Any]:
    out: dict[str, Any] = {}
    tools = body.get("tools")
    if tools:
        converted = []
        for t in tools:
            if t.get("type") != "function":
                # Gemini built-in tools pass the shared validator but
                # have no Anthropic shape — a clear 400 beats silently
                # serving without the capability
                raise TranslationError(
                    f"tool type {t.get('type')!r} is not supported by "
                    "Anthropic backends")
            fn = t.get("function") or {}
            tool = {
                "name": fn.get("name", ""),
                "description": fn.get("description", ""),
                "input_schema": fn.get("parameters", {"type": "object"}),
            }
            if (cc := _cache_control(fn)) is not None:
                tool["cache_control"] = cc
            converted.append(tool)
        out["tools"] = converted
    choice = body.get("tool_choice")
    if choice == "auto":
        out["tool_choice"] = {"type": "auto"}
    elif choice == "required":
        out["tool_choice"] = {"type": "any"}
    elif choice == "none":
        out["tool_choice"] = {"type": "none"}
    elif isinstance(choice, dict) and choice.get("type") == "function":
        out["tool_choice"] = {
            "type": "tool",
            "name": (choice.get("function") or {}).get("name", ""),
        }
    if body.get("parallel_tool_calls") is False and "tool_choice" in out:
        out["tool_choice"]["disable_parallel_tool_use"] = True
    return out


def anthropic_usage_to_openai(usage: TokenUsage) -> TokenUsage:
    """Anthropic input_tokens excludes cache reads/creation; OpenAI
    prompt_tokens includes them (the upstream gateway normalizes the same way)."""
    prompt = (
        usage.input_tokens
        + usage.cached_input_tokens
        + usage.cache_creation_input_tokens
    )
    return TokenUsage(
        input_tokens=prompt,
        output_tokens=usage.output_tokens,
        total_tokens=prompt + usage.output_tokens,
        cached_input_tokens=usage.cached_input_tokens,
        cache_creation_input_tokens=usage.cache_creation_input_tokens,
    )


class OpenAIToAnthropicChat(Translator):
    """OpenAI chat completions client ⇄ Anthropic messages upstream."""

    def __init__(self, *, model_name_override: str = "", stream: bool = False,
                 gcp_backend: bool = False):
        self._override = model_name_override
        self._gcp = gcp_backend
        self._stream = stream
        self._include_usage = False
        self._parser = SSEParser()
        # streaming state
        self._id = f"chatcmpl-{uuid.uuid4().hex[:24]}"
        self._created = int(time.time())
        self._model = ""
        self._usage = TokenUsage()
        self._tool_idx = -1
        self._block_is_tool = False
        self._finish: str | None = None
        self._sent_done = False
        # in-flight thinking block (text + signature accumulate across
        # deltas; flushed as a thinking_blocks delta on block stop)
        self._thinking_acc: dict[str, str] | None = None

    # -- request ----------------------------------------------------------
    def request(self, body: dict[str, Any]) -> RequestTx:
        oai.validate_gateway_chat_request(body)
        self._stream = bool(body.get("stream", False))
        self._include_usage = oai.include_stream_usage(body)
        system, messages = openai_messages_to_anthropic(body["messages"])
        out: dict[str, Any] = {
            "model": self._override or body["model"],
            "messages": messages,
            "max_tokens": int(
                body.get("max_completion_tokens")
                or body.get("max_tokens")
                or anth.DEFAULT_MAX_TOKENS
            ),
        }
        if system:
            out["system"] = system
        if body.get("temperature") is not None:
            # OpenAI range [0,2] → Anthropic [0,1]
            out["temperature"] = min(max(float(body["temperature"]), 0.0), 1.0)
        if body.get("top_p") is not None:
            out["top_p"] = float(body["top_p"])
        stop = body.get("stop")
        if stop:
            out["stop_sequences"] = [stop] if isinstance(stop, str) else list(stop)
        out.update(openai_tools_to_anthropic(body))
        # Structured outputs: response_format json_schema → Anthropic
        # output_config.format (upstream anthropic_helper.go:712-734).
        # GCP-hosted Anthropic does not support structured output; the
        # upstream gateway skips it there too (isGCPBackend check). The schema
        # passes through verbatim — Anthropic accepts standard JSON
        # Schema including $defs/$ref.
        rf = parse_response_format(body)
        if (rf is not None and rf.kind == "json_schema"
                and rf.schema is not None and not self._gcp):
            out["output_config"] = {
                "format": {"type": "json_schema", "schema": rf.schema}
            }
        # reasoning_effort → output_config.effort (anthropic_helper.go:737)
        effort = body.get("reasoning_effort")
        if effort and not self._gcp:
            if effort == "minimal":  # OpenAI's lowest tier → Anthropic low
                effort = "low"
            if effort not in ("low", "medium", "high", "xhigh", "max"):
                raise TranslationError(
                    f"unsupported reasoning effort level: {effort!r}")
            out.setdefault("output_config", {})["effort"] = effort
        # proposal-004 vendor field: thinking union → Messages thinking
        # param (anthropic_helper.go:577-607, applied at :762); shared by
        # the GCP/AWS-hosted subclasses
        thinking = vendor_fields.thinking_to_anthropic(body)
        if thinking is not None:
            out["thinking"] = thinking
        if self._stream:
            out["stream"] = True
        if isinstance(body.get("metadata"), dict) and body["metadata"].get("user_id"):
            out["metadata"] = {"user_id": body["metadata"]["user_id"]}
        elif body.get("user"):
            out["metadata"] = {"user_id": str(body["user"])}
        return RequestTx(
            body=json.dumps(out).encode(),
            path=Endpoint.MESSAGES.value,
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
        usage = anthropic_usage_to_openai(anth.extract_usage(data))
        blocks = data.get("content") or []
        text = anth.text_of_blocks(blocks)
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
        finish = anth.STOP_REASON_TO_OPENAI.get(
            data.get("stop_reason") or "end_turn", "stop"
        )
        model = str(data.get("model", "") or "")
        # thinking blocks → reasoning_content + replayable
        # thinking_blocks (anthropic_helper.go:1321-1343; signatures must
        # survive so the next turn's request can echo them)
        reasoning_parts: list[str] = []
        thinking_blocks: list[dict[str, Any]] = []
        for b in blocks:
            if b.get("type") == "thinking":
                if b.get("thinking"):
                    reasoning_parts.append(b["thinking"])
                thinking_blocks.append({
                    "type": "thinking",
                    "thinking": b.get("thinking", ""),
                    "signature": b.get("signature", ""),
                })
            elif b.get("type") == "redacted_thinking":
                if b.get("data"):
                    thinking_blocks.append({
                        "type": "redacted_thinking",
                        "data": b["data"],
                    })
        out = oai.chat_completion_response(
            model=model,
            content=text,
            finish_reason=finish,
            usage=usage,
            tool_calls=tool_calls or None,
            response_id=self._id,
            reasoning_content="".join(reasoning_parts),
            thinking_blocks=thinking_blocks or None,
        )
        return ResponseTx(body=json.dumps(out).encode(), usage=usage, model=model)

    def _stream_chunk(self, chunk: bytes, end_of_stream: bool) -> ResponseTx:
        events = self._parser.feed(chunk)
        if end_of_stream:
            events += self._parser.flush()
        out = bytearray()
        usage = TokenUsage()
        tokens = 0
        for ev in events:
            if not ev.data:
                continue
            try:
                data = json.loads(ev.data)
            except json.JSONDecodeError:
                continue
            etype = data.get("type") or ev.event
            if etype == "message_start":
                msg = data.get("message") or {}
                self._model = str(msg.get("model", "") or "")
                self._usage = self._usage.merge_override(
                    anthropic_usage_to_openai(anth.extract_usage(msg))
                )
                out += self._emit({"role": "assistant", "content": ""})
            elif etype == "content_block_start":
                block = data.get("content_block") or {}
                self._block_is_tool = block.get("type") == "tool_use"
                if block.get("type") == "thinking":
                    self._thinking_acc = {"type": "thinking",
                                          "thinking": "", "signature": ""}
                elif block.get("type") == "redacted_thinking":
                    # redacted blocks arrive whole on the start event
                    out += self._emit({"thinking_blocks": [{
                        "type": "redacted_thinking",
                        "data": block.get("data", "")}]})
                if self._block_is_tool:
                    self._tool_idx += 1
                    out += self._emit(
                        {
                            "tool_calls": [
                                {
                                    "index": self._tool_idx,
                                    "id": block.get("id", ""),
                                    "type": "function",
                                    "function": {
                                        "name": block.get("name", ""),
                                        "arguments": "",
                                    },
                                }
                            ]
                        }
                    )
            elif etype == "content_block_delta":
                delta = data.get("delta") or {}
                dtype = delta.get("type")
                if dtype == "text_delta":
                    tokens += 1
                    out += self._emit({"content": delta.get("text", "")})
                elif dtype == "input_json_delta":
                    out += self._emit(
                        {
                            "tool_calls": [
                                {
                                    "index": self._tool_idx,
                                    "function": {
                                        "arguments": delta.get("partial_json", "")
                                    },
                                }
                            ]
                        }
                    )
                elif dtype == "thinking_delta":
                    tokens += 1
                    if self._thinking_acc is not None:
                        self._thinking_acc["thinking"] += \
                            delta.get("thinking", "")
                    out += self._emit(
                        {"reasoning_content": delta.get("thinking", "")}
                    )
                elif dtype == "signature_delta":
                    # the signature arrives at the end of a thinking
                    # block; without it the client cannot replay the
                    # block next turn (Anthropic rejects unsigned
                    # thinking before tool_use) — emit the completed
                    # block as a thinking_blocks delta, matching the
                    # unary response shape
                    if self._thinking_acc is not None:
                        self._thinking_acc["signature"] += \
                            delta.get("signature", "")
            elif etype == "content_block_stop":
                if self._thinking_acc is not None and (
                        self._thinking_acc["thinking"]
                        or self._thinking_acc["signature"]):
                    out += self._emit(
                        {"thinking_blocks": [self._thinking_acc]})
                self._thinking_acc = None
            elif etype == "message_delta":
                d = data.get("delta") or {}
                self._finish = anth.STOP_REASON_TO_OPENAI.get(
                    d.get("stop_reason") or "", "stop"
                )
                u = anth.extract_usage(data)
                self._usage = self._usage.merge_override(
                    TokenUsage(output_tokens=u.output_tokens)
                )
                if u.input_tokens and not self._usage.input_tokens:
                    # message_delta's usage is cumulative: an upstream
                    # that learns the input count only at the end (an
                    # Anthropic front over an OpenAI-schema upstream)
                    # sends message_start zeros and the count here. The
                    # reference reads output_tokens alone and bills 0.
                    full = anthropic_usage_to_openai(u)
                    self._usage = self._usage.merge_override(TokenUsage(
                        input_tokens=full.input_tokens,
                        cached_input_tokens=full.cached_input_tokens,
                        cache_creation_input_tokens=(
                            full.cache_creation_input_tokens)))
            elif etype == "message_stop":
                final = TokenUsage(
                    input_tokens=self._usage.input_tokens,
                    output_tokens=self._usage.output_tokens,
                    total_tokens=self._usage.input_tokens
                    + self._usage.output_tokens,
                    cached_input_tokens=self._usage.cached_input_tokens,
                    cache_creation_input_tokens=self._usage.cache_creation_input_tokens,
                )
                usage = usage.merge_override(final)
                out += SSEEvent(
                    data=json.dumps(
                        oai.chat_completion_chunk(
                            response_id=self._id,
                            model=self._model,
                            delta={},
                            finish_reason=self._finish or "stop",
                            usage=final if self._include_usage else None,
                            created=self._created,
                        )
                    )
                ).encode()
                out += SSEEvent(data="[DONE]").encode()
                self._sent_done = True
            elif etype == "error":
                err = data.get("error") or {}
                out += SSEEvent(
                    data=json.dumps(
                        {
                            "error": {
                                "message": err.get("message", "upstream error"),
                                "type": err.get("type", "upstream_error"),
                                "code": None,
                            }
                        }
                    )
                ).encode()
            # ping and unknown events are dropped
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


def _factory(*, model_name_override: str = "", stream: bool = False,
             **_: object):
    return OpenAIToAnthropicChat(
        model_name_override=model_name_override, stream=stream
    )


register_translator(
    Endpoint.CHAT_COMPLETIONS,
    APISchemaName.OPENAI,
    APISchemaName.ANTHROPIC,
    _factory,
)
# The GCP/AWS-hosted Anthropic variants (different envelopes/paths; GCP
# additionally lacks structured-output support) are registered by
# anthropic_hosted.py, which subclasses this translator.
