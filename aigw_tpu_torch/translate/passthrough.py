"""Same-schema passthrough translators (the port's copy of
``aigw_tpu/translate/passthrough.py``): OpenAI→OpenAI,
Anthropic→Anthropic and OpenAI→TPUServe (the replica speaks the OpenAI
surface natively). The request body is forwarded with at
most a model-name rewrite; response bytes are forwarded **unchanged** while
usage/model are extracted on the side — the allocation-lean fast path the
reference optimizes for (openai→openai translator + sjson).
"""

from __future__ import annotations

import json
from typing import Any, Callable

from aigw_tpu_torch.config.model import APISchemaName
from aigw_tpu_torch.gateway.costs import TokenUsage
from aigw_tpu_torch.schemas import anthropic as anthropic_schema
from aigw_tpu_torch.schemas import openai as openai_schema
from aigw_tpu_torch.translate.base import (
    Endpoint,
    RequestTx,
    ResponseTx,
    Translator,
    register_translator,
)
from aigw_tpu_torch.translate.sse import SSEParser


class PassthroughTranslator(Translator):
    def __init__(
        self,
        *,
        path: str,
        usage_extractor: Callable[[dict[str, Any]], TokenUsage],
        model_name_override: str = "",
        stream: bool = False,
    ):
        self._path = path
        self._extract = usage_extractor
        self._override = model_name_override
        self._stream = stream
        self._parser = SSEParser()

    def request(self, body: dict[str, Any]) -> RequestTx:
        stream = bool(body.get("stream", False)) or self._stream
        self._stream = stream
        if self._override:
            body = dict(body, model=self._override)
        return RequestTx(
            body=json.dumps(body).encode(), path=self._path, stream=stream
        )

    def response_body(self, chunk: bytes, end_of_stream: bool) -> ResponseTx:
        if not self._stream:
            if not end_of_stream:
                # buffered mode: the server hands us the whole body at once
                return ResponseTx(body=chunk)
            try:
                data = json.loads(chunk) if chunk else {}
            except json.JSONDecodeError:
                return ResponseTx(body=chunk)
            if not isinstance(data, dict):
                # non-object JSON: nothing to mine; the gateway's
                # response-side validation rejects it for typed endpoints
                return ResponseTx(body=chunk, parsed=data)
            return ResponseTx(
                body=chunk,
                usage=self._extract(data),
                model=str(data.get("model", "") or ""),
                parsed=data,
            )
        #

        # Streaming: forward bytes untouched; mine events for usage/model.
        usage = TokenUsage()
        model = ""
        tokens = 0
        events = self._parser.feed(chunk)
        if end_of_stream:
            events += self._parser.flush()
        for ev in events:
            if not ev.data or ev.data.strip() == "[DONE]":
                continue
            try:
                data = json.loads(ev.data)
            except json.JSONDecodeError:
                continue
            if not isinstance(data, dict):
                continue  # malformed event: the gateway's response-side
                # validation rejects it; don't crash the counter
            usage = usage.merge_override(self._extract(data))
            model = str(data.get("model", "") or "") or model
            choices = data.get("choices", ())
            for choice in choices if isinstance(choices, list) else ():
                if not isinstance(choice, dict):
                    continue
                delta = choice.get("delta")
                if isinstance(delta, dict) and delta.get("content"):
                    tokens += 1
            # Anthropic-shaped stream events carry no "choices"
            if data.get("type") == "content_block_delta":
                if (data.get("delta") or {}).get("type") in (
                    "text_delta", "thinking_delta",
                ):
                    tokens += 1
        return ResponseTx(body=chunk, usage=usage, model=model, tokens_emitted=tokens)


def _anthropic_stream_usage(data: dict[str, Any]) -> TokenUsage:
    # message_start carries usage under message.usage; message_delta at top level.
    if data.get("type") == "message_start":
        return anthropic_schema.extract_usage(data.get("message") or {})
    return anthropic_schema.extract_usage(data)


class AnthropicPassthrough(PassthroughTranslator):
    def __init__(self, **kw: Any):
        kw.setdefault("path", Endpoint.MESSAGES.value)
        kw.setdefault("usage_extractor", _anthropic_stream_usage)
        super().__init__(**kw)

    def request(self, body: dict[str, Any]) -> RequestTx:
        # the gateway admits mid-conversation role:system messages, but
        # the Anthropic upstream rejects them — promote to the top-level
        # system parameter before forwarding
        return super().request(
            anthropic_schema.promote_system_messages(body))

    def response_error(self, status: int, body: bytes) -> bytes:
        text = body.decode("utf-8", errors="replace")[:4096]
        return anthropic_schema.error_body(
            f"upstream error (status {status}): {text}", type_="api_error"
        )


def _openai_factory(path: str):
    def make(*, model_name_override: str = "", stream: bool = False, **_: object):
        return PassthroughTranslator(
            path=path,
            usage_extractor=openai_schema.extract_usage,
            model_name_override=model_name_override,
            stream=stream,
        )

    return make


def _anthropic_factory(*, model_name_override: str = "", stream: bool = False, **_: object):
    return AnthropicPassthrough(
        model_name_override=model_name_override, stream=stream
    )


def _install() -> None:
    openai_like = (APISchemaName.OPENAI, APISchemaName.TPUSERVE)
    for ep in (
        Endpoint.CHAT_COMPLETIONS,
        Endpoint.COMPLETIONS,
        Endpoint.EMBEDDINGS,
        Endpoint.TOKENIZE,
        Endpoint.RESPONSES,
        Endpoint.IMAGES_GENERATIONS,
        Endpoint.AUDIO_SPEECH,
        Endpoint.AUDIO_TRANSCRIPTIONS,
        Endpoint.AUDIO_TRANSLATIONS,
    ):
        for src in openai_like:
            for dst in openai_like:
                register_translator(ep, src, dst, _openai_factory(ep.value))
    register_translator(
        Endpoint.MESSAGES,
        APISchemaName.ANTHROPIC,
        APISchemaName.ANTHROPIC,
        _anthropic_factory,
    )


_install()
