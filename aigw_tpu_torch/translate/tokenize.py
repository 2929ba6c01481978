"""/tokenize endpoint translators (vLLM-compatible front).

Upstream: tokenize × {OpenAI-passthrough, GCPAnthropic, GCPVertexAI,
AWSAnthropic count-tokens} (SURVEY.md §2.4, translator/tokenize*.go).
Providers only expose token *counts*, so the translated response carries
``count`` with an empty ``tokens`` list — same fidelity as the upstream gateway.

The port's copy of ``aigw_tpu/translate/tokenize.py``.
"""

from __future__ import annotations

import json
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


def _tokenize_messages(body: dict[str, Any]) -> list[dict[str, Any]]:
    if isinstance(body.get("messages"), list):
        return body["messages"]
    prompt = body.get("prompt")
    if isinstance(prompt, str):
        return [{"role": "user", "content": prompt}]
    raise TranslationError("tokenize request needs 'prompt' or 'messages'")


class TokenizeToAnthropicCount(Translator):
    """vLLM /tokenize → Anthropic count-tokens APIs.

    Hosted variants use their own envelopes: Vertex serves count-tokens
    through ``publishers/anthropic/models/count-tokens:rawPredict`` (model
    moves into the body); plain Anthropic uses
    ``/v1/messages/count_tokens``."""

    def __init__(self, *, model_name_override: str = "",
                 variant: str = "anthropic", **_: object):
        self._override = model_name_override
        self._variant = variant

    def request(self, body: dict[str, Any]) -> RequestTx:
        from aigw_tpu_torch.translate.openai_anthropic import (
            openai_messages_to_anthropic,
        )

        system, messages = openai_messages_to_anthropic(_tokenize_messages(body))
        out: dict[str, Any] = {
            "model": self._override or oai.request_model(body),
            "messages": messages,
        }
        if system:
            out["system"] = system
        if self._variant == "vertex":
            path = (
                "/v1/projects/{GCP_PROJECT}/locations/{GCP_REGION}"
                "/publishers/anthropic/models/count-tokens:rawPredict"
            )
        else:
            path = "/v1/messages/count_tokens"
        return RequestTx(body=json.dumps(out).encode(), path=path)

    def response_body(self, chunk: bytes, end_of_stream: bool) -> ResponseTx:
        if not end_of_stream:
            return ResponseTx()
        try:
            data = json.loads(chunk)
        except json.JSONDecodeError as e:
            raise TranslationError(f"invalid upstream JSON: {e}") from None
        count = int(data.get("input_tokens", 0) or 0)
        out = {"count": count, "max_model_len": None, "tokens": []}
        usage = TokenUsage(input_tokens=count, total_tokens=count)
        return ResponseTx(body=json.dumps(out).encode(), usage=usage)


class TokenizeToGeminiCount(Translator):
    """vLLM /tokenize → Vertex Gemini ``:countTokens``."""

    def __init__(self, *, model_name_override: str = "", **_: object):
        self._override = model_name_override

    def request(self, body: dict[str, Any]) -> RequestTx:
        from aigw_tpu_torch.translate.openai_gcp import openai_messages_to_gemini

        model = self._override or oai.request_model(body)
        system, contents = openai_messages_to_gemini(_tokenize_messages(body))
        out: dict[str, Any] = {"contents": contents}
        if system:
            out["systemInstruction"] = system
        path = (
            "/v1/projects/{GCP_PROJECT}/locations/{GCP_REGION}"
            f"/publishers/google/models/{model}:countTokens"
        )
        return RequestTx(body=json.dumps(out).encode(), path=path)

    def response_body(self, chunk: bytes, end_of_stream: bool) -> ResponseTx:
        if not end_of_stream:
            return ResponseTx()
        try:
            data = json.loads(chunk)
        except json.JSONDecodeError as e:
            raise TranslationError(f"invalid upstream JSON: {e}") from None
        count = int(data.get("totalTokens", 0) or 0)
        out = {"count": count, "max_model_len": None, "tokens": []}
        usage = TokenUsage(input_tokens=count, total_tokens=count)
        return ResponseTx(body=json.dumps(out).encode(), usage=usage)


register_translator(
    Endpoint.TOKENIZE, APISchemaName.OPENAI, APISchemaName.ANTHROPIC,
    TokenizeToAnthropicCount,
)


def _vertex_count_factory(*, model_name_override: str = "", **_: object):
    return TokenizeToAnthropicCount(
        model_name_override=model_name_override, variant="vertex"
    )


register_translator(
    Endpoint.TOKENIZE, APISchemaName.OPENAI, APISchemaName.GCP_ANTHROPIC,
    _vertex_count_factory,
)


class TokenizeToBedrockAnthropicCount(Translator):
    """vLLM /tokenize → AWS Bedrock CountTokens API
    (tokenize_awsanthropic.go:29-215): the Anthropic Messages body —
    anthropic_version set, max_tokens=1 added because Bedrock validates
    the inner body as a real request, model dropped (it rides the URL) —
    is base64-wrapped as ``{"input":{"invokeModel":{"body": ...}}}`` and
    POSTed to ``/model/{model}/count-tokens``. CountTokens rejects
    cross-region-inference model IDs, so any geography prefix before the
    ``anthropic.`` provider segment is stripped (:108-116)."""

    def __init__(self, *, model_name_override: str = "", **_: object):
        self._override = model_name_override

    def request(self, body: dict[str, Any]) -> RequestTx:
        import base64
        import urllib.parse

        from aigw_tpu_torch.translate.anthropic_hosted import (
            BEDROCK_ANTHROPIC_VERSION,
        )
        from aigw_tpu_torch.translate.openai_anthropic import (
            openai_messages_to_anthropic,
        )

        model = self._override or oai.request_model(body)
        system, messages = openai_messages_to_anthropic(
            _tokenize_messages(body))
        inner: dict[str, Any] = {
            "messages": messages,
            "anthropic_version": BEDROCK_ANTHROPIC_VERSION,
            "max_tokens": 1,
        }
        if system:
            inner["system"] = system
        path_model = model
        i = path_model.find("anthropic.")
        if i > 0:  # CRIS geography prefix (us./eu./apac./us-gov.)
            path_model = path_model[i:]
        out = {"input": {"invokeModel": {"body": base64.b64encode(
            json.dumps(inner).encode()).decode()}}}
        return RequestTx(
            body=json.dumps(out).encode(),
            path=f"/model/{urllib.parse.quote(path_model, safe='')}"
                 f"/count-tokens",
        )

    def response_body(self, chunk: bytes, end_of_stream: bool) -> ResponseTx:
        if not end_of_stream:
            return ResponseTx()
        try:
            data = json.loads(chunk)
        except json.JSONDecodeError as e:
            raise TranslationError(f"invalid upstream JSON: {e}") from None
        count = int(data.get("inputTokens", 0) or 0)
        out = {"count": count, "max_model_len": None, "tokens": []}
        usage = TokenUsage(input_tokens=count, total_tokens=count)
        return ResponseTx(body=json.dumps(out).encode(), usage=usage)


register_translator(
    Endpoint.TOKENIZE, APISchemaName.OPENAI, APISchemaName.AWS_ANTHROPIC,
    TokenizeToBedrockAnthropicCount,
)
register_translator(
    Endpoint.TOKENIZE,
    APISchemaName.OPENAI,
    APISchemaName.GCP_VERTEX_AI,
    TokenizeToGeminiCount,
)
