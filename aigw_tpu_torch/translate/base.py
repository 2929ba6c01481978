"""Translator interface + registry (the port's copy of
``aigw_tpu/translate/base.py``).

Mirrors the upstream gateway's generic ``Translator[ReqT,SpanT]`` contract
(internal/translator/translator.go:42-77):

- ``request()``         ≈ RequestBody  — produce upstream body/path/headers
- ``response_headers()``≈ ResponseHeaders — observe upstream status/headers
- ``response_body()``   ≈ ResponseBody — translate (streaming) response
  chunks, surface token usage + response model
- ``response_error()``  ≈ ResponseError — convert upstream error bodies to
  the client-facing schema

Translators are instantiated per request attempt and must be retry-safe:
a retry constructs a *new* translator from the captured original body
(reference processor_impl.go:90-96,334-339).
"""

from __future__ import annotations

import enum
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Any, Callable

from aigw_tpu_torch.config.model import APISchemaName
from aigw_tpu_torch.gateway.costs import TokenUsage


class TranslationError(Exception):
    """Translation not possible / malformed upstream payload."""


class Endpoint(str, enum.Enum):
    """Gateway endpoint kinds (reference internal/endpointspec registers 11;
    mainlib/main.go:305-328)."""

    CHAT_COMPLETIONS = "/v1/chat/completions"
    COMPLETIONS = "/v1/completions"
    EMBEDDINGS = "/v1/embeddings"
    MESSAGES = "/v1/messages"  # Anthropic-native front door
    TOKENIZE = "/tokenize"  # vLLM-compatible
    RERANK = "/v2/rerank"  # Cohere
    IMAGES_GENERATIONS = "/v1/images/generations"
    AUDIO_SPEECH = "/v1/audio/speech"
    AUDIO_TRANSCRIPTIONS = "/v1/audio/transcriptions"
    AUDIO_TRANSLATIONS = "/v1/audio/translations"
    RESPONSES = "/v1/responses"
    MODELS = "/v1/models"


@dataclass
class RequestTx:
    """Result of request translation."""

    body: bytes
    path: str = ""  # upstream path ("" = same as client path)
    headers: dict[str, str] = field(default_factory=dict)  # set these
    # True if the upstream response will be an SSE stream.
    stream: bool = False


@dataclass
class ResponseTx:
    """Result of translating one response chunk (or the whole body)."""

    body: bytes = b""
    usage: TokenUsage = field(default_factory=TokenUsage)
    model: str = ""  # response model, when the upstream reports one
    # event boundary markers for metrics: tokens emitted in this chunk
    tokens_emitted: int = 0
    # Optional: the parsed JSON of ``body`` when the translator already
    # holds it (non-streaming only) — lets the gateway's response-side
    # typed validation skip a redundant json.loads on the hot path.
    parsed: Any = None


class Translator(ABC):
    """One request's translation state machine.

    ``request()`` MUST NOT mutate the input dict (build fresh structures —
    the reference's sjson no-in-place rule, translator.go:140-153): the
    gateway re-translates the same captured body on every retry attempt.
    """

    @abstractmethod
    def request(self, body: dict[str, Any]) -> RequestTx: ...

    def response_headers(self, status: int, headers: dict[str, str]) -> None:
        """Observe upstream response headers (default: nothing)."""

    @abstractmethod
    def response_body(self, chunk: bytes, end_of_stream: bool) -> ResponseTx: ...

    def response_error(self, status: int, body: bytes) -> bytes:
        """Translate an upstream error body to the client-facing schema.
        Default wraps it in an OpenAI error envelope (the reference wraps
        upstream errors with a user-facing marker, internalapi.go)."""
        from aigw_tpu_torch.schemas import openai as openai_schema

        text = body.decode("utf-8", errors="replace")[:4096]
        return openai_schema.error_body(
            f"upstream error (status {status}): {text}",
            type_="upstream_error",
            code=status,
        )


TranslatorFactory = Callable[..., Translator]

_REGISTRY: dict[tuple[Endpoint, APISchemaName, APISchemaName], TranslatorFactory] = {}


def register_translator(
    endpoint: Endpoint,
    in_schema: APISchemaName,
    out_schema: APISchemaName,
    factory: TranslatorFactory,
) -> None:
    _REGISTRY[(endpoint, in_schema, out_schema)] = factory


def get_translator(
    endpoint: Endpoint,
    in_schema: APISchemaName,
    out_schema: APISchemaName,
    *,
    model_name_override: str = "",
    stream: bool = False,
    out_version: str = "",
) -> Translator:
    """Create a fresh translator for one request attempt
    (reference endpointspec.GetTranslator, endpointspec.go:159).

    ``out_version`` is the backend APISchema.version (e.g. the Azure OpenAI
    api-version query parameter)."""
    key = (endpoint, in_schema, out_schema)
    factory = _REGISTRY.get(key)
    if factory is None:
        raise TranslationError(
            f"no translator for {endpoint.value}: "
            f"{in_schema.value} → {out_schema.value}"
        )
    return factory(
        model_name_override=model_name_override,
        stream=stream,
        out_version=out_version,
    )


def supported_pairs() -> list[tuple[Endpoint, APISchemaName, APISchemaName]]:
    return sorted(_REGISTRY.keys(),
                  key=lambda k: (k[0].value, k[1].value, k[2].value))


def _install_all() -> None:
    """Import the translator modules so their registrations run, in the
    reference's order: ``responses`` re-registers the Responses front to
    its chat-capable targets over the passthrough entries, so those
    backends get ``ResponsesToChat`` while an OpenAI backend keeps the
    passthrough; ``anthropic_hosted`` comes last."""
    from aigw_tpu_torch.translate import (  # noqa: F401
        passthrough,
        openai_anthropic,
        anthropic_openai,
        openai_awsbedrock,
        anthropic_awsbedrock,
        openai_azure,
        openai_gcp,
        embeddings,
        tokenize,
        rerank,
        responses,
        anthropic_hosted,
    )


_install_all()
