"""Typed request schemas of the gateway's endpoints (the port's copy of
``aigw_tpu/schemas/typed.py`` for chat completions, completions and
embeddings): every JSON body is checked before route selection and a
malformed one is a 400 with its JSON path, before any upstream traffic.
Vendor-specific fields (``thinking``, the GCP Vertex AI chat and
embedding fields) are typed where present; unknown fields pass through.
"""

from __future__ import annotations

from typing import Any

from aigw_tpu_torch.schemas.openai import (
    SchemaError,
    validate_gateway_chat_request,
)
from aigw_tpu_torch.schemas.spec import Field, Spec, validate_object

# ---------------------------------------------------------------------------
# shared unions

#: prompt/input token forms: string | [string] | [int] | [[int]]
_TEXT_OR_TOKENS = Field(union=(
    Field(type="string"),
    Field(type="array", min_len=1, item=Field(union=(
        Field(type="string"),
        Field(type="integer"),
        Field(type="array", item=Field(type="integer")),
    ))),
))

_STOP = Field(union=(
    Field(type="string"),
    Field(type="array", max_len=4, item=Field(type="string")),
))

_STREAM_OPTIONS = Field(type="object", spec=Spec(fields={
    "include_usage": Field(type="boolean"),
}))

# ---------------------------------------------------------------------------
# vendor-specific fields (proposal 004)

#: Anthropic/Gemini reasoning config (ThinkingUnion, openai.go:931-1010):
#: discriminated on "type" — enabled|disabled|adaptive.
def _check_thinking(value: dict, path: str) -> None:
    t = value.get("type")
    if t not in ("enabled", "disabled", "adaptive"):
        raise SchemaError(
            f"{path}.type: must be one of ['adaptive', 'disabled', "
            f"'enabled'], got {t!r}")
    if t == "enabled":
        validate_object(value, Spec(fields={
            "budget_tokens": Field(type="integer", required=True, ge=0),
            "includeThoughts": Field(type="boolean"),
            "display": Field(type="string",
                             enum=("summarized", "omitted")),
        }), path)
    elif t == "adaptive":
        validate_object(value, Spec(fields={
            "display": Field(type="string",
                             enum=("summarized", "omitted")),
        }), path)


THINKING = Field(type="object", check=_check_thinking)

#: GCP Vertex AI chat vendor fields (openai.go:2004-2022). Category /
#: threshold values are typed as strings, not closed enums — the genai
#: enum set grows and the reference's string-typed genai enums accept
#: any value at unmarshal time too.
GCP_VERTEXAI_VENDOR = {
    "generationConfig": Field(type="object", spec=Spec(fields={
        "media_resolution": Field(type="string"),
        "thinkingConfig": Field(type="object", spec=Spec(fields={
            "includeThoughts": Field(type="boolean"),
            "thinkingBudget": Field(type="integer", ge=0),
        })),
    })),
    "safetySettings": Field(type="array", item=Field(
        type="object", spec=Spec(fields={
            "category": Field(type="string", required=True),
            "threshold": Field(type="string", required=True),
            "method": Field(type="string"),
        }))),
}

#: GCP Vertex AI embedding vendor fields (openai.go:1840-1854; wire
#: mapping per endpoint lives in translate/embeddings.py)
EMBEDDING_TASK_TYPES = (
    "RETRIEVAL_QUERY", "RETRIEVAL_DOCUMENT", "SEMANTIC_SIMILARITY",
    "CLASSIFICATION", "CLUSTERING", "QUESTION_ANSWERING",
    "FACT_VERIFICATION", "CODE_RETRIEVAL_QUERY",
)
GCP_EMBEDDING_VENDOR = {
    "auto_truncate": Field(type="boolean"),
    "task_type": Field(type="string", enum=EMBEDDING_TASK_TYPES),
    "title": Field(type="string"),
}

# ---------------------------------------------------------------------------
# /v1/completions (CompletionRequest, openai.go:2073-2161)

COMPLETIONS = Spec(fields={
    "model": Field(type="string", required=True, min_len=1),
    "prompt": Field(required=True, union=_TEXT_OR_TOKENS.union),
    "best_of": Field(type="integer", ge=0, le=20),
    "echo": Field(type="boolean"),
    "frequency_penalty": Field(type="number", ge=-2, le=2),
    "logit_bias": Field(type="object"),
    "logprobs": Field(type="integer", ge=0, le=5),
    "max_tokens": Field(type="integer", ge=0),
    "n": Field(type="integer", ge=1, le=128),
    "presence_penalty": Field(type="number", ge=-2, le=2),
    "seed": Field(type="integer"),
    "stop": _STOP,
    "stream": Field(type="boolean"),
    "stream_options": _STREAM_OPTIONS,
    "suffix": Field(type="string"),
    "temperature": Field(type="number", ge=0, le=2),
    "top_p": Field(type="number", ge=0, le=1),
    "user": Field(type="string"),
})

# ---------------------------------------------------------------------------
# /v1/embeddings (EmbeddingRequest discriminated union,
# openai.go:1781-1836: "input" → completion-style, "messages" →
# chat-style/multimodal, never both; input items may be objects carrying
# content/task_type/title, openai.go:408-432)

_EMBEDDING_INPUT_ITEM_OBJ = Field(type="object", spec=Spec(fields={
    "content": Field(required=True, union=(
        Field(type="string"),
        Field(type="array", item=Field(type="string")),
    )),
    "task_type": Field(type="string", enum=EMBEDDING_TASK_TYPES),
    "title": Field(type="string"),
}))

_EMBEDDING_INPUT = Field(union=(
    Field(type="string"),
    Field(type="array", min_len=1, item=Field(union=(
        Field(type="string"),
        Field(type="integer"),
        Field(type="array", item=Field(type="integer")),
        _EMBEDDING_INPUT_ITEM_OBJ,
    ))),
))


def _check_embeddings_variant(body: dict, _path: str) -> None:
    has_input = "input" in body
    has_messages = "messages" in body
    if has_input and has_messages:
        raise SchemaError(
            "embedding request must have either 'input' or 'messages', "
            "not both")
    if not has_input and not has_messages:
        raise SchemaError("input: is required")


EMBEDDINGS = Spec(
    fields={
        "model": Field(type="string", required=True, min_len=1),
        "input": _EMBEDDING_INPUT,
        "messages": Field(type="array", min_len=1, item=Field(
            type="object", spec=Spec(fields={
                "role": Field(type="string", required=True),
            }))),
        "encoding_format": Field(type="string",
                                 enum=("float", "base64")),
        "dimensions": Field(type="integer", ge=1),
        "user": Field(type="string"),
        **GCP_EMBEDDING_VENDOR,
    },
    checks=(_check_embeddings_variant,),
)

# ---------------------------------------------------------------------------
# chat vendor-field overlay (validate_gateway_chat_request covers the core chat
# shape; this adds the proposal-004 fields on top)

_CHAT_VENDOR = Spec(fields={
    "thinking": THINKING,
    **GCP_VERTEXAI_VENDOR,
})


def validate_chat_with_vendor(body: dict[str, Any]) -> None:
    validate_gateway_chat_request(body)
    validate_object(body, _CHAT_VENDOR)


# ---------------------------------------------------------------------------
# dispatch

_BY_ENDPOINT: dict[str, Spec] = {
    "/v1/completions": COMPLETIONS,
    "/v1/embeddings": EMBEDDINGS,
}


def validate_request(endpoint_path: str, body: dict[str, Any]) -> None:
    """Validate a JSON request body for ``endpoint_path``; raises
    SchemaError (→ client 400) on the first violation. Endpoints without
    a registered spec pass through (multipart endpoints are validated
    form-side in the gateway)."""
    if endpoint_path == "/v1/chat/completions":
        validate_chat_with_vendor(body)
        return
    spec = _BY_ENDPOINT.get(endpoint_path)
    if spec is not None:
        validate_object(body, spec)
