"""Typed request schemas of the gateway's endpoints (the port's copy of
``aigw_tpu/schemas/typed.py``: chat completions, completions,
embeddings, image generation, rerank, speech, tokenize and Responses):
every JSON body is checked before route selection and a
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
# /v1/images/generations (ImageGenerationRequest, openai.go:2276-2316)

IMAGES_GENERATIONS = Spec(fields={
    "prompt": Field(type="string", required=True, min_len=1),
    "model": Field(type="string"),
    "n": Field(type="integer", ge=1, le=10),
    "quality": Field(type="string", enum=(
        "auto", "standard", "hd", "low", "medium", "high")),
    "response_format": Field(type="string", enum=("url", "b64_json")),
    "size": Field(type="string"),
    "style": Field(type="string", enum=("vivid", "natural")),
    "user": Field(type="string"),
    "output_format": Field(type="string", enum=("png", "jpeg", "webp")),
    "output_compression": Field(type="integer", ge=0, le=100),
    "background": Field(type="string",
                        enum=("auto", "transparent", "opaque")),
    "moderation": Field(type="string", enum=("auto", "low")),
})

# ---------------------------------------------------------------------------
# /v2/rerank (cohere/rerank_v2.go:11-24)

RERANK = Spec(fields={
    "model": Field(type="string", required=True, min_len=1),
    "query": Field(type="string", required=True),
    "documents": Field(type="array", required=True, min_len=1,
                       item=Field(union=(
                           Field(type="string"),
                           Field(type="object", spec=Spec(fields={
                               "text": Field(type="string",
                                             required=True),
                           })),
                       ))),
    "top_n": Field(type="integer", ge=1),
    "max_tokens_per_doc": Field(type="integer", ge=1),
    "return_documents": Field(type="boolean"),
})

# ---------------------------------------------------------------------------
# /v1/audio/speech (OpenAI createSpeech)

AUDIO_SPEECH = Spec(fields={
    "model": Field(type="string", required=True, min_len=1),
    "input": Field(type="string", required=True, min_len=1),
    "voice": Field(type="string", required=True, min_len=1),
    "instructions": Field(type="string"),
    "response_format": Field(type="string", enum=(
        "mp3", "opus", "aac", "flac", "wav", "pcm")),
    "speed": Field(type="number", ge=0.25, le=4.0),
    "stream_format": Field(type="string", enum=("sse", "audio")),
})

# ---------------------------------------------------------------------------
# /tokenize (vLLM-compatible; reference tokenize/, mainlib/main.go:326)

TOKENIZE = Spec(
    fields={
        "model": Field(type="string", required=True, min_len=1),
        "prompt": Field(type="string"),
        "messages": Field(type="array", item=Field(type="object")),
        "add_special_tokens": Field(type="boolean"),
    },
    checks=(lambda body, _p: (_ for _ in ()).throw(SchemaError(
        "tokenize request must have either 'prompt' or 'messages', "
        "not both")) if "prompt" in body and "messages" in body else None,),
)

# ---------------------------------------------------------------------------
# /v1/responses: input item unions typed deeply. Discriminated on
# "type"; known
# types validate their full shape, unknown type strings pass (the item
# set grows — same forward-compat posture as vendor fields). An item
# with no "type" is a message iff it carries a role (the API accepts
# bare {role, content} items).

_RESPONSES_CONTENT_PARTS: dict[str, Spec] = {
    "input_text": Spec(fields={
        "text": Field(type="string", required=True, nullable=False)}),
    "output_text": Spec(fields={
        "text": Field(type="string", required=True, nullable=False),
        "annotations": Field(type="array"),
    }),
    "refusal": Spec(fields={
        "refusal": Field(type="string", required=True, nullable=False)}),
    "input_image": Spec(fields={
        "image_url": Field(type="string"),
        "file_id": Field(type="string"),
        "detail": Field(type="string", enum=("low", "high", "auto")),
    }),
    "input_file": Spec(fields={
        "file_id": Field(type="string"),
        "filename": Field(type="string"),
        "file_data": Field(type="string"),
        "file_url": Field(type="string"),
    }),
}


def _check_responses_content_part(value: dict, path: str) -> None:
    t = value.get("type")
    if not isinstance(t, str) or not t:
        raise SchemaError(f"{path}.type: is required")
    spec = _RESPONSES_CONTENT_PARTS.get(t)
    if spec is not None:
        validate_object(value, spec, path)


_RESPONSES_MESSAGE_ITEM = Spec(fields={
    "role": Field(type="string", required=True, nullable=False, enum=(
        "user", "assistant", "system", "developer")),
    "content": Field(required=True, nullable=False, union=(
        Field(type="string"),
        Field(type="array", min_len=1, item=Field(
            type="object", check=_check_responses_content_part)),
    )),
    "status": Field(type="string"),
})

_RESPONSES_INPUT_ITEMS: dict[str, Spec] = {
    "message": _RESPONSES_MESSAGE_ITEM,
    "function_call": Spec(fields={
        "call_id": Field(type="string", required=True, nullable=False),
        "name": Field(type="string", required=True, nullable=False),
        "arguments": Field(type="string", required=True, nullable=False),
        "status": Field(type="string"),
    }),
    "function_call_output": Spec(fields={
        "call_id": Field(type="string", required=True, nullable=False),
        "output": Field(required=True, nullable=False, union=(
            Field(type="string"),
            Field(type="array"),
        )),
        "status": Field(type="string"),
    }),
    "reasoning": Spec(fields={
        "summary": Field(type="array", required=True, item=Field(
            type="object", spec=Spec(fields={
                "type": Field(type="string", required=True),
                "text": Field(type="string"),
            }))),
        "encrypted_content": Field(type="string"),
        "status": Field(type="string"),
    }),
    "item_reference": Spec(fields={
        "id": Field(type="string", required=True, nullable=False),
    }),
}


def _check_responses_input_item(value: dict, path: str) -> None:
    t = value.get("type")
    if t is None:
        # bare {role, content} message item
        validate_object(value, _RESPONSES_MESSAGE_ITEM, path)
        return
    if not isinstance(t, str) or not t:
        raise SchemaError(f"{path}.type: must be string")
    spec = _RESPONSES_INPUT_ITEMS.get(t)
    if spec is not None:
        validate_object(value, spec, path)


def _check_responses_tool(value: dict, path: str) -> None:
    t = value.get("type")
    if not isinstance(t, str) or not t:
        raise SchemaError(f"{path}.type: is required")
    if t == "function":
        validate_object(value, Spec(fields={
            "name": Field(type="string", required=True, nullable=False,
                          min_len=1),
            "parameters": Field(type="object"),
            "strict": Field(type="boolean"),
            "description": Field(type="string"),
        }), path)


RESPONSES = Spec(
    fields={
        "model": Field(type="string", required=True, min_len=1),
        "input": Field(union=(
            Field(type="string"),
            Field(type="array", item=Field(
                type="object", check=_check_responses_input_item)),
        )),
        "instructions": Field(type="string"),
        "max_output_tokens": Field(type="integer", ge=1),
        "previous_response_id": Field(type="string"),
        "store": Field(type="boolean"),
        "stream": Field(type="boolean"),
        "temperature": Field(type="number", ge=0, le=2),
        "top_p": Field(type="number", ge=0, le=1),
        "parallel_tool_calls": Field(type="boolean"),
        "truncation": Field(type="string", enum=("auto", "disabled")),
        "reasoning": Field(type="object", spec=Spec(fields={
            "effort": Field(type="string", enum=(
                "minimal", "low", "medium", "high")),
            "summary": Field(type="string", enum=(
                "auto", "concise", "detailed")),
        })),
        "tool_choice": Field(union=(
            Field(type="string"), Field(type="object"))),
        "tools": Field(type="array", item=Field(
            type="object", check=_check_responses_tool)),
    },
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
    "/v1/images/generations": IMAGES_GENERATIONS,
    "/v2/rerank": RERANK,
    "/v1/audio/speech": AUDIO_SPEECH,
    "/tokenize": TOKENIZE,
    "/v1/responses": RESPONSES,
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
