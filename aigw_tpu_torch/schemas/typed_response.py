"""Typed response schemas of the gateway's endpoints (the port's copy of
``aigw_tpu/schemas/typed_response.py``): what the gateway re-emits is
checked against the front schema's shape, for chat completions,
completions, embeddings, rerank, image generation, tokenize, Anthropic
Messages and Responses. A non-streamed body that fails is an upstream
error (502, retried on the next backend); a streamed event that fails is
never relayed, and the stream ends with the error event. Unknown fields
pass, known fields must carry the right shapes; discriminated unions
(Responses output items, Anthropic stream events) validate known
``type`` values deeply and let unknown ones pass.
"""

from __future__ import annotations

from typing import Any

from aigw_tpu_torch.schemas.openai import SchemaError
from aigw_tpu_torch.schemas.spec import Field, Spec, validate_object
from aigw_tpu_torch.translate.base import Endpoint

# ---------------------------------------------------------------------------
# shared pieces

_USAGE = Field(type="object", spec=Spec(fields={
    "prompt_tokens": Field(type="integer", ge=0),
    "completion_tokens": Field(type="integer", ge=0),
    "total_tokens": Field(type="integer", ge=0),
}))

# finish_reason: typed as a string, NOT an enum. OpenAI-compatible
# upstreams legitimately emit values beyond the canonical five
# ("recitation", "error", "safety", vendor extensions …); rejecting
# them would 502 valid non-stream bodies and abort live SSE streams.
# Shape is enforced; the value set is the
# upstream's — same forward-compat posture as unknown fields.
_FINISH = Field(type="string")

_TOOL_CALL = Field(type="object", spec=Spec(fields={
    "id": Field(type="string"),
    "type": Field(type="string"),
    "function": Field(type="object", spec=Spec(fields={
        "name": Field(type="string"),
        "arguments": Field(type="string"),
    })),
}))

_LOGPROBS = Field(type="object", spec=Spec(fields={
    "content": Field(type="array", item=Field(type="object", spec=Spec(
        fields={
            "token": Field(type="string", required=True),
            "logprob": Field(type="number", required=True),
            "top_logprobs": Field(type="array", item=Field(
                type="object", spec=Spec(fields={
                    "token": Field(type="string", required=True),
                    "logprob": Field(type="number", required=True),
                }))),
        }))),
}))

# ---------------------------------------------------------------------------
# /v1/chat/completions (ChatCompletionResponse, openai.go)

_CHAT_MESSAGE = Field(type="object", spec=Spec(fields={
    "role": Field(type="string"),
    "content": Field(type="string"),  # nullable (tool-call-only turns)
    "tool_calls": Field(type="array", item=_TOOL_CALL),
    "reasoning_content": Field(type="string"),
    "refusal": Field(type="string"),
}))

CHAT_RESPONSE = Spec(fields={
    "id": Field(type="string"),
    "object": Field(type="string"),
    "created": Field(type="integer"),
    "model": Field(type="string"),
    "choices": Field(type="array", required=True, item=Field(
        type="object", spec=Spec(fields={
            "index": Field(type="integer", ge=0),
            "message": Field(type="object", required=True,
                             spec=_CHAT_MESSAGE.spec),
            "finish_reason": _FINISH,
            "logprobs": _LOGPROBS,
        }))),
    "usage": _USAGE,
})

CHAT_CHUNK = Spec(fields={
    "id": Field(type="string"),
    "object": Field(type="string"),
    "created": Field(type="integer"),
    "model": Field(type="string"),
    "choices": Field(type="array", required=True, item=Field(
        type="object", spec=Spec(fields={
            "index": Field(type="integer", ge=0),
            # optional: some upstreams send a final finish_reason-only
            # chunk with no delta at all — that chunk must not kill the
            # stream
            "delta": Field(type="object", spec=Spec(
                fields={
                    "role": Field(type="string"),
                    "content": Field(type="string"),
                    "tool_calls": Field(type="array", item=Field(
                        type="object", spec=Spec(fields={
                            "index": Field(type="integer"),
                            "id": Field(type="string"),
                            "type": Field(type="string"),
                            # deep: tpuserve streams native
                            # tool_calls deltas — name frames and
                            # incremental arguments-string frames must
                            # carry string payloads when present
                            "function": Field(type="object", spec=Spec(
                                fields={
                                    "name": Field(type="string"),
                                    "arguments": Field(type="string"),
                                })),
                        }))),
                })),
            "finish_reason": _FINISH,
            "logprobs": _LOGPROBS,
        }))),
    # usage-only final chunks carry an empty choices list — the spec
    # requires the key, not a minimum length
    "usage": _USAGE,
})

# ---------------------------------------------------------------------------
# /v1/completions

_COMPLETION_CHOICE = Field(type="object", spec=Spec(fields={
    "text": Field(type="string", required=True, nullable=False),
    "index": Field(type="integer", ge=0),
    "finish_reason": _FINISH,
    "logprobs": Field(type="object"),
}))

COMPLETIONS_RESPONSE = Spec(fields={
    "id": Field(type="string"),
    "object": Field(type="string"),
    "created": Field(type="integer"),
    "model": Field(type="string"),
    "choices": Field(type="array", required=True,
                     item=_COMPLETION_CHOICE),
    "usage": _USAGE,
})

# streamed completions chunks share the response shape
COMPLETIONS_CHUNK = COMPLETIONS_RESPONSE

# ---------------------------------------------------------------------------
# /v1/embeddings (EmbeddingResponse: data[].embedding is float array or
# base64 string depending on encoding_format)

EMBEDDINGS_RESPONSE = Spec(fields={
    "object": Field(type="string"),
    "model": Field(type="string"),
    "data": Field(type="array", required=True, item=Field(
        type="object", spec=Spec(fields={
            "object": Field(type="string"),
            "index": Field(type="integer", ge=0),
            "embedding": Field(required=True, nullable=False, union=(
                Field(type="array", item=Field(type="number")),
                Field(type="string", min_len=1),  # base64
            )),
        }))),
    "usage": Field(type="object", spec=Spec(fields={
        "prompt_tokens": Field(type="integer", ge=0),
        "total_tokens": Field(type="integer", ge=0),
    })),
})

# ---------------------------------------------------------------------------
# /v2/rerank (cohere rerank_v2 response)

RERANK_RESPONSE = Spec(fields={
    "id": Field(type="string"),
    "results": Field(type="array", required=True, item=Field(
        type="object", spec=Spec(fields={
            "index": Field(type="integer", required=True, ge=0,
                           nullable=False),
            "relevance_score": Field(type="number", required=True,
                                     nullable=False),
            "document": Field(union=(
                Field(type="string"),
                Field(type="object", spec=Spec(fields={
                    "text": Field(type="string"),
                })),
            )),
        }))),
    "meta": Field(type="object"),
})

# ---------------------------------------------------------------------------
# /v1/images/generations


def _check_image_item(value: dict, path: str) -> None:
    if "url" not in value and "b64_json" not in value:
        raise SchemaError(f"{path}: must carry url or b64_json")


IMAGES_RESPONSE = Spec(fields={
    "created": Field(type="integer"),
    "data": Field(type="array", required=True, item=Field(
        type="object", check=_check_image_item, spec=Spec(fields={
            "url": Field(type="string"),
            "b64_json": Field(type="string"),
            "revised_prompt": Field(type="string"),
        }))),
    "usage": Field(type="object"),
})

# ---------------------------------------------------------------------------
# /tokenize (vLLM-compatible)

TOKENIZE_RESPONSE = Spec(fields={
    "count": Field(type="integer", required=True, ge=0, nullable=False),
    "tokens": Field(type="array", item=Field(type="integer")),
    "max_model_len": Field(type="integer"),
})

# ---------------------------------------------------------------------------
# /v1/messages (Anthropic front door; anthropic.go Messages response)

_ANTHROPIC_CONTENT_BLOCKS: dict[str, Spec] = {
    "text": Spec(fields={
        "text": Field(type="string", required=True, nullable=False)}),
    "thinking": Spec(fields={
        "thinking": Field(type="string", required=True),
        "signature": Field(type="string"),
    }),
    "redacted_thinking": Spec(fields={
        "data": Field(type="string", required=True)}),
    "tool_use": Spec(fields={
        "id": Field(type="string", required=True),
        "name": Field(type="string", required=True),
        "input": Field(type="object", required=True, nullable=False),
    }),
    "server_tool_use": Spec(fields={
        "id": Field(type="string"),
        "name": Field(type="string"),
        "input": Field(type="object"),
    }),
}


def _check_anthropic_block(value: dict, path: str) -> None:
    t = value.get("type")
    if not isinstance(t, str) or not t:
        raise SchemaError(f"{path}.type: is required")
    spec = _ANTHROPIC_CONTENT_BLOCKS.get(t)
    if spec is not None:
        validate_object(value, spec, path)


MESSAGES_RESPONSE = Spec(fields={
    "id": Field(type="string"),
    "type": Field(type="string"),
    "role": Field(type="string"),
    "model": Field(type="string"),
    "content": Field(type="array", required=True, item=Field(
        type="object", check=_check_anthropic_block)),
    "stop_reason": Field(type="string"),
    "stop_sequence": Field(type="string"),
    "usage": Field(type="object", spec=Spec(fields={
        "input_tokens": Field(type="integer", ge=0),
        "output_tokens": Field(type="integer", ge=0),
    })),
})

#: Anthropic stream events, discriminated on "type" (anthropic.go
#: stream event types; unknown types pass — the event set grows)
_ANTHROPIC_EVENTS: dict[str, Spec] = {
    "message_start": Spec(fields={
        "message": Field(type="object", required=True, nullable=False)}),
    "content_block_start": Spec(fields={
        "index": Field(type="integer", required=True, ge=0,
                       nullable=False),
        "content_block": Field(type="object", required=True,
                               nullable=False),
    }),
    "content_block_delta": Spec(fields={
        "index": Field(type="integer", required=True, ge=0,
                       nullable=False),
        "delta": Field(type="object", required=True, nullable=False),
    }),
    "content_block_stop": Spec(fields={
        "index": Field(type="integer", required=True, ge=0,
                       nullable=False)}),
    "message_delta": Spec(fields={
        "delta": Field(type="object", required=True, nullable=False),
        "usage": Field(type="object"),
    }),
    "message_stop": Spec(),
    "ping": Spec(),
    "error": Spec(fields={
        "error": Field(type="object", required=True, nullable=False)}),
}

# ---------------------------------------------------------------------------
# /v1/responses: the output item unions typed deeply

_RESPONSES_OUTPUT_ITEMS: dict[str, Spec] = {
    "message": Spec(fields={
        "id": Field(type="string"),
        "role": Field(type="string"),
        "status": Field(type="string"),
        "content": Field(type="array", required=True, item=Field(
            type="object", check=lambda v, p: _check_output_content(v, p))),
    }),
    "function_call": Spec(fields={
        "id": Field(type="string"),
        "call_id": Field(type="string", required=True, nullable=False),
        "name": Field(type="string", required=True, nullable=False),
        "arguments": Field(type="string", required=True, nullable=False),
        "status": Field(type="string"),
    }),
    "reasoning": Spec(fields={
        "id": Field(type="string"),
        "summary": Field(type="array", required=True, item=Field(
            type="object", spec=Spec(fields={
                "type": Field(type="string", required=True),
                "text": Field(type="string"),
            }))),
        "encrypted_content": Field(type="string"),
        "status": Field(type="string"),
    }),
    "web_search_call": Spec(fields={
        "id": Field(type="string"),
        "status": Field(type="string"),
    }),
    "file_search_call": Spec(fields={
        "id": Field(type="string"),
        "status": Field(type="string"),
    }),
}

_RESPONSES_OUTPUT_CONTENT: dict[str, Spec] = {
    "output_text": Spec(fields={
        "text": Field(type="string", required=True, nullable=False),
        "annotations": Field(type="array"),
    }),
    "refusal": Spec(fields={
        "refusal": Field(type="string", required=True, nullable=False),
    }),
}


def _check_output_content(value: dict, path: str) -> None:
    t = value.get("type")
    if not isinstance(t, str) or not t:
        raise SchemaError(f"{path}.type: is required")
    spec = _RESPONSES_OUTPUT_CONTENT.get(t)
    if spec is not None:
        validate_object(value, spec, path)


def _check_output_item(value: dict, path: str) -> None:
    t = value.get("type")
    if not isinstance(t, str) or not t:
        raise SchemaError(f"{path}.type: is required")
    spec = _RESPONSES_OUTPUT_ITEMS.get(t)
    if spec is not None:
        validate_object(value, spec, path)


RESPONSES_RESPONSE = Spec(fields={
    "id": Field(type="string", required=True, nullable=False),
    "object": Field(type="string"),
    "created_at": Field(type="number"),
    "status": Field(type="string", enum=(
        "completed", "failed", "in_progress", "cancelled", "queued",
        "incomplete")),
    "error": Field(type="object", spec=Spec(fields={
        "code": Field(type="string"),
        "message": Field(type="string"),
    })),
    "incomplete_details": Field(type="object"),
    "model": Field(type="string"),
    "output": Field(type="array", required=True, item=Field(
        type="object", check=_check_output_item)),
    "previous_response_id": Field(type="string"),
    "usage": Field(type="object", spec=Spec(fields={
        "input_tokens": Field(type="integer", ge=0),
        "output_tokens": Field(type="integer", ge=0),
        "total_tokens": Field(type="integer", ge=0),
        "input_tokens_details": Field(type="object"),
        "output_tokens_details": Field(type="object"),
    })),
})

#: Responses stream events: {type: "response.*", ...}. The envelope is
#: validated for every event; payloads deeply for the high-traffic ones.
_RESPONSES_EVENTS: dict[str, Spec] = {
    "response.output_text.delta": Spec(fields={
        "delta": Field(type="string", required=True, nullable=False),
        "item_id": Field(type="string"),
        "output_index": Field(type="integer", ge=0),
        "content_index": Field(type="integer", ge=0),
    }),
    "response.function_call_arguments.delta": Spec(fields={
        "delta": Field(type="string", required=True, nullable=False),
        "item_id": Field(type="string"),
        "output_index": Field(type="integer", ge=0),
    }),
    "response.created": Spec(fields={
        "response": Field(type="object", required=True, nullable=False)}),
    "response.in_progress": Spec(fields={
        "response": Field(type="object", required=True, nullable=False)}),
    "response.completed": Spec(fields={
        "response": Field(type="object", required=True, nullable=False,
                          spec=RESPONSES_RESPONSE)}),
    "response.output_item.added": Spec(fields={
        "output_index": Field(type="integer", ge=0),
        "item": Field(type="object", required=True, nullable=False,
                      check=_check_output_item),
    }),
    "response.output_item.done": Spec(fields={
        "output_index": Field(type="integer", ge=0),
        "item": Field(type="object", required=True, nullable=False,
                      check=_check_output_item),
    }),
}

# ---------------------------------------------------------------------------
# dispatch

_BY_ENDPOINT: dict[Endpoint, Spec] = {
    Endpoint.CHAT_COMPLETIONS: CHAT_RESPONSE,
    Endpoint.COMPLETIONS: COMPLETIONS_RESPONSE,
    Endpoint.EMBEDDINGS: EMBEDDINGS_RESPONSE,
    Endpoint.RERANK: RERANK_RESPONSE,
    Endpoint.IMAGES_GENERATIONS: IMAGES_RESPONSE,
    Endpoint.TOKENIZE: TOKENIZE_RESPONSE,
    Endpoint.MESSAGES: MESSAGES_RESPONSE,
    Endpoint.RESPONSES: RESPONSES_RESPONSE,
}

_CHUNK_BY_ENDPOINT: dict[Endpoint, Spec] = {
    Endpoint.CHAT_COMPLETIONS: CHAT_CHUNK,
    Endpoint.COMPLETIONS: COMPLETIONS_CHUNK,
}


def has_spec(endpoint: Endpoint) -> bool:
    """True when the endpoint's non-stream response is JSON-typed (audio
    bytes and multipart endpoints are not)."""
    return endpoint in _BY_ENDPOINT


def has_stream_spec(endpoint: Endpoint) -> bool:
    return (endpoint in _CHUNK_BY_ENDPOINT
            or endpoint in (Endpoint.MESSAGES, Endpoint.RESPONSES))


def validate_response(endpoint: Endpoint, body: Any) -> None:
    """Validate a non-streaming front-schema response body the gateway
    is about to re-emit; raises SchemaError (→ 502 upstream_error) on
    violation. Endpoints without a registered spec pass (audio bytes,
    multipart)."""
    spec = _BY_ENDPOINT.get(endpoint)
    if spec is not None:
        validate_object(body, spec)


def validate_stream_event(endpoint: Endpoint, event: Any) -> None:
    """Validate one parsed SSE event for a streaming response.

    - chat/completions: every chunk against the chunk spec
    - /v1/messages: discriminated Anthropic event types
    - /v1/responses: ``response.*`` envelope + deep payloads for the
      delta/item/completed events
    Raises SchemaError; the relay surfaces the stream-error event."""
    if endpoint in _CHUNK_BY_ENDPOINT:
        validate_object(event, _CHUNK_BY_ENDPOINT[endpoint])
        return
    if endpoint is Endpoint.MESSAGES:
        if not isinstance(event, dict):
            raise SchemaError("stream event must be object")
        t = event.get("type")
        if not isinstance(t, str) or not t:
            raise SchemaError("type: is required")
        spec = _ANTHROPIC_EVENTS.get(t)
        if spec is not None:
            validate_object(event, spec)
        return
    if endpoint is Endpoint.RESPONSES:
        if not isinstance(event, dict):
            raise SchemaError("stream event must be object")
        t = event.get("type")
        if not isinstance(t, str) or not t:
            raise SchemaError("type: is required")
        spec = _RESPONSES_EVENTS.get(t)
        if spec is not None:
            validate_object(event, spec)
