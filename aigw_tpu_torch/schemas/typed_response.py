"""Typed response schemas of the gateway's endpoints (the port's copy of
``aigw_tpu/schemas/typed_response.py`` for chat completions,
completions and embeddings): what the gateway re-emits is checked
against the front schema's shape. A non-streamed body that fails is an
upstream error (502, retried on the next backend); a streamed event
that fails is never relayed, and the stream ends with the error event.
Unknown fields pass, known fields must carry the right shapes.
"""

from __future__ import annotations

from typing import Any

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
# dispatch

_BY_ENDPOINT: dict[Endpoint, Spec] = {
    Endpoint.CHAT_COMPLETIONS: CHAT_RESPONSE,
    Endpoint.COMPLETIONS: COMPLETIONS_RESPONSE,
    Endpoint.EMBEDDINGS: EMBEDDINGS_RESPONSE,
}

_CHUNK_BY_ENDPOINT: dict[Endpoint, Spec] = {
    Endpoint.CHAT_COMPLETIONS: CHAT_CHUNK,
    Endpoint.COMPLETIONS: COMPLETIONS_CHUNK,
}


def has_spec(endpoint: Endpoint) -> bool:
    return endpoint in _BY_ENDPOINT


def has_stream_spec(endpoint: Endpoint) -> bool:
    return endpoint in _CHUNK_BY_ENDPOINT


def validate_response(endpoint: Endpoint, body: Any) -> None:
    """Validate a non-streamed response body the gateway is about to
    re-emit; raises SchemaError (502 upstream_error) on violation."""
    spec = _BY_ENDPOINT.get(endpoint)
    if spec is not None:
        validate_object(body, spec)


def validate_stream_event(endpoint: Endpoint, event: Any) -> None:
    """Validate one parsed SSE event of a streamed response against the
    endpoint's chunk spec; raises SchemaError."""
    spec = _CHUNK_BY_ENDPOINT.get(endpoint)
    if spec is not None:
        validate_object(event, spec)
