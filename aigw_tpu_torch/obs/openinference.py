"""OpenInference span semantic conventions (the port's copy of
``aigw_tpu/obs/openinference.py``; standard library only).

Attribute-name and value parity with the reference's
``internal/tracing/openinference`` package:

- constants: ``openinference.go:18-240`` (span kind, llm.*, input/output,
  token counts incl. prompt/completion details, embeddings, tools)
- request builders: ``openai/request_attrs.go:32-340`` (chat, embeddings,
  completions)
- response builders: ``openai/response_attrs.go:20-170``
- privacy config: ``config.go`` (OPENINFERENCE_HIDE_* env vars,
  ``__REDACTED__`` sentinel, base64 image cap)
- error typing: ``response_error.go`` (HTTP status → OpenAI SDK-style
  exception class names)

Everything operates on plain request/response dicts (this gateway's
schema layer is dict-based) and returns ``{attr_name: value}`` maps to
merge into a ``Span``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any

# -- semconv constants (openinference.go) --------------------------------
SPAN_KIND = "openinference.span.kind"
SPAN_KIND_LLM = "LLM"
SPAN_KIND_EMBEDDING = "EMBEDDING"
LLM_SYSTEM = "llm.system"
LLM_SYSTEM_OPENAI = "openai"
LLM_SYSTEM_ANTHROPIC = "anthropic"
LLM_MODEL_NAME = "llm.model_name"
LLM_INVOCATION_PARAMETERS = "llm.invocation_parameters"
INPUT_VALUE = "input.value"
INPUT_MIME_TYPE = "input.mime_type"
OUTPUT_VALUE = "output.value"
OUTPUT_MIME_TYPE = "output.mime_type"
MIME_TYPE_JSON = "application/json"
LLM_INPUT_MESSAGES = "llm.input_messages"
LLM_OUTPUT_MESSAGES = "llm.output_messages"
MESSAGE_ROLE = "message.role"
MESSAGE_CONTENT = "message.content"
MESSAGE_TOOL_CALLS = "message.tool_calls"
TOOL_CALL_ID = "tool_call.id"
TOOL_CALL_FUNCTION_NAME = "tool_call.function.name"
TOOL_CALL_FUNCTION_ARGUMENTS = "tool_call.function.arguments"
LLM_TOOLS = "llm.tools"
LLM_PROMPTS = "llm.prompts"
LLM_CHOICES = "llm.choices"
LLM_TOKEN_COUNT_PROMPT = "llm.token_count.prompt"
LLM_TOKEN_COUNT_COMPLETION = "llm.token_count.completion"
LLM_TOKEN_COUNT_TOTAL = "llm.token_count.total"
LLM_TOKEN_COUNT_PROMPT_CACHE_HIT = (
    "llm.token_count.prompt_details.cache_read")
LLM_TOKEN_COUNT_PROMPT_CACHE_WRITE = (
    "llm.token_count.prompt_details.cache_creation")
LLM_TOKEN_COUNT_PROMPT_AUDIO = "llm.token_count.prompt_details.audio"
LLM_TOKEN_COUNT_COMPLETION_REASONING = (
    "llm.token_count.completion_details.reasoning")
LLM_TOKEN_COUNT_COMPLETION_AUDIO = (
    "llm.token_count.completion_details.audio")
EMBEDDING_MODEL_NAME = "embedding.model_name"
EMBEDDING_INVOCATION_PARAMETERS = "embedding.invocation_parameters"
EMBEDDING_EMBEDDINGS = "embedding.embeddings"

REDACTED = "__REDACTED__"


def input_message_attr(i: int, suffix: str) -> str:
    return f"{LLM_INPUT_MESSAGES}.{i}.{suffix}"


def input_message_content_attr(i: int, j: int, suffix: str) -> str:
    return f"{LLM_INPUT_MESSAGES}.{i}.message.contents.{j}." \
           f"message_content.{suffix}"


def input_message_tool_call_attr(i: int, j: int, suffix: str) -> str:
    return f"{LLM_INPUT_MESSAGES}.{i}.{MESSAGE_TOOL_CALLS}.{j}.{suffix}"


def output_message_attr(i: int, suffix: str) -> str:
    return f"{LLM_OUTPUT_MESSAGES}.{i}.{suffix}"


def output_message_content_attr(i: int, j: int, suffix: str) -> str:
    return f"{LLM_OUTPUT_MESSAGES}.{i}.message.contents.{j}." \
           f"message_content.{suffix}"


def output_message_tool_call_attr(i: int, j: int, suffix: str) -> str:
    return f"{LLM_OUTPUT_MESSAGES}.{i}.{MESSAGE_TOOL_CALLS}.{j}.{suffix}"


def input_tools_attr(i: int) -> str:
    return f"{LLM_TOOLS}.{i}.tool.json_schema"


def embedding_text_attr(i: int) -> str:
    return f"{EMBEDDING_EMBEDDINGS}.{i}.embedding.text"


def embedding_vector_attr(i: int) -> str:
    return f"{EMBEDDING_EMBEDDINGS}.{i}.embedding.vector"


def prompt_text_attr(i: int) -> str:
    return f"{LLM_PROMPTS}.{i}.prompt.text"


def choice_text_attr(i: int) -> str:
    return f"{LLM_CHOICES}.{i}.completion.text"


# -- privacy config (config.go) ------------------------------------------
def _env_bool(name: str, default: bool = False) -> bool:
    v = os.environ.get(name, "")
    if not v:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


@dataclass(frozen=True)
class TraceConfig:
    hide_llm_invocation_parameters: bool = False
    hide_inputs: bool = False
    hide_outputs: bool = False
    hide_input_messages: bool = False
    hide_output_messages: bool = False
    hide_input_images: bool = False
    hide_input_text: bool = False
    hide_output_text: bool = False
    hide_embeddings_text: bool = False
    hide_embeddings_vectors: bool = False
    hide_prompts: bool = False
    hide_choices: bool = False
    base64_image_max_length: int = 32000

    @staticmethod
    def from_env() -> "TraceConfig":
        try:
            maxlen = int(os.environ.get(
                "OPENINFERENCE_BASE64_IMAGE_MAX_LENGTH", "32000"))
        except ValueError:
            maxlen = 32000
        return TraceConfig(
            hide_llm_invocation_parameters=_env_bool(
                "OPENINFERENCE_HIDE_LLM_INVOCATION_PARAMETERS"),
            hide_inputs=_env_bool("OPENINFERENCE_HIDE_INPUTS"),
            hide_outputs=_env_bool("OPENINFERENCE_HIDE_OUTPUTS"),
            hide_input_messages=_env_bool(
                "OPENINFERENCE_HIDE_INPUT_MESSAGES"),
            hide_output_messages=_env_bool(
                "OPENINFERENCE_HIDE_OUTPUT_MESSAGES"),
            hide_input_images=_env_bool("OPENINFERENCE_HIDE_INPUT_IMAGES"),
            hide_input_text=_env_bool("OPENINFERENCE_HIDE_INPUT_TEXT"),
            hide_output_text=_env_bool("OPENINFERENCE_HIDE_OUTPUT_TEXT"),
            hide_embeddings_text=_env_bool(
                "OPENINFERENCE_HIDE_EMBEDDINGS_TEXT"),
            hide_embeddings_vectors=_env_bool(
                "OPENINFERENCE_HIDE_EMBEDDINGS_VECTORS"),
            hide_prompts=_env_bool("OPENINFERENCE_HIDE_PROMPTS"),
            hide_choices=_env_bool("OPENINFERENCE_HIDE_CHOICES"),
            base64_image_max_length=maxlen,
        )


# -- error typing (response_error.go) ------------------------------------
def error_type_for_status(status: int) -> str:
    """HTTP status → OpenAI SDK exception class name."""
    if status == 400:
        return "BadRequestError"
    if status == 401:
        return "AuthenticationError"
    if status == 403:
        return "PermissionDeniedError"
    if status == 404:
        return "NotFoundError"
    if status == 429:
        return "RateLimitError"
    if status >= 500:
        return "InternalServerError"
    return "Error"


# -- request builders -----------------------------------------------------
def _content_text(content: Any) -> str | None:
    """Plain-string content, or None when it's a parts list."""
    if isinstance(content, str):
        return content
    return None


def _maybe_truncate_image(url: str, cfg: TraceConfig) -> str | None:
    """None = drop the image attribute entirely (reference drops base64
    URLs longer than the cap rather than truncating them)."""
    if url.startswith("data:") and len(url) > cfg.base64_image_max_length:
        return None
    return url


def chat_request_attributes(
    req: dict[str, Any],
    raw: str | bytes,
    cfg: TraceConfig,
    system: str = LLM_SYSTEM_OPENAI,
) -> dict[str, Any]:
    """OpenAI-shape chat request → attrs (request_attrs.go:32-207).
    ``system`` distinguishes the Anthropic /v1/messages front."""
    attrs: dict[str, Any] = {
        SPAN_KIND: SPAN_KIND_LLM,
        LLM_SYSTEM: system,
        LLM_MODEL_NAME: str(req.get("model", "")),
    }
    if cfg.hide_inputs:
        attrs[INPUT_VALUE] = REDACTED
    else:
        attrs[INPUT_VALUE] = (
            raw.decode("utf-8", "replace")
            if isinstance(raw, bytes) else raw
        )
        attrs[INPUT_MIME_TYPE] = MIME_TYPE_JSON
    if not cfg.hide_llm_invocation_parameters:
        params = {k: v for k, v in req.items()
                  if k not in ("messages", "tools")}
        attrs[LLM_INVOCATION_PARAMETERS] = json.dumps(params)
    if not cfg.hide_inputs and not cfg.hide_input_messages:
        for i, msg in enumerate(req.get("messages") or ()):
            if not isinstance(msg, dict):
                continue
            role = str(msg.get("role", ""))
            attrs[input_message_attr(i, MESSAGE_ROLE)] = role
            content = msg.get("content")
            text = _content_text(content)
            if text is not None:
                attrs[input_message_attr(i, MESSAGE_CONTENT)] = (
                    REDACTED if cfg.hide_input_text else text
                )
            elif isinstance(content, list):
                for j, part in enumerate(content):
                    if not isinstance(part, dict):
                        continue
                    ptype = part.get("type", "")
                    if ptype == "text":
                        attrs[input_message_content_attr(
                            i, j, "text")] = (
                            REDACTED if cfg.hide_input_text
                            else str(part.get("text", ""))
                        )
                        attrs[input_message_content_attr(
                            i, j, "type")] = "text"
                    elif (ptype == "image_url"
                          and not cfg.hide_input_images):
                        url = str(
                            (part.get("image_url") or {}).get("url", ""))
                        kept = _maybe_truncate_image(url, cfg)
                        if kept is not None:
                            key = input_message_content_attr(
                                i, j, "image.image.url")
                            attrs[key] = kept
                            attrs[input_message_content_attr(
                                i, j, "type")] = "image"
            for j, tc in enumerate(msg.get("tool_calls") or ()):
                if not isinstance(tc, dict):
                    continue
                if tc.get("id"):
                    attrs[input_message_tool_call_attr(
                        i, j, TOOL_CALL_ID)] = str(tc["id"])
                fn = tc.get("function") or {}
                attrs[input_message_tool_call_attr(
                    i, j, TOOL_CALL_FUNCTION_NAME)] = str(
                    fn.get("name", ""))
                attrs[input_message_tool_call_attr(
                    i, j, TOOL_CALL_FUNCTION_ARGUMENTS)] = str(
                    fn.get("arguments", ""))
    for i, tool in enumerate(req.get("tools") or ()):
        attrs[input_tools_attr(i)] = json.dumps(tool)
    return attrs


def _usage_attributes(usage: dict[str, Any]) -> dict[str, Any]:
    """Token counts incl. prompt/completion details
    (response_attrs.go:56-78); accepts OpenAI and Anthropic field
    names."""
    attrs: dict[str, Any] = {}
    pt = usage.get("prompt_tokens") or usage.get("input_tokens") or 0
    ct = usage.get("completion_tokens") or usage.get("output_tokens") or 0
    tt = usage.get("total_tokens") or 0
    if not tt and (pt or ct):
        tt = pt + ct
    if pt:
        attrs[LLM_TOKEN_COUNT_PROMPT] = int(pt)
    ptd = usage.get("prompt_tokens_details") or {}
    if ptd.get("audio_tokens"):
        attrs[LLM_TOKEN_COUNT_PROMPT_AUDIO] = int(ptd["audio_tokens"])
    cache_read = (ptd.get("cached_tokens")
                  or usage.get("cache_read_input_tokens") or 0)
    if cache_read:
        attrs[LLM_TOKEN_COUNT_PROMPT_CACHE_HIT] = int(cache_read)
    cache_write = (ptd.get("cache_creation_tokens")
                   or usage.get("cache_creation_input_tokens") or 0)
    if cache_write:
        attrs[LLM_TOKEN_COUNT_PROMPT_CACHE_WRITE] = int(cache_write)
    if ct:
        attrs[LLM_TOKEN_COUNT_COMPLETION] = int(ct)
    ctd = usage.get("completion_tokens_details") or {}
    if ctd.get("audio_tokens"):
        attrs[LLM_TOKEN_COUNT_COMPLETION_AUDIO] = int(ctd["audio_tokens"])
    if ctd.get("reasoning_tokens"):
        attrs[LLM_TOKEN_COUNT_COMPLETION_REASONING] = int(
            ctd["reasoning_tokens"])
    if tt:
        attrs[LLM_TOKEN_COUNT_TOTAL] = int(tt)
    return attrs


def chat_response_attributes(
    resp: dict[str, Any], cfg: TraceConfig
) -> dict[str, Any]:
    """OpenAI-shape chat response → attrs (response_attrs.go:20-79)."""
    attrs: dict[str, Any] = {}
    if resp.get("model"):
        attrs[LLM_MODEL_NAME] = str(resp["model"])
    if cfg.hide_outputs:
        attrs[OUTPUT_VALUE] = REDACTED
    else:
        attrs[OUTPUT_VALUE] = json.dumps(resp)
        attrs[OUTPUT_MIME_TYPE] = MIME_TYPE_JSON
    if not cfg.hide_outputs and not cfg.hide_output_messages:
        for i, choice in enumerate(resp.get("choices") or ()):
            msg = choice.get("message") or {}
            if msg.get("role"):
                attrs[output_message_attr(i, MESSAGE_ROLE)] = str(
                    msg["role"])
            content = msg.get("content")
            if isinstance(content, str) and content:
                attrs[output_message_attr(i, MESSAGE_CONTENT)] = (
                    REDACTED if cfg.hide_output_text else content
                )
            for j, tc in enumerate(msg.get("tool_calls") or ()):
                if tc.get("id"):
                    attrs[output_message_tool_call_attr(
                        i, j, TOOL_CALL_ID)] = str(tc["id"])
                fn = tc.get("function") or {}
                attrs[output_message_tool_call_attr(
                    i, j, TOOL_CALL_FUNCTION_NAME)] = str(
                    fn.get("name", ""))
                attrs[output_message_tool_call_attr(
                    i, j, TOOL_CALL_FUNCTION_ARGUMENTS)] = str(
                    fn.get("arguments", ""))
    attrs.update(_usage_attributes(resp.get("usage") or {}))
    return attrs


def anthropic_response_attributes(
    resp: dict[str, Any], cfg: TraceConfig
) -> dict[str, Any]:
    """Anthropic /v1/messages response → the same output attrs (so the
    Anthropic front traces identically to chat)."""
    attrs: dict[str, Any] = {}
    if resp.get("model"):
        attrs[LLM_MODEL_NAME] = str(resp["model"])
    if cfg.hide_outputs:
        attrs[OUTPUT_VALUE] = REDACTED
    else:
        attrs[OUTPUT_VALUE] = json.dumps(resp)
        attrs[OUTPUT_MIME_TYPE] = MIME_TYPE_JSON
    if not cfg.hide_outputs and not cfg.hide_output_messages:
        attrs[output_message_attr(0, MESSAGE_ROLE)] = str(
            resp.get("role", "assistant"))
        texts = [b.get("text", "") for b in resp.get("content") or ()
                 if isinstance(b, dict) and b.get("type") == "text"]
        if any(texts):
            attrs[output_message_attr(0, MESSAGE_CONTENT)] = (
                REDACTED if cfg.hide_output_text else "".join(texts)
            )
        tool_uses = [b for b in resp.get("content") or ()
                     if isinstance(b, dict)
                     and b.get("type") == "tool_use"]
        for j, tu in enumerate(tool_uses):
            if tu.get("id"):
                attrs[output_message_tool_call_attr(
                    0, j, TOOL_CALL_ID)] = str(tu["id"])
            attrs[output_message_tool_call_attr(
                0, j, TOOL_CALL_FUNCTION_NAME)] = str(tu.get("name", ""))
            attrs[output_message_tool_call_attr(
                0, j, TOOL_CALL_FUNCTION_ARGUMENTS)] = json.dumps(
                tu.get("input") or {})
    attrs.update(_usage_attributes(resp.get("usage") or {}))
    return attrs


def embeddings_request_attributes(
    req: dict[str, Any], raw: str | bytes, cfg: TraceConfig
) -> dict[str, Any]:
    """Embeddings request → attrs (request_attrs.go:223-300)."""
    attrs: dict[str, Any] = {
        SPAN_KIND: SPAN_KIND_EMBEDDING,
        EMBEDDING_MODEL_NAME: str(req.get("model", "")),
    }
    if cfg.hide_inputs:
        attrs[INPUT_VALUE] = REDACTED
    else:
        attrs[INPUT_VALUE] = (
            raw.decode("utf-8", "replace")
            if isinstance(raw, bytes) else raw
        )
        attrs[INPUT_MIME_TYPE] = MIME_TYPE_JSON
    if not cfg.hide_llm_invocation_parameters:
        params = {k: v for k, v in req.items() if k != "input"}
        attrs[EMBEDDING_INVOCATION_PARAMETERS] = json.dumps(params)
    if not cfg.hide_inputs and not cfg.hide_embeddings_text:
        inputs = req.get("input")
        if isinstance(inputs, str):
            attrs[embedding_text_attr(0)] = inputs
        elif isinstance(inputs, list):
            for i, text in enumerate(inputs):
                if isinstance(text, str):
                    attrs[embedding_text_attr(i)] = text
    return attrs


def embeddings_response_attributes(
    resp: dict[str, Any], cfg: TraceConfig
) -> dict[str, Any]:
    """Embeddings response → attrs (response_attrs.go:82-119)."""
    attrs: dict[str, Any] = {}
    if resp.get("model"):
        attrs[EMBEDDING_MODEL_NAME] = str(resp["model"])
    if cfg.hide_outputs:
        attrs[OUTPUT_VALUE] = REDACTED
    else:
        attrs[OUTPUT_MIME_TYPE] = MIME_TYPE_JSON
    if not cfg.hide_outputs and not cfg.hide_embeddings_vectors:
        for i, item in enumerate(resp.get("data") or ()):
            emb = item.get("embedding")
            if isinstance(emb, list) and emb:
                attrs[embedding_vector_attr(i)] = [
                    float(x) for x in emb]
    usage = resp.get("usage") or {}
    if usage.get("prompt_tokens"):
        attrs[LLM_TOKEN_COUNT_PROMPT] = int(usage["prompt_tokens"])
    if usage.get("total_tokens"):
        attrs[LLM_TOKEN_COUNT_TOTAL] = int(usage["total_tokens"])
    return attrs


def completion_request_attributes(
    req: dict[str, Any], raw: str | bytes, cfg: TraceConfig
) -> dict[str, Any]:
    """Legacy /v1/completions request → attrs
    (request_attrs.go:309-350)."""
    attrs: dict[str, Any] = {
        SPAN_KIND: SPAN_KIND_LLM,
        LLM_SYSTEM: LLM_SYSTEM_OPENAI,
        LLM_MODEL_NAME: str(req.get("model", "")),
    }
    if cfg.hide_inputs:
        attrs[INPUT_VALUE] = REDACTED
    else:
        attrs[INPUT_VALUE] = (
            raw.decode("utf-8", "replace")
            if isinstance(raw, bytes) else raw
        )
        attrs[INPUT_MIME_TYPE] = MIME_TYPE_JSON
    if not cfg.hide_llm_invocation_parameters:
        params = {k: v for k, v in req.items() if k != "prompt"}
        attrs[LLM_INVOCATION_PARAMETERS] = json.dumps(params)
    if not cfg.hide_inputs and not cfg.hide_prompts:
        prompt = req.get("prompt")
        if isinstance(prompt, str):
            attrs[prompt_text_attr(0)] = prompt
        elif isinstance(prompt, list):
            for i, p in enumerate(prompt):
                if isinstance(p, str):
                    attrs[prompt_text_attr(i)] = p
    return attrs


def completion_response_attributes(
    resp: dict[str, Any], cfg: TraceConfig
) -> dict[str, Any]:
    """Legacy /v1/completions response → attrs
    (response_attrs.go:141-172)."""
    attrs: dict[str, Any] = {}
    if resp.get("model"):
        attrs[LLM_MODEL_NAME] = str(resp["model"])
    if cfg.hide_outputs:
        attrs[OUTPUT_VALUE] = REDACTED
    else:
        attrs[OUTPUT_VALUE] = json.dumps(resp)
        attrs[OUTPUT_MIME_TYPE] = MIME_TYPE_JSON
    if not cfg.hide_outputs and not cfg.hide_choices:
        for i, choice in enumerate(resp.get("choices") or ()):
            text = choice.get("text")
            if isinstance(text, str) and text:
                attrs[choice_text_attr(i)] = text
    attrs.update(_usage_attributes(resp.get("usage") or {}))
    return attrs


SPAN_KIND_RERANKER = "RERANKER"
LLM_SYSTEM_COHERE = "cohere"
RERANKER_MODEL_NAME = "reranker.model_name"
RERANKER_QUERY = "reranker.query"
RERANKER_TOP_K = "reranker.top_k"


def reranker_input_doc_attr(i: int) -> str:
    """Flattened input-document key (openinference/rerank.go:45-49)."""
    return f"reranker.input_documents.{i}.document.content"


def reranker_output_doc_attr(i: int) -> str:
    return f"reranker.output_documents.{i}.document.score"


def rerank_request_attributes(
    req: dict[str, Any], raw: str | bytes, cfg: TraceConfig
) -> dict[str, Any]:
    """Cohere /v2/rerank request → OpenInference RERANKER attrs
    (reference openinference/cohere/rerank.go:84-123)."""
    attrs: dict[str, Any] = {
        LLM_SYSTEM: LLM_SYSTEM_COHERE,
        SPAN_KIND: SPAN_KIND_RERANKER,
    }
    if req.get("model"):
        attrs[RERANKER_MODEL_NAME] = str(req["model"])
    if req.get("top_n") is not None:
        attrs[RERANKER_TOP_K] = int(req["top_n"])
    if req.get("query"):
        attrs[RERANKER_QUERY] = str(req["query"])
    if cfg.hide_inputs:
        attrs[INPUT_VALUE] = REDACTED
    else:
        attrs[INPUT_VALUE] = (
            raw.decode("utf-8", "replace")
            if isinstance(raw, bytes) else raw
        )
        attrs[INPUT_MIME_TYPE] = MIME_TYPE_JSON
        for i, doc in enumerate(req.get("documents") or ()):
            text = doc if isinstance(doc, str) else (
                doc.get("text", "") if isinstance(doc, dict) else "")
            if text:
                attrs[reranker_input_doc_attr(i)] = text
    return attrs


def rerank_response_attributes(
    resp: dict[str, Any], cfg: TraceConfig
) -> dict[str, Any]:
    """Cohere /v2/rerank response → attrs (rerank.go:125-154): per-result
    relevance scores as output documents; token counts survive
    hide_outputs."""
    attrs: dict[str, Any] = {}
    if cfg.hide_outputs:
        attrs[OUTPUT_VALUE] = REDACTED
    else:
        attrs[OUTPUT_VALUE] = json.dumps(resp)
        attrs[OUTPUT_MIME_TYPE] = MIME_TYPE_JSON
        for i, res in enumerate(resp.get("results") or ()):
            if isinstance(res, dict) and "relevance_score" in res:
                attrs[reranker_output_doc_attr(i)] = float(
                    res["relevance_score"])
    tokens = ((resp.get("meta") or {}).get("tokens") or {})
    inp = tokens.get("input_tokens")
    out = tokens.get("output_tokens")
    if inp:
        attrs[LLM_TOKEN_COUNT_PROMPT] = int(inp)
    if out:
        attrs[LLM_TOKEN_COUNT_COMPLETION] = int(out)
    if inp or out:
        attrs[LLM_TOKEN_COUNT_TOTAL] = int(inp or 0) + int(out or 0)
    return attrs


class StreamAccumulator:
    """Reconstructs a response dict from front-schema SSE bytes so
    streamed requests get the same output attributes as unary ones
    (reference openai/sse_converter.go). Feed the bytes already written
    to the client; ``response()`` returns an OpenAI- or Anthropic-shaped
    dict depending on the front schema observed."""

    def __init__(self) -> None:
        from aigw_tpu_torch.translate.sse import SSEParser

        self._parser = SSEParser()
        self._model = ""
        self._role = ""
        self._texts: dict[int, list[str]] = {}
        self._tool_calls: dict[int, dict[int, dict[str, Any]]] = {}
        self._finish: dict[int, str] = {}
        self._usage: dict[str, Any] = {}
        self._anthropic = False
        self._completion = False  # legacy text-completion chunks seen
        self._anth_blocks: dict[int, dict[str, Any]] = {}

    def feed(self, data: bytes) -> None:
        """Never raises: upstream-controlled bytes feed this from the
        client-streaming hot loop, and telemetry must not sever the
        stream."""
        try:
            events = self._parser.feed(data)
        except Exception:  # noqa: BLE001
            return
        for ev in events:
            if not ev.data or ev.data.strip() == "[DONE]":
                continue
            try:
                msg = json.loads(ev.data)
                if not isinstance(msg, dict):
                    continue
                if "type" in msg and "choices" not in msg:
                    self._feed_anthropic(msg)
                else:
                    self._feed_openai(msg)
            except Exception:  # noqa: BLE001 — malformed upstream event
                continue

    def _feed_openai(self, msg: dict[str, Any]) -> None:
        self._model = msg.get("model") or self._model
        if isinstance(msg.get("usage"), dict):
            self._usage.update(msg["usage"])
        for choice in msg.get("choices") or ():
            if not isinstance(choice, dict):
                continue
            idx = int(choice.get("index") or 0)
            # legacy /v1/completions chunks carry text directly
            if isinstance(choice.get("text"), str) and "delta" not in choice:
                self._completion = True
                self._texts.setdefault(idx, []).append(choice["text"])
                if choice.get("finish_reason"):
                    self._finish[idx] = choice["finish_reason"]
                continue
            delta = choice.get("delta") or {}
            if delta.get("role"):
                self._role = delta["role"]
            if isinstance(delta.get("content"), str):
                self._texts.setdefault(idx, []).append(delta["content"])
            for tc in delta.get("tool_calls") or ():
                ti = int(tc.get("index", 0))
                acc = self._tool_calls.setdefault(idx, {}).setdefault(
                    ti, {"id": "", "function": {"name": "",
                                                "arguments": ""}})
                if tc.get("id"):
                    acc["id"] = tc["id"]
                fn = tc.get("function") or {}
                if fn.get("name"):
                    acc["function"]["name"] = fn["name"]
                if fn.get("arguments"):
                    acc["function"]["arguments"] += fn["arguments"]
            if choice.get("finish_reason"):
                self._finish[idx] = choice["finish_reason"]

    def _feed_anthropic(self, msg: dict[str, Any]) -> None:
        self._anthropic = True
        t = msg.get("type")
        if t == "message_start":
            m = msg.get("message") or {}
            self._model = m.get("model") or self._model
            self._role = m.get("role", "assistant")
            if isinstance(m.get("usage"), dict):
                self._usage.update(m["usage"])
        elif t == "content_block_start":
            idx = int(msg.get("index", 0))
            self._anth_blocks[idx] = dict(
                msg.get("content_block") or {})
            self._anth_blocks[idx].setdefault("_json", [])
        elif t == "content_block_delta":
            idx = int(msg.get("index", 0))
            block = self._anth_blocks.setdefault(
                idx, {"type": "text", "_json": []})
            d = msg.get("delta") or {}
            if d.get("type") == "text_delta":
                block["text"] = block.get("text", "") + d.get("text", "")
            elif d.get("type") == "input_json_delta":
                block.setdefault("_json", []).append(
                    d.get("partial_json", ""))
        elif t == "message_delta":
            if isinstance(msg.get("usage"), dict):
                self._usage.update(msg["usage"])

    def response(self) -> dict[str, Any] | None:
        if self._anthropic:
            content: list[dict[str, Any]] = []
            for idx in sorted(self._anth_blocks):
                block = dict(self._anth_blocks[idx])
                parts = block.pop("_json", [])
                if block.get("type") == "tool_use" and parts:
                    try:
                        block["input"] = json.loads("".join(parts))
                    except ValueError:
                        pass
                content.append(block)
            if not (content or self._model or self._usage):
                return None
            return {
                "model": self._model,
                "role": self._role or "assistant",
                "content": content,
                "usage": self._usage,
            }
        if not (self._texts or self._tool_calls or self._model
                or self._usage):
            return None
        if self._completion:
            return {
                "model": self._model,
                "choices": [
                    {"index": idx, "text": "".join(self._texts[idx]),
                     "finish_reason": self._finish.get(idx)}
                    for idx in sorted(self._texts)
                ],
                "usage": self._usage,
            }
        choices = []
        for idx in sorted(set(self._texts) | set(self._tool_calls)
                          | set(self._finish) | {0}):
            msg: dict[str, Any] = {"role": self._role or "assistant"}
            if idx in self._texts:
                msg["content"] = "".join(self._texts[idx])
            if idx in self._tool_calls:
                msg["tool_calls"] = [
                    self._tool_calls[idx][ti]
                    for ti in sorted(self._tool_calls[idx])
                ]
            choices.append({
                "index": idx,
                "message": msg,
                "finish_reason": self._finish.get(idx),
            })
        return {
            "model": self._model,
            "choices": choices,
            "usage": self._usage,
        }
