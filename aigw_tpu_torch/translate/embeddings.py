"""Cross-schema embeddings translators.

Upstream matrix: embeddings × {OpenAI, Bedrock, Azure, Vertex}
(SURVEY.md §2.4). OpenAI→OpenAI/TPUServe and →Azure are passthrough
(passthrough.py / openai_azure.py); here are the structural pairs:
Vertex ``:predict`` and Bedrock Titan ``invoke``.

The port's copy of ``aigw_tpu/translate/embeddings.py``.
"""

from __future__ import annotations

import json
from typing import Any

from aigw_tpu_torch.config.model import APISchemaName
from aigw_tpu_torch.gateway.costs import TokenUsage
from aigw_tpu_torch.schemas import openai as oai
from aigw_tpu_torch.translate import vendor_fields
from aigw_tpu_torch.translate.base import (
    Endpoint,
    RequestTx,
    ResponseTx,
    TranslationError,
    Translator,
    register_translator,
)


def _inputs(body: dict[str, Any]) -> list[str]:
    raw = body.get("input")
    if isinstance(raw, str):
        return [raw]
    if isinstance(raw, list) and all(isinstance(x, str) for x in raw):
        return list(raw)
    raise TranslationError("embeddings input must be a string or string array")


def _input_items(body: dict[str, Any]) -> list[dict[str, Any]]:
    """Input union → [{content, task_type?, title?}] items. Supports the
    upstream gateway's object form carrying per-item task_type/title
    (openai.go:408-432 EmbeddingInputItem) plus plain string forms;
    request-level vendor fields (openai.go:1840-1854) fill the defaults."""
    defaults = vendor_fields.gcp_embedding_vendor(body)
    raw = body.get("input")
    items: list[dict[str, Any]] = []

    def push(content: str, task_type: str = "", title: str = "") -> None:
        items.append({
            "content": content,
            "task_type": task_type or defaults.get("task_type", ""),
            "title": title or defaults.get("title", ""),
        })

    if isinstance(raw, str):
        push(raw)
    elif isinstance(raw, list):
        for x in raw:
            if isinstance(x, str):
                push(x)
            elif isinstance(x, dict):
                content = x.get("content")
                texts = [content] if isinstance(content, str) else content
                if not isinstance(texts, list):
                    raise TranslationError(
                        "embedding input object content must be a string "
                        "or string array")
                for t in texts:
                    push(str(t), x.get("task_type", ""), x.get("title", ""))
            else:
                raise TranslationError(
                    "embeddings input must be strings or content objects")
    else:
        raise TranslationError(
            "embeddings input must be a string or array")
    return items


class OpenAIToVertexEmbeddings(Translator):
    """OpenAI /v1/embeddings → Vertex text-embedding ``:predict``."""

    def __init__(self, *, model_name_override: str = "", **_: object):
        self._override = model_name_override
        self._model = ""

    def request(self, body: dict[str, Any]) -> RequestTx:
        self._model = self._override or oai.request_model(body)
        instances = []
        for item in _input_items(body):
            inst: dict[str, Any] = {"content": item["content"]}
            # vendor fields on the predict wire: instances[].task_type /
            # title, parameters.auto_truncate (openai.go:1841-1843)
            if item["task_type"]:
                inst["task_type"] = item["task_type"]
            if item["title"]:
                inst["title"] = item["title"]
            instances.append(inst)
        out: dict[str, Any] = {"instances": instances}
        vendor = vendor_fields.gcp_embedding_vendor(body)
        if "auto_truncate" in vendor:
            out["parameters"] = {"auto_truncate": vendor["auto_truncate"]}
        if body.get("dimensions"):
            out.setdefault("parameters", {})["outputDimensionality"] = int(
                body["dimensions"])
        path = (
            "/v1/projects/{GCP_PROJECT}/locations/{GCP_REGION}"
            f"/publishers/google/models/{self._model}:predict"
        )
        return RequestTx(body=json.dumps(out).encode(), path=path)

    def response_body(self, chunk: bytes, end_of_stream: bool) -> ResponseTx:
        if not end_of_stream:
            return ResponseTx()
        try:
            data = json.loads(chunk)
        except json.JSONDecodeError as e:
            raise TranslationError(f"invalid upstream JSON: {e}") from None
        vectors = []
        total_tokens = 0
        for pred in data.get("predictions") or ():
            emb = pred.get("embeddings") or {}
            vectors.append(emb.get("values") or [])
            stats = emb.get("statistics") or {}
            total_tokens += int(stats.get("token_count", 0) or 0)
        usage = TokenUsage(input_tokens=total_tokens, total_tokens=total_tokens)
        out = oai.embeddings_response(
            model=self._model, vectors=vectors, usage=usage
        )
        return ResponseTx(
            body=json.dumps(out).encode(), usage=usage, model=self._model
        )


class OpenAIToBedrockEmbeddings(Translator):
    """OpenAI /v1/embeddings → Bedrock Titan embeddings ``invoke``.

    Titan accepts one input per call; multi-input requests are rejected the
    same way the upstream gateway surfaces provider limitations as 400s.
    """

    def __init__(self, *, model_name_override: str = "", **_: object):
        self._override = model_name_override
        self._model = ""

    def request(self, body: dict[str, Any]) -> RequestTx:
        self._model = self._override or oai.request_model(body)
        inputs = _inputs(body)
        if len(inputs) != 1:
            raise TranslationError(
                "Bedrock Titan embeddings accept exactly one input per request"
            )
        out: dict[str, Any] = {"inputText": inputs[0]}
        if body.get("dimensions"):
            out["dimensions"] = int(body["dimensions"])
        return RequestTx(
            body=json.dumps(out).encode(), path=f"/model/{self._model}/invoke"
        )

    def response_body(self, chunk: bytes, end_of_stream: bool) -> ResponseTx:
        if not end_of_stream:
            return ResponseTx()
        try:
            data = json.loads(chunk)
        except json.JSONDecodeError as e:
            raise TranslationError(f"invalid upstream JSON: {e}") from None
        tokens = int(data.get("inputTextTokenCount", 0) or 0)
        usage = TokenUsage(input_tokens=tokens, total_tokens=tokens)
        out = oai.embeddings_response(
            model=self._model,
            vectors=[data.get("embedding") or []],
            usage=usage,
        )
        return ResponseTx(
            body=json.dumps(out).encode(), usage=usage, model=self._model
        )


register_translator(
    Endpoint.EMBEDDINGS,
    APISchemaName.OPENAI,
    APISchemaName.GCP_VERTEX_AI,
    OpenAIToVertexEmbeddings,
)
register_translator(
    Endpoint.EMBEDDINGS,
    APISchemaName.OPENAI,
    APISchemaName.AWS_BEDROCK,
    OpenAIToBedrockEmbeddings,
)
