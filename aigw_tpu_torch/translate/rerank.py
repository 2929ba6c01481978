"""Cohere /v2/rerank translators (the port's copy of
``aigw_tpu/translate/rerank.py``): a Cohere front to a self-hosted
Cohere-compatible reranker, body forwarded, billed units mined."""

from __future__ import annotations

import json
from typing import Any

from aigw_tpu_torch.config.model import APISchemaName
from aigw_tpu_torch.gateway.costs import TokenUsage
from aigw_tpu_torch.schemas.openai import SchemaError
from aigw_tpu_torch.translate.base import (
    Endpoint,
    RequestTx,
    ResponseTx,
    Translator,
    register_translator,
)


class CoherePassthroughRerank(Translator):
    """Cohere front → Cohere backend; mines billed-unit usage."""

    def __init__(self, *, model_name_override: str = "", **_: object):
        self._override = model_name_override

    def request(self, body: dict[str, Any]) -> RequestTx:
        if not isinstance(body.get("query"), str):
            raise SchemaError("rerank request needs a 'query' string")
        if not isinstance(body.get("documents"), list) or not body["documents"]:
            raise SchemaError("rerank request needs non-empty 'documents'")
        if self._override:
            body = dict(body, model=self._override)
        return RequestTx(body=json.dumps(body).encode(),
                         path=Endpoint.RERANK.value)

    def response_body(self, chunk: bytes, end_of_stream: bool) -> ResponseTx:
        if not end_of_stream:
            return ResponseTx(body=chunk)
        try:
            data = json.loads(chunk) if chunk else {}
        except json.JSONDecodeError:
            return ResponseTx(body=chunk)
        units = ((data.get("meta") or {}).get("billed_units") or {})
        usage = TokenUsage(
            input_tokens=int(units.get("input_tokens", 0) or 0),
            output_tokens=int(units.get("output_tokens", 0) or 0),
            total_tokens=int(units.get("input_tokens", 0) or 0)
            + int(units.get("output_tokens", 0) or 0),
        )
        return ResponseTx(body=chunk, usage=usage,
                          model=str(data.get("model", "") or ""))


register_translator(
    Endpoint.RERANK, APISchemaName.COHERE, APISchemaName.COHERE,
    CoherePassthroughRerank,
)
