"""Schema translation of the port (counterpart of ``aigw_tpu/translate``):
``get_translator(endpoint, in_schema, out_schema)`` returns a fresh
stateful translator per request, from the registry every module of the
package fills at import (``base._install_all``): the same-schema
passthroughs, the client fronts (``/v1/messages``, ``/v1/responses``,
rerank), the hosted providers (Anthropic, Azure OpenAI, Vertex Gemini,
Vertex and Bedrock Anthropic, Bedrock Converse), the count-tokens and
embeddings pairs; ``sse`` and ``eventstream`` frame the streams and
``structured`` holds the replica's and the translators'
structured-output helpers."""

from aigw_tpu_torch.translate.base import (
    Endpoint,
    RequestTx,
    ResponseTx,
    TranslationError,
    Translator,
    get_translator,
    register_translator,
    supported_pairs,
)

__all__ = [
    "Endpoint",
    "RequestTx",
    "ResponseTx",
    "TranslationError",
    "Translator",
    "get_translator",
    "register_translator",
    "supported_pairs",
]
