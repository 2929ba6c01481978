"""Schema translation of the port (counterpart of ``aigw_tpu/translate``):
the gateway's passthrough translators (``base``, ``passthrough``,
``sse``) and the replica's structured-output helpers (``structured``)."""

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
