"""OpenAI front → Azure OpenAI backend.

Azure speaks the OpenAI schema; the differences are the deployment-scoped
path and the api-version query parameter (upstream openai→azureopenai
translator). The APISchema.version of the backend carries the api-version.

The port's copy of ``aigw_tpu/translate/openai_azure.py``.
"""

from __future__ import annotations

import urllib.parse
from typing import Any

from aigw_tpu_torch.config.model import APISchemaName
from aigw_tpu_torch.schemas import openai as oai
from aigw_tpu_torch.translate.base import Endpoint, RequestTx, register_translator
from aigw_tpu_torch.translate.passthrough import PassthroughTranslator

DEFAULT_API_VERSION = "2025-01-01-preview"

_ENDPOINT_SUFFIX = {
    Endpoint.CHAT_COMPLETIONS: "chat/completions",
    Endpoint.COMPLETIONS: "completions",
    Endpoint.EMBEDDINGS: "embeddings",
    Endpoint.AUDIO_SPEECH: "audio/speech",
    Endpoint.AUDIO_TRANSCRIPTIONS: "audio/transcriptions",
    Endpoint.AUDIO_TRANSLATIONS: "audio/translations",
    Endpoint.IMAGES_GENERATIONS: "images/generations",
}


class OpenAIToAzure(PassthroughTranslator):
    def __init__(
        self,
        endpoint: Endpoint,
        *,
        model_name_override: str = "",
        stream: bool = False,
        out_version: str = "",
    ):
        super().__init__(
            path="",  # computed per request from the model/deployment
            usage_extractor=oai.extract_usage,
            model_name_override=model_name_override,
            stream=stream,
        )
        self._endpoint = endpoint
        self._api_version = out_version or DEFAULT_API_VERSION

    def request(self, body: dict[str, Any]) -> RequestTx:
        tx = super().request(body)
        deployment = urllib.parse.quote(
            self._override or oai.request_model(body), safe=""
        )
        suffix = _ENDPOINT_SUFFIX[self._endpoint]
        tx.path = (
            f"/openai/deployments/{deployment}/{suffix}"
            f"?api-version={self._api_version}"
        )
        return tx


def _install() -> None:
    for ep in _ENDPOINT_SUFFIX:
        def make(*, model_name_override: str = "", stream: bool = False,
                 out_version: str = "", _ep: Endpoint = ep):
            return OpenAIToAzure(
                _ep,
                model_name_override=model_name_override,
                stream=stream,
                out_version=out_version,
            )

        register_translator(ep, APISchemaName.OPENAI, APISchemaName.AZURE_OPENAI, make)


_install()
