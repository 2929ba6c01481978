"""Zero-config from environment variables (the port's copy of
``aigw_tpu/config/autoconfig.py``).

Equivalent of upstream's internal/autoconfig (config.go:24-110):
``python -m aigw_tpu_torch run`` with no config file builds a working
gateway from whatever provider credentials the environment carries:

- ``OPENAI_API_KEY``       → OpenAI backend (``OPENAI_BASE_URL`` optional)
- ``ANTHROPIC_API_KEY``    → Anthropic backend
- ``AZURE_OPENAI_API_KEY`` + ``AZURE_OPENAI_ENDPOINT`` → Azure backend
- ``TPUSERVE_URL``         → a serving replica (``TPUServe`` schema)
- ``AIGW_MODELS``          → comma-separated model names to route
                              (default: route any model to the first
                              backend via a catch-all rule)
"""

from __future__ import annotations

import os
from typing import Any

from aigw_tpu_torch.config.model import Config, ConfigError


def autoconfig_from_env(env: dict[str, str] | None = None) -> Config:
    env = dict(os.environ) if env is None else env
    backends: list[dict[str, Any]] = []

    if env.get("TPUSERVE_URL"):
        backends.append(
            {"name": "tpuserve", "schema": "TPUServe",
             "url": env["TPUSERVE_URL"]}
        )
    if env.get("OPENAI_API_KEY"):
        backends.append(
            {
                "name": "openai",
                "schema": "OpenAI",
                "url": env.get("OPENAI_BASE_URL", "https://api.openai.com"),
                "auth": {"kind": "APIKey", "api_key": env["OPENAI_API_KEY"]},
            }
        )
    if env.get("ANTHROPIC_API_KEY"):
        backends.append(
            {
                "name": "anthropic",
                "schema": "Anthropic",
                "url": env.get("ANTHROPIC_BASE_URL",
                               "https://api.anthropic.com"),
                "auth": {"kind": "AnthropicAPIKey",
                         "api_key": env["ANTHROPIC_API_KEY"]},
            }
        )
    if env.get("AZURE_OPENAI_API_KEY") and env.get("AZURE_OPENAI_ENDPOINT"):
        backends.append(
            {
                "name": "azure",
                "schema": {"name": "AzureOpenAI",
                           "version": env.get("AZURE_OPENAI_API_VERSION",
                                              "")},
                "url": env["AZURE_OPENAI_ENDPOINT"],
                "auth": {"kind": "AzureAPIKey",
                         "azure_api_key": env["AZURE_OPENAI_API_KEY"]},
            }
        )
    if not backends:
        raise ConfigError(
            "autoconfig found no credentials: set OPENAI_API_KEY, "
            "ANTHROPIC_API_KEY, AZURE_OPENAI_API_KEY+AZURE_OPENAI_ENDPOINT, "
            "or TPUSERVE_URL (or pass a config file)"
        )

    models = [m.strip() for m in env.get("AIGW_MODELS", "").split(",")
              if m.strip()]
    names = [b["name"] for b in backends]
    rules: list[dict[str, Any]] = []
    if models:
        rules.append({"models": models, "backends": [names[0]]})
    # model-prefix routing so every configured provider is reachable:
    # claude-* → Anthropic, gpt-*/o* → OpenAI-schema backends
    if "anthropic" in names:
        rules.append({"model_prefixes": ["claude"],
                      "backends": ["anthropic"]})
    openai_like = [n for n in ("openai", "azure") if n in names]
    if openai_like:
        rules.append({"model_prefixes": ["gpt", "o1", "o3", "o4",
                                         "text-embedding", "chatgpt"],
                      "backends": openai_like})
    # catch-all: every backend forms a priority fallback chain
    rules.append({
        "backends": [
            {"backend": n, "priority": i} for i, n in enumerate(names)
        ]
    })

    return Config.parse(
        {
            "version": "v1",
            "backends": backends,
            "routes": [{"name": "autoconfig", "rules": rules}],
            "models": models,
            "llm_request_costs": [
                {"metadata_key": "total_tokens", "type": "TotalToken"}
            ],
        }
    )
