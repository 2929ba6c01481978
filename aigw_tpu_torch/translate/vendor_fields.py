"""Vendor-specific field application during translation.

Proposal 004 (upstream docs/proposals/004-vendor-specific-fields/):
users put backend-specific parameters inline in the unified OpenAI
request; the translator for the *target* backend extracts and applies
them, and every other backend's translator ignores them. Application
sites in the upstream gateway:

- Gemini chat:   openai_gcpvertexai.go:498-594 (thinking →
  generationConfig.thinkingConfig; vendor generationConfig +
  safetySettings override translated fields)
- Anthropic:     anthropic_helper.go:577-607, :762 (thinking →
  Messages-API thinking param; shared by the GCP/AWS-hosted variants)
- Bedrock Converse: openai_awsbedrock.go:57-90, :142-146 (thinking →
  additionalModelRequestFields.thinking)
- Gemini embeddings: openai.go:1840-1854 + gemini embeddings translator
  (auto_truncate/task_type/title → per-endpoint wire spots)

Validation of these fields happens gateway-side in schemas/typed.py;
these helpers assume a validated body.

The port's copy of ``aigw_tpu/translate/vendor_fields.py``.
"""

from __future__ import annotations

from typing import Any


def thinking_to_anthropic(body: dict[str, Any]) -> dict[str, Any] | None:
    """``thinking`` union → Anthropic Messages `thinking` param
    (anthropic_helper.go:577-607: enabled carries budget_tokens(+display),
    adaptive carries type(+display), disabled carries type only — the
    upstream gateway's ThinkingConfigDisabledParam has no display field)."""
    t = body.get("thinking")
    if not isinstance(t, dict):
        return None
    kind = t.get("type")
    if kind == "enabled":
        out: dict[str, Any] = {"type": "enabled",
                               "budget_tokens": int(t["budget_tokens"])}
        if t.get("display"):
            out["display"] = t["display"]
        return out
    if kind == "disabled":
        return {"type": "disabled"}
    if kind == "adaptive":
        out = {"type": "adaptive"}
        if t.get("display"):
            out["display"] = t["display"]
        return out
    return None


def thinking_to_bedrock(body: dict[str, Any]) -> dict[str, Any] | None:
    """``thinking`` union → Converse additionalModelRequestFields
    (openai_awsbedrock.go:57-90: same shapes, wrapped under a
    "thinking" key; budget not forwarded for disabled/adaptive)."""
    inner = thinking_to_anthropic(body)
    if inner is None:
        return None
    return {"thinking": inner}


def apply_gcp_chat_vendor(body: dict[str, Any], out: dict[str, Any],
                          gen: dict[str, Any]) -> None:
    """Apply Gemini vendor fields onto the translated request —
    ``thinking`` → generationConfig.thinkingConfig
    (openai_gcpvertexai.go:500-523), then vendor ``generationConfig``
    keys merged with precedence over translated ones and
    ``safetySettings`` attached verbatim (:572-594, "vendor fields take
    precedence over translated fields")."""
    t = body.get("thinking")
    if isinstance(t, dict):
        if t.get("type") == "enabled":
            tc: dict[str, Any] = {
                "thinkingBudget": int(t["budget_tokens"]),
            }
            if t.get("includeThoughts"):
                tc["includeThoughts"] = True
            gen["thinkingConfig"] = tc
        elif t.get("type") == "disabled":
            gen["thinkingConfig"] = {}
    vendor_gen = body.get("generationConfig")
    if isinstance(vendor_gen, dict):
        for key, value in vendor_gen.items():
            if key == "media_resolution":
                # json name differs from the wire name (openai.go:2021)
                gen["mediaResolution"] = value
            else:
                gen[key] = value
    safety = body.get("safetySettings")
    if isinstance(safety, list):
        out["safetySettings"] = safety


def gcp_embedding_vendor(body: dict[str, Any]) -> dict[str, Any]:
    """The embedding vendor triple, if present (openai.go:1840-1854)."""
    out: dict[str, Any] = {}
    if isinstance(body.get("auto_truncate"), bool):
        out["auto_truncate"] = body["auto_truncate"]
    if isinstance(body.get("task_type"), str):
        out["task_type"] = body["task_type"]
    if isinstance(body.get("title"), str):
        out["title"] = body["title"]
    return out


def cache_control_marker(part: dict[str, Any]) -> dict[str, Any] | None:
    """Anthropic prompt-caching marker riding the OpenAI surface
    (AnthropicContentFields, openai.go:460-462; the upstream gateway's
    isCacheEnabled predicate, anthropic_helper.go:258-260). One shared
    detector so the Anthropic and Bedrock mappings can't drift."""
    cc = part.get("cache_control")
    if isinstance(cc, dict) and cc.get("type") == "ephemeral":
        return cc
    return None
