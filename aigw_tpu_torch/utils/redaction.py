"""Sensitive-data redaction for debug logs.

The upstream gateway redacts credential headers and (optionally) message content
from debug logs (extproc/server.go:457-609, endpointspec
RedactSensitiveInfoFromRequest, internal/redaction). Same policy here:

- credential headers are always masked;
- request/response *content* is replaced by length placeholders unless
  ``AIGW_LOG_SENSITIVE=true`` explicitly opts into full payloads.

The port's copy of ``aigw_tpu/utils/redaction.py``.
"""

from __future__ import annotations

import os
from typing import Any

#: headers that carry credentials — always masked in logs
SENSITIVE_HEADERS = frozenset(
    {
        "authorization",
        "x-api-key",
        "api-key",
        "proxy-authorization",
        "cookie",
        "x-amz-security-token",
        "mcp-session-id",
    }
)

_CONTENT_FIELDS = ("messages", "prompt", "input", "system", "documents",
                   "query", "contents")


def log_sensitive_allowed() -> bool:
    return os.environ.get("AIGW_LOG_SENSITIVE", "").lower() == "true"


def redact_headers(headers: dict[str, str]) -> dict[str, str]:
    return {
        k: "[REDACTED]" if k.lower() in SENSITIVE_HEADERS else v
        for k, v in headers.items()
    }


def redact_body(body: Any) -> Any:
    """Replace content-bearing fields with size placeholders."""
    if log_sensitive_allowed():
        return body
    if not isinstance(body, dict):
        return body
    out = dict(body)
    for field in _CONTENT_FIELDS:
        if field in out:
            v = out[field]
            if isinstance(v, str):
                out[field] = f"[REDACTED {len(v)} chars]"
            elif isinstance(v, list):
                out[field] = f"[REDACTED {len(v)} items]"
            else:
                out[field] = "[REDACTED]"
    return out
