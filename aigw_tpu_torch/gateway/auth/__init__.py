"""Upstream credential injection (upstream internal/backendauth/auth.go:19-61).

Each handler implements ``apply(headers, body, path) -> (headers, path)``:
given the outgoing request headers (lowercase keys), the final serialized
body and the upstream path, it returns mutated headers (and possibly a
rewritten path — the GCP handler rewrites region/project placeholders).

Handlers must be retry-safe: they are re-applied from scratch on each
attempt (the upstream gateway re-signs per retry because SigV4 covers the body:
extproc/processor_impl.go:334-339).

The port's copy of ``aigw_tpu/gateway/auth/__init__.py``.
"""

from aigw_tpu_torch.gateway.auth.handlers import (
    AuthError,
    AuthHandler,
    new_handler,
)

__all__ = ["AuthError", "AuthHandler", "new_handler"]
