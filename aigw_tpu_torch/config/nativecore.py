"""Compile a gateway Config into the native proxy core's config JSON (the
port's copy of ``aigw_tpu/config/nativecore.py``; its output is the
reference's, byte for byte).

The C++ core (``aigw_tpu_torch/native/proxy_core.cpp``, built by
``aigw_tpu_torch.native.core_binary()``; the reference's Envoy role —
SURVEY.md §2.8) natively serves the subset of routing it can express:
same-schema (OpenAI passthrough) backends over plain HTTP with static
header auth, model exact/prefix matching, weights and priority tiers,
header set/remove mutations, retry/failover. Everything else relays to
the Python gateway on the fallback address, which remains 100%
feature-complete.

Eligibility is decided here, conservatively, per route rule:

- backend schema must be OpenAI (the front schema — no translation),
  `url` must be plain http with an explicit or default port, no picker
  endpoint pools, no body mutations, no model override;
- auth must be static-header-expressible (none / APIKey / AzureAPIKey /
  AnthropicAPIKey); `file:` keys become `value_file` entries the core
  re-reads on mtime change (credential-rotator compatible);
- the rule may match on model exact/prefix only (arbitrary header
  matchers stay in Python);
- the config must have no global/route request costs and no quotas —
  those need per-request token accounting that lives in Python.

Order matters: the gateway evaluates rules first-match-wins, so only the
longest PREFIX of the rule sequence that is fully native-eligible is
compiled. The first non-eligible rule stops compilation — a model that
would have matched it can never be shadowed by a later native rule; the
core simply finds no match and falls back.

Native-path requests trade per-request observability (OTel spans, token
metrics, access-log usage fields) for throughput — the same tradeoff as
fronting any L7 proxy. The core exposes its own counters at
``/aigw-core/stats``.
"""

from __future__ import annotations

import json
from typing import Any
from urllib.parse import urlsplit

from aigw_tpu_torch.config.model import (
    APISchemaName,
    AuthConfig,
    AuthKind,
    Backend,
    Config,
)

#: JSON POST endpoints the core may route natively (passthrough-safe).
NATIVE_ENDPOINTS = (
    "/v1/chat/completions",
    "/v1/completions",
    "/v1/embeddings",
)

_STATIC_AUTH_KINDS = (
    AuthKind.NONE,
    AuthKind.API_KEY,
    AuthKind.AZURE_API_KEY,
    AuthKind.ANTHROPIC_API_KEY,
)


class NotEligible(Exception):
    """Why a rule/backend can't go native (collected for the report)."""


def _auth_headers(auth: AuthConfig) -> list[dict[str, str]]:
    def entry(name: str, prefix: str, key: str) -> dict[str, str]:
        d: dict[str, str] = {"name": name, "prefix": prefix}
        if key.startswith("file:"):
            d["value_file"] = key[len("file:"):]
        else:
            d["value"] = key
        return d

    if auth.kind is AuthKind.NONE:
        return []
    if auth.kind is AuthKind.API_KEY:
        return [entry("authorization", "Bearer ", auth.api_key)]
    if auth.kind is AuthKind.AZURE_API_KEY:
        return [entry("api-key", "", auth.azure_api_key)]
    if auth.kind is AuthKind.ANTHROPIC_API_KEY:
        return [
            entry("x-api-key", "", auth.api_key),
            {"name": "anthropic-version", "prefix": "",
             "value": auth.anthropic_version},
        ]
    raise NotEligible(f"auth kind {auth.kind.value} needs request signing "
                      "or token refresh")


def _backend_entry(b: Backend, weight: int, priority: int) -> dict[str, Any]:
    if b.schema.name is not APISchemaName.OPENAI:
        raise NotEligible(f"backend {b.name!r}: schema "
                          f"{b.schema.name.value} needs translation")
    if b.endpoints:
        raise NotEligible(f"backend {b.name!r}: picker endpoint pool")
    if b.body_mutation.set or b.body_mutation.remove:
        raise NotEligible(f"backend {b.name!r}: body mutation")
    if b.model_name_override:
        raise NotEligible(f"backend {b.name!r}: model override")
    if b.auth.kind not in _STATIC_AUTH_KINDS:
        raise NotEligible(f"backend {b.name!r}: auth {b.auth.kind.value}")
    u = urlsplit(b.url)
    if u.scheme not in ("http", "https"):
        raise NotEligible(f"backend {b.name!r}: scheme {u.scheme or '??'}")
    tls = u.scheme == "https"
    if not u.hostname:
        raise NotEligible(f"backend {b.name!r}: no host in url")
    if u.path not in ("", "/"):
        # the core forwards the client path verbatim; a base-path prefix
        # would be silently dropped
        raise NotEligible(f"backend {b.name!r}: url path prefix "
                          f"{u.path!r}")
    if u.query or u.fragment:
        # same verbatim-path reason: ?api-version=... (Azure) would be
        # silently dropped by the core
        raise NotEligible(f"backend {b.name!r}: url carries query/fragment")
    if u.username or u.password:
        # the core dials hostname:port only; inline credentials would be
        # silently discarded and requests would reach the upstream unsigned
        raise NotEligible(f"backend {b.name!r}: url carries userinfo")
    entry: dict[str, Any] = {
        "name": b.name,
        "host": u.hostname,
        "port": u.port or (443 if tls else 80),
        "weight": weight,
        "priority": priority,
        "read_timeout_s": int(max(b.stream_idle_timeout, 1.0)),
    }
    if tls:
        # core dials TLS itself (dlopen'd libssl, verified, SNI =
        # hostname) — real external providers are native-eligible
        entry["tls"] = True
        entry["sni"] = u.hostname
    headers = _auth_headers(b.auth)
    if headers:
        entry["auth_headers"] = headers
    if b.header_mutation.set:
        entry["set_headers"] = [
            {"name": k, "value": v} for k, v in b.header_mutation.set
        ]
    if b.header_mutation.remove:
        entry["remove_headers"] = list(b.header_mutation.remove)
    return entry


def compile_core_config(
    cfg: Config,
    *,
    listen_host: str = "0.0.0.0",
    listen_port: int = 1975,
    fallback_host: str = "127.0.0.1",
    fallback_port: int = 1976,
    access_log_path: str = "",
) -> tuple[dict[str, Any], list[str]]:
    """Returns (core_config_dict, skipped_reasons).

    ``skipped_reasons`` explains every rule that stays on the Python
    path — surfaced by the CLI so operators see exactly what the native
    core accelerates.
    """
    skipped: list[str] = []
    rules: list[dict[str, Any]] = []
    blocked = False

    if cfg.llm_request_costs:
        if access_log_path:
            # costs are computed post-hoc by the gateway's access-log
            # tailer (obs/native_spans.py make_cost_fn) from the usage
            # the core mines off the response tail — cost-bearing rules
            # can go native when the log pipe exists
            skipped.append(
                "note: global llm_request_costs computed post-hoc from "
                "the native access log (AIGW_CORE_ACCESS_LOG on the "
                "gateway)")
        else:
            skipped.append(
                "global llm_request_costs need the access-log pipe for "
                "post-hoc accounting — pass --access-log and set "
                "AIGW_CORE_ACCESS_LOG on the gateway (python path for "
                "all rules)")
            blocked = True
    if cfg.quotas:
        # quotas ENFORCE at admission time (429 before the upstream
        # call); post-hoc accounting can't do that, so quota-bearing
        # configs stay on the Python path by design
        skipped.append("quotas need request-time admission "
                       "(python path for all rules)")
        blocked = True

    for route in cfg.routes:
        if blocked:
            break
        if route.llm_request_costs:
            skipped.append(f"route {route.name!r}: route-level costs "
                           "(stops native compilation here)")
            break
        for rule in route.rules:
            label = rule.name or route.name
            try:
                if rule.headers:
                    raise NotEligible("header matchers beyond model")
                if not rule.models and not rule.model_prefixes:
                    raise NotEligible("catch-all rule (no model match)")
                # weight 0 = drained (the python router filters them the
                # same way); a rule with every backend drained can't go
                # native — let python produce its error semantics
                backends = [
                    _backend_entry(cfg.backend(ref.backend), ref.weight,
                                   ref.priority)
                    for ref in rule.backends if ref.weight > 0
                ]
                if not backends:
                    raise NotEligible("all backends drained (weight 0)")
            except NotEligible as e:
                # first non-eligible rule ends compilation: later rules
                # must not shadow it (first-match-wins order)
                skipped.append(f"rule {label!r}: {e} "
                               "(stops native compilation here)")
                blocked = True
                break
            base = {"backends": backends}
            if route.hostnames:
                base["hostnames"] = list(route.hostnames)
            for m in rule.models:
                rules.append({**base, "model_exact": m})
            for p in rule.model_prefixes:
                rules.append({**base, "model_prefix": p})

    core = {
        "listen_host": listen_host,
        "listen_port": listen_port,
        "fallback_host": fallback_host,
        "fallback_port": fallback_port,
        "endpoints": list(NATIVE_ENDPOINTS),
        "rules": rules,
    }
    if access_log_path:
        core["access_log_path"] = access_log_path
    return core, skipped


def write_core_config(path: str, core: dict[str, Any]) -> None:
    with open(path, "w") as f:
        json.dump(core, f, indent=1)
        f.write("\n")
