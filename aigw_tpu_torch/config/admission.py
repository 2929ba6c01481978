"""CRD admission validation (the port's copy of
``aigw_tpu/config/admission.py``): upstream's CEL and schema rules as
plain checks.

Upstream encodes apply-time invariants as CEL expressions and OpenAPI
constraints on its CRDs (api/v1beta1/*.go ``+kubebuilder`` markers).
Without an API server the same invariants run here, invoked by the
reconciling control plane (``config/controller.py``) before an object is
compiled: an invalid object is NotAccepted with the rule's message, as
an admission rejection would leave it. Every rule and message is the
reference's.
"""

from __future__ import annotations

from typing import Any

SUPPORTED_SCHEMAS = (
    "OpenAI", "Cohere", "AWSBedrock", "AzureOpenAI", "GCPVertexAI",
    "GCPAnthropic", "Anthropic",
)

#: BackendSecurityPolicy type → its configuration field
_BSP_FIELDS = {
    "APIKey": "apiKey",
    "AWSCredentials": "awsCredentials",
    "AzureAPIKey": "azureAPIKey",
    "AzureCredentials": "azureCredentials",
    "GCPCredentials": "gcpCredentials",
    "AnthropicAPIKey": "anthropicAPIKey",
}

_RESERVED_RULE_NAMES = {"route-not-found"}
_MAX_ROUTE_RULES = 15


def validate(obj: dict[str, Any]) -> list[str]:
    """Admission errors for one CRD object ([] = accepted)."""
    kind = obj.get("kind", "")
    spec = obj.get("spec") or {}
    if kind == "AIGatewayRoute":
        return _validate_route(spec)
    if kind == "AIServiceBackend":
        return _validate_backend(spec)
    if kind == "BackendSecurityPolicy":
        return _validate_bsp(spec)
    if kind == "MCPRoute":
        return _validate_mcp(spec)
    if kind == "QuotaPolicy":
        return _validate_quota(spec)
    return []


def _parse_duration(value: Any) -> float | None:
    """Gateway-API Duration ("1h2m3s500ms") → seconds, None if unparseable."""
    import re

    if not isinstance(value, str):
        return None
    m = re.fullmatch(
        r"(?:(\d+)h)?(?:(\d+)m)?(?:(\d+)s)?(?:(\d+)ms)?", value.strip())
    if not m or not any(m.groups()):
        return None
    h, mi, sec, ms = (int(g) if g else 0 for g in m.groups())
    return h * 3600 + mi * 60 + sec + ms / 1000.0


def _validate_parent_refs(spec: dict[str, Any]) -> list[str]:
    errors = []
    for ref in spec.get("parentRefs") or ():
        if (ref or {}).get("kind", "Gateway") != "Gateway":
            errors.append("spec.parentRefs: only Gateway is supported")
    return errors


def _validate_route(spec: dict[str, Any]) -> list[str]:
    errors = _validate_parent_refs(spec)
    rules = spec.get("rules") or ()
    if len(rules) > _MAX_ROUTE_RULES:
        errors.append(
            f"spec.rules: too many: {len(rules)}: must have at most "
            f"{_MAX_ROUTE_RULES} items")
    seen_names: set[str] = set()
    for i, rule in enumerate(rules):
        name = (rule or {}).get("name", "")
        if name:
            if name in _RESERVED_RULE_NAMES:
                errors.append(
                    f"spec.rules[{i}]: rule name {name} is reserved")
            elif name in seen_names:
                errors.append(
                    "spec.rules: rule name must be unique within the route")
            seen_names.add(name)
        pools = 0
        non_pools = 0
        for j, ref in enumerate(rule.get("backendRefs") or ()):
            group = (ref or {}).get("group")
            rkind = (ref or {}).get("kind")
            if (group is None) != (rkind is None):
                errors.append(
                    f"spec.rules[{i}].backendRefs[{j}]: group and kind "
                    "must be specified together")
                continue
            if group is None:
                non_pools += 1
                continue
            if rkind != "InferencePool" or \
                    group != "inference.networking.k8s.io":
                errors.append(
                    f"spec.rules[{i}].backendRefs[{j}]: only InferencePool "
                    "from inference.networking.k8s.io group is supported")
                continue
            pools += 1
        timeouts = rule.get("timeouts") or {}
        req_t = _parse_duration(timeouts.get("request"))
        be_t = _parse_duration(timeouts.get("backendRequest"))
        if req_t is not None and be_t is not None and be_t > req_t:
            errors.append(
                f"spec.rules[{i}].timeouts: backendRequest timeout cannot "
                "be longer than request timeout")
        if pools and non_pools:
            errors.append(
                f"spec.rules[{i}]: cannot mix InferencePool and "
                "AIServiceBackend references in the same rule")
        if pools > 1:
            errors.append(
                f"spec.rules[{i}]: only one InferencePool backend is "
                "allowed per rule")
    return errors


def _validate_backend(spec: dict[str, Any]) -> list[str]:
    errors = []
    schema_name = (spec.get("schema") or {}).get("name", "")
    if schema_name not in SUPPORTED_SCHEMAS:
        errors.append(
            f"spec.schema.name: unsupported value {schema_name!r}: "
            f"supported values: {', '.join(SUPPORTED_SCHEMAS)}")
    ref = spec.get("backendRef") or {}
    if ref and ref.get("kind", "Backend") != "Backend":
        errors.append(
            "spec.backendRef: BackendRef must be a Backend resource of "
            "Envoy Gateway")
    return errors


def _validate_bsp(spec: dict[str, Any]) -> list[str]:
    errors = []
    btype = spec.get("type", "")
    field = _BSP_FIELDS.get(btype)
    if field is None:
        errors.append(
            f"spec.type: unsupported value {btype!r}: supported values: "
            f"{', '.join(_BSP_FIELDS)}")
    else:
        others = [f for t, f in _BSP_FIELDS.items()
                  if f != field and spec.get(f) is not None]
        if spec.get(field) is None or others:
            errors.append(
                f"spec: when type is {btype}, only {field} field "
                "should be set")
    az = spec.get("azureCredentials")
    if az is not None:
        if not (az.get("clientID") or ""):
            errors.append(
                "spec.azureCredentials.clientID should be at least 1 "
                "chars long")
        if not (az.get("tenantID") or ""):
            errors.append(
                "spec.azureCredentials.tenantID should be at least 1 "
                "chars long")
        has_secret = az.get("clientSecretRef") is not None
        has_oidc = az.get("oidcExchangeToken") is not None
        if has_secret == has_oidc:
            errors.append(
                "spec.azureCredentials: exactly one of clientSecretRef or "
                "oidcExchangeToken must be specified")
    gcp = spec.get("gcpCredentials")
    if gcp is not None:
        wif = (gcp.get("workloadIdentityFederationConfig") is not None)
        cred_file = (gcp.get("credentialsFile") is not None)
        if wif and cred_file:
            errors.append(
                "spec.gcpCredentials: at most one of credentialsFile or "
                "workloadIdentityFederationConfig may be specified")
        if not wif and not cred_file:
            errors.append(
                "spec.gcpCredentials: exactly one of "
                "GCPWorkloadIdentityFederationConfig or GCPCredentialsFile "
                "must be specified")
    target_groups = {
        "AIServiceBackend": "aigateway.envoyproxy.io",
        "InferencePool": "inference.networking.k8s.io",
    }
    for i, ref in enumerate(spec.get("targetRefs") or ()):
        rkind = (ref or {}).get("kind", "AIServiceBackend")
        want_group = target_groups.get(rkind)
        group = (ref or {}).get("group", want_group)
        if want_group is None or group != want_group:
            errors.append(
                f"spec.targetRefs[{i}]: targetRefs must reference "
                "AIServiceBackend or InferencePool resources")
    return errors


def _validate_mcp_tool_selector(sel: dict[str, Any],
                                path: str) -> list[str]:
    errors = []
    keys = [k for k in ("include", "includeRegex", "exclude",
                        "excludeRegex") if sel.get(k)]
    if not keys:
        errors.append(
            f"{path}: at least one of include, includeRegex, exclude, or "
            "excludeRegex must be specified")
    if sel.get("include") and sel.get("includeRegex"):
        errors.append(
            f"{path}: include and includeRegex are mutually exclusive")
    if sel.get("exclude") and sel.get("excludeRegex"):
        errors.append(
            f"{path}: exclude and excludeRegex are mutually exclusive")
    return errors


_MCP_REF_GROUPS = {"", "multicluster.x-k8s.io", "gateway.envoyproxy.io"}
_MCP_REF_KINDS = {"Service", "ServiceImport", "Backend"}


def _validate_mcp(spec: dict[str, Any]) -> list[str]:
    errors = _validate_parent_refs(spec)
    if spec.get("backendRef") is not None:
        errors.append(
            "spec: BackendRefs must be used, backendRef is not supported")
    if not (spec.get("backendRefs") or ()):
        errors.append("spec: backendRef or backendRefs needs to be set")
    seen: set[str] = set()
    for i, ref in enumerate(spec.get("backendRefs") or ()):
        group = (ref or {}).get("group", "") or ""
        rkind = (ref or {}).get("kind", "Service")
        if group not in _MCP_REF_GROUPS:
            errors.append(
                f"spec.backendRefs[{i}]: BackendRefs only supports Core, "
                "multicluster.x-k8s.io, and gateway.envoyproxy.io groups")
        elif rkind not in _MCP_REF_KINDS:
            errors.append(
                f"spec.backendRefs[{i}]: BackendRefs only supports "
                "Service, ServiceImport, and Backend kind")
        name = (ref or {}).get("name", "")
        if name in seen:
            errors.append(
                "spec.backendRefs: all backendRefs names must be unique")
        seen.add(name)
        sel = ref.get("toolSelector")
        if sel is not None:
            errors.extend(_validate_mcp_tool_selector(
                sel, f"spec.backendRefs[{i}].toolSelector"))
        api_key = ((ref.get("securityPolicy") or {}).get("apiKey"))
        if api_key is not None:
            has_secret = api_key.get("secretRef") is not None
            has_inline = api_key.get("inline") is not None
            if has_secret == has_inline:
                errors.append(
                    f"spec.backendRefs[{i}].securityPolicy.apiKey: exactly "
                    "one of secretRef or inline must be set")
            if api_key.get("header") and api_key.get("queryParam"):
                errors.append(
                    f"spec.backendRefs[{i}].securityPolicy.apiKey: only "
                    "one of header or queryParam can be set")
    policy = spec.get("securityPolicy") or {}
    oauth = policy.get("oauth")
    if oauth is not None:
        jwks = oauth.get("jwks") or {}
        has_remote = jwks.get("remoteJWKS") is not None
        has_local = jwks.get("localJWKS") is not None
        if not has_remote and not has_local:
            errors.append(
                "spec.securityPolicy.oauth.jwks: either remoteJWKS or "
                "localJWKS must be specified")
        if has_remote and has_local:
            errors.append(
                "spec.securityPolicy.oauth.jwks: remoteJWKS and localJWKS "
                "cannot both be specified")
    for i, rule in enumerate(
            (policy.get("authorization") or {}).get("rules") or ()):
        jwt = ((rule or {}).get("source") or {}).get("jwt")
        if jwt is None:
            continue
        if oauth is None:
            errors.append(
                "spec.securityPolicy: oauth must be configured when any "
                "authorization rule uses a jwt source")
        claims = jwt.get("claims") or ()
        if not claims and not (jwt.get("scopes") or ()):
            errors.append(
                f"spec.securityPolicy.authorization.rules[{i}].source.jwt: "
                "either scopes or claims must be specified")
        for claim in claims:
            if (claim or {}).get("name") == "scope":
                errors.append(
                    f"spec.securityPolicy.authorization.rules[{i}].source"
                    ".jwt.claims: 'scope' claim name is reserved for "
                    "OAuth scopes")
    return errors


def _validate_quota(spec: dict[str, Any]) -> list[str]:
    errors = []
    for i, ref in enumerate(spec.get("targetRefs") or ()):
        if (ref or {}).get("kind", "AIServiceBackend") != \
                "AIServiceBackend":
            errors.append(
                f"spec.targetRefs[{i}]: targetRefs must reference "
                "AIServiceBackend resources")
    for i, rule in enumerate(spec.get("rules") or ()):
        for j, m in enumerate((rule or {}).get("matches") or ()):
            if not any((m or {}).get(k) for k in (
                    "headers", "methods", "path", "sourceCIDR",
                    "queryParams")):
                errors.append(
                    f"spec.rules[{i}].matches[{j}]: at least one of "
                    "headers, methods, path, sourceCIDR or queryParams "
                    "must be specified")
    return errors
