"""Kind-aware loader for Kubernetes CRD manifests (the port's copy of
``aigw_tpu/config/crd.py``).

Compiles the upstream project's example manifests, unchanged, into the
native config dict that ``Config.parse`` consumes: the role upstream's
``aigw translate`` plays by running its controllers against a fake
Kubernetes client (cmd/aigw/translate.go:114-392), collapsed into a
direct compilation because this gateway has no Kubernetes dependency.

Manifest text is read by ``load_documents``: through ``pyyaml`` where it
is installed (``yaml.safe_load_all``, as the reference reads it), else as
JSON text, which is YAML too, so the objects are the ones pyyaml gives. A
top-level list of mappings stands for a stream of documents in both
readers.

Kinds handled:
- ``AIGatewayRoute`` (v1alpha1/v1beta1) → routes + llm_request_costs
  (ai_gateway_route.go:37)
- ``AIServiceBackend`` → backend schema/timeouts (ai_service_backend.go:28)
- ``Backend`` (gateway.envoyproxy.io) → backend address(es)
- ``BackendSecurityPolicy`` → backend auth, secrets resolved from co-bundled
  ``Secret`` objects with ``${ENV}`` substitution (backendsecurity_policy.go)
- ``BackendTLSPolicy`` → https scheme
- ``InferencePool`` → picker-driven backend (x-gateway-destination-endpoint
  contract, internalapi.go:76)
- ``BackendTrafficPolicy`` rateLimit → token quotas (QuotaPolicy-style
  descriptor rules)
- ``QuotaPolicy`` → token quotas with their cost metrics
- ``MCPRoute`` → MCP proxy config (mcp_route.go:25)
- ``GatewayConfig`` → global llm_request_costs (gateway_config.go:40)

Infrastructure kinds (GatewayClass, Gateway, EnvoyProxy, Deployment,
Service, ClientTrafficPolicy, HTTPRoute, …) are recognized and skipped —
the native data plane subsumes their roles.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
from typing import Any

from aigw_tpu_torch.config.model import MODEL_NAME_HEADER, ConfigError

logger = logging.getLogger(__name__)

#: CRD kinds that carry gateway semantics we compile
_HANDLED = {
    "AIGatewayRoute", "AIServiceBackend", "BackendSecurityPolicy",
    "Backend", "BackendTLSPolicy", "InferencePool", "BackendTrafficPolicy",
    "MCPRoute", "GatewayConfig", "QuotaPolicy", "Secret", "Gateway",
}
#: infra kinds silently skipped
_SKIPPED = {
    "GatewayClass", "EnvoyProxy", "Deployment", "Service",
    "ClientTrafficPolicy", "HTTPRoute", "HTTPRouteFilter", "ServiceAccount",
    "ConfigMap", "Role", "RoleBinding", "ClusterRole", "ClusterRoleBinding",
    "InferenceObjective", "InferenceModel", "Namespace", "Job",
    "SecurityPolicy", "EnvoyExtensionPolicy",
    # consumed by config.refgrant (cross-namespace authorization), not
    # compiled into the serving config itself
    "ReferenceGrant",
}

MODEL_HEADER = "x-ai-eg-model"


def looks_like_crd(docs: list[dict[str, Any]]) -> bool:
    """True when the YAML stream contains K8s-style objects."""
    return any(
        isinstance(d, dict) and "kind" in d and "apiVersion" in d
        for d in docs
    )


def load_documents(text: str, where: str = "manifest") -> list[Any]:
    """Every document of a YAML stream: ``yaml.safe_load_all`` where
    pyyaml is installed; without it, the text must be one JSON value
    (JSON is YAML), else ``ConfigError`` names pyyaml. One document that
    is a list of mappings is taken as the stream of those mappings."""
    try:
        import yaml
    except ImportError:
        yaml = None
    if yaml is not None:
        docs = list(yaml.safe_load_all(text))
    elif not text.strip():
        docs = []
    else:
        try:
            docs = [json.loads(text)]
        except json.JSONDecodeError:
            raise ConfigError(
                f"{where} is YAML and pyyaml is not installed: install "
                "pyyaml or write it as JSON text") from None
    if len(docs) == 1 and isinstance(docs[0], list) and docs[0] and all(
            isinstance(d, dict) for d in docs[0]):
        return list(docs[0])
    return docs


def load_crd_documents(text: str) -> list[dict[str, Any]]:
    return [d for d in load_documents(text) if isinstance(d, dict)]


def _name(obj: dict[str, Any]) -> str:
    return str((obj.get("metadata") or {}).get("name", ""))


def _duration_seconds(v: Any, default: float) -> float:
    """'120s' / '3m' / '1h' / '100ms' → seconds."""
    if v is None:
        return default
    if isinstance(v, (int, float)):
        return float(v)
    m = re.fullmatch(r"(\d+(?:\.\d+)?)(ms|s|m|h)?", str(v).strip())
    if not m:
        raise ConfigError(f"unparseable duration {v!r}")
    n = float(m.group(1))
    return n * {"ms": 1e-3, "s": 1.0, "m": 60.0, "h": 3600.0,
                None: 1.0}[m.group(2)]


def _env_substitute(s: str) -> str:
    """Expand ``${VAR}`` from the environment (the reference's ``aigw run``
    does the same substitution over Secret stringData, run.go:154-159)."""
    return re.sub(
        r"\$\{(\w+)\}", lambda m: os.environ.get(m.group(1), ""), s)


class _Secrets:
    def __init__(self, objs: list[dict[str, Any]]):
        self._by_name: dict[str, dict[str, str]] = {}
        for o in objs:
            data: dict[str, str] = {}
            for k, v in (o.get("stringData") or {}).items():
                data[k] = _env_substitute(str(v))
            for k, v in (o.get("data") or {}).items():
                import base64

                try:
                    data.setdefault(
                        k, base64.b64decode(str(v)).decode("utf-8"))
                except Exception:
                    pass
            self._by_name[_name(o)] = data

    def get(self, name: str, key: str) -> str:
        return self._by_name.get(name, {}).get(key, "")


def _backend_url(backend_obj: dict[str, Any], tls: bool) -> tuple[str, list]:
    """Envoy Gateway Backend endpoints → (url, picker endpoints)."""
    scheme = "https" if tls else "http"
    addrs: list[str] = []
    for ep in (backend_obj.get("spec") or {}).get("endpoints", ()):
        if "fqdn" in ep:
            host = ep["fqdn"].get("hostname", "")
            port = int(ep["fqdn"].get("port", 80))
        elif "ip" in ep:
            host = ep["ip"].get("address", "")
            port = int(ep["ip"].get("port", 80))
        elif "unix" in ep:
            continue
        else:
            continue
        if port == 443:
            scheme = "https"
        addrs.append(f"{host}:{port}")
    if not addrs:
        return "", []
    if len(addrs) == 1:
        return f"{scheme}://{addrs[0]}", []
    return "", addrs  # replica pool → endpoint picker


def _auth_from_bsp(spec: dict[str, Any], secrets: _Secrets) -> dict[str, Any]:
    kind = spec.get("type", "")
    if kind == "APIKey":
        ref = ((spec.get("apiKey") or {}).get("secretRef") or {})
        return {"kind": "APIKey",
                "api_key": secrets.get(ref.get("name", ""), "apiKey")}
    if kind == "AnthropicAPIKey":
        ref = ((spec.get("anthropicAPIKey") or {}).get("secretRef") or {})
        out: dict[str, Any] = {
            "kind": "AnthropicAPIKey",
            "api_key": secrets.get(ref.get("name", ""), "apiKey")}
        if (spec.get("anthropicAPIKey") or {}).get("apiVersion"):
            out["anthropic_version"] = spec["anthropicAPIKey"]["apiVersion"]
        return out
    if kind == "AzureAPIKey":
        ref = ((spec.get("azureAPIKey") or {}).get("secretRef") or {})
        return {"kind": "AzureAPIKey",
                "azure_api_key": secrets.get(ref.get("name", ""), "apiKey")}
    if kind == "AzureCredentials":
        # OIDC client-credentials exchange happens at runtime (oidc.py);
        # statically we map the token secret when present
        ref = (((spec.get("azureCredentials") or {}).get(
            "clientSecretRef")) or {})
        return {"kind": "AzureToken",
                "azure_access_token": secrets.get(ref.get("name", ""),
                                                  "client-secret")}
    if kind == "AWSCredentials":
        aws = spec.get("awsCredentials") or {}
        out = {"kind": "AWSSigV4", "aws_region": aws.get("region", "")}
        ref = ((aws.get("credentialsFile") or {}).get("secretRef") or {})
        creds = secrets.get(ref.get("name", ""), "credentials")
        if creds:
            # AWS shared-credentials INI (the rotators write this format)
            for line in creds.splitlines():
                line = line.strip()
                if line.startswith("aws_access_key_id"):
                    out["aws_access_key_id"] = line.split("=", 1)[1].strip()
                elif line.startswith("aws_secret_access_key"):
                    out["aws_secret_access_key"] = \
                        line.split("=", 1)[1].strip()
                elif line.startswith("aws_session_token"):
                    out["aws_session_token"] = line.split("=", 1)[1].strip()
        return out
    if kind == "GCPCredentials":
        gcp = spec.get("gcpCredentials") or {}
        return {
            "kind": "GCPToken",
            "gcp_project": gcp.get("projectName", ""),
            "gcp_region": gcp.get("region", ""),
        }
    raise ConfigError(f"unsupported BackendSecurityPolicy type {kind!r}")


def _compile_route_rules(route_obj: dict[str, Any]) -> list[dict[str, Any]]:
    """AIGatewayRoute rules → native route rules. A CRD rule's ``matches``
    entries are OR'd (each is an AND of header matches) — expanded into
    one native rule per match."""
    out: list[dict[str, Any]] = []
    spec = route_obj.get("spec") or {}
    route_name = _name(route_obj)
    for ri, rule in enumerate(spec.get("rules", ())):
        backends = []
        for ref in rule.get("backendRefs", ()):
            b: dict[str, Any] = {"backend": ref.get("name", "")}
            if ref.get("weight") is not None:
                b["weight"] = int(ref["weight"])
            if ref.get("priority") is not None:
                b["priority"] = int(ref["priority"])
            backends.append(b)
        if not backends:
            continue
        matches = rule.get("matches") or [{}]
        timeout = (rule.get("timeouts") or {}).get("request")
        for mi, match in enumerate(matches):
            models: list[str] = []
            headers: list[dict[str, Any]] = []
            for h in match.get("headers", ()):
                htype = h.get("type", "Exact")
                name = str(h.get("name", "")).lower()
                value = str(h.get("value", ""))
                if name == MODEL_HEADER and htype == "Exact":
                    models.append(value)
                elif htype == "Exact":
                    headers.append({"name": name, "value": value})
                elif htype == "RegularExpression":
                    if name == MODEL_HEADER:
                        if value in (".*", "^.*$"):
                            pass  # match-all model: no constraint
                        else:
                            # the native gateway stamps the model under its
                            # own header name (MODEL_NAME_HEADER) — rewrite
                            # the CRD's x-ai-eg-model to match it
                            headers.append({"name": MODEL_NAME_HEADER,
                                            "value": value, "regex": True})
                    else:
                        headers.append({"name": name, "value": value,
                                        "regex": True})
                else:
                    raise ConfigError(
                        f"route {route_name!r}: unsupported header match "
                        f"type {htype!r}")
            native: dict[str, Any] = {
                "backends": backends,
                "name": f"{route_name}/rule{ri}"
                        + (f"/m{mi}" if len(matches) > 1 else ""),
            }
            if models:
                native["models"] = models
            if headers:
                native["headers"] = headers
            if timeout is not None:
                native["_request_timeout"] = _duration_seconds(timeout, 120.0)
            out.append(native)
    return out


def _costs_of(spec: dict[str, Any], key: str) -> list[dict[str, Any]]:
    out = []
    for c in spec.get(key, ()) or ():
        cost: dict[str, Any] = {
            "metadata_key": c.get("metadataKey", ""),
            "type": c.get("type", "TotalToken"),
        }
        if cost["type"] == "CEL":
            # reference llmcostcel CEL → native Expression engine
            cost["type"] = "Expression"
            cost["expression"] = c.get("cel", "")
        out.append(cost)
    return out


_UNIT_SECONDS = {"Second": 1, "Minute": 60, "Hour": 3600, "Day": 86400}

#: QuotaPolicy window enum (quotapolicies CRD: duration 1s|1m|1h|1d)
_QP_DURATION = {"1s": 1, "1m": 60, "1h": 3600, "1d": 86400}


def _quotas_from_quota_policy(
    objs: list[dict[str, Any]],
) -> tuple[list[dict[str, Any]], list[dict[str, Any]]]:
    """QuotaPolicy CRD objects → (native quota rules, synthesized
    llm_request_costs).

    Mapping (quotapolicies CRD schema, api/v1alpha1):
    - targetRefs (AIServiceBackend) → per-rule backend scope
    - serviceQuota.quota → one rule per target, any model
    - perModelQuotas[].quota.defaultBucket → model-scoped rule
    - perModelQuotas[].quota.bucketRules[] → model-scoped rules keyed
      by the first Distinct header selector (client buckets); rules in
      shadowMode are skipped (observe-only)
    - costExpression → a synthesized Expression cost metric the rule
      draws down ("total_tokens" default → shared TotalToken metric);
      name/namespace-alphabetical precedence for duplicate model keys
      follows the CRD's own documented tie-break."""
    quotas: list[dict[str, Any]] = []
    costs: dict[str, dict[str, Any]] = {}

    def cost_key(expr: str | None) -> str:
        if not expr:
            key = "aigw_qp_total_tokens"
            costs.setdefault(key, {
                "metadata_key": key, "type": "TotalToken"})
            return key
        key = "aigw_qp_cost_" + hashlib.sha256(
            expr.encode()).hexdigest()[:10]
        costs.setdefault(key, {
            "metadata_key": key, "type": "Expression",
            "expression": expr})
        return key

    def client_header(rule: dict[str, Any]) -> str:
        for sel in rule.get("clientSelectors") or ():
            for h in (sel or {}).get("headers") or ():
                if h.get("type") == "Distinct" and h.get("name"):
                    return str(h["name"]).lower()
        return ""

    #: (model, backend) pairs already claimed by an alphabetically
    #: earlier policy — the CRD's documented tie-break ("the policy
    #: whose namespace/name is alphabetically first takes precedence")
    claimed: set[tuple[str, str]] = set()
    for o in sorted(objs, key=lambda x: (_namespace_of(x), _name(x))):
        ns = _namespace_of(o)
        # namespace-qualified identity: two same-named policies in
        # different namespaces must not merge into one budget (rule
        # names key the limiter's buckets)
        pname = _name(o) if ns == "default" else f"{ns}/{_name(o)}"
        spec = o.get("spec") or {}
        targets = [str(r.get("name", "")) for r in
                   (spec.get("targetRefs") or ())
                   if r.get("kind") in (None, "AIServiceBackend")
                   and r.get("name")]
        if not targets:
            continue
        sq = spec.get("serviceQuota") or {}
        sq_quota = sq.get("quota") or {}
        if sq_quota.get("limit"):
            key = cost_key(sq.get("costExpression"))
            for t in targets:
                quotas.append({
                    "name": f"{pname}/service/{t}",
                    "metadata_key": key,
                    "limit": int(sq_quota["limit"]),
                    "window_seconds": _QP_DURATION.get(
                        sq_quota.get("duration", "1h"), 3600),
                    "backend": t,
                })
        for pm in spec.get("perModelQuotas") or ():
            model = str(pm.get("modelName", "") or "")
            q = pm.get("quota") or {}
            live_targets = [t for t in targets
                            if (model, t) not in claimed]
            if not live_targets:
                continue  # a preceding policy owns this (model, backend)
            buckets: list[tuple[str, dict[str, Any], str]] = []
            db = q.get("defaultBucket") or {}
            if db.get("limit"):
                buckets.append(("default", db, ""))
            for j, br in enumerate(q.get("bucketRules") or ()):
                if br.get("shadowMode"):
                    continue  # observe-only: never rejects
                brq = (br or {}).get("quota") or {}
                if brq.get("limit"):
                    buckets.append((f"bucket{j}", brq,
                                    client_header(br)))
            if not buckets:
                # a shadow-only / limit-less entry enforces nothing and
                # must not claim the (model, backend) pair away from an
                # alphabetically later policy with a real limit
                continue
            claimed.update((model, t) for t in live_targets)
            key = cost_key(q.get("costExpression"))
            for label, bq, hdr in buckets:
                for t in live_targets:
                    rule = {
                        "name": f"{pname}/{model}/{label}/{t}",
                        "metadata_key": key,
                        "limit": int(bq["limit"]),
                        "window_seconds": _QP_DURATION.get(
                            bq.get("duration", "1h"), 3600),
                        "model": model,
                        "backend": t,
                        # CRD "Shared" mode: default bucket + bucket
                        # rules of one per-model entry charge together
                        # and allow while ANY has headroom
                        "shared_group": f"{pname}/{model}/{t}",
                    }
                    if hdr:
                        rule["client_key_header"] = hdr
                    quotas.append(rule)
    return quotas, list(costs.values())


def _namespace_of(obj: dict[str, Any]) -> str:
    return (obj.get("metadata") or {}).get("namespace") or "default"


def _quotas_from_btp(objs: list[dict[str, Any]]) -> list[dict[str, Any]]:
    """BackendTrafficPolicy global rate-limit rules whose response cost
    reads io.envoy.ai_gateway metadata → native token quotas."""
    quotas: list[dict[str, Any]] = []
    for o in objs:
        rl = ((o.get("spec") or {}).get("rateLimit") or {})
        for i, rule in enumerate((rl.get("global") or {}).get("rules", ())):
            meta = (((rule.get("cost") or {}).get("response") or {})
                    .get("metadata") or {})
            if meta.get("namespace") not in ("io.envoy.ai_gateway", None) \
                    or not meta.get("key"):
                continue
            limit = rule.get("limit") or {}
            window = _UNIT_SECONDS.get(limit.get("unit", "Hour"), 3600)
            q: dict[str, Any] = {
                "name": f"{_name(o)}/rule{i}",
                "metadata_key": meta["key"],
                "limit": int(limit.get("requests", 0)),
                "window_seconds": window,
            }
            for sel in rule.get("clientSelectors", ()):
                for h in sel.get("headers", ()):
                    if h.get("type") == "Distinct" and h.get("name"):
                        q["client_key_header"] = str(h["name"]).lower()
            quotas.append(q)
    return quotas


def _mcp_config(mcp_routes: list[dict[str, Any]],
                backends: dict[str, dict[str, Any]],
                tls_targets: set[str],
                secrets: _Secrets) -> dict[str, Any] | None:
    if not mcp_routes:
        return None
    out_backends: list[dict[str, Any]] = []
    path = "/mcp"
    for route in mcp_routes:
        spec = route.get("spec") or {}
        path = spec.get("path", path) or path
        for ref in spec.get("backendRefs", ()):
            name = ref.get("name", "")
            bobj = backends.get(name)
            if bobj is None:
                raise ConfigError(
                    f"MCPRoute references unknown Backend {name!r}")
            url, pool = _backend_url(bobj, name in tls_targets)
            if not url and pool:
                url = f"http://{pool[0]}"
            b: dict[str, Any] = {
                "name": name,
                "url": url + str(ref.get("path", "") or ""),
            }
            sel = ref.get("toolSelector") or {}
            include = list(sel.get("include", ()) or ())
            include_regex = list(sel.get("includeRegex", ()) or ())
            if include or include_regex:
                tf: dict[str, Any] = {}
                if include:
                    tf["include"] = include
                if include_regex:
                    tf["include_regex"] = include_regex
                b["tool_filter"] = tf
            sp = ref.get("securityPolicy") or {}
            key_ref = ((sp.get("apiKey") or {}).get("secretRef") or {})
            if key_ref.get("name"):
                key = secrets.get(key_ref["name"], "apiKey") or \
                    secrets.get(key_ref["name"], "token")
                if key:
                    b["headers"] = [{"name": "authorization",
                                     "value": f"Bearer {key}"}]
            out_backends.append(b)
    return {"backends": out_backends, "path": path}


def compile_crd_objects(docs: list[dict[str, Any]]) -> dict[str, Any]:
    """K8s CRD objects → native config dict (feed to ``Config.parse``)."""
    by_kind: dict[str, list[dict[str, Any]]] = {}
    for d in docs:
        kind = d.get("kind", "")
        if kind in _HANDLED or kind in _SKIPPED:
            by_kind.setdefault(kind, []).append(d)
        else:
            logger.warning("ignoring unrecognized kind %r", kind)

    secrets = _Secrets(by_kind.get("Secret", []))
    eg_backends = {_name(o): o for o in by_kind.get("Backend", [])}
    tls_targets: set[str] = set()
    for o in by_kind.get("BackendTLSPolicy", []):
        for ref in (o.get("spec") or {}).get("targetRefs", ()):
            tls_targets.add(ref.get("name", ""))

    # BSPs indexed by the AIServiceBackend they target
    bsp_by_backend: dict[str, dict[str, Any]] = {}
    for o in by_kind.get("BackendSecurityPolicy", []):
        spec = o.get("spec") or {}
        for ref in spec.get("targetRefs", ()):
            if ref.get("kind", "AIServiceBackend") == "AIServiceBackend":
                bsp_by_backend[ref.get("name", "")] = spec

    pools = {_name(o): o for o in by_kind.get("InferencePool", [])}

    backends: list[dict[str, Any]] = []
    seen: set[str] = set()
    for o in by_kind.get("AIServiceBackend", []):
        name = _name(o)
        spec = o.get("spec") or {}
        schema = spec.get("schema") or {}
        native: dict[str, Any] = {
            "name": name,
            "schema": ({"name": schema.get("name", "OpenAI"),
                        "version": schema["version"]}
                       if schema.get("version")
                       else schema.get("name", "OpenAI")),
        }
        ref_name = (spec.get("backendRef") or {}).get("name", name)
        bobj = eg_backends.get(ref_name)
        if bobj is not None:
            tls = ref_name in tls_targets
            url, pool_eps = _backend_url(bobj, tls)
            if url:
                native["url"] = url
            elif pool_eps:
                native["endpoints"] = pool_eps
        timeout = (spec.get("timeouts") or {}).get("request")
        if timeout is not None:
            native["request_timeout"] = _duration_seconds(timeout, 120.0)
        if name in bsp_by_backend:
            native["auth"] = _auth_from_bsp(bsp_by_backend[name], secrets)
        backends.append(native)
        seen.add(name)

    # InferencePool backends: no static address — replicas are picked at
    # request time (the reference resolves pods by selector + EPP; natively
    # the x-gateway-destination-endpoint header or a configured pool drives
    # the picker)
    for name, pool in pools.items():
        if name in seen:
            continue
        backends.append({"name": name, "schema": "OpenAI"})
        seen.add(name)

    routes: list[dict[str, Any]] = []
    costs: list[dict[str, Any]] = []
    models: list[str] = []
    for o in by_kind.get("AIGatewayRoute", []):
        rules = _compile_route_rules(o)
        # referenced-but-undeclared backends (e.g. InferencePool refs by
        # bare name) must exist
        for rule in rules:
            for b in rule["backends"]:
                if b["backend"] not in seen:
                    backends.append({"name": b["backend"],
                                     "schema": "OpenAI"})
                    seen.add(b["backend"])
            models.extend(rule.get("models", ()))
        # per-rule timeouts land on the referenced backends
        for rule in rules:
            t = rule.pop("_request_timeout", None)
            if t is not None:
                for b in rule["backends"]:
                    for nb in backends:
                        if nb["name"] == b["backend"]:
                            nb.setdefault("request_timeout", t)
        routes.append({"name": _name(o), "rules": rules})
        costs.extend(_costs_of(o.get("spec") or {}, "llmRequestCosts"))

    for o in by_kind.get("GatewayConfig", []):
        costs.extend(_costs_of(o.get("spec") or {}, "globalLLMRequestCosts"))

    # de-duplicate costs by metadata key (route-level + global may repeat)
    uniq_costs: list[dict[str, Any]] = []
    cost_keys: set[str] = set()
    for c in costs:
        if c["metadata_key"] and c["metadata_key"] not in cost_keys:
            cost_keys.add(c["metadata_key"])
            uniq_costs.append(c)

    out: dict[str, Any] = {
        "version": "v1",
        "backends": backends,
        "routes": routes,
    }
    uniq_models = sorted(set(m for m in models if m))
    if uniq_models:
        out["models"] = uniq_models
    if uniq_costs:
        out["llm_request_costs"] = uniq_costs
    quotas = _quotas_from_btp(by_kind.get("BackendTrafficPolicy", []))
    qp_quotas, qp_costs = _quotas_from_quota_policy(
        by_kind.get("QuotaPolicy", []))
    quotas += qp_quotas
    if qp_costs:
        have = {c.get("metadata_key") for c in
                out.get("llm_request_costs", ())}
        out.setdefault("llm_request_costs", []).extend(
            c for c in qp_costs if c["metadata_key"] not in have)
    if quotas:
        out["quotas"] = quotas
    mcp = _mcp_config(by_kind.get("MCPRoute", []), eg_backends,
                      tls_targets, secrets)
    if mcp:
        out["mcp"] = mcp
    return out


def load_crd_yaml(text: str) -> dict[str, Any]:
    return compile_crd_objects(load_crd_documents(text))
