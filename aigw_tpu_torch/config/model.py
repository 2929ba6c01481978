"""Typed gateway configuration model (the port's copy of
``aigw_tpu/config/model.py``).

The declarative model a user writes (JSON, or YAML where ``pyyaml`` is
installed) and the gateway consumes: backends of every provider schema
with their upstream ``auth``, serving pools with a pool's fleet
``controller``, gateway-driven ``migration`` and token ``quotas``, and the
MCP proxy's ``mcp`` block (kept raw, parsed by ``aigw_tpu_torch.mcp``).
Kubernetes CRD manifests are compiled into it by ``config/crd.py``.
It is deliberately decoupled from any orchestrator (the reference makes the
same choice for its data-plane config: filterapi/filterconfig.go:6-12).

Shape parity with the reference:

- ``Config``            ≈ filterapi.Config          (filterconfig.go:25)
- ``Backend``           ≈ filterapi.Backend + AIServiceBackend CRD
                          (api/v1alpha1/ai_service_backend.go:28)
- ``Route``/``RouteRule``≈ AIGatewayRoute CRD rules  (ai_gateway_route.go:216)
- ``RuleBackendRef``    ≈ AIGatewayRouteRuleBackendRef weight/priority
                          (ai_gateway_route.go:377-397)
- ``LLMRequestCost``    ≈ filterapi.LLMRequestCost   (shared_types.go:103-162)
- ``APISchema``         ≈ VersionedAPISchema         (shared_types.go:15-74)
- ``AuthConfig``        ≈ BackendSecurityPolicy CRD  (backendsecurity_policy.go:37)
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
import json
from dataclasses import dataclass, field
from typing import Any

# Header used to carry the extracted model name from the route-selection
# phase into route matching — the same role as the reference's
# ``x-ai-eg-model`` (api/v1alpha1/shared_types.go:160-162).
MODEL_NAME_HEADER = "x-aigw-model"
# Original path of the request before backend-specific rewrites
# (reference internalapi.go `x-ai-eg-original-path`).
ORIGINAL_PATH_HEADER = "x-aigw-original-path"
# Internal per-request id linking the route phase to the upstream phase
# (reference `x-ai-eg-internal-req-id`, extproc/server.go).
INTERNAL_REQUEST_ID_HEADER = "x-aigw-internal-req-id"
# Endpoint-picker selected destination (reference
# `x-gateway-destination-endpoint`, internalapi.go:76).
DESTINATION_ENDPOINT_HEADER = "x-gateway-destination-endpoint"

# Config schema version. Configs with a different version are rejected at
# load time — the same rolling-upgrade gate as the reference
# (filterapi/filterconfig.go:26-31).
CONFIG_VERSION = "v1"


class ConfigError(ValueError):
    """Raised for invalid gateway configuration."""


class APISchemaName(str, enum.Enum):
    """Supported provider API schemas (reference shared_types.go:30-74)."""

    OPENAI = "OpenAI"
    ANTHROPIC = "Anthropic"
    AWS_BEDROCK = "AWSBedrock"
    AWS_ANTHROPIC = "AWSAnthropic"
    AZURE_OPENAI = "AzureOpenAI"
    GCP_VERTEX_AI = "GCPVertexAI"
    GCP_ANTHROPIC = "GCPAnthropic"
    COHERE = "Cohere"
    # The in-tree serving replica. Speaks the OpenAI surface natively
    # plus engine-specific extensions (KV-occupancy telemetry headers).
    TPUSERVE = "TPUServe"


@dataclass(frozen=True)
class APISchema:
    """A schema name plus optional version (e.g. OpenAI "v1")."""

    name: APISchemaName
    version: str = ""

    @staticmethod
    def parse(value: Any) -> "APISchema":
        if isinstance(value, str):
            return APISchema(name=APISchemaName(value))
        if isinstance(value, dict):
            return APISchema(
                name=APISchemaName(value["name"]), version=value.get("version", "")
            )
        raise ConfigError(f"invalid APISchema: {value!r}")

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {"name": self.name.value}
        if self.version:
            d["version"] = self.version
        return d


class AuthKind(str, enum.Enum):
    """Upstream credential kinds (upstream backendauth/auth.go)."""

    NONE = "None"
    API_KEY = "APIKey"  # Authorization: Bearer <key>
    AWS_SIGV4 = "AWSSigV4"  # SigV4 request signing (incl. body hash)
    AZURE_API_KEY = "AzureAPIKey"  # api-key header
    AZURE_TOKEN = "AzureToken"  # Authorization: Bearer <oauth token>
    GCP_TOKEN = "GCPToken"  # Bearer token + project/region path rewrite
    ANTHROPIC_API_KEY = "AnthropicAPIKey"  # x-api-key + anthropic-version


@dataclass(frozen=True)
class AuthConfig:
    """Per-backend upstream credential configuration.

    ``api_key``/``secret_*`` fields may be literal values or ``file:<path>``
    references, read by the backend's handler (``gateway/auth``) when a
    request is sent and again whenever the file changes.
    """

    kind: AuthKind = AuthKind.NONE
    api_key: str = ""
    # AWS SigV4
    aws_access_key_id: str = ""
    aws_secret_access_key: str = ""
    aws_session_token: str = ""
    aws_region: str = ""
    aws_service: str = "bedrock"
    # Azure
    azure_api_key: str = ""
    azure_access_token: str = ""
    # GCP
    gcp_access_token: str = ""
    gcp_project: str = ""
    gcp_region: str = ""
    # Anthropic
    anthropic_version: str = "2023-06-01"

    @staticmethod
    def parse(value: dict[str, Any] | None) -> "AuthConfig":
        if not value:
            return AuthConfig()
        kind = AuthKind(value.get("kind", "None"))
        known = {f.name for f in dataclasses.fields(AuthConfig)}
        kwargs = {k: v for k, v in value.items() if k in known and k != "kind"}
        unknown = set(value) - known - {"kind"}
        if unknown:
            raise ConfigError(f"unknown auth fields: {sorted(unknown)}")
        return AuthConfig(kind=kind, **kwargs)

    def to_dict(self) -> dict[str, Any]:
        d = {"kind": self.kind.value}
        for f in dataclasses.fields(self):
            if f.name == "kind":
                continue
            v = getattr(self, f.name)
            if v != f.default:
                d[f.name] = v
        return d


@dataclass(frozen=True)
class HeaderMutation:
    """Set/remove request headers toward a backend
    (reference filterapi HTTPHeaderMutation; headermutator/header_mutator.go:15).
    """

    set: tuple[tuple[str, str], ...] = ()
    remove: tuple[str, ...] = ()

    @staticmethod
    def parse(value: dict[str, Any] | None) -> "HeaderMutation":
        if not value:
            return HeaderMutation()
        sets = tuple(
            (str(h["name"]).lower(), str(h["value"])) for h in value.get("set", ())
        )
        removes = tuple(str(h).lower() for h in value.get("remove", ()))
        return HeaderMutation(set=sets, remove=removes)

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {}
        if self.set:
            d["set"] = [{"name": n, "value": v} for n, v in self.set]
        if self.remove:
            d["remove"] = list(self.remove)
        return d


@dataclass(frozen=True)
class BodyMutation:
    """Set/remove top-level JSON body fields toward a backend
    (reference bodymutator/body_mutator.go:17-85)."""

    set: tuple[tuple[str, Any], ...] = ()
    remove: tuple[str, ...] = ()

    @staticmethod
    def parse(value: dict[str, Any] | None) -> "BodyMutation":
        if not value:
            return BodyMutation()
        sets = tuple(
            (str(f["name"]), _freeze(f["value"])) for f in value.get("set", ())
        )
        removes = tuple(str(f) for f in value.get("remove", ()))
        return BodyMutation(set=sets, remove=removes)

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {}
        if self.set:
            d["set"] = [{"name": n, "value": _thaw(v)} for n, v in self.set]
        if self.remove:
            d["remove"] = list(self.remove)
        return d


def _check_endpoint(e: Any) -> Any:
    """Reject malformed picker endpoints at config load so a bad hot
    reload is dropped by the keep-last-good path instead of blowing up in
    the reload callback."""
    if isinstance(e, str) and e:
        return e
    if isinstance(e, dict) and isinstance(e.get("address"), str) and e["address"]:
        return e
    raise ConfigError(
        f"invalid endpoint entry {e!r}: expected 'host:port' or "
        "{{address: ..., slice: ...}}"
    )


def _freeze(v: Any) -> Any:
    """Make parsed JSON hashable so dataclasses stay frozen."""
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    if isinstance(v, list):
        return tuple(_freeze(x) for x in v)
    return v


def _thaw(v: Any) -> Any:
    if isinstance(v, tuple):
        if v and all(isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], str) for x in v):
            return {k: _thaw(x) for k, x in v}
        return [_thaw(x) for x in v]
    return v


class LLMRequestCostType(str, enum.Enum):
    """Token-cost metrics attachable to a request
    (reference shared_types.go:103-162: 7 cost types incl. CEL)."""

    INPUT_TOKEN = "InputToken"
    OUTPUT_TOKEN = "OutputToken"
    TOTAL_TOKEN = "TotalToken"
    CACHED_INPUT_TOKEN = "CachedInputToken"
    CACHE_CREATION_INPUT_TOKEN = "CacheCreationInputToken"
    REASONING_TOKEN = "ReasoningToken"
    EXPRESSION = "Expression"  # cost expression (reference: CEL, llmcostcel)


@dataclass(frozen=True)
class LLMRequestCost:
    """One cost metric: write `<metadata_key> = <cost>` at end of stream."""

    metadata_key: str
    cost_type: LLMRequestCostType
    expression: str = ""

    @staticmethod
    def parse(value: dict[str, Any]) -> "LLMRequestCost":
        c = LLMRequestCost(
            metadata_key=value["metadata_key"],
            cost_type=LLMRequestCostType(value.get("type", "TotalToken")),
            expression=value.get("expression", ""),
        )
        if c.cost_type is LLMRequestCostType.EXPRESSION and not c.expression:
            raise ConfigError(f"cost {c.metadata_key}: Expression type needs expression")
        return c

    def to_dict(self) -> dict[str, Any]:
        d = {"metadata_key": self.metadata_key, "type": self.cost_type.value}
        if self.expression:
            d["expression"] = self.expression
        return d


def _check_picker_mode(mode: str) -> str:
    if mode not in ("static", "slo"):
        raise ConfigError(
            f"picker_mode must be 'static' or 'slo' (got {mode!r})")
    return mode


def _check_controller(value: dict[str, Any]) -> Any:
    """Validate a backend's fleet-controller block at parse time (the
    knobs are read by ``gateway/controller.ControllerConfig``; the frozen
    mapping keeps Backend hashable). The import is lazy: the config
    layer imports without the gateway."""
    raw = value.get("controller")
    if raw is None:
        return None
    from aigw_tpu_torch.gateway.controller import ControllerConfig

    if not value.get("endpoints"):
        raise ConfigError(
            f"backend {value.get('name', '?')!r}: controller requires "
            "an endpoint pool")
    try:
        ControllerConfig.parse(dict(raw))
    except (TypeError, ValueError) as e:
        raise ConfigError(
            f"backend {value.get('name', '?')!r}: invalid controller "
            f"block: {e}") from None
    return _freeze(raw)


@dataclass(frozen=True)
class Backend:
    """One upstream backend: schema + address + auth + mutations.

    ≈ AIServiceBackend CRD (ai_service_backend.go:28) flattened with the
    resolved Envoy Gateway ``Backend`` address.
    """

    name: str
    schema: APISchema
    # Upstream base URL, e.g. "https://api.openai.com" or
    # "http://127.0.0.1:8011". TLS decided by the scheme.
    url: str = ""
    # Replica pool for the endpoint picker (InferencePool equivalent):
    # entries are "host:port" strings or {address, slice} mappings. When
    # set, the picker chooses a replica per request by KV occupancy /
    # queue depth / slice affinity and overrides `url`.
    endpoints: tuple[Any, ...] = ()
    picker_poll_interval: float = 1.0
    # Derive a session-affinity key from the conversation prefix (all
    # messages except the latest user turn) so consecutive turns land on
    # the replica holding their KV prefix cache. Explicit
    # x-aigw-session-affinity headers still win.
    picker_content_affinity: bool = False
    # Endpoint-picker scoring mode: "static" = the classic
    # occupancy/queue score sum; "slo" = rank replicas by PREDICTED
    # TTFT derived from each replica's live phase histograms + queue
    # depth, with admission control against slo_ttft_ms.
    picker_mode: str = "static"
    # TTFT SLO budget in milliseconds for slo mode: when > 0 and every
    # candidate's predicted TTFT exceeds it, the gateway sheds the
    # request with 429 + Retry-After instead of queueing into collapse.
    # 0 = route predictively but never shed.
    slo_ttft_ms: float = 0.0
    # Prefill/decode disaggregation: let the gateway hand a
    # young streaming session from a prefill-pressured replica to a
    # decode-leaning sibling (KV page migration through the replicas'
    # /migrate endpoints). Requires an endpoint pool.
    migration: bool = False
    # Migrate only while the source replica's admission queue is at
    # least this deep (prefill pressure)…
    migration_queue_depth: int = 2
    # …and only sessions still young (streamed tokens ≤ this): mature
    # decodes have amortized their prefill and aren't worth moving.
    migration_young_tokens: int = 32
    # Fleet KV memory hierarchy: maintain a chain-hash →
    # replica index from the replicas' polled /state digests and name
    # chain-holding siblings in the x-aigw-kv-peers header so a prefix
    # miss on the chosen replica becomes a cross-replica page fetch.
    # Costs nothing against replicas that don't advertise chains;
    # False suppresses the peers header entirely.
    kv_fleet: bool = True
    # Fleet observability plane: feed the live SLO burn-rate
    # monitor from the polled TTFT histograms and record every routing
    # decision in the /debug/decisions audit ring. False is the A/B
    # control (bench --ab fleet_obs); /fleet/state and /fleet/metrics
    # stay served either way (health machine + rollups are ~free).
    fleet_obs: bool = True
    # SLO burn-rate monitor knobs: the availability objective the error
    # budget derives from (goodput target; budget = 1 - objective), the
    # goodput window length, and how many consecutive over-budget
    # windows raise the sustained-overshoot flag (the autoscale
    # predicate). The TTFT threshold itself is slo_ttft_ms (falling
    # back to the monitor's 500ms default when unset).
    slo_objective: float = 0.95
    slo_window_s: float = 30.0
    slo_burn_windows: int = 3
    # The pool's replica lifecycle manager: autoscaling off the SLO
    # monitor's sustained-overshoot flag, scale-in through a lossless
    # drain, crash failover. A mapping of
    # gateway/controller.ControllerConfig knobs (min_replicas,
    # max_replicas, tick_s, scale_cooldown_s, idle_ticks,
    # idle_slots_frac, down_grace_s, drain_timeout_s, launcher:
    # {kind: local, spec: {...}, env: {...}}). None = a static pool.
    # Requires an endpoint pool.
    controller: Any = None
    auth: AuthConfig = AuthConfig()
    header_mutation: HeaderMutation = HeaderMutation()
    body_mutation: BodyMutation = BodyMutation()
    # Rewrite the model name sent upstream (reference modelNameOverride).
    model_name_override: str = ""
    # Timeouts (seconds). stream_idle_timeout guards stalled SSE streams and
    # triggers failover (reference ai_gateway_route.go:268-281 →
    # per_try_idle_timeout).
    request_timeout: float = 120.0
    stream_idle_timeout: float = 30.0

    @staticmethod
    def parse(value: dict[str, Any]) -> "Backend":
        try:
            return Backend(
                name=value["name"],
                schema=APISchema.parse(value["schema"]),
                url=value.get("url", ""),
                endpoints=tuple(
                    _freeze(_check_endpoint(e))
                    for e in value.get("endpoints", ())
                ),
                picker_poll_interval=float(
                    value.get("picker_poll_interval", 1.0)
                ),
                picker_content_affinity=bool(
                    value.get("picker_content_affinity", False)
                ),
                picker_mode=_check_picker_mode(
                    str(value.get("picker_mode", "static"))),
                slo_ttft_ms=float(value.get("slo_ttft_ms", 0.0)),
                migration=bool(value.get("migration", False)),
                migration_queue_depth=int(
                    value.get("migration_queue_depth", 2)),
                migration_young_tokens=int(
                    value.get("migration_young_tokens", 32)),
                kv_fleet=bool(value.get("kv_fleet", True)),
                fleet_obs=bool(value.get("fleet_obs", True)),
                slo_objective=float(value.get("slo_objective", 0.95)),
                slo_window_s=float(value.get("slo_window_s", 30.0)),
                slo_burn_windows=int(value.get("slo_burn_windows", 3)),
                controller=_check_controller(value),
                auth=AuthConfig.parse(value.get("auth")),
                header_mutation=HeaderMutation.parse(value.get("header_mutation")),
                body_mutation=BodyMutation.parse(value.get("body_mutation")),
                model_name_override=value.get("model_name_override", ""),
                request_timeout=float(value.get("request_timeout", 120.0)),
                stream_idle_timeout=float(value.get("stream_idle_timeout", 30.0)),
            )
        except KeyError as e:
            raise ConfigError(f"backend missing required field {e}") from None

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {"name": self.name, "schema": self.schema.to_dict()}
        if self.url:
            d["url"] = self.url
        if self.endpoints:
            d["endpoints"] = [_thaw(e) for e in self.endpoints]
        if self.picker_poll_interval != 1.0:
            d["picker_poll_interval"] = self.picker_poll_interval
        if self.picker_content_affinity:
            d["picker_content_affinity"] = True
        if self.picker_mode != "static":
            d["picker_mode"] = self.picker_mode
        if self.slo_ttft_ms:
            d["slo_ttft_ms"] = self.slo_ttft_ms
        if self.migration:
            d["migration"] = True
        if self.migration_queue_depth != 2:
            d["migration_queue_depth"] = self.migration_queue_depth
        if self.migration_young_tokens != 32:
            d["migration_young_tokens"] = self.migration_young_tokens
        if not self.kv_fleet:
            d["kv_fleet"] = False
        if not self.fleet_obs:
            d["fleet_obs"] = False
        if self.slo_objective != 0.95:
            d["slo_objective"] = self.slo_objective
        if self.slo_window_s != 30.0:
            d["slo_window_s"] = self.slo_window_s
        if self.slo_burn_windows != 3:
            d["slo_burn_windows"] = self.slo_burn_windows
        if self.controller is not None:
            d["controller"] = _thaw(self.controller)
        if self.auth.kind is not AuthKind.NONE:
            d["auth"] = self.auth.to_dict()
        if self.header_mutation != HeaderMutation():
            d["header_mutation"] = self.header_mutation.to_dict()
        if self.body_mutation != BodyMutation():
            d["body_mutation"] = self.body_mutation.to_dict()
        if self.model_name_override:
            d["model_name_override"] = self.model_name_override
        if self.request_timeout != 120.0:
            d["request_timeout"] = self.request_timeout
        if self.stream_idle_timeout != 30.0:
            d["stream_idle_timeout"] = self.stream_idle_timeout
        return d


@dataclass(frozen=True)
class RuleBackendRef:
    """Weighted/priority reference from a route rule to a backend
    (reference ai_gateway_route.go:377-397: weight for traffic split,
    priority for fallback ordering — lower number = tried first)."""

    backend: str
    weight: int = 1
    priority: int = 0

    @staticmethod
    def parse(value: Any) -> "RuleBackendRef":
        if isinstance(value, str):
            return RuleBackendRef(backend=value)
        return RuleBackendRef(
            backend=value["backend"],
            weight=int(value.get("weight", 1)),
            priority=int(value.get("priority", 0)),
        )

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {"backend": self.backend}
        if self.weight != 1:
            d["weight"] = self.weight
        if self.priority != 0:
            d["priority"] = self.priority
        return d


@dataclass(frozen=True)
class HeaderMatch:
    """Exact or regex header match for a route rule (reference matches on
    x-ai-eg-model via HTTPRoute header matching, types Exact and
    RegularExpression)."""

    name: str
    value: str
    regex: bool = False

    def match(self, got: str) -> bool:
        if self.regex:
            import re

            try:
                return re.fullmatch(self.value, got) is not None
            except re.error:
                return False
        return got == self.value

    @staticmethod
    def parse(value: dict[str, Any]) -> "HeaderMatch":
        m = HeaderMatch(
            name=str(value["name"]).lower(),
            value=str(value["value"]),
            regex=bool(value.get("regex", False)),
        )
        if m.regex:
            import re

            try:
                re.compile(m.value)
            except re.error as e:
                raise ConfigError(
                    f"invalid regex for header {m.name!r}: {e}") from None
        return m

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {"name": self.name, "value": self.value}
        if self.regex:
            d["regex"] = True
        return d


@dataclass(frozen=True)
class RouteRule:
    """One route rule: header matches (typically on the model header) →
    backend refs (reference AIGatewayRouteRule, ai_gateway_route.go:216)."""

    backends: tuple[RuleBackendRef, ...]
    headers: tuple[HeaderMatch, ...] = ()
    # Convenience sugar: `models: [m1, m2]` expands to model-header matches.
    models: tuple[str, ...] = ()
    # Prefix matches (e.g. "gpt-" routes every GPT model).
    model_prefixes: tuple[str, ...] = ()
    name: str = ""

    def matches(self, headers: dict[str, str]) -> bool:
        model = headers.get(MODEL_NAME_HEADER, "")
        if self.models or self.model_prefixes:
            exact = model in self.models
            prefix = any(model.startswith(p) for p in self.model_prefixes)
            if not exact and not prefix:
                return False
        for m in self.headers:
            got = headers.get(m.name)
            # a missing header never matches — even patterns that accept
            # the empty string (HTTPRoute semantics: header must exist)
            if got is None or not m.match(got):
                return False
        return True

    @staticmethod
    def parse(value: dict[str, Any]) -> "RouteRule":
        backends = tuple(RuleBackendRef.parse(b) for b in value.get("backends", ()))
        if not backends:
            raise ConfigError("route rule needs at least one backend")
        return RouteRule(
            backends=backends,
            headers=tuple(HeaderMatch.parse(h) for h in value.get("headers", ())),
            models=tuple(value.get("models", ())),
            model_prefixes=tuple(value.get("model_prefixes", ())),
            name=value.get("name", ""),
        )

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {"backends": [b.to_dict() for b in self.backends]}
        if self.headers:
            d["headers"] = [h.to_dict() for h in self.headers]
        if self.models:
            d["models"] = list(self.models)
        if self.model_prefixes:
            d["model_prefixes"] = list(self.model_prefixes)
        if self.name:
            d["name"] = self.name
        return d


@dataclass(frozen=True)
class Model:
    """Entry for /v1/models discovery (reference filterapi Model +
    AIGatewayRouteRule model-listing metadata)."""

    name: str
    owned_by: str = "aigw-tpu"
    created_at: int = 0

    @staticmethod
    def parse(value: Any) -> "Model":
        if isinstance(value, str):
            return Model(name=value)
        return Model(
            name=value["name"],
            owned_by=value.get("owned_by", "aigw-tpu"),
            created_at=int(value.get("created_at", 0)),
        )

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {"name": self.name}
        if self.owned_by != "aigw-tpu":
            d["owned_by"] = self.owned_by
        if self.created_at:
            d["created_at"] = self.created_at
        return d


@dataclass(frozen=True)
class Route:
    """A named route: rules evaluated in order, first match wins."""

    name: str
    rules: tuple[RouteRule, ...]
    # Hostnames this route applies to ("" = all), mirroring per-host model
    # scoping (reference filterapi ModelsByHost).
    hostnames: tuple[str, ...] = ()
    # Route-level costs, merged over the global list (reference
    # AIGatewayRoute.Spec.LLMRequestCosts, ai_gateway_route.go:57).
    llm_request_costs: tuple[LLMRequestCost, ...] = ()

    @staticmethod
    def parse(value: dict[str, Any]) -> "Route":
        return Route(
            name=value["name"],
            rules=tuple(RouteRule.parse(r) for r in value.get("rules", ())),
            hostnames=tuple(value.get("hostnames", ())),
            llm_request_costs=tuple(
                LLMRequestCost.parse(c)
                for c in value.get("llm_request_costs", ())
            ),
        )

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {
            "name": self.name,
            "rules": [r.to_dict() for r in self.rules],
        }
        if self.hostnames:
            d["hostnames"] = list(self.hostnames)
        if self.llm_request_costs:
            d["llm_request_costs"] = [
                c.to_dict() for c in self.llm_request_costs
            ]
        return d


@dataclass(frozen=True)
class Config:
    """The complete gateway configuration (≈ filterapi.Config,
    filterconfig.go:25). Immutable; hot reload swaps whole objects."""

    backends: tuple[Backend, ...] = ()
    routes: tuple[Route, ...] = ()
    models: tuple[Model, ...] = ()
    llm_request_costs: tuple[LLMRequestCost, ...] = ()
    # Quota rules (parsed/enforced by aigw_tpu_torch.gateway.ratelimit — the
    # QuotaPolicy equivalent); stored frozen for hashability.
    quotas: tuple[Any, ...] = ()
    mcp: dict[str, Any] | None = None  # parsed by aigw_tpu_torch.mcp
    # Engine-truth usage metering: the gateway ledger's
    # knobs, stored frozen. None = metering ON with defaults (in-memory
    # ledger, 60s windows, no budgets). Mapping keys: enabled (bool),
    # window_s (float), retain_windows (int), journal (JSONL path, ""
    # = in-memory), budgets ({tenant: cost-per-window}), burn_windows
    # (K consecutive over-budget windows → sustained alert).
    usage: Any = None
    version: str = CONFIG_VERSION
    uuid: str = ""

    def backend(self, name: str) -> Backend:
        for b in self.backends:
            if b.name == name:
                return b
        raise ConfigError(f"unknown backend {name!r}")

    def validate(self) -> None:
        names = [b.name for b in self.backends]
        if len(names) != len(set(names)):
            raise ConfigError("duplicate backend names")
        # NOTE: a backend with neither url nor endpoints is legal — it can
        # be driven purely by the x-gateway-destination-endpoint header
        # (external EPP flow, reference post_cluster_modify.go:67-80).
        for r in self.routes:
            for rule in r.rules:
                for ref in rule.backends:
                    if ref.backend not in names:
                        raise ConfigError(
                            f"route {r.name!r} references unknown backend "
                            f"{ref.backend!r}"
                        )
                    if ref.weight < 0:
                        raise ConfigError("backend weight must be >= 0")
        keys = [c.metadata_key for c in self.llm_request_costs]
        if len(keys) != len(set(keys)):
            raise ConfigError("duplicate llm_request_costs metadata keys")
        for r in self.routes:
            rkeys = [c.metadata_key for c in r.llm_request_costs]
            if len(rkeys) != len(set(rkeys)):
                raise ConfigError(
                    f"route {r.name!r}: duplicate cost metadata keys"
                )

    @staticmethod
    def parse(value: dict[str, Any]) -> "Config":
        version = value.get("version", CONFIG_VERSION)
        if version != CONFIG_VERSION:
            # Version-gated load: reject configs written by a different
            # framework version mid rolling-upgrade (filterconfig.go:26-31).
            raise ConfigError(
                f"config version {version!r} != supported {CONFIG_VERSION!r}"
            )
        cfg = Config(
            backends=tuple(Backend.parse(b) for b in value.get("backends", ())),
            routes=tuple(Route.parse(r) for r in value.get("routes", ())),
            models=tuple(Model.parse(m) for m in value.get("models", ())),
            llm_request_costs=tuple(
                LLMRequestCost.parse(c) for c in value.get("llm_request_costs", ())
            ),
            quotas=tuple(_freeze(q) for q in value.get("quotas", ())),
            mcp=value.get("mcp"),
            usage=(_freeze(value["usage"])
                   if value.get("usage") is not None else None),
            version=version,
            uuid=value.get("uuid", ""),
        )
        cfg.validate()
        return cfg

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {"version": self.version}
        if self.uuid:
            d["uuid"] = self.uuid
        if self.backends:
            d["backends"] = [b.to_dict() for b in self.backends]
        if self.routes:
            d["routes"] = [r.to_dict() for r in self.routes]
        if self.models:
            d["models"] = [m.to_dict() for m in self.models]
        if self.llm_request_costs:
            d["llm_request_costs"] = [c.to_dict() for c in self.llm_request_costs]
        if self.quotas:
            d["quotas"] = [_thaw(q) for q in self.quotas]
        if self.mcp is not None:
            d["mcp"] = self.mcp
        if self.usage is not None:
            d["usage"] = _thaw(self.usage)
        return d

    def checksum(self) -> str:
        """Stable content hash, used by the watcher to skip no-op reloads
        (the reference checksums bundle parts, config_bundle.go:21)."""
        blob = json.dumps(self.to_dict(), sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()


def load_config(path: str) -> Config:
    """Load a Config from a JSON file, or from a YAML file (``.yaml`` /
    ``.yml``) through ``config.crd.load_documents`` (pyyaml where it is
    installed, else the file must be JSON text, and any other text raises
    ``ConfigError`` naming ``pyyaml``). Kubernetes CRD manifests
    (documents with ``kind`` and ``apiVersion``) are compiled through
    ``config.crd``, as the reference compiles them; a native config is
    one document."""
    from aigw_tpu_torch.config.crd import (
        compile_crd_objects,
        load_documents,
        looks_like_crd,
    )

    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    if path.endswith((".yaml", ".yml")):
        docs = [d for d in load_documents(text, repr(path)) if d is not None]
    else:
        try:
            docs = [json.loads(text)] if text.strip() else []
        except json.JSONDecodeError as e:
            raise ConfigError(f"{path!r} is not valid JSON: {e}") from None
    if not docs:
        raise ConfigError(f"empty config file {path!r}")
    if looks_like_crd([d for d in docs if isinstance(d, dict)]):
        return Config.parse(compile_crd_objects(
            [d for d in docs if isinstance(d, dict)]))
    if len(docs) > 1:
        raise ConfigError(
            f"{path!r} contains {len(docs)} YAML documents but is not a "
            "K8s CRD manifest; native configs must be a single document")
    data = docs[0]
    if not isinstance(data, dict):
        raise ConfigError(f"config root must be a mapping, got {type(data)}")
    return Config.parse(data)
