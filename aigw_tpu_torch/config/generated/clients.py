"""GENERATED by aigw_tpu_torch.config.clientgen — DO NOT EDIT.

Typed clientset/informer surface over the shipped CRD schemas
(charts/aigw-tpu-crds). Regenerate with:

    python -m aigw_tpu_torch.config.clientgen

tests/test_torch_clientgen.py fails when this file is stale.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

from aigw_tpu_torch.config.kube import KubeClient, KubeSource


@dataclass
class AIGatewayRouteSpec:
    """spec of aigateway.envoyproxy.io/v1alpha1 AIGatewayRoute (generated)."""

    hostnames: list[Any] = field(default_factory=list)
    llm_request_costs: list[Any] = field(default_factory=list)
    parent_refs: list[Any] = field(default_factory=list)
    rules: list[Any] = field(default_factory=list)

    @classmethod
    def from_dict(cls, spec: dict[str, Any]) -> "AIGatewayRouteSpec":
        spec = spec or {}
        return cls(
            hostnames=spec.get('hostnames') or [],
            llm_request_costs=spec.get('llmRequestCosts') or [],
            parent_refs=spec.get('parentRefs') or [],
            rules=spec.get('rules') or [],
        )

    def to_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {}
        if self.hostnames is not None:
            out['hostnames'] = self.hostnames
        if self.llm_request_costs is not None:
            out['llmRequestCosts'] = self.llm_request_costs
        if self.parent_refs is not None:
            out['parentRefs'] = self.parent_refs
        if self.rules is not None:
            out['rules'] = self.rules
        return out


@dataclass
class AIGatewayRoute:
    """aigateway.envoyproxy.io/v1alpha1 AIGatewayRoute (generated)."""

    API_VERSION = "aigateway.envoyproxy.io/v1alpha1"
    KIND = "AIGatewayRoute"
    PLURAL = "aigatewayroutes"

    metadata: dict[str, Any] = field(default_factory=dict)
    spec: AIGatewayRouteSpec = field(default_factory=AIGatewayRouteSpec)
    status: dict[str, Any] = field(default_factory=dict)
    raw: dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, obj: dict[str, Any]) -> "AIGatewayRoute":
        return cls(
            metadata=obj.get("metadata") or {},
            spec=AIGatewayRouteSpec.from_dict(obj.get("spec") or {}),
            status=obj.get("status") or {},
            raw=obj,
        )

    @property
    def name(self) -> str:
        return self.metadata.get("name", "")

    @property
    def namespace(self) -> str:
        return self.metadata.get("namespace") or "default"


class AIGatewayRouteClient:
    """Typed REST access for AIGatewayRoute (generated)."""

    def __init__(self, client: KubeClient):
        self._c = client

    async def list(self) -> list[AIGatewayRoute]:
        items, _rv, _installed = await self._c.list_resource(
            "AIGatewayRoute")
        return [AIGatewayRoute.from_dict(o) for o in items]

    async def get(self, name: str, namespace: str = "default") -> AIGatewayRoute | None:
        for obj in await self.list():
            if obj.name == name and obj.namespace == namespace:
                return obj
        return None

    async def patch_status(self, obj: AIGatewayRoute, conditions: list[dict[str, Any]]) -> bool:
        return await self._c.patch_status(obj.raw, conditions)


class AIGatewayRouteInformer:
    """client-go-style informer for AIGatewayRoute over the KubeSource cache (generated)."""

    def __init__(self, source: KubeSource):
        self._source = source
        self._handlers: list[Callable[[str, AIGatewayRoute], None]] = []
        source.add_listener(self._on_event)

    def add_event_handler(self, fn: Callable[[str, AIGatewayRoute], None]) -> None:
        """fn(event_type, obj); event_type in {"ADDED", "MODIFIED", "DELETED"}."""
        self._handlers.append(fn)

    def _on_event(self, etype: str, obj: dict[str, Any]) -> None:
        if obj.get("kind") != "AIGatewayRoute":
            return
        typed = AIGatewayRoute.from_dict(obj)
        for fn in self._handlers:
            fn(etype, typed)

    def store(self) -> list[AIGatewayRoute]:
        """Current cache contents (the informer lister)."""
        return [AIGatewayRoute.from_dict(o) for o in self._source.objects()
                if o.get("kind") == "AIGatewayRoute"]


@dataclass
class AIServiceBackendSpec:
    """spec of aigateway.envoyproxy.io/v1alpha1 AIServiceBackend (generated)."""

    backend_ref: dict[str, Any] = field(default_factory=dict)
    body_mutation: dict[str, Any] = field(default_factory=dict)
    header_mutation: dict[str, Any] = field(default_factory=dict)
    schema: dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, spec: dict[str, Any]) -> "AIServiceBackendSpec":
        spec = spec or {}
        return cls(
            backend_ref=spec.get('backendRef') or {},
            body_mutation=spec.get('bodyMutation') or {},
            header_mutation=spec.get('headerMutation') or {},
            schema=spec.get('schema') or {},
        )

    def to_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {}
        if self.backend_ref is not None:
            out['backendRef'] = self.backend_ref
        if self.body_mutation is not None:
            out['bodyMutation'] = self.body_mutation
        if self.header_mutation is not None:
            out['headerMutation'] = self.header_mutation
        if self.schema is not None:
            out['schema'] = self.schema
        return out


@dataclass
class AIServiceBackend:
    """aigateway.envoyproxy.io/v1alpha1 AIServiceBackend (generated)."""

    API_VERSION = "aigateway.envoyproxy.io/v1alpha1"
    KIND = "AIServiceBackend"
    PLURAL = "aiservicebackends"

    metadata: dict[str, Any] = field(default_factory=dict)
    spec: AIServiceBackendSpec = field(default_factory=AIServiceBackendSpec)
    status: dict[str, Any] = field(default_factory=dict)
    raw: dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, obj: dict[str, Any]) -> "AIServiceBackend":
        return cls(
            metadata=obj.get("metadata") or {},
            spec=AIServiceBackendSpec.from_dict(obj.get("spec") or {}),
            status=obj.get("status") or {},
            raw=obj,
        )

    @property
    def name(self) -> str:
        return self.metadata.get("name", "")

    @property
    def namespace(self) -> str:
        return self.metadata.get("namespace") or "default"


class AIServiceBackendClient:
    """Typed REST access for AIServiceBackend (generated)."""

    def __init__(self, client: KubeClient):
        self._c = client

    async def list(self) -> list[AIServiceBackend]:
        items, _rv, _installed = await self._c.list_resource(
            "AIServiceBackend")
        return [AIServiceBackend.from_dict(o) for o in items]

    async def get(self, name: str, namespace: str = "default") -> AIServiceBackend | None:
        for obj in await self.list():
            if obj.name == name and obj.namespace == namespace:
                return obj
        return None

    async def patch_status(self, obj: AIServiceBackend, conditions: list[dict[str, Any]]) -> bool:
        return await self._c.patch_status(obj.raw, conditions)


class AIServiceBackendInformer:
    """client-go-style informer for AIServiceBackend over the KubeSource cache (generated)."""

    def __init__(self, source: KubeSource):
        self._source = source
        self._handlers: list[Callable[[str, AIServiceBackend], None]] = []
        source.add_listener(self._on_event)

    def add_event_handler(self, fn: Callable[[str, AIServiceBackend], None]) -> None:
        """fn(event_type, obj); event_type in {"ADDED", "MODIFIED", "DELETED"}."""
        self._handlers.append(fn)

    def _on_event(self, etype: str, obj: dict[str, Any]) -> None:
        if obj.get("kind") != "AIServiceBackend":
            return
        typed = AIServiceBackend.from_dict(obj)
        for fn in self._handlers:
            fn(etype, typed)

    def store(self) -> list[AIServiceBackend]:
        """Current cache contents (the informer lister)."""
        return [AIServiceBackend.from_dict(o) for o in self._source.objects()
                if o.get("kind") == "AIServiceBackend"]


@dataclass
class BackendSecurityPolicySpec:
    """spec of aigateway.envoyproxy.io/v1alpha1 BackendSecurityPolicy (generated)."""

    anthropic_api_key: dict[str, Any] = field(default_factory=dict)
    api_key: dict[str, Any] = field(default_factory=dict)
    aws_credentials: dict[str, Any] = field(default_factory=dict)
    azure_api_key: dict[str, Any] = field(default_factory=dict)
    azure_credentials: dict[str, Any] = field(default_factory=dict)
    gcp_credentials: dict[str, Any] = field(default_factory=dict)
    target_refs: list[Any] = field(default_factory=list)
    type_: str | None = None

    @classmethod
    def from_dict(cls, spec: dict[str, Any]) -> "BackendSecurityPolicySpec":
        spec = spec or {}
        return cls(
            anthropic_api_key=spec.get('anthropicAPIKey') or {},
            api_key=spec.get('apiKey') or {},
            aws_credentials=spec.get('awsCredentials') or {},
            azure_api_key=spec.get('azureAPIKey') or {},
            azure_credentials=spec.get('azureCredentials') or {},
            gcp_credentials=spec.get('gcpCredentials') or {},
            target_refs=spec.get('targetRefs') or [],
            type_=spec.get('type'),
        )

    def to_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {}
        if self.anthropic_api_key is not None:
            out['anthropicAPIKey'] = self.anthropic_api_key
        if self.api_key is not None:
            out['apiKey'] = self.api_key
        if self.aws_credentials is not None:
            out['awsCredentials'] = self.aws_credentials
        if self.azure_api_key is not None:
            out['azureAPIKey'] = self.azure_api_key
        if self.azure_credentials is not None:
            out['azureCredentials'] = self.azure_credentials
        if self.gcp_credentials is not None:
            out['gcpCredentials'] = self.gcp_credentials
        if self.target_refs is not None:
            out['targetRefs'] = self.target_refs
        if self.type_ is not None:
            out['type'] = self.type_
        return out


@dataclass
class BackendSecurityPolicy:
    """aigateway.envoyproxy.io/v1alpha1 BackendSecurityPolicy (generated)."""

    API_VERSION = "aigateway.envoyproxy.io/v1alpha1"
    KIND = "BackendSecurityPolicy"
    PLURAL = "backendsecuritypolicies"

    metadata: dict[str, Any] = field(default_factory=dict)
    spec: BackendSecurityPolicySpec = field(default_factory=BackendSecurityPolicySpec)
    status: dict[str, Any] = field(default_factory=dict)
    raw: dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, obj: dict[str, Any]) -> "BackendSecurityPolicy":
        return cls(
            metadata=obj.get("metadata") or {},
            spec=BackendSecurityPolicySpec.from_dict(obj.get("spec") or {}),
            status=obj.get("status") or {},
            raw=obj,
        )

    @property
    def name(self) -> str:
        return self.metadata.get("name", "")

    @property
    def namespace(self) -> str:
        return self.metadata.get("namespace") or "default"


class BackendSecurityPolicyClient:
    """Typed REST access for BackendSecurityPolicy (generated)."""

    def __init__(self, client: KubeClient):
        self._c = client

    async def list(self) -> list[BackendSecurityPolicy]:
        items, _rv, _installed = await self._c.list_resource(
            "BackendSecurityPolicy")
        return [BackendSecurityPolicy.from_dict(o) for o in items]

    async def get(self, name: str, namespace: str = "default") -> BackendSecurityPolicy | None:
        for obj in await self.list():
            if obj.name == name and obj.namespace == namespace:
                return obj
        return None

    async def patch_status(self, obj: BackendSecurityPolicy, conditions: list[dict[str, Any]]) -> bool:
        return await self._c.patch_status(obj.raw, conditions)


class BackendSecurityPolicyInformer:
    """client-go-style informer for BackendSecurityPolicy over the KubeSource cache (generated)."""

    def __init__(self, source: KubeSource):
        self._source = source
        self._handlers: list[Callable[[str, BackendSecurityPolicy], None]] = []
        source.add_listener(self._on_event)

    def add_event_handler(self, fn: Callable[[str, BackendSecurityPolicy], None]) -> None:
        """fn(event_type, obj); event_type in {"ADDED", "MODIFIED", "DELETED"}."""
        self._handlers.append(fn)

    def _on_event(self, etype: str, obj: dict[str, Any]) -> None:
        if obj.get("kind") != "BackendSecurityPolicy":
            return
        typed = BackendSecurityPolicy.from_dict(obj)
        for fn in self._handlers:
            fn(etype, typed)

    def store(self) -> list[BackendSecurityPolicy]:
        """Current cache contents (the informer lister)."""
        return [BackendSecurityPolicy.from_dict(o) for o in self._source.objects()
                if o.get("kind") == "BackendSecurityPolicy"]


@dataclass
class GatewayConfigSpec:
    """spec of aigateway.envoyproxy.io/v1alpha1 GatewayConfig (generated)."""

    ext_proc: dict[str, Any] = field(default_factory=dict)
    global_llm_request_costs: list[Any] = field(default_factory=list)

    @classmethod
    def from_dict(cls, spec: dict[str, Any]) -> "GatewayConfigSpec":
        spec = spec or {}
        return cls(
            ext_proc=spec.get('extProc') or {},
            global_llm_request_costs=spec.get('globalLLMRequestCosts') or [],
        )

    def to_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {}
        if self.ext_proc is not None:
            out['extProc'] = self.ext_proc
        if self.global_llm_request_costs is not None:
            out['globalLLMRequestCosts'] = self.global_llm_request_costs
        return out


@dataclass
class GatewayConfig:
    """aigateway.envoyproxy.io/v1alpha1 GatewayConfig (generated)."""

    API_VERSION = "aigateway.envoyproxy.io/v1alpha1"
    KIND = "GatewayConfig"
    PLURAL = "gatewayconfigs"

    metadata: dict[str, Any] = field(default_factory=dict)
    spec: GatewayConfigSpec = field(default_factory=GatewayConfigSpec)
    status: dict[str, Any] = field(default_factory=dict)
    raw: dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, obj: dict[str, Any]) -> "GatewayConfig":
        return cls(
            metadata=obj.get("metadata") or {},
            spec=GatewayConfigSpec.from_dict(obj.get("spec") or {}),
            status=obj.get("status") or {},
            raw=obj,
        )

    @property
    def name(self) -> str:
        return self.metadata.get("name", "")

    @property
    def namespace(self) -> str:
        return self.metadata.get("namespace") or "default"


class GatewayConfigClient:
    """Typed REST access for GatewayConfig (generated)."""

    def __init__(self, client: KubeClient):
        self._c = client

    async def list(self) -> list[GatewayConfig]:
        items, _rv, _installed = await self._c.list_resource(
            "GatewayConfig")
        return [GatewayConfig.from_dict(o) for o in items]

    async def get(self, name: str, namespace: str = "default") -> GatewayConfig | None:
        for obj in await self.list():
            if obj.name == name and obj.namespace == namespace:
                return obj
        return None

    async def patch_status(self, obj: GatewayConfig, conditions: list[dict[str, Any]]) -> bool:
        return await self._c.patch_status(obj.raw, conditions)


class GatewayConfigInformer:
    """client-go-style informer for GatewayConfig over the KubeSource cache (generated)."""

    def __init__(self, source: KubeSource):
        self._source = source
        self._handlers: list[Callable[[str, GatewayConfig], None]] = []
        source.add_listener(self._on_event)

    def add_event_handler(self, fn: Callable[[str, GatewayConfig], None]) -> None:
        """fn(event_type, obj); event_type in {"ADDED", "MODIFIED", "DELETED"}."""
        self._handlers.append(fn)

    def _on_event(self, etype: str, obj: dict[str, Any]) -> None:
        if obj.get("kind") != "GatewayConfig":
            return
        typed = GatewayConfig.from_dict(obj)
        for fn in self._handlers:
            fn(etype, typed)

    def store(self) -> list[GatewayConfig]:
        """Current cache contents (the informer lister)."""
        return [GatewayConfig.from_dict(o) for o in self._source.objects()
                if o.get("kind") == "GatewayConfig"]


@dataclass
class MCPRouteSpec:
    """spec of aigateway.envoyproxy.io/v1alpha1 MCPRoute (generated)."""

    backend_refs: list[Any] = field(default_factory=list)
    headers: list[Any] = field(default_factory=list)
    parent_refs: list[Any] = field(default_factory=list)
    path: str | None = None
    security_policy: dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, spec: dict[str, Any]) -> "MCPRouteSpec":
        spec = spec or {}
        return cls(
            backend_refs=spec.get('backendRefs') or [],
            headers=spec.get('headers') or [],
            parent_refs=spec.get('parentRefs') or [],
            path=spec.get('path'),
            security_policy=spec.get('securityPolicy') or {},
        )

    def to_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {}
        if self.backend_refs is not None:
            out['backendRefs'] = self.backend_refs
        if self.headers is not None:
            out['headers'] = self.headers
        if self.parent_refs is not None:
            out['parentRefs'] = self.parent_refs
        if self.path is not None:
            out['path'] = self.path
        if self.security_policy is not None:
            out['securityPolicy'] = self.security_policy
        return out


@dataclass
class MCPRoute:
    """aigateway.envoyproxy.io/v1alpha1 MCPRoute (generated)."""

    API_VERSION = "aigateway.envoyproxy.io/v1alpha1"
    KIND = "MCPRoute"
    PLURAL = "mcproutes"

    metadata: dict[str, Any] = field(default_factory=dict)
    spec: MCPRouteSpec = field(default_factory=MCPRouteSpec)
    status: dict[str, Any] = field(default_factory=dict)
    raw: dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, obj: dict[str, Any]) -> "MCPRoute":
        return cls(
            metadata=obj.get("metadata") or {},
            spec=MCPRouteSpec.from_dict(obj.get("spec") or {}),
            status=obj.get("status") or {},
            raw=obj,
        )

    @property
    def name(self) -> str:
        return self.metadata.get("name", "")

    @property
    def namespace(self) -> str:
        return self.metadata.get("namespace") or "default"


class MCPRouteClient:
    """Typed REST access for MCPRoute (generated)."""

    def __init__(self, client: KubeClient):
        self._c = client

    async def list(self) -> list[MCPRoute]:
        items, _rv, _installed = await self._c.list_resource(
            "MCPRoute")
        return [MCPRoute.from_dict(o) for o in items]

    async def get(self, name: str, namespace: str = "default") -> MCPRoute | None:
        for obj in await self.list():
            if obj.name == name and obj.namespace == namespace:
                return obj
        return None

    async def patch_status(self, obj: MCPRoute, conditions: list[dict[str, Any]]) -> bool:
        return await self._c.patch_status(obj.raw, conditions)


class MCPRouteInformer:
    """client-go-style informer for MCPRoute over the KubeSource cache (generated)."""

    def __init__(self, source: KubeSource):
        self._source = source
        self._handlers: list[Callable[[str, MCPRoute], None]] = []
        source.add_listener(self._on_event)

    def add_event_handler(self, fn: Callable[[str, MCPRoute], None]) -> None:
        """fn(event_type, obj); event_type in {"ADDED", "MODIFIED", "DELETED"}."""
        self._handlers.append(fn)

    def _on_event(self, etype: str, obj: dict[str, Any]) -> None:
        if obj.get("kind") != "MCPRoute":
            return
        typed = MCPRoute.from_dict(obj)
        for fn in self._handlers:
            fn(etype, typed)

    def store(self) -> list[MCPRoute]:
        """Current cache contents (the informer lister)."""
        return [MCPRoute.from_dict(o) for o in self._source.objects()
                if o.get("kind") == "MCPRoute"]


@dataclass
class QuotaPolicySpec:
    """spec of aigateway.envoyproxy.io/v1alpha1 QuotaPolicy (generated)."""

    per_model_quotas: list[Any] = field(default_factory=list)
    service_quota: dict[str, Any] = field(default_factory=dict)
    target_refs: list[Any] = field(default_factory=list)

    @classmethod
    def from_dict(cls, spec: dict[str, Any]) -> "QuotaPolicySpec":
        spec = spec or {}
        return cls(
            per_model_quotas=spec.get('perModelQuotas') or [],
            service_quota=spec.get('serviceQuota') or {},
            target_refs=spec.get('targetRefs') or [],
        )

    def to_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {}
        if self.per_model_quotas is not None:
            out['perModelQuotas'] = self.per_model_quotas
        if self.service_quota is not None:
            out['serviceQuota'] = self.service_quota
        if self.target_refs is not None:
            out['targetRefs'] = self.target_refs
        return out


@dataclass
class QuotaPolicy:
    """aigateway.envoyproxy.io/v1alpha1 QuotaPolicy (generated)."""

    API_VERSION = "aigateway.envoyproxy.io/v1alpha1"
    KIND = "QuotaPolicy"
    PLURAL = "quotapolicies"

    metadata: dict[str, Any] = field(default_factory=dict)
    spec: QuotaPolicySpec = field(default_factory=QuotaPolicySpec)
    status: dict[str, Any] = field(default_factory=dict)
    raw: dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, obj: dict[str, Any]) -> "QuotaPolicy":
        return cls(
            metadata=obj.get("metadata") or {},
            spec=QuotaPolicySpec.from_dict(obj.get("spec") or {}),
            status=obj.get("status") or {},
            raw=obj,
        )

    @property
    def name(self) -> str:
        return self.metadata.get("name", "")

    @property
    def namespace(self) -> str:
        return self.metadata.get("namespace") or "default"


class QuotaPolicyClient:
    """Typed REST access for QuotaPolicy (generated)."""

    def __init__(self, client: KubeClient):
        self._c = client

    async def list(self) -> list[QuotaPolicy]:
        items, _rv, _installed = await self._c.list_resource(
            "QuotaPolicy")
        return [QuotaPolicy.from_dict(o) for o in items]

    async def get(self, name: str, namespace: str = "default") -> QuotaPolicy | None:
        for obj in await self.list():
            if obj.name == name and obj.namespace == namespace:
                return obj
        return None

    async def patch_status(self, obj: QuotaPolicy, conditions: list[dict[str, Any]]) -> bool:
        return await self._c.patch_status(obj.raw, conditions)


class QuotaPolicyInformer:
    """client-go-style informer for QuotaPolicy over the KubeSource cache (generated)."""

    def __init__(self, source: KubeSource):
        self._source = source
        self._handlers: list[Callable[[str, QuotaPolicy], None]] = []
        source.add_listener(self._on_event)

    def add_event_handler(self, fn: Callable[[str, QuotaPolicy], None]) -> None:
        """fn(event_type, obj); event_type in {"ADDED", "MODIFIED", "DELETED"}."""
        self._handlers.append(fn)

    def _on_event(self, etype: str, obj: dict[str, Any]) -> None:
        if obj.get("kind") != "QuotaPolicy":
            return
        typed = QuotaPolicy.from_dict(obj)
        for fn in self._handlers:
            fn(etype, typed)

    def store(self) -> list[QuotaPolicy]:
        """Current cache contents (the informer lister)."""
        return [QuotaPolicy.from_dict(o) for o in self._source.objects()
                if o.get("kind") == "QuotaPolicy"]


class AigwClientset:
    """Aggregate typed clientset over every shipped CRD kind (generated)."""

    def __init__(self, client: KubeClient):
        self.ai_gateway_route = AIGatewayRouteClient(client)
        self.ai_service_backend = AIServiceBackendClient(client)
        self.backend_security_policy = BackendSecurityPolicyClient(client)
        self.gateway_config = GatewayConfigClient(client)
        self.mcp_route = MCPRouteClient(client)
        self.quota_policy = QuotaPolicyClient(client)


ALL_KINDS = ['AIGatewayRoute', 'AIServiceBackend', 'BackendSecurityPolicy', 'GatewayConfig', 'MCPRoute', 'QuotaPolicy']
