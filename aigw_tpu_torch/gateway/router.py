"""Route matching and weighted/priority backend selection.

The reference delegates this to Envoy (weighted clusters from
AIGatewayRouteRuleBackendRef weights, priority-ordered fallback +
BackendTrafficPolicy retries — ai_gateway_route.go:377-397,
examples/provider_fallback). Here it is native: first-match rule lookup,
then a retry-aware selector that walks priority tiers and weighted-samples
within a tier, never repeating a failed backend.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Any

from aigw_tpu_torch.config.model import Route, RouteRule, RuleBackendRef
from aigw_tpu_torch.config.runtime import RuntimeConfig


class NoRouteError(Exception):
    """No route rule matched (→ 404, the reference's route-not-found rule)."""


def split_model(name: str) -> tuple[str, str]:
    """Model-zoo name resolution: ``<base>:<adapter>`` → (base, adapter);
    a plain name is (name, ""). The colon convention is tpuserve's LoRA
    surface (replica /v1/models lists ``llama-3-8b:tenant-a`` style
    entries); the gateway routes such names by their BASE model and uses
    the adapter part for tenancy accounting and picker affinity."""
    base, _, adapter = name.partition(":")
    return (base, adapter) if adapter else (name, "")


@dataclass
class RouteMatch:
    route: Route
    rule: RouteRule


def match_route(
    rc: RuntimeConfig, host: str, headers: dict[str, str]
) -> RouteMatch:
    from aigw_tpu_torch.config.model import MODEL_NAME_HEADER

    for route in rc.routes_for_host(host):
        for rule in route.rules:
            if rule.matches(headers):
                return RouteMatch(route=route, rule=rule)
    # model-zoo fallback: an adapter-suffixed name ("llama-3-8b:tenant-a")
    # routes to the rule serving its base model — a route per adapter
    # would make every adapter a config change, and the serving replica
    # resolves the suffix itself (tpuserve _resolve_adapter)
    model = headers.get(MODEL_NAME_HEADER, "")
    base, adapter = split_model(model)
    if adapter:
        base_headers = dict(headers, **{MODEL_NAME_HEADER: base})
        for route in rc.routes_for_host(host):
            for rule in route.rules:
                if rule.matches(base_headers):
                    return RouteMatch(route=route, rule=rule)
    raise NoRouteError("no route matched the request model")


@dataclass
class BackendSelector:
    """Retry-aware backend iterator for one request.

    Walks priority tiers in ascending order (priority 0 first). Within a
    tier, picks weighted-random among backends not yet tried — equivalent to
    Envoy's weighted-cluster pick plus priority failover. Backends whose
    circuit is open (outlier ejection) are deferred to a second pass so a
    fully-ejected rule still gets a best-effort attempt.
    """

    rule: RouteRule
    circuit: Any = None  # aigw_tpu_torch.gateway.circuit.CircuitBreaker | None
    rng: random.Random = field(default_factory=random.Random)
    _tried: set[str] = field(default_factory=set)
    _skip_open: bool = True

    def next_backend(self) -> RuleBackendRef | None:
        ref = self._next_backend_pass()
        if ref is None and self._skip_open and self.circuit is not None:
            # every healthy candidate is exhausted: allow open-circuit
            # backends rather than failing outright
            self._skip_open = False
            ref = self._next_backend_pass()
        return ref

    def _next_backend_pass(self) -> RuleBackendRef | None:
        for priority in sorted({b.priority for b in self.rule.backends}):
            tier = [
                b
                for b in self.rule.backends
                if b.priority == priority
                and b.backend not in self._tried
                and b.weight > 0
                and not (
                    self._skip_open
                    and self.circuit is not None
                    and self.circuit.is_open(b.backend)
                )
            ]
            if not tier:
                continue
            total = sum(b.weight for b in tier)
            pick = self.rng.uniform(0, total)
            acc = 0.0
            for b in tier:
                acc += b.weight
                if pick <= acc:
                    self._tried.add(b.backend)
                    return b
            self._tried.add(tier[-1].backend)
            return tier[-1]
        return None
