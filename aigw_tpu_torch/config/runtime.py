"""RuntimeConfig: a Config with everything pre-built for the hot path
(the port's copy of ``aigw_tpu/config/runtime.py``).

Equivalent of the upstream ``filterapi.RuntimeConfig``: each backend's
auth handler constructed (``gateway/auth.new_handler``), cost
expressions compiled, route-level cost lists merged over the global one
and the quota rate limiter built from ``quotas`` (adopting the previous
runtime's window counters across a hot reload), so per-request
processing never touches parsing or compilation.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from aigw_tpu_torch.config.model import Backend, Config, Route


@dataclass
class RuntimeBackend:
    """A Backend plus its pre-built auth handler."""

    backend: Backend
    auth_handler: Any  # gateway.auth.AuthHandler


@dataclass
class RuntimeConfig:
    config: Config
    backends: dict[str, RuntimeBackend] = field(default_factory=dict)
    cost_calculator: Any = None  # gateway.costs.CostCalculator
    # per-route calculators (global costs + route-level overrides)
    route_cost_calculators: dict[str, Any] = field(default_factory=dict)
    rate_limiter: Any = None  # gateway.ratelimit.RateLimiter

    @staticmethod
    def build(config: Config,
              previous: "RuntimeConfig | None" = None) -> "RuntimeConfig":
        from aigw_tpu_torch.config.model import _thaw
        from aigw_tpu_torch.gateway.auth import new_handler
        from aigw_tpu_torch.gateway.costs import CostCalculator
        from aigw_tpu_torch.gateway.ratelimit import RateLimiter

        config.validate()
        rc = RuntimeConfig(config=config)
        for b in config.backends:
            rc.backends[b.name] = RuntimeBackend(
                backend=b, auth_handler=new_handler(b.auth))
        rc.cost_calculator = CostCalculator.from_config(config)
        global_costs = {c.metadata_key: c for c in config.llm_request_costs}
        for route in config.routes:
            if route.llm_request_costs:
                merged = dict(global_costs)
                merged.update(
                    {c.metadata_key: c for c in route.llm_request_costs}
                )
                rc.route_cost_calculators[route.name] = CostCalculator(
                    tuple(merged.values())
                )
        rc.rate_limiter = RateLimiter.from_config_value(
            [_thaw(q) for q in config.quotas]
        ).adopt(previous.rate_limiter if previous else None)
        return rc

    def cost_calculator_for(self, route_name: str):
        return self.route_cost_calculators.get(route_name,
                                               self.cost_calculator)

    def routes_for_host(self, host: str) -> list[Route]:
        host = host.split(":")[0].lower()
        out = []
        for r in self.config.routes:
            if not r.hostnames or host in r.hostnames:
                out.append(r)
        return out
