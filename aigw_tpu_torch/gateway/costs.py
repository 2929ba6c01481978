"""Token cost expression engine.

Equivalent of the reference's CEL-based cost engine
(``internal/llmcostcel/cel.go:32-71``): a cost expression is compiled once at
config load and evaluated per request with the variables

    model, backend, route_name,
    input_tokens, output_tokens, total_tokens,
    cached_input_tokens, cache_creation_input_tokens, reasoning_tokens

and must produce a non-negative integer cost.

Instead of CEL we compile a restricted Python expression: the AST is
whitelisted (arithmetic, comparisons, boolean ops, conditional expression,
min/max, variable names, numeric/string literals) so configuration can never
execute arbitrary code. This matches CEL's expressive envelope for the cost
use case while staying dependency-free.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass

from aigw_tpu_torch.config.model import (
    Config,
    ConfigError,
    LLMRequestCost,
    LLMRequestCostType,
)


#: Variables available inside cost expressions (reference cel.go:32-49,
#: plus ``tenant`` — the multi-tenant accounting key the gateway derives
#: from the x-aigw-tenant header or the model's adapter suffix).
#:
#: The second block is the engine-truth meter surface: variables sourced
#: from the tpuserve ``MeterRecord`` a self-hosted response carries in
#: ``usage.aigw_meter``. They default to 0 (or "" for ``priority``) when
#: the backend is an external provider that meters nothing, so one cost
#: expression can price both paths.
COST_VARIABLES = (
    "model",
    "backend",
    "route_name",
    "tenant",
    "input_tokens",
    "output_tokens",
    "total_tokens",
    "cached_input_tokens",
    "cache_creation_input_tokens",
    "reasoning_tokens",
    # engine-truth meter variables (tpuserve MeterRecord)
    "prefill_padded_tokens",
    "prefix_reused_tokens",
    "decode_tokens",
    "spec_drafted_tokens",
    "spec_accepted_tokens",
    "kv_page_byte_seconds",
    "host_page_byte_seconds",
    "priority",
)

_ALLOWED_NODES = (
    ast.Expression,
    ast.BinOp,
    ast.UnaryOp,
    ast.BoolOp,
    ast.Compare,
    ast.IfExp,
    ast.Call,
    ast.Name,
    ast.Load,
    ast.Constant,
    ast.Add,
    ast.Sub,
    ast.Mult,
    ast.Div,
    ast.FloorDiv,
    ast.Mod,
    ast.Pow,
    ast.USub,
    ast.UAdd,
    ast.Not,
    ast.And,
    ast.Or,
    ast.Eq,
    ast.NotEq,
    ast.Lt,
    ast.LtE,
    ast.Gt,
    ast.GtE,
    ast.In,
    ast.NotIn,
    ast.Tuple,
)

_ALLOWED_FUNCS = {"min": min, "max": max, "int": int, "float": float, "abs": abs}

_MAX_UINT64 = (1 << 64) - 1


#: the engine's MeterRecord fields (one record per request lifetime,
#: ``Engine._meter_emit``), as cost expressions and the usage ledger
#: read them off ``usage.aigw_meter``
METER_FIELDS: tuple[str, ...] = (
    "schema", "finish", "prefill_real", "prefill_padded", "prefix_reused",
    "decode_tokens", "spec_drafted", "spec_accepted", "hbm_page_byte_s",
    "host_page_byte_s", "segments", "tenant", "priority",
)


def meter_to_tuple(record: dict) -> tuple:
    """Flatten an engine MeterRecord dict into a hashable, order-stable
    tuple of ``(key, value)`` pairs for carriage inside ``TokenUsage``."""
    return tuple(sorted((str(k), v) for k, v in record.items()))


def meter_dict(usage: "TokenUsage") -> dict:
    """Inverse of :func:`meter_to_tuple` for the usage's meter payload."""
    return dict(usage.meter)


@dataclass(frozen=True)
class TokenUsage:
    """Cumulative token usage for one request.

    The reference accumulates usage with *override* semantics — the last
    usage chunk on a stream wins (extproc/processor_impl.go:556-574,
    metrics.TokenUsage). ``merge_override`` implements exactly that.

    ``meter`` carries the engine-truth MeterRecord (when the backend is
    tpuserve) as a sorted tuple of ``(key, value)`` pairs so the dataclass
    stays frozen/hashable; :func:`meter_dict` recovers the mapping.
    """

    input_tokens: int = 0
    output_tokens: int = 0
    total_tokens: int = 0
    cached_input_tokens: int = 0
    cache_creation_input_tokens: int = 0
    reasoning_tokens: int = 0
    meter: tuple = ()

    def merge_override(self, other: "TokenUsage") -> "TokenUsage":
        """Fields present (non-zero) in ``other`` override ours."""
        if other == TokenUsage():
            return self
        return TokenUsage(
            input_tokens=other.input_tokens or self.input_tokens,
            output_tokens=other.output_tokens or self.output_tokens,
            total_tokens=other.total_tokens or self.total_tokens,
            cached_input_tokens=other.cached_input_tokens
            or self.cached_input_tokens,
            cache_creation_input_tokens=other.cache_creation_input_tokens
            or self.cache_creation_input_tokens,
            reasoning_tokens=other.reasoning_tokens or self.reasoning_tokens,
            meter=other.meter or self.meter,
        )


class CostProgram:
    """A compiled cost expression (reference llmcostcel.NewProgram, cel.go:51)."""

    def __init__(self, expression: str):
        self.expression = expression
        try:
            tree = ast.parse(expression, mode="eval")
        except SyntaxError as e:
            raise ConfigError(f"invalid cost expression {expression!r}: {e}") from None
        for node in ast.walk(tree):
            if not isinstance(node, _ALLOWED_NODES):
                raise ConfigError(
                    f"cost expression {expression!r}: disallowed syntax "
                    f"{type(node).__name__}"
                )
            if isinstance(node, ast.Name):
                if node.id not in COST_VARIABLES and node.id not in _ALLOWED_FUNCS:
                    raise ConfigError(
                        f"cost expression {expression!r}: unknown variable "
                        f"{node.id!r}"
                    )
            if isinstance(node, ast.Call):
                if not (
                    isinstance(node.func, ast.Name)
                    and node.func.id in _ALLOWED_FUNCS
                ):
                    raise ConfigError(
                        f"cost expression {expression!r}: only "
                        f"{sorted(_ALLOWED_FUNCS)} calls allowed"
                    )
        self._code = compile(tree, "<cost-expression>", "eval")
        # Smoke-evaluate at compile time so bad expressions fail at config
        # load, not per request (the reference does the same via a CEL
        # typecheck in NewProgram).
        self.evaluate(TokenUsage(), model="m", backend="b", route_name="r")

    def evaluate(
        self,
        usage: TokenUsage,
        *,
        model: str = "",
        backend: str = "",
        route_name: str = "",
        tenant: str = "",
    ) -> int:
        m = dict(usage.meter)
        env = {
            "__builtins__": {},
            "model": model,
            "backend": backend,
            "route_name": route_name,
            "tenant": tenant,
            "input_tokens": usage.input_tokens,
            "output_tokens": usage.output_tokens,
            "total_tokens": usage.total_tokens,
            "cached_input_tokens": usage.cached_input_tokens,
            "cache_creation_input_tokens": usage.cache_creation_input_tokens,
            "reasoning_tokens": usage.reasoning_tokens,
            "prefill_padded_tokens": m.get("prefill_padded", 0),
            "prefix_reused_tokens": m.get("prefix_reused", 0),
            "decode_tokens": m.get("decode_tokens", 0),
            "spec_drafted_tokens": m.get("spec_drafted", 0),
            "spec_accepted_tokens": m.get("spec_accepted", 0),
            "kv_page_byte_seconds": m.get("hbm_page_byte_s", 0.0),
            "host_page_byte_seconds": m.get("host_page_byte_s", 0.0),
            "priority": m.get("priority", ""),
            **_ALLOWED_FUNCS,
        }
        out = eval(self._code, env)  # noqa: S307 — AST whitelisted above
        cost = int(out)
        if cost < 0:
            raise ValueError(
                f"cost expression {self.expression!r} produced negative {cost}"
            )
        return min(cost, _MAX_UINT64)


class CostCalculator:
    """All compiled cost metrics for a config; produces the metadata map
    written at end-of-stream (reference extproc/util.go buildDynamicMetadata)."""

    def __init__(self, costs: tuple[LLMRequestCost, ...]):
        self._entries: list[tuple[LLMRequestCost, CostProgram | None]] = []
        for c in costs:
            prog = (
                CostProgram(c.expression)
                if c.cost_type is LLMRequestCostType.EXPRESSION
                else None
            )
            self._entries.append((c, prog))

    @staticmethod
    def from_config(cfg: Config) -> "CostCalculator":
        return CostCalculator(cfg.llm_request_costs)

    def calculate(
        self,
        usage: TokenUsage,
        *,
        model: str = "",
        backend: str = "",
        route_name: str = "",
        tenant: str = "",
    ) -> dict[str, int]:
        out: dict[str, int] = {}
        for cost, prog in self._entries:
            t = cost.cost_type
            if t is LLMRequestCostType.INPUT_TOKEN:
                v = usage.input_tokens
            elif t is LLMRequestCostType.OUTPUT_TOKEN:
                v = usage.output_tokens
            elif t is LLMRequestCostType.TOTAL_TOKEN:
                v = usage.total_tokens
            elif t is LLMRequestCostType.CACHED_INPUT_TOKEN:
                v = usage.cached_input_tokens
            elif t is LLMRequestCostType.CACHE_CREATION_INPUT_TOKEN:
                v = usage.cache_creation_input_tokens
            elif t is LLMRequestCostType.REASONING_TOKEN:
                v = usage.reasoning_tokens
            else:
                assert prog is not None
                v = prog.evaluate(
                    usage, model=model, backend=backend,
                    route_name=route_name, tenant=tenant,
                )
            out[cost.metadata_key] = v
        return out
