"""The replica's ``/metrics`` surface and the engine's serving-phase
latency histograms (the port's copy of ``aigw_tpu/obs/metrics.py``'s
replica half; standard library only).

``GET /metrics`` renders, in the reference's order: the GenAI request
families (``GENAI_FAMILIES``), the engine gauges (``ENGINE_GAUGES``),
the resolved decode rung as an info gauge, the per-device gauges
(``DEVICE_GAUGES``), the MoE per-expert and per-layer gauges (MoE
families only) and the phase histograms with trace-id exemplars
(``ENGINE_HISTOGRAMS``). The reference registers the GenAI families on a
``prometheus_client`` registry, which the port does not depend on; they
are written here by hand with the same names, help strings and types,
and render as ``prometheus_client.generate_latest`` renders them. The
four GenAI histograms (``GenAIMetrics``, labeled by operation, provider
and request and response model, the token usage also by token type and
the duration by error type) take the reference's buckets and are
observed where the reference replica observes them: a handler makes a
``RequestMetrics``, each streamed token calls ``record_tokens_emitted``
(time to first token, time per output token) and the request's end
``finish`` (token usage, request duration). A family with samples
renders its ``_bucket``, ``_count`` and ``_sum`` lines per label set,
then its ``_created`` gauge, which ``parse_exposition`` counts as part
of the histogram.

The reference exports 100 engine gauges, and so does the port: its
``EngineStats`` has the fields of ``ENGINE_GAUGES``, the reference's map.
``GAUGES_NOT_PORTED``, the gauges a later slice would bring with their
ROADMAP entry, is empty, so the port's family set (``metric_families``)
is the reference's.

``/state`` exports ``EnginePhases.percentiles()`` as
``phase_percentiles``, the key the gateway's picker prices a replica's
TTFT from, and the TTFT histogram's ``cumulative()`` buckets as
``ttft_hist_buckets``, which the gateway's SLO burn-rate monitor reads
off the same poll.
"""

from __future__ import annotations

import bisect
import math
import re
import threading
import time
from dataclasses import dataclass, field
from typing import Any

#: the GenAI and gateway request families of the reference's
#: ``GenAIMetrics`` registry: (name, type, help), in registration order
GENAI_FAMILIES: tuple[tuple[str, str, str], ...] = (
    ("gen_ai_client_token_usage", "histogram",
     "Number of input/output tokens used per request"),
    ("gen_ai_server_request_duration_seconds", "histogram",
     "End-to-end request duration"),
    ("gen_ai_server_time_to_first_token_seconds", "histogram",
     "Time until the first streamed token"),
    ("gen_ai_server_time_per_output_token_seconds", "histogram",
     "Inter-token latency for streamed tokens"),
    ("aigw_requests_total", "counter", "Requests by route/backend/status"),
    ("aigw_retries_total", "counter", "Upstream retry attempts"),
    ("aigw_slo_sheds_total", "counter",
     "Requests shed because predicted TTFT exceeded the SLO on every "
     "candidate replica"),
    ("aigw_migrations_total", "counter",
     "Sessions migrated between replicas by the gateway"),
)


#: the reference's GenAI histogram buckets (seconds, and tokens)
LATENCY_BUCKETS = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
    10.0, 30.0, 60.0, 120.0,
)
TOKEN_BUCKETS = (
    1, 4, 16, 64, 256, 1024, 4096, 16384, 65536, 262144, 1048576,
)
#: the GenAI label names, in the reference's order
GENAI_LABELS = ("gen_ai_operation_name", "gen_ai_provider_name",
                "gen_ai_request_model", "gen_ai_response_model")


def float_to_go(d: float) -> str:
    """A sample value or bucket bound as ``prometheus_client`` writes it
    (its ``floatToGoString``: Go's exponent form past 1e6)."""
    d = float(d)
    if d == math.inf:
        return "+Inf"
    if d == -math.inf:
        return "-Inf"
    if math.isnan(d):
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    if d > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')


def _escape_help(h: str) -> str:
    return h.replace("\\", r"\\").replace("\n", r"\n")


class LabeledHistogram:
    """A Prometheus histogram with label names, rendered as
    ``generate_latest`` renders ``prometheus_client.Histogram``: label
    sets in first-observation order, labels sorted by name, cumulative
    ``_bucket`` lines (``le`` last through ``+Inf``), ``_count``,
    ``_sum``, then every label set's ``_created`` time as a gauge
    family. With no label names the one child exists from construction
    and renders at zero, as ``prometheus_client``'s does. Handler
    threads observe under a lock."""

    def __init__(self, name: str, help_: str, labelnames: tuple[str, ...],
                 buckets: tuple[float, ...]):
        self.name = name
        self.help = help_
        self.labelnames = labelnames
        self.bounds = tuple(float(b) for b in buckets) + (math.inf,)
        # label values → [bucket counts, sum, created]
        self._children: dict[tuple[str, ...], list] = {}
        if not labelnames:
            self._children[()] = [[0] * len(self.bounds), 0.0, time.time()]
        self._lock = threading.Lock()

    def observe(self, labels: tuple[str, ...], value: float) -> None:
        if len(labels) != len(self.labelnames):
            raise ValueError(f"{self.name}: {len(self.labelnames)} label "
                             f"values expected, got {labels!r}")
        with self._lock:
            c = self._children.get(labels)
            if c is None:
                c = self._children[labels] = [
                    [0] * len(self.bounds), 0.0, time.time()]
            c[0][bisect.bisect_left(self.bounds, value)] += 1
            c[1] += value

    def _labelstr(self, labels: tuple[str, ...], extra=()) -> str:
        pairs = sorted(list(zip(self.labelnames, labels)) + list(extra))
        ls = ",".join(f'{k}="{_escape_label(v)}"' for k, v in pairs)
        return f"{{{ls}}}" if ls else ""

    def render(self) -> str:
        help_ = _escape_help(self.help)
        out = [f"# HELP {self.name} {help_}\n",
               f"# TYPE {self.name} histogram\n"]
        created = []
        with self._lock:
            children = [(k, list(c[0]), c[1], c[2])
                        for k, c in self._children.items()]
        for labels, counts, total, t0 in children:
            acc = 0
            for bound, n in zip(self.bounds, counts):
                acc += n
                ls = self._labelstr(labels, [("le", float_to_go(bound))])
                out.append(f"{self.name}_bucket{ls} {float_to_go(acc)}\n")
            ls = self._labelstr(labels)
            out.append(f"{self.name}_count{ls} {float_to_go(acc)}\n")
            out.append(f"{self.name}_sum{ls} {float_to_go(total)}\n")
            created.append(f"{self.name}_created{ls} "
                           f"{float_to_go(t0)}\n")
        if created:
            out.append(f"# HELP {self.name}_created {help_}\n")
            out.append(f"# TYPE {self.name}_created gauge\n")
            out += created
        return "".join(out)


class LabeledCounter:
    """A Prometheus counter with label names, rendered as
    ``generate_latest`` renders ``prometheus_client.Counter``: label sets
    in first-increment order, labels sorted by name, then every label
    set's ``_created`` time as a gauge family (an unlabeled counter's one
    child exists, at zero, from construction). ``labels(*values).inc(n)``
    as the reference's counters are moved."""

    def __init__(self, name: str, help_: str,
                 labelnames: tuple[str, ...]):
        self.name = name
        self.help = help_
        self.labelnames = labelnames
        # label values → [value, created]
        self._children: dict[tuple[str, ...], list] = {}
        if not labelnames:
            self._children[()] = [0.0, time.time()]
        self._lock = threading.Lock()

    def labels(self, *values: str) -> "_CounterChild":
        if len(values) != len(self.labelnames):
            raise ValueError(f"{self.name}: {len(self.labelnames)} label "
                             f"values expected, got {values!r}")
        return _CounterChild(self, tuple(str(v) for v in values))

    def _inc(self, labels: tuple[str, ...], n: float) -> None:
        with self._lock:
            c = self._children.get(labels)
            if c is None:
                c = self._children[labels] = [0.0, time.time()]
            c[0] += n

    def render(self) -> str:
        base = self.name[:-len("_total")] if self.name.endswith(
            "_total") else self.name
        help_ = _escape_help(self.help)
        out = [f"# HELP {self.name} {help_}\n",
               f"# TYPE {self.name} counter\n"]
        created = []
        with self._lock:
            children = [(k, c[0], c[1]) for k, c in self._children.items()]
        for labels, v, t0 in children:
            ls = ",".join(f'{k}="{_escape_label(x)}"' for k, x in
                          sorted(zip(self.labelnames, labels)))
            ls = f"{{{ls}}}" if ls else ""
            out.append(f"{self.name}{ls} {float_to_go(v)}\n")
            created.append(f"{base}_created{ls} {float_to_go(t0)}\n")
        if created:
            out.append(f"# HELP {base}_created {help_}\n")
            out.append(f"# TYPE {base}_created gauge\n")
            out += created
        return "".join(out)


@dataclass
class _CounterChild:
    counter: LabeledCounter
    labels: tuple[str, ...]

    def inc(self, n: float = 1.0) -> None:
        self.counter._inc(self.labels, n)


#: the gateway's counters: (attribute, label names)
GATEWAY_COUNTERS: tuple[tuple[str, tuple[str, ...]], ...] = (
    ("requests_total", ("route", "backend", "status")),
    ("retries_total", ("route", "backend")),
    ("slo_sheds_total", ("route", "backend")),
    ("migrations_total", ("route", "backend")),
)


class GenAIMetrics:
    """The reference's ``GenAIMetrics`` registry: the four GenAI
    histograms and the gateway's four counters (``GATEWAY_COUNTERS``),
    which the gateway moves and a replica declares and never moves."""

    def __init__(self) -> None:
        (tu, _t, tu_h), (rd, _t, rd_h), (ft, _t, ft_h), (tp, _t, tp_h) = \
            GENAI_FAMILIES[:4]
        self.token_usage = LabeledHistogram(
            tu, tu_h, GENAI_LABELS + ("gen_ai_token_type",), TOKEN_BUCKETS)
        self.request_duration = LabeledHistogram(
            rd, rd_h, GENAI_LABELS + ("error_type",), LATENCY_BUCKETS)
        self.time_to_first_token = LabeledHistogram(
            ft, ft_h, GENAI_LABELS, LATENCY_BUCKETS)
        self.time_per_output_token = LabeledHistogram(
            tp, tp_h, GENAI_LABELS, LATENCY_BUCKETS)
        self.counters = tuple(
            LabeledCounter(name, help_, labelnames)
            for (name, _t, help_), (_a, labelnames)
            in zip(GENAI_FAMILIES[4:], GATEWAY_COUNTERS))
        for (attr, _l), counter in zip(GATEWAY_COUNTERS, self.counters):
            setattr(self, attr, counter)
        #: families registered later on the same registry (the gateway's
        #: ``MCPMetrics``), rendered after these in registration order
        self.extra: list = []

    def histograms(self) -> tuple[LabeledHistogram, ...]:
        return (self.token_usage, self.request_duration,
                self.time_to_first_token, self.time_per_output_token)

    def export(self) -> bytes:
        """The families in registration order, as ``generate_latest``."""
        return ("".join(h.render() for h in self.histograms())
                + "".join(c.render() for c in self.counters)
                + "".join(f.render() for f in self.extra)).encode()


def render_genai_families(genai: GenAIMetrics | None = None) -> bytes:
    """The GenAI families as ``generate_latest`` writes them: ``genai``'s
    samples, or none."""
    return (genai or GenAIMetrics()).export()


class MCPMetrics:
    """The MCP proxy's instruments (the reference's ``MCPMetrics``: method
    counts by method, backend and status, request and initialization
    durations, negotiated capabilities, routed progress notifications
    and errors by type), registered on the gateway's ``GenAIMetrics``
    so ``/metrics`` renders them after its families, as the reference's
    shared registry does."""

    def __init__(self, genai: GenAIMetrics):
        self.method_total = LabeledCounter(
            "mcp_method_total",
            "JSON-RPC methods handled by the MCP proxy",
            ("mcp_method_name", "mcp_backend", "status"))
        self.request_duration = LabeledHistogram(
            "mcp_request_duration_seconds",
            "MCP request handling duration",
            ("mcp_method_name",), LATENCY_BUCKETS)
        self.initialization_duration = LabeledHistogram(
            "mcp_initialization_duration_seconds",
            "MCP session initialization duration (backend fan-out)",
            (), LATENCY_BUCKETS)
        self.capabilities_negotiated = LabeledCounter(
            "mcp_capabilities_negotiated_total",
            "Capabilities negotiated at initialize",
            ("capability_type", "capability_side"))
        self.progress_notifications = LabeledCounter(
            "mcp_progress_notifications_total",
            "Progress notifications routed through the proxy", ())
        self.errors_total = LabeledCounter(
            "mcp_errors_total",
            "MCP errors by method and type",
            ("mcp_method_name", "error_type"))
        genai.extra += [self.method_total, self.request_duration,
                        self.initialization_duration,
                        self.capabilities_negotiated,
                        self.progress_notifications, self.errors_total]


@dataclass
class RequestMetrics:
    """One request's GenAI recorder (the reference's ``RequestMetrics``):
    the replica's handlers make one per generation and the gateway one
    per request, call ``record_tokens_emitted`` per streamed token and
    ``finish`` at its end."""

    metrics: GenAIMetrics
    operation: str = "chat"
    provider: str = ""
    request_model: str = ""
    response_model: str = ""
    start: float = field(default_factory=time.monotonic)
    first_token_at: float = 0.0
    last_token_at: float = 0.0
    tokens_seen: int = 0
    final_usage: Any = None
    error_type: str = ""
    # the gateway's access-log fields: cost metadata, upstream attempts,
    # the replica's request id and the pick's decision-ring entry
    costs: dict = field(default_factory=dict)
    attempts: int = 0
    upstream_request_id: str = ""
    decision: dict = field(default_factory=dict)

    def _labels(self) -> tuple[str, ...]:
        return (self.operation, self.provider, self.request_model,
                self.response_model or self.request_model)

    def record_tokens_emitted(self, n: int) -> None:
        """Streamed tokens: the first observes the time to first token,
        each later call the time per output token since the last."""
        if n <= 0:
            return
        now = time.monotonic()
        if self.first_token_at == 0.0:
            self.first_token_at = now
            self.metrics.time_to_first_token.observe(self._labels(),
                                                     now - self.start)
        elif self.tokens_seen:
            self.metrics.time_per_output_token.observe(
                self._labels(), (now - self.last_token_at) / n)
        self.last_token_at = now
        self.tokens_seen += n

    def finish(self, usage, error_type: str = "") -> None:
        """The request's token usage by type (non-zero counts only) and
        its duration, labeled by ``error_type``."""
        self.final_usage = usage
        self.error_type = error_type
        labels = self._labels()
        for token_type, n in (("input", usage.input_tokens),
                              ("output", usage.output_tokens),
                              ("total", usage.total_tokens),
                              ("cached_input", usage.cached_input_tokens)):
            if n:
                self.metrics.token_usage.observe(labels + (token_type,), n)
        self.metrics.request_duration.observe(
            labels + (error_type,), time.monotonic() - self.start)


#: FleetState rollup key → the gateway's ``aigw_fleet_*`` gauge
FLEET_GAUGES: tuple[tuple[str, str], ...] = (
    ("replicas_total", "aigw_fleet_replicas_total"),
    ("replicas_up", "aigw_fleet_replicas_up"),
    ("replicas_degraded", "aigw_fleet_replicas_degraded"),
    ("replicas_draining", "aigw_fleet_replicas_draining"),
    ("replicas_down", "aigw_fleet_replicas_down"),
    ("slots_total", "aigw_fleet_slots_total"),
    ("slots_free", "aigw_fleet_slots_free"),
    ("queued_total", "aigw_fleet_queued_total"),
    ("kv_occupancy_worst", "aigw_fleet_kv_occupancy_worst"),
    ("kv_occupancy_mean", "aigw_fleet_kv_occupancy_mean"),
    ("device_memory_frac_worst",
     "aigw_fleet_device_memory_frac_worst"),
    ("kv_spills_total", "aigw_fleet_kv_spills_total"),
    ("kv_revives_total", "aigw_fleet_kv_revives_total"),
    ("kv_fetch_pages_in_total", "aigw_fleet_kv_fetch_pages_in_total"),
    ("kv_fetch_pages_out_total",
     "aigw_fleet_kv_fetch_pages_out_total"),
    ("migrations_in_total", "aigw_fleet_migrations_in_total"),
    ("migrations_out_total", "aigw_fleet_migrations_out_total"),
    ("adapters_resident", "aigw_fleet_adapters_resident"),
    ("slo_goodput", "aigw_fleet_slo_goodput"),
    ("slo_burn_rate", "aigw_fleet_slo_burn_rate"),
    ("slo_overshoot_sustained", "aigw_fleet_slo_overshoot_sustained"),
)


def render_fleet_gauges(rollup: dict, backend: str = "") -> bytes:
    """A FleetState rollup → the ``aigw_fleet_*`` gauges, labeled by
    backend pool when the gateway serves more than one."""
    sel = f'{{backend="{backend}"}}' if backend else ""
    lines = []
    for key, name in FLEET_GAUGES:
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name}{sel} {rollup.get(key, 0)}")
    return ("\n".join(lines) + "\n").encode()


#: UsageLedger snapshot key → the gateway's ``aigw_usage_*`` gauge
USAGE_GAUGES: tuple[tuple[str, str], ...] = (
    ("records_total", "aigw_usage_records_total"),
    ("prefill_tokens_total", "aigw_usage_prefill_tokens_total"),
    ("prefill_padded_tokens_total",
     "aigw_usage_prefill_padded_tokens_total"),
    ("prefix_reused_tokens_total",
     "aigw_usage_prefix_reused_tokens_total"),
    ("decode_tokens_total", "aigw_usage_decode_tokens_total"),
    ("spec_drafted_total", "aigw_usage_spec_drafted_total"),
    ("spec_accepted_total", "aigw_usage_spec_accepted_total"),
    ("hbm_page_byte_s_total", "aigw_usage_hbm_page_byte_s_total"),
    ("host_page_byte_s_total", "aigw_usage_host_page_byte_s_total"),
    ("cost_total", "aigw_usage_cost_total"),
    ("tenants", "aigw_usage_tenants"),
    ("windows_closed_total", "aigw_usage_windows_closed_total"),
    ("journal_lines_total", "aigw_usage_journal_lines_total"),
    ("reconcile_mismatches_total",
     "aigw_usage_reconcile_mismatches_total"),
    ("over_budget_tenants", "aigw_usage_over_budget_tenants"),
    ("burn_sustained_tenants", "aigw_usage_burn_sustained_tenants"),
)


def render_usage_gauges(snapshot: dict) -> bytes:
    """A UsageLedger snapshot → the ``aigw_usage_*`` gauges the gateway
    appends to its ``/metrics``."""
    lines = []
    for key, name in USAGE_GAUGES:
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {snapshot.get(key, 0)}")
    return ("\n".join(lines) + "\n").encode()


#: ``FleetController.gauge_values()`` key → the gauge the gateway's
#: ``GET /fleet/metrics`` renders for a pool with a controller
CONTROLLER_GAUGES: tuple[tuple[str, str], ...] = (
    ("scale_outs", "aigw_ctl_scale_outs_total"),
    ("scale_ins", "aigw_ctl_scale_ins_total"),
    ("drains", "aigw_ctl_drains_total"),
    ("retires", "aigw_ctl_retires_total"),
    ("failovers", "aigw_ctl_failovers_total"),
    ("launch_failures", "aigw_ctl_launch_failures_total"),
    ("launches_in_flight", "aigw_ctl_launches_in_flight"),
    ("drains_in_progress", "aigw_ctl_drains_in_progress"),
    ("replicas_min", "aigw_ctl_replicas_min"),
    ("replicas_max", "aigw_ctl_replicas_max"),
    ("replicas_live", "aigw_ctl_replicas_live"),
    ("idle_streak", "aigw_ctl_idle_streak"),
)


def render_controller_gauges(values: dict, backend: str = "") -> bytes:
    """A FleetController's gauge dict → the ``aigw_ctl_*`` gauges,
    labeled by backend pool when the gateway serves more than one."""
    sel = f'{{backend="{backend}"}}' if backend else ""
    lines = []
    for key, name in CONTROLLER_GAUGES:
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name}{sel} {values.get(key, 0)}")
    return ("\n".join(lines) + "\n").encode()


#: EngineStats attribute → Prometheus gauge name, the reference's map
#: (same order; none is in ``GAUGES_NOT_PORTED``)
ENGINE_GAUGES: tuple[tuple[str, str], ...] = (
    ("active_slots", "tpuserve_active_slots"),
    ("queued", "tpuserve_queued_requests"),
    ("queue_wait_ms", "tpuserve_queue_wait_ms"),
    ("kv_pages_free", "tpuserve_kv_pages_free"),
    ("kv_occupancy", "tpuserve_kv_occupancy"),
    ("tokens_generated", "tpuserve_tokens_generated_total"),
    ("prefills", "tpuserve_prefills_total"),
    ("sp_prefills", "tpuserve_sp_prefills_total"),
    # the sequence-parallel prefill: prefills that ran as chunked ring
    # steps, those that resumed at a cached offset, and short requests
    # admitted at a chunk boundary of one
    ("sp_chunked_prefills", "tpuserve_sp_chunked_prefills_total"),
    ("sp_resume_prefills", "tpuserve_sp_resume_prefills_total"),
    ("sp_interactive_admits", "tpuserve_sp_interactive_admits_total"),
    ("chunked_prefill_steps", "tpuserve_chunked_prefill_steps_total"),
    ("decode_steps", "tpuserve_decode_steps_total"),
    ("decode_window", "tpuserve_decode_window_steps"),
    ("window_shrinks", "tpuserve_decode_window_shrinks_total"),
    ("window_grows", "tpuserve_decode_window_grows_total"),
    ("spec_accepted", "tpuserve_spec_accepted_total"),
    ("spec_drafted", "tpuserve_spec_drafted_tokens_total"),
    ("spec_accept_rate", "tpuserve_spec_accept_rate"),
    ("spec_draft_len", "tpuserve_spec_draft_len"),
    ("spec_rung_ups", "tpuserve_spec_rung_ups_total"),
    ("spec_rung_downs", "tpuserve_spec_rung_downs_total"),
    ("spec_lookahead_slots", "tpuserve_spec_lookahead_slots_total"),
    ("state_rebuilds", "tpuserve_state_rebuilds_total"),
    ("prefix_cache_hits", "tpuserve_prefix_cache_hits_total"),
    ("prefix_tokens_reused", "tpuserve_prefix_tokens_reused_total"),
    ("prefix_cache_misses", "tpuserve_prefix_cache_misses_total"),
    ("prefix_cache_evictions", "tpuserve_prefix_cache_evictions_total"),
    ("prefix_full_hits", "tpuserve_prefix_full_hits_total"),
    ("prefix_cow_copies", "tpuserve_prefix_cow_copies_total"),
    ("prefix_pages_resident", "tpuserve_prefix_pages_resident"),
    ("prefix_pages_pinned", "tpuserve_prefix_pages_pinned"),
    ("prefix_cache_hit_rate", "tpuserve_prefix_cache_hit_rate"),
    ("prefill_ms", "tpuserve_prefill_ms_total"),
    ("transfer_ms", "tpuserve_transfer_ms_total"),
    ("emit_ms", "tpuserve_emit_ms_total"),
    ("first_emit_ms", "tpuserve_first_emit_ms_total"),
    ("prefill_tokens_real", "tpuserve_prefill_tokens_real_total"),
    ("prefill_tokens_padded", "tpuserve_prefill_tokens_padded_total"),
    ("prefill_padded_frac", "tpuserve_prefill_padded_frac"),
    ("warmup_ms", "tpuserve_warmup_ms"),
    # the programs warm-up captured, and the captures made since the
    # engine came up with their wall ms (a CUDA graph stands for a
    # compiled program): growth after warm-up is a hot-path capture
    ("warm_programs", "tpuserve_warm_programs"),
    ("xla_compiles", "tpuserve_xla_compiles_total"),
    ("xla_compile_ms", "tpuserve_xla_compile_ms_total"),
    ("adapter_loads", "tpuserve_adapter_loads_total"),
    ("adapter_evictions", "tpuserve_adapter_evictions_total"),
    ("adapter_resident", "tpuserve_adapter_resident"),
    ("adapter_slots", "tpuserve_adapter_slots"),
    ("migrations_out", "tpuserve_migrations_out_total"),
    ("migrations_in", "tpuserve_migrations_in_total"),
    ("migration_pages_out", "tpuserve_migration_pages_out_total"),
    ("migration_pages_in", "tpuserve_migration_pages_in_total"),
    ("migratable_slots", "tpuserve_migratable_slots"),
    ("kv_spills", "tpuserve_kv_spills_total"),
    ("kv_revives", "tpuserve_kv_revives_total"),
    ("kv_spill_evictions", "tpuserve_kv_spill_evictions_total"),
    ("kv_spilled_pages", "tpuserve_kv_spilled_pages"),
    ("kv_spill_bytes", "tpuserve_kv_spill_bytes"),
    ("kv_host_bytes", "tpuserve_kv_host_bytes"),
    ("kv_fetches_out", "tpuserve_kv_fetches_out_total"),
    ("kv_fetches_in", "tpuserve_kv_fetches_in_total"),
    ("kv_fetch_pages_out", "tpuserve_kv_fetch_pages_out_total"),
    ("kv_fetch_pages_in", "tpuserve_kv_fetch_pages_in_total"),
    ("tenants_active", "tpuserve_tenants_active"),
    ("tenant_max_slots", "tpuserve_tenant_max_slots"),
    ("tenant_deferrals", "tpuserve_tenant_deferrals_total"),
    ("constrained_slots", "tpuserve_constrained_slots"),
    ("constraint_requests", "tpuserve_constraint_requests_total"),
    ("constraint_rollbacks", "tpuserve_constraint_rollbacks_total"),
    ("constraint_mask_updates",
     "tpuserve_constraint_mask_updates_total"),
    ("constraint_grammars", "tpuserve_constraint_grammars"),
    ("device_bytes_in_use", "tpuserve_device_bytes_in_use"),
    ("device_bytes_limit", "tpuserve_device_bytes_limit"),
    ("device_memory_frac", "tpuserve_device_memory_frac"),
    ("kv_pool_bytes", "tpuserve_kv_pool_bytes"),
    ("kv_bytes_in_use", "tpuserve_kv_bytes_in_use"),
    ("device_count", "tpuserve_device_count"),
    ("device_memory_frac_worst", "tpuserve_device_memory_frac_worst"),
    # the analytical collective bytes of one decoded token on the mesh,
    # and the running total (0 off-mesh)
    ("ici_bytes_per_token", "tpuserve_ici_bytes_per_token"),
    ("ici_bytes_total", "tpuserve_ici_bytes_total"),
    ("kv_quant_bits", "tpuserve_kv_quant_bits"),
    ("kv_bytes_per_token", "tpuserve_kv_bytes_per_token"),
    ("moe_tokens_routed", "tpuserve_moe_tokens_routed_total"),
    ("moe_tokens_dropped", "tpuserve_moe_tokens_dropped_total"),
    ("moe_dropped_frac", "tpuserve_moe_dropped_frac"),
    ("moe_expert_imbalance", "tpuserve_moe_expert_imbalance"),
    # the offline batch tier: waiting work (queued lines and parked
    # sessions), slots it holds, parks and resumes, tokens generated
    ("batch_queued", "tpuserve_batch_queued"),
    ("batch_active", "tpuserve_batch_active"),
    ("batch_preemptions", "tpuserve_batch_preemptions_total"),
    ("batch_resumed", "tpuserve_batch_resumed_total"),
    ("batch_tokens", "tpuserve_batch_tokens_total"),
    # engine-truth usage metering: cumulative MeterRecord totals, moved
    # only where a record is emitted (Engine._meter_emit)
    ("meter_records", "tpuserve_meter_records_total"),
    ("meter_prefill_tokens", "tpuserve_meter_prefill_tokens_total"),
    ("meter_prefill_padded_tokens",
     "tpuserve_meter_prefill_padded_tokens_total"),
    ("meter_prefix_reused_tokens",
     "tpuserve_meter_prefix_reused_tokens_total"),
    ("meter_decode_tokens", "tpuserve_meter_decode_tokens_total"),
    ("meter_spec_drafted", "tpuserve_meter_spec_drafted_total"),
    ("meter_spec_accepted", "tpuserve_meter_spec_accepted_total"),
    ("meter_hbm_page_byte_s", "tpuserve_meter_hbm_page_byte_s_total"),
    ("meter_host_page_byte_s",
     "tpuserve_meter_host_page_byte_s_total"),
)

#: the reference's engine gauges the port does not export: EngineStats
#: attribute → (gauge name, ROADMAP queue 1 entry). None since the
#: sequence-parallel prefill's four were ported
GAUGES_NOT_PORTED: dict[str, tuple[str, str]] = {}


def render_engine_gauges(stats: object) -> bytes:
    """EngineStats → Prometheus text exposition."""
    lines = []
    for attr, name in ENGINE_GAUGES:
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {getattr(stats, attr, 0)}")
    return ("\n".join(lines) + "\n").encode()


#: the resolved decode rung, an info gauge labeled by its name
DECODE_IMPL_GAUGE = "tpuserve_decode_attn_impl"


def render_decode_impl(impl: str) -> bytes:
    return (f"# TYPE {DECODE_IMPL_GAUGE} gauge\n"
            f'{DECODE_IMPL_GAUGE}{{impl="{impl}"}} 1\n').encode()


#: key in one entry of ``Engine.device_stats`` → labeled gauge name
DEVICE_GAUGES: tuple[tuple[str, str], ...] = (
    ("bytes_in_use", "tpuserve_device_bytes_in_use_per_device"),
    ("bytes_limit", "tpuserve_device_bytes_limit_per_device"),
    ("memory_frac", "tpuserve_device_memory_frac_per_device"),
    ("kv_pool_bytes", "tpuserve_device_kv_pool_bytes"),
    ("kv_bytes_in_use", "tpuserve_device_kv_bytes_in_use"),
    ("kv_occupancy", "tpuserve_device_kv_occupancy"),
    ("param_bytes", "tpuserve_device_param_bytes"),
)


def render_device_gauges(devices: list) -> bytes:
    """Per-device stats dicts → gauges labeled ``device``."""
    lines = []
    for _key, name in DEVICE_GAUGES:
        lines.append(f"# TYPE {name} gauge")
    for dev in devices:
        label = dev.get("id", 0)
        for key, name in DEVICE_GAUGES:
            lines.append(f'{name}{{device="{label}"}} {dev.get(key, 0)}')
    return ("\n".join(lines) + "\n").encode() if lines else b""


#: the MoE per-expert and per-layer gauges (MoE families only)
MOE_FAMILIES = ("tpuserve_moe_expert_load", "tpuserve_moe_layer_drops")


def render_moe_gauges(expert_load: list, layer_drops: list) -> bytes:
    """MoE per-expert / per-layer totals → labeled gauges; dense
    families contribute zero bytes (``/state``'s ``moe_expert_load`` and
    ``moe_layer_drops`` in the same order)."""
    if not expert_load and not layer_drops:
        return b""
    lines = ["# TYPE tpuserve_moe_expert_load gauge"]
    for e, n in enumerate(expert_load):
        lines.append(f'tpuserve_moe_expert_load{{expert="{e}"}} {n}')
    lines.append("# TYPE tpuserve_moe_layer_drops gauge")
    for layer, n in enumerate(layer_drops):
        lines.append(f'tpuserve_moe_layer_drops{{layer="{layer}"}} {n}')
    return ("\n".join(lines) + "\n").encode()


#: (phase key, metric family name), in the reference's order
ENGINE_HISTOGRAMS: tuple[tuple[str, str], ...] = (
    ("queue_wait", "tpuserve_queue_wait_hist_ms"),
    ("prefill", "tpuserve_prefill_hist_ms"),
    ("ttft", "tpuserve_ttft_hist_ms"),
    ("first_emit", "tpuserve_first_emit_hist_ms"),
    ("decode_per_token", "tpuserve_decode_per_token_hist_ms"),
    ("transfer", "tpuserve_transfer_hist_ms"),
)

#: histogram bucket upper bounds in milliseconds (+Inf implicit)
PHASE_BUCKETS_MS: tuple[float, ...] = (
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0, 30000.0,
)


def metric_families(moe: bool = False) -> frozenset[str]:
    """The family names a port replica's ``/metrics`` declares (``#
    TYPE`` lines): the reference replica's less ``GAUGES_NOT_PORTED``."""
    names = [n for n, _t, _h in GENAI_FAMILIES]
    names += [n for _a, n in ENGINE_GAUGES]
    names.append(DECODE_IMPL_GAUGE)
    names += [n for _k, n in DEVICE_GAUGES]
    if moe:
        names += MOE_FAMILIES
    names += [n for _k, n in ENGINE_HISTOGRAMS]
    return frozenset(names)


_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? (\S+)'
    r'( # \{trace_id="[0-9a-f]+"\} \S+)?$')


def parse_exposition(text: str) -> dict[str, str]:
    """A Prometheus text exposition → ``{family: type}``. Raises
    ValueError on a malformed line or a sample whose family was never
    declared (a histogram's ``_bucket``, ``_sum`` and ``_count``, and
    its ``_created`` gauge family, belong to it); exemplar suffixes are
    accepted on any sample."""
    fams: dict[str, str] = {}
    for no, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(" ", 3)
            if len(parts) < 4 or parts[1] not in ("HELP", "TYPE"):
                raise ValueError(f"line {no}: bad comment {line!r}")
            if parts[1] == "TYPE":
                if parts[3] not in ("gauge", "counter", "histogram"):
                    raise ValueError(f"line {no}: bad type {line!r}")
                if parts[2].endswith("_created") and fams.get(
                        parts[2][:-len("_created")]) == "histogram":
                    continue  # a histogram's creation times, its own
                fams[parts[2]] = parts[3]
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {no}: bad sample {line!r}")
        name = m.group(1)
        float(m.group(3))
        base = re.sub(r"_(bucket|sum|count|created)$", "", name)
        if name not in fams and fams.get(base) != "histogram":
            raise ValueError(f"line {no}: undeclared family {name!r}")
    return fams


class PhaseHistogram:
    """Fixed-bucket latency histogram with per-bucket trace-id
    exemplars. The engine thread writes (``observe`` is a few list and
    scalar operations, no lock); readers tolerate a count torn by one
    observation."""

    __slots__ = ("name", "buckets", "counts", "total", "count",
                 "exemplars")

    def __init__(self, name: str,
                 buckets: tuple[float, ...] = PHASE_BUCKETS_MS):
        self.name = name
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)  # last = +Inf
        self.total = 0.0
        self.count = 0
        # bucket index → (trace_id, observed value) of the most recent
        # traced observation landing there
        self.exemplars: dict[int, tuple[str, float]] = {}

    def observe(self, ms: float, trace_id: str = "") -> None:
        i = bisect.bisect_left(self.buckets, ms)
        self.counts[i] += 1
        self.total += ms
        self.count += 1
        if trace_id:
            self.exemplars[i] = (trace_id, ms)

    def percentile(self, q: float) -> float:
        """q in (0, 1] -> linear interpolation inside the target bucket;
        -1.0 when empty (distinguishable from a real 0 ms)."""
        counts = list(self.counts)
        n = sum(counts)
        if n == 0:
            return -1.0
        target = q * n
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            if cum >= target:
                hi = (self.buckets[i] if i < len(self.buckets)
                      else self.buckets[-1] * 2)
                lo = self.buckets[i - 1] if i > 0 else 0.0
                if c == 0:
                    return hi
                frac = (target - (cum - c)) / c
                return lo + (hi - lo) * frac
        return self.buckets[-1] * 2

    def percentiles(self) -> dict[str, float]:
        return {
            "p50": round(self.percentile(0.50), 3),
            "p95": round(self.percentile(0.95), 3),
            "p99": round(self.percentile(0.99), 3),
        }

    def cumulative(self) -> dict[str, int]:
        """Cumulative bucket counts ``{le: count}``, ``+Inf`` last (the
        reference's ``/state`` ``ttft_hist_buckets``)."""
        out: dict[str, int] = {}
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            le = (f"{self.buckets[i]:g}" if i < len(self.buckets)
                  else "+Inf")
            out[le] = cum
        return out

    def render(self) -> str:
        """Prometheus histogram exposition; a bucket line carries an
        OpenMetrics-style ``# {trace_id="…"} v`` exemplar when a traced
        request landed in the bucket."""
        lines = [f"# TYPE {self.name} histogram"]
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            le = (f"{self.buckets[i]:g}" if i < len(self.buckets)
                  else "+Inf")
            line = f'{self.name}_bucket{{le="{le}"}} {cum}'
            ex = self.exemplars.get(i)
            if ex is not None:
                line += f' # {{trace_id="{ex[0]}"}} {ex[1]:g}'
            lines.append(line)
        lines.append(f"{self.name}_sum {self.total:g}")
        lines.append(f"{self.name}_count {cum}")
        return "\n".join(lines) + "\n"


class EnginePhases:
    """One PhaseHistogram per ENGINE_HISTOGRAMS phase, owned by the
    engine; rendered on ``/metrics`` and summarized as p50/p95/p99 on
    ``/state``."""

    def __init__(self) -> None:
        self.hists: dict[str, PhaseHistogram] = {
            key: PhaseHistogram(name) for key, name in ENGINE_HISTOGRAMS
        }

    def observe(self, phase: str, ms: float, trace_id: str = "") -> None:
        h = self.hists.get(phase)
        if h is not None:
            h.observe(ms, trace_id)

    def percentiles(self) -> dict[str, dict[str, float]]:
        return {key: h.percentiles() for key, h in self.hists.items()}

    def render(self) -> bytes:
        return "".join(h.render() for h in self.hists.values()).encode()
