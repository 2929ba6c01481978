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
and render as ``prometheus_client.generate_latest`` renders them empty:
their ``# HELP`` and ``# TYPE`` lines. (The reference replica also
observes a request's token counts and duration into two of them; the
port records nothing there yet.)

The reference exports 100 engine gauges. The port's ``EngineStats``
has the fields of ``ENGINE_GAUGES``; ``GAUGES_NOT_PORTED`` names the
rest with the ROADMAP entry that brings each, so the port's family set
(``metric_families``) is the reference's minus that map.

``/state`` exports ``EnginePhases.percentiles()`` as
``phase_percentiles``, the key the gateway's picker prices a replica's
TTFT from, and the TTFT histogram's ``cumulative()`` buckets as
``ttft_hist_buckets``, which the gateway's SLO burn-rate monitor reads
off the same poll.
"""

from __future__ import annotations

import bisect
import re

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


def render_genai_families() -> bytes:
    """The GenAI families with no samples, as ``generate_latest`` writes
    them."""
    return "".join(f"# HELP {name} {help_}\n# TYPE {name} {type_}\n"
                   for name, type_, help_ in GENAI_FAMILIES).encode()


#: EngineStats attribute → Prometheus gauge name, the reference's map
#: (same order) less ``GAUGES_NOT_PORTED``
ENGINE_GAUGES: tuple[tuple[str, str], ...] = (
    ("active_slots", "tpuserve_active_slots"),
    ("queued", "tpuserve_queued_requests"),
    ("queue_wait_ms", "tpuserve_queue_wait_ms"),
    ("kv_pages_free", "tpuserve_kv_pages_free"),
    ("kv_occupancy", "tpuserve_kv_occupancy"),
    ("tokens_generated", "tpuserve_tokens_generated_total"),
    ("prefills", "tpuserve_prefills_total"),
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

_MESH = "item 7, multi-GPU"
#: the reference's engine gauges the port does not export yet:
#: EngineStats attribute → (gauge name, ROADMAP queue 1 entry)
GAUGES_NOT_PORTED: dict[str, tuple[str, str]] = {
    "sp_prefills": ("tpuserve_sp_prefills_total", _MESH),
    "sp_chunked_prefills": ("tpuserve_sp_chunked_prefills_total", _MESH),
    "sp_resume_prefills": ("tpuserve_sp_resume_prefills_total", _MESH),
    "sp_interactive_admits": ("tpuserve_sp_interactive_admits_total", _MESH),
    "ici_bytes_per_token": ("tpuserve_ici_bytes_per_token", _MESH),
    "ici_bytes_total": ("tpuserve_ici_bytes_total", _MESH),
}


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
    declared (a histogram's ``_bucket``, ``_sum`` and ``_count`` belong
    to it); exemplar suffixes are accepted on any sample."""
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
                fams[parts[2]] = parts[3]
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {no}: bad sample {line!r}")
        name = m.group(1)
        float(m.group(3))
        base = re.sub(r"_(bucket|sum|count)$", "", name)
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
