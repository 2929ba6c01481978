"""Generated gauge/state manifest (rule ``gauge-drift``; the port's copy
of ``aigw_tpu/analysis/manifest.py``, reading the port's
``obs/metrics.py``).

The /state ↔ ENGINE_GAUGES drift contract is derived from
``obs.metrics.ENGINE_GAUGES`` plus two explicit exemption tables, and
both consumers read it:

- the ``gauge-drift`` static pass compares the derived key set against
  the literal dict keys of ``TPUServeServer.state`` at analysis time;
- drift tests iterate ``state_fields(group)`` / ``gauge_names(group)``
  instead of hand-rolled tuples.

Adding a /state field that is not an EngineStats gauge REQUIRES an
entry in ``STATE_ONLY`` (with the reason it has no gauge), and a gauge
kept off /state requires one in ``METRICS_ONLY`` — drift is a lint
error, not a test archaeology exercise.
"""

from __future__ import annotations

from dataclasses import dataclass

from aigw_tpu_torch.obs.metrics import ENGINE_GAUGES, FLEET_GAUGES, USAGE_GAUGES

ENGINE_GAUGE_ATTRS: tuple[str, ...] = tuple(a for a, _ in ENGINE_GAUGES)
FLEET_GAUGE_KEYS: tuple[str, ...] = tuple(k for k, _ in FLEET_GAUGES)
USAGE_GAUGE_KEYS: tuple[str, ...] = tuple(k for k, _ in USAGE_GAUGES)

#: EngineStats gauges that intentionally do NOT export on /state
#: (they ride /metrics only) — attr → reason. The reference keeps seven
#: more off its /state (the prefill, window and prefix counters); the
#: port's /state carries them (``tests/test_torch_histograms.py``'s
#: ``PORT_STATE_KEYS``).
METRICS_ONLY: dict[str, str] = {
    "sp_prefills": "sequence-parallel prefill counter, /metrics only",
    "adapter_resident": "/state exports the adapters_resident NAME "
                        "list; the numeric gauge rides /metrics",
}

#: /state fields with no numeric EngineStats gauge — field → reason.
STATE_ONLY: dict[str, str] = {
    "model": "replica identity, string",
    "device": "the card's name (the port's key), string",
    "enable_prefix_cache": "EngineConfig echo (the port's key)",
    "defaults_differ": "the table of defaults the port sets apart from "
                       "the reference's (the port's key), dict",
    "replica_id": "fleet identity, string",
    "started_at": "fleet identity, joined with replica_id",
    "uptime_s": "derived from started_at at serve time",
    "draining": "control-plane overlay, boolean",
    "ttft_hist_buckets": "cumulative histogram dict consumed by the "
                         "SLO burn-rate monitor; /metrics renders the "
                         "histogram family",
    "adapters_registered": "name list (the zoo)",
    "adapters_resident": "name list; numeric twin is the "
                         "tpuserve_adapter_resident gauge",
    "adapter_rows": "static row capacity from the AdapterStore",
    "tenant_slots": "per-tenant dict, not a scalar",
    "tenant_slot_cap": "EngineConfig echo",
    "kv_chains": "chain-hash digest list feeding the fleet KV index",
    "constrained_decoding": "capability flag, boolean",
    "capabilities": "capability dict merged into /v1/models",
    "kv_cache_dtype": "EngineConfig echo, string",
    "decode_backend": "EngineConfig echo, string",
    "decode_attn_impl": "resolved rung, string; /metrics carries the "
                        "labeled tpuserve_decode_attn_impl info gauge",
    "decode_attn_reason": "resolution explanation, string",
    "attention_backend": "resolved prefill backend name, string",
    "attention_backend_reason": "resolution explanation, string",
    "mesh_axes": "topology dict",
    "mesh_devices": "alias of device_count, the reference's key for "
                    "its multi-chip consumers",
    "devices": "per-device dict list; DEVICE_GAUGES renders the "
               "labeled /metrics twins",
    "param_bytes_total": "derived sum over param_bytes_by_device",
    "param_bytes_per_device": "per-device dict",
    "migration": "capability flag, boolean",
    "max_slots": "EngineConfig echo; the picker derives free slots",
    "prefix_bytes_pinned": "derived: prefix_pages_pinned × page bytes",
    "phase_percentiles": "p50/p95/p99 dict derived from "
                         "ENGINE_HISTOGRAMS",
    # long-context serving surface (the picker's context-length filter
    # and prompt-priced TTFT model read these)
    "max_seq_len": "EngineConfig echo; advertised context length the "
                   "gateway filters candidates by",
    "sp": "mesh sp axis size (1 off-mesh); topology echo",
    "sp_prefill_mode": "resolved sp routing (chunked | monolithic | "
                       "off), string",
    "prefill_ms_per_token": "derived: token-decayed prefill rate "
                            "(EngineStats.prefill_ms_per_token(), ~16k-"
                            "token half-life; lifetime mean until the "
                            "first observed call) — the picker's "
                            "prompt-length TTFT pricing rate",
    # priority-tiered serving surface
    "batch_slot_frac": "EngineConfig echo; the batch class's slot "
                       "ceiling fraction",
    # MoE serving surface
    "moe_expert_load": "per-expert token list [E]; /metrics renders "
                       "the labeled tpuserve_moe_expert_load twins",
    "moe_layer_drops": "per-layer capacity-drop list [L]; /metrics "
                       "renders the labeled tpuserve_moe_layer_drops "
                       "twins",
}


@dataclass(frozen=True)
class Group:
    """Field selector for one subsystem's drift smoke: exact names
    plus name prefixes, matched against gauge attrs and /state keys."""

    prefixes: tuple[str, ...] = ()
    exact: tuple[str, ...] = ()

    def matches(self, name: str) -> bool:
        return name in self.exact or any(
            name.startswith(p) for p in self.prefixes)


#: the per-subsystem groups the tier-1 drift smokes iterate — the
#: generated successors of the old hand-maintained tuples.
GROUPS: dict[str, Group] = {
    "prefix": Group(prefixes=("prefix_",)),
    "spec": Group(prefixes=("spec_",), exact=("state_rebuilds",)),
    "ragged": Group(
        prefixes=("prefill_tokens_",),
        exact=("prefill_padded_frac", "attention_backend", "warmup_ms",
               "warm_programs")),
    "adapter": Group(prefixes=("adapter", "tenant")),
    "migration": Group(
        prefixes=("migrations_", "migration_pages_", "migratable_")),
    "constraint": Group(prefixes=("constrain",), exact=("capabilities",)),
    "memory": Group(
        prefixes=("device_bytes_", "kv_bytes_"),
        exact=("device_memory_frac", "kv_pool_bytes", "kv_quant_bits",
               "kv_cache_dtype", "decode_backend", "decode_attn_impl",
               "decode_attn_reason")),
    "mesh": Group(
        prefixes=("mesh_", "param_bytes_", "ici_"),
        exact=("devices", "device_count", "device_memory_frac_worst",
               "attention_backend_reason", "decode_attn_impl",
               "decode_attn_reason", "migration")),
    "kvtier": Group(
        prefixes=("kv_spill", "kv_fetch", "kv_revives"),
        exact=("kv_host_bytes", "kv_chains")),
    "longctx": Group(
        prefixes=("sp_",),
        exact=("sp", "max_seq_len", "prefill_ms_per_token")),
    "fleetobs": Group(
        exact=("replica_id", "started_at", "uptime_s",
               "ttft_hist_buckets", "draining")),
    "moe": Group(prefixes=("moe_",)),
    "batch": Group(prefixes=("batch_",)),
    # engine-truth usage metering: the MeterRecord counter
    # family the gateway's ledger reconciles against
    "meter": Group(prefixes=("meter_",)),
}

#: /metrics substrings a group's smoke must also assert on but that are
#: not plain ENGINE_GAUGES families (labeled info gauges).
EXTRA_METRICS: dict[str, tuple[str, ...]] = {
    "memory": ('tpuserve_decode_attn_impl{impl="',),
    "moe": ('tpuserve_moe_expert_load{expert="',
            'tpuserve_moe_layer_drops{layer="'),
}


def expected_state_keys() -> set[str]:
    """Every key the /state payload's literal dict must carry: the
    gauge attrs that export there plus the documented state-only
    fields."""
    return ({a for a in ENGINE_GAUGE_ATTRS if a not in METRICS_ONLY}
            | set(STATE_ONLY))


def state_fields(group: str) -> tuple[str, ...]:
    """The /state fields of one subsystem group (drift-smoke input)."""
    g = GROUPS[group]
    return tuple(sorted(k for k in expected_state_keys()
                        if g.matches(k)))


def gauge_names(group: str) -> tuple[str, ...]:
    """The /metrics gauge families of one subsystem group."""
    g = GROUPS[group]
    return tuple(sorted(name for attr, name in ENGINE_GAUGES
                        if g.matches(attr)))


def _validate() -> None:
    """Exemption tables must stay anchored to real declarations — a
    stale entry is exactly the silent drift this manifest exists to
    kill. Runs at import so both the lint and the tests inherit it."""
    attrs = set(ENGINE_GAUGE_ATTRS)
    stale = set(METRICS_ONLY) - attrs
    if stale:
        raise AssertionError(
            f"METRICS_ONLY names unknown ENGINE_GAUGES attrs: "
            f"{sorted(stale)}")
    doubled = set(STATE_ONLY) & attrs
    if doubled:
        raise AssertionError(
            f"STATE_ONLY lists fields that ARE ENGINE_GAUGES attrs "
            f"(drop the exemption): {sorted(doubled)}")


_validate()
