"""OpenAI-surface replica server on the standard library (counterpart of
``aigw_tpu/tpuserve/server.py``).

Routes: ``POST /v1/chat/completions`` and ``POST /v1/completions``
(streamed over SSE and not, in the reference server's response shapes),
``POST /v1/embeddings``, ``POST /tokenize``, ``GET /v1/models``, ``GET
/health`` and ``GET /state`` (the reference's keys that this engine has,
under the same names, ``phase_percentiles`` and the constraint keys
among them). A
gateway in front routes to it like to a reference replica, prices its
TTFT from ``phase_percentiles`` as a reference replica's, and merges the
``capabilities`` it advertises on ``/v1/models`` and ``/state``.

Structured outputs and tool calls (``tpuserve/constrain.py``):
``response_format`` ``json_object`` / ``json_schema`` and ``tools`` with
``tool_choice`` ``required`` or named compile to a grammar the engine
enforces; the reply carries the JSON as content, or the envelope as
``message.tool_calls`` with ``finish_reason: "tool_calls"`` (streamed as
``tool_calls`` deltas). ``tool_choice: "auto"`` generates freely and the
server detects an envelope in the output, holding streamed text back
only while it is still a viable envelope prefix.

Per-token logprobs (``EngineConfig.logprobs_topk``, ``--logprobs``):
the chat dialect (``logprobs: true`` + ``top_logprobs``) and the legacy
integer ``logprobs`` of ``/v1/completions``, validated by
``check_logprobs`` with the reference's messages, returned in OpenAI's
shapes buffered and streamed (one entry per completion token, an empty
mid-UTF-8 piece included). ``n > 1`` fans out one engine request per
choice (``submit_n``, per-choice seeds) and assembles indexed choices,
buffered or as one interleaved stream. A request's tenant (the
``x-aigw-tenant`` header, else its adapter) feeds the engine's fairness
guard; ``/state`` carries the tenant keys and ``ttft_hist_buckets``.

Multi-LoRA (``lora_adapters``, ``tpuserve/adapters.py``): a request
whose ``model`` is ``<base>:<adapter>`` or a bare adapter name decodes
through that adapter; an unknown ``<base>:`` suffix is a 404 (a typo
must not silently serve base-model output). ``/v1/models`` lists
``<model>:<adapter>`` per registered adapter, and ``/state`` carries the
picker's adapter keys on every replica, zoo or not.

The operations surface: ``GET /metrics`` (``obs/metrics.py``: the
engine gauges, the per-device and MoE gauges, the phase histograms with
trace-id exemplars); ``POST /drain`` (new generations then get 503 with
``retry-after: 2`` and ``x-aigw-draining: 1`` while live ones finish;
``{"on": false}`` un-drains; ``/state``'s ``draining``) and ``drain()``,
which the CLI's signal handling polls; ``GET /debug/requests[/{rid}]``,
the flight recorder (``obs/flight.py``) of every request, whose
``RequestTrace`` also feeds the request's span when tracing is on
(``obs/tracing.py``, the ``OTEL_*`` variables; the caller's
``traceparent`` or B3 header is the parent, and its trace id is recorded
even with tracing off); ``GET /debug/profile?seconds=N`` (opt-in), a
``torch.profiler`` capture written as a Chrome trace. Every response's
``usage`` carries the engine's MeterRecord as ``aigw_meter``, and
``/state`` the ``meter_*`` totals.

KV mobility: ``POST /migrate/export`` cuts a live stream (by its
``x-aigw-request-id``) at a token boundary and answers its pages and
state, the source's stream ending without terminal frames; ``POST
/migrate/import`` adopts them and streams the continuation under the
original response id, its usage counting the whole session. ``POST
/kv/pages`` serves pages by chain key to a sibling, and a request naming
siblings in ``x-aigw-kv-peers`` fetches the prompt's missing leading
pages from them before admission (best effort: a dead peer means a cold
prefill, counted in ``kv_fetch_failures``). Every response names its
prompt's first chain key in ``x-aigw-kv-chain``, and ``/state`` carries
``kv_chains`` and the spill tier's and the fetch's keys. Pages travel as
``encode_wire_page`` writes them, byte for byte the reference's wire, so
a reference replica and a port replica exchange pages.

The offline batch tier: ``POST /v1/files`` (a raw JSONL body), ``GET
/v1/files/{id}/content``, and ``/v1/batches`` create, list, get and
cancel run each line at priority ``batch`` (also the ``x-aigw-priority:
batch`` header's class), which the engine admits only into slots
interactive work leaves idle, parks when interactive arrivals need them
and resumes byte-identically.

``POST /v1/embeddings`` pools the model's final hidden states
(``hidden_states``) over each input, on the handler's thread beside the
engine's, and answers while the replica drains, as the reference does.

The server is ``http.server.ThreadingHTTPServer``: one thread per
connection, each waiting on its request's token queue, which the engine
thread fills.
"""

from __future__ import annotations

import base64
import json
import logging
import os
import queue
import tempfile
import threading
import time
import urllib.error
import urllib.request
import uuid
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

import numpy as np
import torch

from aigw_tpu_torch.device import device_name, resolve_device
from aigw_tpu_torch.models.quant import quantize_params
from aigw_tpu_torch.models.registry import family_fns, get_model_spec
from aigw_tpu_torch.obs import metrics as obs_metrics
from aigw_tpu_torch.obs.flight import FlightRecorder, RequestTrace
from aigw_tpu_torch.obs.tracing import Tracer, genai_attributes
from aigw_tpu_torch.schemas import openai as oai
from aigw_tpu_torch.translate.structured import (
    JSONSchemaError,
    parse_response_format,
)
from aigw_tpu_torch.tpuserve import constrain
from aigw_tpu_torch.tpuserve.adapters import AdapterStore
from aigw_tpu_torch.tpuserve.engine import (
    DEFAULTS_DIFFER,
    Engine,
    EngineConfig,
    EngineOverloadedError,
    GenRequest,
    MigrationError,
    continuation_request,
)
from aigw_tpu_torch.tpuserve.kvcache import page_chain_hashes
from aigw_tpu_torch.tpuserve.sampling import SamplingParams
from aigw_tpu_torch.tpuserve.tokenizer import (
    StreamingDecoder,
    apply_chat_template,
    load_tokenizer,
)

logger = logging.getLogger(__name__)

_PARAM_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

#: the tenant key header (sent by clients or relayed by the gateway),
#: read into GenRequest.tenant for the engine's fairness guard
TENANT_HEADER = "x-aigw-tenant"

#: the priority class header: "batch" rides the engine's offline queue
#: (never shed); anything else is interactive
PRIORITY_HEADER = "x-aigw-priority"

#: sibling replicas ("host:port", comma-separated) the gateway believes
#: hold KV for the prompt's chain: their pages are fetched over /kv/pages
#: and imported before admission
KV_PEERS_HEADER = "x-aigw-kv-peers"

#: response header: the served prompt's first chain key, from which the
#: gateway learns prefix head → chain
KV_CHAIN_HEADER = "x-aigw-kv-chain"

#: the fleet fetch's bounds: peers tried per request, pages per fetch,
#: and each peer's HTTP budget (a slow sibling delays admission by a
#: bounded amount, and the cold prefill is always the way on)
KV_PEERS_MAX = 3
KV_FETCH_MAX_PAGES = 64
KV_FETCH_TIMEOUT_S = 10.0

#: the longest /debug/profile capture window, seconds
PROFILE_MAX_SECONDS = 30.0

#: the error a draining replica answers new work with
_DRAIN_MSG = ("replica is draining (shutting down or being retired); "
              "retry against another replica")
_DRAIN_HEADERS = {"retry-after": "2", "x-aigw-draining": "1"}


def encode_wire_page(d) -> dict:
    """Host page (``models/kvq.py``) → JSON-able wire dict, the
    reference's bytes: a native page as float32 (``b64``, ``shape``); a
    quantized page at its own dtype (int4 one element per byte) with
    ``dtype`` and its float32 scales (``scale_b64``, ``scale_shape``),
    never re-rounded."""
    if isinstance(d, dict):
        q = np.ascontiguousarray(np.asarray(d["q"]))
        sc = np.ascontiguousarray(np.asarray(d["scale"]), dtype=np.float32)
        return {
            "b64": base64.b64encode(q.tobytes()).decode(),
            "shape": list(q.shape),
            "dtype": str(d["dtype"]),
            "scale_b64": base64.b64encode(sc.tobytes()).decode(),
            "scale_shape": list(sc.shape),
        }
    arr = (d.float().numpy() if isinstance(d, torch.Tensor)
           else np.asarray(d, np.float32))
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    return {"b64": base64.b64encode(arr.tobytes()).decode(),
            "shape": list(arr.shape)}


def decode_wire_page(p: dict):
    """Inverse of :func:`encode_wire_page` → a host page (raises
    KeyError or ValueError on a malformed one: the caller's 400)."""
    dt = p.get("dtype")
    if dt:
        np_dt = {"int8": np.int8, "int4": np.uint8}[str(dt)]
        q = np.frombuffer(base64.b64decode(p["b64"]),
                          np_dt).reshape(p["shape"])
        scale = np.frombuffer(base64.b64decode(p["scale_b64"]),
                              np.float32).reshape(p["scale_shape"])
        return {"q": torch.from_numpy(q.copy()),
                "scale": torch.from_numpy(scale.copy()), "dtype": str(dt)}
    arr = np.frombuffer(base64.b64decode(p["b64"]),
                        np.float32).reshape(p["shape"])
    return torch.from_numpy(arr.copy())


def _find_stop(text: str, stop_strs: list[str]) -> int | None:
    """Earliest index where a stop sequence begins, or None."""
    hits = [i for i in (text.find(s) for s in stop_strs if s) if i >= 0]
    return min(hits) if hits else None


class TPUServeServer:
    """One model replica: engine + HTTP front end."""

    #: the float32 attention logits one embeddings sub-batch may hold a
    #: layer (2 GiB: 4 inputs at S 2048 at Llama-3-8B's 32 heads)
    embed_logits_bytes = 1 << 31

    def __init__(self, model: str, engine_cfg: EngineConfig,
                 device: str | torch.device = "cuda",
                 host: str = "127.0.0.1", port: int = 8011,
                 param_dtype: str = "bfloat16", quantize: str = "",
                 lora_adapters: dict[str, dict] | None = None,
                 lora_slots: int = 0, flight_entries: int = 256,
                 enable_profile_endpoint: bool = False,
                 params: dict[str, torch.Tensor] | None = None):
        """``lora_adapters``: name → one adapter's tensors (``[r, in]`` /
        ``[out, r]`` per target), the zoo, of which ``lora_slots`` are
        resident on the device at a time (0 = one row per adapter).
        ``flight_entries``: the flight recorder's ring. The
        ``/debug/profile`` route answers 404 unless
        ``enable_profile_endpoint``. Tracing follows the ``OTEL_*``
        environment (service name ``tpuserve`` unless it sets one).
        ``params``: weights to serve instead of drawing random ones (a
        second replica in one process sharing a first's tensors)."""
        self.device = resolve_device(device)
        self.model_name = model
        spec = get_model_spec(model)
        self.fns = family_fns(spec.family)
        self.model_cfg = spec.config
        self.tokenizer = load_tokenizer(spec.tokenizer)
        self.chat_template = spec.chat_template
        if spec.weights != "random":
            raise NotImplementedError(
                f"weights {spec.weights!r}: checkpoint loading is not "
                "ported yet (ROADMAP queue 1: checkpoints); register a "
                "weights='random' spec")
        if quantize not in ("", "int8", "int4"):
            raise ValueError(f"unknown quantization {quantize!r}")
        if params is None:
            logger.info("initializing random %s weights for %s on %s",
                        param_dtype, spec.name, self.device)
            params = self._draw_params(param_dtype, quantize)
            if quantize:
                logger.info("weights quantized to %s (W%sA16)", quantize,
                            quantize[-1])
        elif quantize:
            raise ValueError("pass quantized params, or quantize, not both")
        self.adapter_store: AdapterStore | None = None
        if lora_adapters:
            if spec.family != "llama":
                raise ValueError("LoRA serving supports the llama family")
            self.adapter_store = AdapterStore(
                n_slots=lora_slots or len(lora_adapters), device=self.device)
            for name, adapter in lora_adapters.items():
                self.adapter_store.register(name, adapter)
        self.engine = Engine(params, self.model_cfg, engine_cfg,
                             eos_token_ids=(self.tokenizer.eos_id,),
                             fns=self.fns, device=self.device,
                             adapter_store=self.adapter_store)
        self._started_at = time.time()
        self.replica_id = uuid.uuid4().hex[:16]
        self.tracer = Tracer(
            service_name=os.environ.get("OTEL_SERVICE_NAME", "")
            or "tpuserve")
        self.flight = FlightRecorder(capacity=flight_entries)
        self.enable_profile = enable_profile_endpoint
        self._profile_lock = threading.Lock()
        # when set, new generations are refused with 503 while live ones
        # finish (POST /drain, or the CLI's SIGTERM/SIGINT)
        self.draining = False
        # generation responses in flight: response id → streamed
        self._live: dict[str, bool] = {}
        # streams /migrate/export can cut: response id → (request, the
        # continuation's stream meta); a stream leaves at its end
        self._exportable: dict[str, tuple[GenRequest, dict]] = {}
        # fleet fetches that got nothing from a peer or failed to import
        # (the request then prefilled cold); handler threads count them
        self.kv_fetch_failures = 0
        self._fetch_lock = threading.Lock()
        # the batch tier: the in-memory file store (JSONL in and out),
        # batch objects, and each batch's requests in flight
        self._files: dict[str, bytes] = {}
        self._batches: dict[str, dict] = {}
        self._batch_live: dict[str, list[GenRequest]] = {}
        self.httpd = ThreadingHTTPServer((host, port), _make_handler(self))
        self.httpd.daemon_threads = True
        self._http_thread: threading.Thread | None = None

    def _draw_params(self, param_dtype: str, quantize: str
                     ) -> dict[str, torch.Tensor]:
        """Random weights drawn one tensor at a time and, with a
        quantization, quantized as drawn: the peak is the quantized
        model plus one bf16 tensor (Mixtral-8x7B's bf16 weights do not
        fit one 80 GB card)."""
        params: dict[str, torch.Tensor] = {}
        for name, w in self.fns.iter_params(0, self.model_cfg,
                                            _PARAM_DTYPES[param_dtype],
                                            self.device):
            params.update(quantize_params({name: w}, consume=True,
                                          mode=quantize)
                          if quantize else {name: w})
            del w
        return params

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> None:
        """Build the kernels, start the engine, then accept requests."""
        self.engine.warmup()
        self.engine.start()
        self._http_thread = threading.Thread(
            target=self.httpd.serve_forever, name="tpuserve-http",
            daemon=True)
        self._http_thread.start()
        logger.info("tpuserve listening on %s:%d (%s)",
                    *self.httpd.server_address[:2],
                    device_name(self.device))

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._http_thread is not None:
            self._http_thread.join(timeout=10)
        self.engine.stop()

    # -- endpoints --------------------------------------------------------
    def capabilities(self) -> dict[str, Any]:
        """The structured-output and tool-calling flags this replica
        enforces (empty with constrained decoding off)."""
        return (dict(constrain.CAPABILITIES)
                if self.engine.cfg.constrained_decoding else {})

    @property
    def adapter_names(self) -> tuple[str, ...]:
        """The served zoo (registered adapters, resident or not)."""
        if self.adapter_store is None:
            return ()
        return self.adapter_store.names()

    def _resolve_adapter(self, model: str) -> str:
        """``<base>:<adapter>`` or a bare adapter name → the adapter; any
        other name → "" (the base model). An unknown colon suffix raises
        SchemaError (the server's 404)."""
        if model.startswith(self.model_name + ":"):
            cand = model[len(self.model_name) + 1:]
            if cand not in self.adapter_names:
                raise oai.SchemaError(
                    f"unknown LoRA adapter {cand!r}; loaded: "
                    f"{sorted(self.adapter_names)}")
            return cand
        return model if model in self.adapter_names else ""

    def models(self) -> dict[str, Any]:
        caps = self.capabilities()
        extra = {"capabilities": caps} if caps else None
        return oai.models_response(
            [(self.model_name, "tpuserve", 0, extra)]
            + [(f"{self.model_name}:{a}", "tpuserve-lora", 0, extra)
               for a in self.adapter_names])

    def health(self) -> tuple[int, dict[str, Any]]:
        if not self.engine.healthy:
            return 503, {"status": "error", "model": self.model_name,
                         "error": self.engine.last_error}
        return 200, {"status": "ok", "model": self.model_name}

    def state(self) -> dict[str, Any]:
        """Endpoint-picker telemetry under the reference's /state keys."""
        eng = self.engine
        s = eng.stats
        cfg = eng.cfg
        tenant_slots = eng._tenant_slots()
        return {
            "model": self.model_name,
            "replica_id": self.replica_id,
            "started_at": round(self._started_at, 3),
            "uptime_s": round(time.time() - self._started_at, 3),
            "draining": self.draining,
            "device": device_name(self.device),
            "device_count": s.device_count,
            "active_slots": s.active_slots,
            "max_slots": cfg.max_batch_size,
            "queued": s.queued,
            "queue_wait_ms": round(s.queue_wait_ms, 3),
            "kv_pages_free": s.kv_pages_free,
            "kv_occupancy": s.kv_occupancy,
            "kv_pool_bytes": s.kv_pool_bytes,
            "kv_bytes_in_use": s.kv_bytes_in_use,
            "kv_quant_bits": s.kv_quant_bits,
            "kv_bytes_per_token": s.kv_bytes_per_token,
            "kv_cache_dtype": cfg.kv_cache_dtype,
            "device_bytes_in_use": s.device_bytes_in_use,
            "device_bytes_limit": s.device_bytes_limit,
            "device_memory_frac": s.device_memory_frac,
            "max_seq_len": cfg.max_seq_len,
            "tokens_generated": s.tokens_generated,
            "decode_steps": s.decode_steps,
            "decode_window": s.decode_window,
            "window_shrinks": s.window_shrinks,
            "window_grows": s.window_grows,
            "state_rebuilds": s.state_rebuilds,
            "prefills": s.prefills,
            "chunked_prefill_steps": s.chunked_prefill_steps,
            "prefill_ms": round(s.prefill_ms, 3),
            "prefill_ms_per_token": round(s.prefill_ms_per_token(), 4),
            "transfer_ms": round(s.transfer_ms, 3),
            "emit_ms": round(s.emit_ms, 3),
            "first_emit_ms": round(s.first_emit_ms, 3),
            # cold-start observables: warmup()'s wall ms and the
            # programs it captured; the captures since the engine came
            # up (growth after warm-up = a capture on the hot path)
            "warmup_ms": s.warmup_ms,
            "warm_programs": s.warm_programs,
            "xla_compiles": s.xla_compiles,
            "xla_compile_ms": s.xla_compile_ms,
            "attention_backend": eng.attn.name,
            "attention_backend_reason": eng.attn_reason,
            "prefill_tokens_real": s.prefill_tokens_real,
            "prefill_tokens_padded": s.prefill_tokens_padded,
            "prefill_padded_frac": s.prefill_padded_frac,
            "decode_backend": cfg.decode_backend,
            "decode_attn_impl": eng.decode_attn_impl,
            "decode_attn_reason": eng.decode_attn_reason,
            # prefix cache: the picker's prefix-affinity scoring and
            # capacity dashboards read these
            "prefix_cache_hit_rate": round(s.prefix_cache_hit_rate, 4),
            "prefix_pages_resident": s.prefix_pages_resident,
            "prefix_pages_pinned": s.prefix_pages_pinned,
            "prefix_bytes_pinned": s.prefix_pages_pinned * eng.kv_page_bytes,
            "prefix_cache_hits": s.prefix_cache_hits,
            "prefix_cache_misses": s.prefix_cache_misses,
            "prefix_cache_evictions": s.prefix_cache_evictions,
            "prefix_full_hits": s.prefix_full_hits,
            "prefix_cow_copies": s.prefix_cow_copies,
            "prefix_tokens_reused": s.prefix_tokens_reused,
            # speculative decoding: acceptance telemetry
            "spec_accepted": s.spec_accepted,
            "spec_drafted": s.spec_drafted,
            "spec_accept_rate": round(s.spec_accept_rate, 4),
            "spec_draft_len": s.spec_draft_len,
            "spec_rung_ups": s.spec_rung_ups,
            "spec_rung_downs": s.spec_rung_downs,
            "spec_lookahead_slots": s.spec_lookahead_slots,
            # usage metering: cumulative MeterRecord totals, which the
            # gateway's usage ledger reconciles its per-tenant sums
            # against token for token
            "meter_records": s.meter_records,
            "meter_prefill_tokens": s.meter_prefill_tokens,
            "meter_prefill_padded_tokens": s.meter_prefill_padded_tokens,
            "meter_prefix_reused_tokens": s.meter_prefix_reused_tokens,
            "meter_decode_tokens": s.meter_decode_tokens,
            "meter_spec_drafted": s.meter_spec_drafted,
            "meter_spec_accepted": s.meter_spec_accepted,
            "meter_hbm_page_byte_s": s.meter_hbm_page_byte_s,
            "meter_host_page_byte_s": s.meter_host_page_byte_s,
            # grammar-constrained decoding: the flags the gateway merges
            # into /v1/models, live constrained slots, rollbacks (grammar
            # cuts), bias-row patches, the compiled-grammar cache size
            "constrained_decoding": cfg.constrained_decoding,
            "capabilities": self.capabilities(),
            "constrained_slots": s.constrained_slots,
            "constraint_requests": s.constraint_requests,
            "constraint_rollbacks": s.constraint_rollbacks,
            "constraint_mask_updates": s.constraint_mask_updates,
            "constraint_grammars": s.constraint_grammars,
            # mixture of experts: placements and capacity drops, the
            # picker's imbalance price, per-expert load and per-layer
            # drops (zero or [] on a dense family)
            "moe_tokens_routed": s.moe_tokens_routed,
            "moe_tokens_dropped": s.moe_tokens_dropped,
            "moe_dropped_frac": s.moe_dropped_frac,
            "moe_expert_imbalance": s.moe_expert_imbalance,
            "moe_expert_load": eng.moe_expert_load(),
            "moe_layer_drops": eng.moe_layer_drops(),
            # adapter serving: the zoo, device residency, load/evict
            # churn and live adapter slots (the picker's adapter
            # affinity reads adapters_resident)
            "adapters_registered": sorted(self.adapter_names),
            "adapters_resident": (self.adapter_store.resident_names()
                                  if self.adapter_store is not None
                                  else []),
            "adapter_rows": (self.adapter_store.n_slots
                             if self.adapter_store is not None else 0),
            "adapter_loads": s.adapter_loads,
            "adapter_evictions": s.adapter_evictions,
            "adapter_slots": s.adapter_slots,
            # tenant fairness: who holds slots now, and how often the
            # per-tenant cap deferred an admission
            "tenant_slots": {t or "(anonymous)": c
                             for t, c in sorted(tenant_slots.items())},
            "tenants_active": s.tenants_active,
            "tenant_max_slots": s.tenant_max_slots,
            "tenant_deferrals": s.tenant_deferrals,
            "tenant_slot_cap": cfg.tenant_slot_cap,
            # the offline batch class (the picker reads queued, active
            # and preemptions; ``queued`` above stays interactive)
            "batch_queued": s.batch_queued,
            "batch_active": s.batch_active,
            "batch_preemptions": s.batch_preemptions,
            "batch_resumed": s.batch_resumed,
            "batch_tokens": s.batch_tokens,
            "batch_slot_frac": cfg.batch_slot_frac,
            # KV mobility: migrations and their pages, live young slots,
            # the spill tier, the fleet fetch, and the chain digest the
            # gateway's fleet index polls
            "migrations_out": s.migrations_out,
            "migrations_in": s.migrations_in,
            "migration_pages_out": s.migration_pages_out,
            "migration_pages_in": s.migration_pages_in,
            "migratable_slots": s.migratable_slots,
            "kv_spills": s.kv_spills,
            "kv_revives": s.kv_revives,
            "kv_spill_evictions": s.kv_spill_evictions,
            "kv_spilled_pages": s.kv_spilled_pages,
            "kv_spill_bytes": s.kv_spill_bytes,
            "kv_host_bytes": s.kv_host_bytes,
            "kv_fetches_out": s.kv_fetches_out,
            "kv_fetches_in": s.kv_fetches_in,
            "kv_fetch_pages_out": s.kv_fetch_pages_out,
            "kv_fetch_pages_in": s.kv_fetch_pages_in,
            "kv_chains": list(eng.kv_chain_digest()),
            "enable_prefix_cache": cfg.enable_prefix_cache,
            "defaults_differ": dict(DEFAULTS_DIFFER),
            "migration": eng.migratable,
            # serving-phase latency distributions (p50/p95/p99 per
            # phase; -1 = no observations yet): the picker's TTFT
            # prediction reads the prefill and ttft p50
            "phase_percentiles": eng.phases.percentiles(),
            # the TTFT histogram's cumulative buckets: the gateway's SLO
            # burn-rate monitor computes windowed goodput from them
            "ttft_hist_buckets": eng.phases.hists["ttft"].cumulative(),
        }

    def metrics(self) -> bytes:
        """The ``/metrics`` exposition, in the reference's order."""
        eng = self.engine
        return (obs_metrics.render_genai_families()
                + obs_metrics.render_engine_gauges(eng.stats)
                + obs_metrics.render_decode_impl(eng.decode_attn_impl)
                + obs_metrics.render_device_gauges(eng.device_stats)
                + obs_metrics.render_moe_gauges(eng.moe_expert_load(),
                                                eng.moe_layer_drops())
                + eng.phases.render())

    # -- drain ----------------------------------------------------------------
    def set_draining(self, on: bool = True) -> dict[str, Any]:
        """``POST /drain``: flip the flag (new generations then get 503
        while live ones keep serving) and report what is still live."""
        self.draining = bool(on)
        s = self.engine.stats
        return {"draining": self.draining, "active_slots": s.active_slots,
                "queued": s.queued,
                "live_streams": sum(self._live.values())}

    def drained(self) -> bool:
        """No slot, nothing queued, and no response still writing."""
        s = self.engine.stats
        return s.active_slots == 0 and s.queued == 0 and not self._live

    def drain(self, timeout_s: float = 60.0, poll_s: float = 0.1,
              stop: threading.Event | None = None) -> bool:
        """Refuse new generations and wait until the replica is empty
        (``drained``), ``timeout_s`` passes or ``stop`` is set; True when
        empty. Blocks the caller only: handler threads keep serving."""
        self.draining = True
        deadline = time.monotonic() + timeout_s
        while not self.drained():
            if time.monotonic() >= deadline or (stop is not None
                                                and stop.is_set()):
                break
            time.sleep(poll_s)
        return self.drained()

    # -- KV mobility ----------------------------------------------------------
    def prefix_hashes(self, prompt: list[int]) -> list | None:
        """The prompt's chain keys at the engine's page size (None with
        the prefix cache off)."""
        if self.engine.prefix_cache is None:
            return None
        return page_chain_hashes(prompt, self.engine.cfg.page_size)

    @staticmethod
    def kv_chain_header(hashes: list | None) -> dict[str, str]:
        """``x-aigw-kv-chain``: the prompt's first chain key (none for a
        prompt without a full page: nothing shareable)."""
        if not hashes:
            return {}
        return {KV_CHAIN_HEADER: hashes[0].hex()}

    def migrate_export(self, body: dict[str, Any]) -> tuple[int, bytes]:
        """``POST /migrate/export``: cut the live stream ``request_id``
        and answer its blob and wire pages; its own stream then ends with
        no terminal frames. 404 for an id that is not an exportable live
        stream; 409 when the engine refuses (the session serves on)."""
        rid = str(body.get("request_id", ""))
        live = self._exportable.get(rid)
        if live is None:
            return 404, oai.error_body(
                f"request {rid!r} is not an exportable live stream")
        gen_req, meta = live
        try:
            out = self.engine.migrate_export(gen_req)
        except (MigrationError, TimeoutError) as e:
            return 409, oai.error_body(str(e))
        blob = out["blob"]
        blob["meta"] = meta
        pages = [encode_wire_page(d) for d in out["data"]]
        return 200, json.dumps({"blob": blob, "pages": pages}).encode()

    def kv_pages(self, body: dict[str, Any]) -> tuple[int, bytes]:
        """``POST /kv/pages``: the pages this replica holds among
        ``keys`` (hex chain keys, the first KV_FETCH_MAX_PAGES), resident
        or spilled, each on the wire with its ``key``; keys not held are
        absent."""
        raw_keys = body.get("keys")
        if not isinstance(raw_keys, list) or not raw_keys:
            return 400, oai.error_body(
                "keys must be a non-empty list of hex chain hashes")
        try:
            keys = [bytes.fromhex(str(k))
                    for k in raw_keys[:KV_FETCH_MAX_PAGES]]
        except ValueError as e:
            return 400, oai.error_body(f"malformed chain hash: {e}")
        try:
            out = self.engine.kv_export_pages(keys)
        except (MigrationError, TimeoutError) as e:
            return 409, oai.error_body(str(e))
        pages = [dict(encode_wire_page(d), key=k.hex()) for k, d in out]
        return 200, json.dumps({
            "model": self.model_name,
            "page_size": self.engine.cfg.page_size,
            "pages": pages}).encode()

    def maybe_fleet_fetch(self, peers_hdr: str, prompt: list[int],
                          hashes: list | None) -> int:
        """Before admission: when siblings are named (``x-aigw-kv-peers``)
        and the prompt's leading written pages are missing here, fetch
        them over ``/kv/pages`` and import the leading contiguous run as
        cached pages, so the prefill becomes a resume. Best effort, as
        in the reference: a peer that fails or holds nothing is skipped
        (counted in ``kv_fetch_failures``) and the request prefills cold.
        Returns the pages imported."""
        eng = self.engine
        if not peers_hdr or not hashes or eng.prefix_cache is None:
            return 0
        ps = eng.cfg.page_size
        # only pages whose every row is written KV travel
        usable = min(len(hashes), (len(prompt) - 1) // ps)
        present = set(eng.kv_chain_digest())
        miss = 0
        while miss < usable and hashes[miss].hex() in present:
            miss += 1
        if miss >= usable:
            return 0
        want = [h.hex() for h in hashes[miss:usable]]
        peers = [p.strip() for p in peers_hdr.split(",")
                 if p.strip()][:KV_PEERS_MAX]
        for peer in peers:
            got = self.fetch_pages_from(peer, want)
            run: list = []
            for h in want:
                rows = got.get(h)
                if rows is None:
                    break  # the leading contiguous run only
                run.append(rows)
            if not run:
                self._count_fetch_failure()
                continue
            try:
                n = eng.kv_import_pages(prompt, run, miss)
            except (MigrationError, TimeoutError) as e:
                logger.info("fleet KV import from %s failed: %s", peer, e)
                self._count_fetch_failure()
                return 0
            logger.info("fleet-fetched %d KV pages from %s", n, peer)
            return n
        return 0

    def _count_fetch_failure(self) -> None:
        with self._fetch_lock:
            self.kv_fetch_failures += 1

    @staticmethod
    def fetch_pages_from(peer: str, keys_hex: list[str]) -> dict:
        """``POST /kv/pages`` to one sibling: {key hex: host page}, or {}
        on any error (the fetch is best effort)."""
        base = peer if "://" in peer else f"http://{peer}"
        req = urllib.request.Request(
            base + "/kv/pages", data=json.dumps({"keys": keys_hex}).encode(),
            headers={"content-type": "application/json"})
        try:
            with urllib.request.urlopen(req,
                                        timeout=KV_FETCH_TIMEOUT_S) as r:
                data = json.loads(r.read())
        except (urllib.error.URLError, OSError, ValueError):
            return {}
        out: dict = {}
        try:
            for p in data.get("pages") or ():
                out[str(p["key"])] = decode_wire_page(p)
        except (AttributeError, KeyError, TypeError, ValueError):
            return {}
        return out

    # -- the offline batch tier -----------------------------------------------
    #: request lines accepted per batch file (an in-memory store)
    BATCH_MAX_LINES = 10_000

    def file_upload(self, raw: bytes) -> tuple[int, bytes]:
        """``POST /v1/files``: a raw JSONL body → a file id."""
        if not raw.strip():
            return 400, oai.error_body(
                "empty file body; POST the JSONL batch input as the "
                "request body")
        fid = f"file-{uuid.uuid4().hex[:24]}"
        self._files[fid] = raw
        return 200, json.dumps({
            "id": fid, "object": "file", "bytes": len(raw),
            "created_at": int(time.time()), "purpose": "batch"}).encode()

    def parse_batch_lines(self, raw: bytes, endpoint: str
                          ) -> list[tuple[str, dict]]:
        """Validate the whole JSONL input before any engine work: every
        malformed line is a SchemaError naming it."""
        lines: list[tuple[str, dict]] = []
        seen: set[str] = set()
        for i, ln in enumerate(raw.splitlines(), start=1):
            if not ln.strip():
                continue
            try:
                obj = json.loads(ln)
            except ValueError:
                raise oai.SchemaError(f"line {i}: not valid JSON") from None
            if not isinstance(obj, dict):
                raise oai.SchemaError(
                    f"line {i}: each line must be a JSON object")
            cid = obj.get("custom_id")
            if not isinstance(cid, str) or not cid:
                raise oai.SchemaError(
                    f"line {i}: custom_id must be a non-empty string")
            if cid in seen:
                raise oai.SchemaError(
                    f"line {i}: duplicate custom_id {cid!r}")
            seen.add(cid)
            if obj.get("method", "POST") != "POST":
                raise oai.SchemaError(f"line {i}: method must be POST")
            url = obj.get("url", endpoint)
            if url != endpoint:
                raise oai.SchemaError(
                    f"line {i}: url {url!r} does not match the batch "
                    f"endpoint {endpoint!r}")
            body = obj.get("body")
            if not isinstance(body, dict):
                raise oai.SchemaError(
                    f"line {i}: body must be a JSON object")
            if body.get("stream"):
                raise oai.SchemaError(
                    f"line {i}: stream is not supported in batches")
            lines.append((cid, body))
        if not lines:
            raise oai.SchemaError("batch input has no request lines")
        if len(lines) > self.BATCH_MAX_LINES:
            raise oai.SchemaError(
                f"batch input has {len(lines)} lines; this replica caps "
                f"a batch at {self.BATCH_MAX_LINES}")
        return lines

    def batch_create(self, body: dict[str, Any]) -> tuple[int, bytes]:
        """``POST /v1/batches``: validate the input file, register the
        batch and start its runner (a thread)."""
        endpoint = str(body.get("endpoint", ""))
        if endpoint not in ("/v1/chat/completions", "/v1/completions"):
            return 400, oai.error_body(
                "endpoint must be /v1/chat/completions or "
                "/v1/completions")
        fid = str(body.get("input_file_id", ""))
        raw = self._files.get(fid)
        if raw is None:
            return 404, oai.error_body(f"unknown input_file_id {fid!r}")
        try:
            lines = self.parse_batch_lines(raw, endpoint)
        except oai.SchemaError as e:
            return 400, oai.error_body(str(e))
        bid = f"batch_{uuid.uuid4().hex[:24]}"
        self._batches[bid] = {
            "id": bid, "object": "batch", "endpoint": endpoint,
            "input_file_id": fid, "status": "in_progress",
            "output_file_id": None, "created_at": int(time.time()),
            "request_counts": {"total": len(lines), "completed": 0,
                               "failed": 0},
        }
        self._batch_live[bid] = []
        threading.Thread(target=self.run_batch, args=(bid, lines),
                         name=f"batch-{bid}", daemon=True).start()
        return 200, json.dumps(self._batches[bid]).encode()

    def batch_list(self) -> dict[str, Any]:
        return {"object": "list",
                "data": sorted(self._batches.values(),
                               key=lambda b: b["created_at"])}

    def batch_cancel(self, bid: str) -> tuple[int, bytes]:
        """``POST /v1/batches/{id}/cancel``: stop starting lines and
        cancel those in flight; the runner finalizes to ``cancelled``
        with the lines that did finish."""
        b = self._batches.get(bid)
        if b is None:
            return 404, oai.error_body("unknown batch id")
        if b["status"] == "in_progress":
            b["status"] = "cancelling"
            for req in list(self._batch_live.get(bid, ())):
                req.cancelled.set()
        return 200, json.dumps(b).encode()

    def batch_one(self, bid: str, body: dict[str, Any], chat: bool
                  ) -> tuple[int, dict[str, Any]]:
        """One batch line through the normal submit path at priority
        "batch", buffered: (status code, response body); a failed line
        is an output line, never a batch-level error."""
        try:
            prompt = (self.encode_chat(body) if chat
                      else self.encode_text(body))
            lp_top_n = self.check_logprobs(body)
            out, gen_req, box = self.submit(
                prompt, body, lp_top_n=lp_top_n,
                tenant=str(body.get("user", "")), priority="batch")
        except ValueError as e:  # SchemaError included
            return 400, json.loads(oai.error_body(str(e)))
        self._batch_live[bid].append(gen_req)
        stops = body.get("stop")
        stop_strs = [stops] if isinstance(stops, str) else list(stops or [])
        try:
            text, n_out, finish, lp_content = self.collect(
                out, stop_strs, lp_top_n)
        finally:
            self._batch_live[bid].remove(gen_req)
        gen_req.cancelled.set()  # a stop-string hit ends the line
        if finish == "error":
            return 500, json.loads(oai.error_body("engine failure",
                                                  "server_error"))
        # the usage carries the engine's record: a parked and resumed
        # line's spans the whole session, host residency included
        usage = self.usage_from_meter(len(prompt), n_out, box)
        if chat:
            resp = oai.chat_completion_response(
                model=self.model_name, content=text, finish_reason=finish,
                usage=usage,
                response_id=f"chatcmpl-{uuid.uuid4().hex[:24]}")
            if lp_content is not None:
                resp["choices"][0]["logprobs"] = {"content": lp_content}
        else:
            resp = oai.completion_response(
                model=self.model_name, text=text, finish_reason=finish,
                usage=usage, response_id=f"cmpl-{uuid.uuid4().hex[:24]}",
                created=int(time.time()))
            if lp_content is not None:
                resp["choices"][0]["logprobs"] = \
                    self.legacy_logprobs(lp_content)
        return 200, resp

    def run_batch(self, bid: str, lines: list[tuple[str, dict]]) -> None:
        """The batch runner: every line at priority "batch" with at most
        one engine's worth in flight, then the JSONL output file and the
        batch's final status."""
        b = self._batches[bid]
        chat = b["endpoint"] == "/v1/chat/completions"
        out_lines: list[bytes | None] = [None] * len(lines)
        counts_lock = threading.Lock()  # the workers count concurrently

        def one(i: int) -> None:
            cid, body = lines[i]
            if b["status"] != "in_progress":
                return  # cancelled before this line started
            status, resp = self.batch_one(bid, body, chat)
            entry = {"id": f"batch_req_{uuid.uuid4().hex[:16]}",
                     "custom_id": cid,
                     "response": {"status_code": status, "body": resp},
                     "error": None}
            with counts_lock:
                b["request_counts"]["completed" if status == 200
                                    else "failed"] += 1
            out_lines[i] = json.dumps(entry).encode()

        workers = max(2, self.engine.cfg.max_batch_size)
        with ThreadPoolExecutor(max_workers=workers,
                                thread_name_prefix=f"batch-{bid}") as ex:
            list(ex.map(one, range(len(lines))))
        ofid = f"file-{uuid.uuid4().hex[:24]}"
        self._files[ofid] = b"\n".join(
            ln for ln in out_lines if ln is not None) + b"\n"
        b["output_file_id"] = ofid
        b["status"] = ("cancelled" if b["status"] == "cancelling"
                       else "completed")

    # -- debug ------------------------------------------------------------------
    def profile(self, query: str) -> tuple[int, bytes]:
        """``GET /debug/profile?seconds=N``: a ``torch.profiler`` capture
        of the next N seconds (at most PROFILE_MAX_SECONDS; CUDA activity
        on the card, CPU activity on the CPU) written as a Chrome trace
        into a fresh directory; returns (status, JSON body). 404 unless
        enabled, 409 while a capture runs, 500 with the reason when the
        profiler fails."""
        from urllib.parse import parse_qs

        if not self.enable_profile:
            return 404, oai.error_body(
                "profiling endpoint disabled (start tpuserve with "
                "--enable-profile-endpoint)", "not_found")
        try:
            seconds = float(parse_qs(query).get("seconds", ["2"])[0])
        except ValueError:
            return 400, oai.error_body("seconds must be a number")
        seconds = min(max(seconds, 0.1), PROFILE_MAX_SECONDS)
        if not self._profile_lock.acquire(blocking=False):
            return 409, oai.error_body(
                "a profile capture is already running")
        try:
            out_dir = tempfile.mkdtemp(prefix="tpuserve-profile-")
            try:
                from torch.profiler import ProfilerActivity, profile

                act = (ProfilerActivity.CUDA if self.device.type == "cuda"
                       else ProfilerActivity.CPU)
                with profile(activities=[act]) as prof:
                    time.sleep(seconds)
                prof.export_chrome_trace(os.path.join(out_dir,
                                                      "trace.json"))
            except Exception as e:  # noqa: BLE001 — a profiler fault is
                # the caller's 500, not a crashed replica
                return 500, oai.error_body(
                    f"profiler capture failed: {e}", "server_error")
        finally:
            self._profile_lock.release()
        return 200, json.dumps({"profile_dir": out_dir,
                                "seconds": seconds}).encode()

    # -- request traces and usage ---------------------------------------------
    def begin_trace(self, headers: dict[str, str], rid: str, model: str,
                    prompt: list[int], body: dict[str, Any], stream: bool,
                    chat: bool) -> RequestTrace:
        """The request's span (a child of the caller's ``traceparent`` or
        B3 context) when tracing is on, and its flight entry, which keeps
        the caller's trace id with tracing off too."""
        parent = self.tracer.propagators.extract(headers)
        span = None
        if self.tracer.enabled:
            op = "chat" if chat else "text_completion"
            span = self.tracer.start_span(f"tpuserve.{op} {model}", parent)
            span.attributes.update(genai_attributes(
                operation=op, request_model=model,
                response_model=self.model_name, backend="tpuserve",
                streaming=stream))
            span.set("tpuserve.request_id", rid)
        entry = self.flight.begin(
            rid, model=model, prompt_tokens=len(prompt),
            max_tokens=int(body.get("max_completion_tokens")
                           or body.get("max_tokens") or 256),
            stream=stream,
            trace_id=(span.context.trace_id if span is not None
                      else parent.trace_id if parent is not None else ""),
            span_id=span.context.span_id if span is not None else "")
        return RequestTrace(entry=entry, tracer=self.tracer, span=span)

    def end_trace(self, trace: RequestTrace, finish: str, n_out: int,
                  n_prompt: int = 0, error: str = "") -> None:
        self._exportable.pop(trace.entry.rid, None)  # no longer cut
        self.flight.finish(trace.entry, finish, n_out)
        span = trace.span
        if span is not None:
            span.set("gen_ai.usage.input_tokens", n_prompt)
            span.set("gen_ai.usage.output_tokens", n_out)
            span.set("tpuserve.finish_reason", finish)
            if error:
                span.record_error(error)
            span.end()

    @staticmethod
    def usage_from_meter(n_prompt: int, n_out: int,
                         box: dict[str, Any] | None) -> oai.TokenUsage:
        """The response's usage: the counts the handler saw, the cached
        tokens the engine skipped and its MeterRecord (``aigw_meter``).
        An empty box (a stop-string cancel that ended the response before
        the engine's reap) gives the plain counts."""
        if not box:
            return oai.TokenUsage(n_prompt, n_out, n_prompt + n_out)
        return oai.TokenUsage(
            n_prompt, n_out, n_prompt + n_out,
            cached_input_tokens=int(box.get("prefix_reused", 0) or 0),
            meter=oai.meter_to_tuple(box))

    @staticmethod
    def merge_meter_boxes(boxes: list[dict]) -> dict[str, Any]:
        """The ``n > 1`` fan-out's records summed field by field (each
        choice is one engine request and one record; identity fields
        from the first)."""
        merged: dict[str, Any] = {}
        for b in boxes:
            for k, v in b.items():
                if k == "schema":
                    merged[k] = v
                elif isinstance(v, bool) or not isinstance(v, (int, float)):
                    merged.setdefault(k, v)
                else:
                    merged[k] = round(merged.get(k, 0) + v, 6)
        return merged

    def tokenize(self, body: dict[str, Any]) -> dict[str, Any]:
        """The reference's ``/tokenize``: chat ``messages`` through the
        chat template, else ``prompt`` as text (no BOS), with the
        replica's context limit."""
        if isinstance(body.get("messages"), list):
            ids = apply_chat_template(body["messages"], self.tokenizer,
                                      self.chat_template)
        else:
            ids = self.tokenizer.encode(str(body.get("prompt", "")))
        return {"count": len(ids),
                "max_model_len": self.engine.cfg.max_seq_len,
                "tokens": ids}

    def embed_rows(self, S: int) -> int:
        """Inputs one ``hidden_states`` call of the embeddings route
        takes at block length ``S``: as many as keep a layer's float32
        ``[rows, n_heads, S, S]`` attention logits within
        ``embed_logits_bytes``, at least one."""
        per_row = 4 * self.model_cfg.n_heads * S * S
        return max(1, self.embed_logits_bytes // per_row)

    def embeddings(self, body: dict[str, Any]) -> tuple[int, bytes]:
        """``POST /v1/embeddings``, as the reference answers it: a string,
        a list of strings, one token-id list or a list of them; strings
        are encoded (no BOS), token ids taken mod the vocabulary, each
        input cut to ``max_seq_len``, the batch padded to a power-of-two
        ``S >= 8``, and every vector the float32 mean of the model's
        final hidden states (``hidden_states`` on the engine's weights,
        run on the caller's thread, beside the engine's). The inputs run
        in sub-batches of ``embed_rows(S)``, so one body's dense pass
        stays within ``embed_logits_bytes`` whatever its input count.
        Not refused while draining: it starts no generation."""
        raw = body.get("input")
        if isinstance(raw, str):
            items: list = [raw]
        elif isinstance(raw, list) and raw and all(
                isinstance(x, int) for x in raw):
            items = [raw]  # one pre-tokenized input
        elif isinstance(raw, list):
            items = list(raw)
        else:
            items = []
        if not items:
            return 400, oai.error_body(
                "input must be a string, array of strings, or array of "
                "token ids")
        max_len = self.engine.cfg.max_seq_len
        vocab = self.model_cfg.vocab_size
        encoded = []
        for it in items:
            if isinstance(it, str):
                encoded.append(self.tokenizer.encode(it)[:max_len])
            elif isinstance(it, list) and all(isinstance(x, int)
                                              for x in it):
                encoded.append([x % vocab for x in it][:max_len])
            else:
                return 400, oai.error_body("invalid embeddings input element")
        S = max(8, max(len(e) for e in encoded))
        S = 1 << (S - 1).bit_length()  # the power-of-two bucket
        toks = np.zeros((len(encoded), S), np.int32)
        lens = np.zeros((len(encoded),), np.int32)
        for i, e in enumerate(encoded):
            toks[i, :len(e)] = e
            lens[i] = len(e)
        dev = self.device
        rows = self.embed_rows(S)
        with torch.inference_mode():
            hidden = np.concatenate([self.fns.hidden_states(
                self.engine.params, self.model_cfg,
                torch.from_numpy(toks[i:i + rows]).to(dev),
                torch.from_numpy(lens[i:i + rows]).to(dev)).cpu().numpy()
                for i in range(0, len(encoded), rows)])
        n_tokens = int(lens.sum())
        usage = oai.TokenUsage(input_tokens=n_tokens, total_tokens=n_tokens)
        return 200, json.dumps(oai.embeddings_response(
            model=self.model_name, vectors=[h.tolist() for h in hidden],
            usage=usage)).encode()

    # -- generation -------------------------------------------------------
    def encode_chat(self, body: dict[str, Any]) -> list[int]:
        oai.validate_chat_request(body)
        return apply_chat_template(body["messages"], self.tokenizer,
                                   self.chat_template)

    def encode_text(self, body: dict[str, Any]) -> list[int]:
        oai.request_model(body)
        text = body.get("prompt", "")
        if isinstance(text, list):
            text = "".join(text)
        return [self.tokenizer.bos_id] + self.tokenizer.encode(str(text))

    def check_request(self, body: dict[str, Any], chat: bool
                      ) -> tuple[int, int, Any, dict[str, Any] | None]:
        """Intake checks in the reference's order: logprobs, then the
        constraints (which refuse tools with ``n > 1`` and logprobs
        with a grammar), then ``n`` against the batch. Returns
        (``check_logprobs``' top-n, n, grammar, mode)."""
        lp_top_n = self.check_logprobs(body)
        n = int(body.get("n") or 1)
        constraint, cmode = self.check_constraints(body, chat, n, lp_top_n)
        if n > self.engine.cfg.max_batch_size:
            raise oai.SchemaError(
                f"n={n} exceeds max_batch_size "
                f"{self.engine.cfg.max_batch_size}")
        return lp_top_n, n, constraint, cmode

    def check_logprobs(self, body: dict[str, Any]) -> int:
        """The request's logprobs knobs → top alternates per token (-1 =
        logprobs off, 0 = the chosen token only), the reference's
        ``_check_logprobs``. Chat sends ``logprobs: bool`` +
        ``top_logprobs: int``; legacy ``/v1/completions`` sends
        ``logprobs: int`` (the alternate count). The cap is
        ``min(logprobs_topk, 20)``. Raises SchemaError (a 400)."""
        raw = body.get("logprobs")
        try:
            if isinstance(raw, bool) or raw is None:
                want = bool(raw)
                top_n = int(body.get("top_logprobs") or 0)
                if top_n and not want:
                    # a SchemaError is a ValueError: the reference's
                    # handler below answers with the type message
                    raise oai.SchemaError(
                        "top_logprobs requires logprobs: true")
            else:  # the legacy integer form
                want = True
                top_n = int(raw)
        except (TypeError, ValueError):
            raise oai.SchemaError(
                "logprobs must be a boolean (chat) or integer (legacy); "
                "top_logprobs must be an integer") from None
        if top_n < 0:
            raise oai.SchemaError("logprobs count must be >= 0")
        if not want:
            return -1
        cap = self.engine.cfg.logprobs_topk
        if cap <= 0:
            raise oai.SchemaError(
                "this server was started without --logprobs; "
                "per-token logprobs are unavailable")
        if top_n > min(cap, 20):
            raise oai.SchemaError(
                f"top_logprobs {top_n} exceeds the served maximum "
                f"{min(cap, 20)}")
        return top_n

    def check_constraints(self, body: dict[str, Any], chat: bool, n: int,
                          lp_top_n: int = -1
                          ) -> tuple[Any, dict[str, Any] | None]:
        """``response_format`` and ``tools``/``tool_choice`` → a compiled
        TokenFSM (or None) and how the reply is assembled (None, or
        ``{"mode": "json"}``, or ``{"mode": "tool", "choice": ...,
        "names": [...]}``). Every unsupported or malformed ask raises
        SchemaError (a 400) with the reference's message."""
        try:
            rf = parse_response_format(body)
        except JSONSchemaError as e:
            raise oai.SchemaError(str(e)) from None
        if rf is not None and rf.kind == "text":
            rf = None
        tools = body.get("tools")
        choice = body.get("tool_choice")
        tools_active = bool(tools) and choice != "none"
        if rf is None and not tools_active:
            return None, None
        if not chat:
            raise oai.SchemaError(
                "response_format and tools are only supported on "
                "/v1/chat/completions")
        if not self.engine.cfg.constrained_decoding:
            raise oai.SchemaError(
                "this server was started with --no-constrained-decoding; "
                "response_format json modes and tool calling are "
                "unavailable")
        if lp_top_n >= 0:
            raise oai.SchemaError(
                "logprobs cannot be combined with response_format json "
                "modes or tools (the grammar mask reshapes the "
                "distribution the logprobs would describe)")
        if rf is not None and tools_active:
            raise oai.SchemaError(
                "response_format json modes cannot be combined with "
                "tools on this backend; send one or the other")
        eos = (self.tokenizer.eos_id,)
        V = self.model_cfg.vocab_size
        try:
            if tools_active:
                if n > 1:
                    raise oai.SchemaError(
                        "n > 1 is not supported with tools on this "
                        "backend")
                specs = constrain.parse_tools(tools)
                names = [nm for nm, _s in specs]
                named = ""
                if isinstance(choice, dict):
                    named = str(choice["function"]["name"])
                    if named not in names:
                        raise oai.SchemaError(
                            f"tool_choice names unknown tool {named!r}; "
                            f"tools declare {names}")
                    specs = [t for t in specs if t[0] == named]
                mode = ("named" if named
                        else "required" if choice == "required"
                        else "auto")
                if mode == "auto":
                    # free generation; the reply is searched for an
                    # envelope (a grammar admitting all text masks
                    # nothing)
                    return None, {"mode": "tool", "choice": "auto",
                                  "names": names}
                fsm = constrain.compile_constraint(
                    self.tokenizer, V, eos, constrain.spec_for_tools(specs))
                return fsm, {"mode": "tool", "choice": mode,
                             "names": [t[0] for t in specs]}
            if rf.kind == "json_schema" and rf.schema is None:
                raise oai.SchemaError(
                    "response_format.json_schema.schema is required for "
                    "constrained decoding")
            fsm = constrain.compile_constraint(
                self.tokenizer, V, eos,
                constrain.spec_for_response_format(rf.kind, rf.schema))
            return fsm, {"mode": "json"}
        except (JSONSchemaError,
                constrain.UnsupportedConstraintError) as e:
            raise oai.SchemaError(str(e)) from None

    def submit(self, prompt: list[int], body: dict[str, Any],
               constraint: Any = None, lp_top_n: int = -1,
               tenant: str = "", sink: Any = None,
               trace: RequestTrace | None = None,
               priority: str = "interactive"):
        """Submit to the engine; returns (token queue, request, meter
        box). The queue yields (token_id, finish_reason, lp) items, lp
        None without logprobs, else (chosen logprob, [(top id, top
        logprob)]); ``sink`` (a callable taking each item) replaces the
        queue, which is then None. ``lp_top_n`` is ``check_logprobs``'
        value (>= 0 attaches logprobs); the tenant is the header's, else
        the adapter. The box is a dict the engine fills with the
        request's MeterRecord before its finish item. ``priority`` is the
        engine's class ("batch": the offline queue). Raises SchemaError
        for an unknown adapter suffix."""
        adapter = self._resolve_adapter(str(body.get("model", "")))
        out: queue.Queue | None = queue.Queue() if sink is None else None
        put = out.put if sink is None else sink
        max_tokens = int(body.get("max_completion_tokens")
                         or body.get("max_tokens") or 256)

        def emit_lp(tok, fin, chosen, top) -> None:
            put((tok, fin, None if chosen is None else (chosen, top)))

        box: dict[str, Any] = {}
        req = GenRequest(prompt=prompt, max_tokens=max_tokens,
                         sampling=SamplingParams.from_request(body),
                         emit=lambda t, f: put((t, f, None)),
                         emit_lp=emit_lp if lp_top_n >= 0 else None,
                         constraint=constraint, adapter=adapter,
                         tenant=tenant or adapter, trace=trace,
                         meter_sink=box.update, priority=priority)
        self.engine.submit(req)
        return out, req, box

    def submit_n(self, prompt: list[int], body: dict[str, Any], n: int,
                 constraint: Any = None, lp_top_n: int = -1,
                 tenant: str = "", merged: queue.Queue | None = None,
                 priority: str = "interactive") -> list:
        """``n`` engine requests, one per choice (the reference's
        ``_submit_n``): choice i samples with seed ``(seed or 0) + i``
        when a seed is given or the temperature is above 0, else 0.
        Returns [(queue, request, meter box)]; with ``merged``, choice
        i's items go there as (i, item) and its queue is None. A refusal (overload,
        an unknown adapter, bad sampling) cancels the choices already
        queued and raises."""
        sampling = SamplingParams.from_request(body)
        outs: list = []
        try:
            for i in range(n):
                per_choice = dict(body)
                per_choice["seed"] = ((sampling.seed or 0) + i
                                      if sampling.seed
                                      or sampling.temperature > 0 else 0)
                sink = (None if merged is None
                        else lambda item, i=i: merged.put((i, item)))
                outs.append(self.submit(prompt, per_choice, constraint,
                                        lp_top_n, tenant, sink,
                                        priority=priority))
        except (EngineOverloadedError, ValueError):
            for _q, req, _b in outs:  # no orphaned choices in the queue
                req.cancelled.set()
            raise
        return outs

    def collect(self, out: queue.Queue, stop_strs: list[str],
                lp_top_n: int = -1) -> tuple[str, int, str, list | None]:
        """Drain a generation to completion (non-streaming path): (text,
        tokens, finish, logprobs content entries or None). The entries
        are not cut at a stop-string hit, as in the reference."""
        decoder = StreamingDecoder(self.tokenizer)
        text = ""
        n_out = 0
        lp_content: list | None = [] if lp_top_n >= 0 else None
        while True:
            tok, fin, lp = out.get()
            if tok >= 0:
                n_out += 1
                piece = decoder.push(tok)
                text += piece
                if lp_content is not None and lp is not None:
                    lp_content.append(self.lp_entry(piece, lp, lp_top_n))
                hit = _find_stop(text, stop_strs)
                if hit is not None:
                    return text[:hit], n_out, "stop", lp_content
            if fin is not None:
                if fin != "error":
                    text += decoder.flush()
                return text, n_out, fin, lp_content

    @staticmethod
    def legacy_logprobs(entries: list[dict[str, Any]]) -> dict[str, Any]:
        """The legacy ``/v1/completions`` logprobs shape from the chat
        content entries."""
        return {
            "tokens": [e["token"] for e in entries],
            "token_logprobs": [e["logprob"] for e in entries],
            "top_logprobs": [
                {t["token"]: t["logprob"] for t in e["top_logprobs"]}
                for e in entries],
        }

    def lp_entry(self, piece: str, lp, top_n: int) -> dict[str, Any]:
        """One OpenAI logprobs content entry for an emitted token."""
        chosen, top = lp
        tops = []
        for tid, tval in (top or [])[:top_n]:
            ttext = self.tokenizer.decode([int(tid)])
            tops.append({"token": ttext, "logprob": float(tval),
                         "bytes": list(ttext.encode("utf-8"))})
        return {"token": piece, "logprob": float(chosen),
                "bytes": list(piece.encode("utf-8")), "top_logprobs": tops}


def _make_handler(server: TPUServeServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        srv = server

        def log_message(self, fmt, *args):  # route to logging, not stderr
            logger.debug("%s " + fmt, self.address_string(), *args)

        def _send(self, status: int, body: bytes,
                  ctype: str = "application/json",
                  headers: dict[str, str] | None = None) -> None:
            self.send_response(status)
            self.send_header("content-type", ctype)
            self.send_header("content-length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _json(self, status: int, obj: Any, headers=None) -> None:
            self._send(status, json.dumps(obj).encode(), headers=headers)

        def _error(self, status: int, msg: str,
                   type_: str = "invalid_request_error", headers=None):
            self._send(status, oai.error_body(msg, type_), headers=headers)

        def do_GET(self):  # noqa: N802 (http.server naming)
            path, _, query = self.path.partition("?")
            srv = self.srv
            if path == "/v1/models":
                self._json(200, srv.models())
            elif path == "/health":
                self._json(*srv.health())
            elif path == "/state":
                self._json(200, srv.state())
            elif path == "/metrics":
                self._send(200, srv.metrics(),
                           "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/debug/requests":
                self._json(200, srv.flight.snapshot())
            elif path.startswith("/debug/requests/"):
                entry = srv.flight.get(path[len("/debug/requests/"):])
                if entry is None:
                    self._error(404, "unknown request id", "not_found")
                else:
                    self._json(200, entry.detail())
            elif path == "/debug/profile":
                self._send(*srv.profile(query))
            elif path == "/v1/batches":
                self._json(200, srv.batch_list())
            elif path.startswith("/v1/batches/"):
                b = srv._batches.get(path[len("/v1/batches/"):])
                if b is None:
                    self._error(404, "unknown batch id")
                else:
                    self._json(200, b)
            elif path.startswith("/v1/files/") \
                    and path.endswith("/content"):
                raw = srv._files.get(path[len("/v1/files/"):-len(
                    "/content")])
                if raw is None:
                    self._error(404, "unknown file id")
                else:
                    self._send(200, raw, "application/jsonl")
            else:
                self._error(404, f"no route {path}", "not_found")

        #: POST routes refused with the drain's 503 on a draining replica
        _DRAINED = ("/v1/chat/completions", "/v1/completions",
                    "/v1/files", "/v1/batches", "/migrate/import")

        def do_POST(self):  # noqa: N802
            path = self.path.split("?", 1)[0]
            chat = path == "/v1/chat/completions"
            cancel = (path.startswith("/v1/batches/")
                      and path.endswith("/cancel"))
            if not chat and not cancel and path not in (
                    "/v1/completions", "/tokenize", "/drain", "/v1/files",
                    "/v1/batches", "/migrate/export", "/migrate/import",
                    "/kv/pages", "/v1/embeddings"):
                self._error(404, f"no route {path}", "not_found")
                return
            length = int(self.headers.get("content-length") or 0)
            raw = self.rfile.read(length)
            srv = self.srv
            if path == "/drain":
                try:
                    body = oai.parse_json_body(raw) if raw.strip() else {}
                except oai.SchemaError as e:
                    self._error(400, str(e))
                    return
                self._json(200, srv.set_draining(
                    bool(body.get("on", True))))
                return
            if path in self._DRAINED and srv.draining:
                # no new work on a draining replica: the gateway retries
                # a sibling before the first byte
                self._error(503, _DRAIN_MSG, "server_error",
                            headers=_DRAIN_HEADERS)
                return
            if cancel:
                self._send(*srv.batch_cancel(
                    path[len("/v1/batches/"):-len("/cancel")]))
                return
            if path == "/v1/files":
                self._send(*srv.file_upload(raw))
                return
            try:
                body = oai.parse_json_body(raw)
            except oai.SchemaError as e:
                self._error(400, str(e))
                return
            if path == "/v1/batches":
                self._send(*srv.batch_create(body))
                return
            if path == "/v1/embeddings":
                self._send(*srv.embeddings(body))
                return
            if path == "/migrate/export":
                self._send(*srv.migrate_export(body))
                return
            if path == "/kv/pages":
                self._send(*srv.kv_pages(body))
                return
            if path == "/migrate/import":
                self._migrate_import(body)
                return
            try:
                if path == "/tokenize":
                    self._json(200, srv.tokenize(body))
                    return
                prompt = (srv.encode_chat(body) if chat
                          else srv.encode_text(body))
                intake = srv.check_request(body, chat)
            except oai.SchemaError as e:
                self._error(400, str(e))
                return
            self._generate(body, prompt, chat, *intake)

        def _migrate_import(self, body):
            """``POST /migrate/import``: adopt an exported chain and stream
            the session's continuation under the original response id,
            its decoder primed with the generated tokens (characters and
            stop strings across the seam resolve as on the exporter), its
            usage counting the whole session."""
            srv = self.srv
            blob = body.get("blob") or {}
            try:
                tokens = [int(t) for t in blob["tokens"]]
                pages = [decode_wire_page(p)
                         for p in (body.get("pages") or ())]
            except (KeyError, TypeError, ValueError) as e:
                self._error(400, f"malformed migration blob: {e}")
                return
            try:
                srv.engine.migrate_import(tokens, pages)
            except (MigrationError, TimeoutError) as e:
                if "OutOfPages" in str(e):
                    # page pressure: the overload contract
                    self._error(503, str(e), headers={"retry-after": "1"})
                else:
                    self._error(400, str(e))
                return
            meta = blob.get("meta") or {}
            rid = str(meta.get("response_id")
                      or f"chatcmpl-{uuid.uuid4().hex[:24]}")
            chat = bool(meta.get("chat", True))
            created = int(meta.get("created") or time.time())
            stop_strs = [x for x in (meta.get("stop_strs") or ())
                         if isinstance(x, str)]
            include_usage = bool(meta.get("include_usage", False))
            n_prev = int(blob.get("generated", 0))
            orig_len = int(blob.get("orig_prompt_len", len(tokens)))
            out: queue.Queue = queue.Queue()
            box: dict[str, Any] = {}
            creq = continuation_request(
                blob, emit=lambda t, f: out.put((t, f)))
            # the exporter emitted no record at the cut: this one, fed by
            # the blob's carry, covers the whole session
            creq.meter_sink = box.update
            entry = srv.flight.begin(
                rid, model=srv.model_name, prompt_tokens=len(tokens),
                max_tokens=creq.max_tokens, stream=True)
            creq.trace = RequestTrace(entry=entry, tracer=srv.tracer,
                                      span=None)
            try:
                srv.engine.submit(creq)
            except EngineOverloadedError as e:
                self._error(429, str(e), "rate_limit_error",
                            headers={"retry-after": "1"})
                return
            except ValueError as e:
                self._error(400, str(e))
                return
            # the continuation can move again
            srv._exportable[rid] = (creq, meta)
            srv._live[rid] = True
            try:
                self._continue_stream(out, creq, box, chat, rid, created,
                                      stop_strs, include_usage, tokens,
                                      orig_len, n_prev)
            except (BrokenPipeError, ConnectionResetError):
                creq.cancelled.set()
                srv.end_trace(creq.trace, "cancelled", 0, orig_len)
                self.close_connection = True
            finally:
                srv._live.pop(rid, None)

        def _continue_stream(self, out, creq, box, chat, rid, created,
                             stop_strs, include_usage, tokens, orig_len,
                             n_prev):
            srv = self.srv
            self._start_sse(rid)
            decoder = StreamingDecoder(srv.tokenizer)
            emitted = ""
            for t in tokens[orig_len:]:
                emitted += decoder.push(t)
            n_out = 0
            finish = "stop"
            done = False
            while not done:
                burst = [out.get()]
                while True:
                    try:
                        burst.append(out.get_nowait())
                    except queue.Empty:
                        break
                pieces: list[str] = []
                for tok, fin in burst:
                    if tok >= 0:
                        n_out += 1
                        piece = decoder.push(tok)
                        if piece:
                            emitted += piece
                            hit = _find_stop(emitted, stop_strs)
                            if hit is not None:
                                keep = hit - (len(emitted) - len(piece))
                                pieces.append(piece[:max(keep, 0)])
                                finish = "stop"
                                creq.cancelled.set()
                                done = True
                                break
                            pieces.append(piece)
                    if fin is not None:
                        finish = fin
                        if fin not in ("error", "migrated"):
                            pieces.append(decoder.flush())
                        done = True
                        break
                text = "".join(pieces)
                if text:
                    self.wfile.write(self._chunk(chat, rid, created, text))
                    self.wfile.flush()
            usage = srv.usage_from_meter(orig_len, n_prev + n_out, box)
            srv.end_trace(creq.trace, finish, n_out, orig_len)
            if finish == "migrated":
                self.wfile.flush()  # moved again: the next replica ends it
                return
            if chat:
                tail = oai.stream_chunk_sse(
                    response_id=rid, model=srv.model_name, created=created,
                    delta={}, finish_reason=finish,
                    usage=usage if include_usage else None)
            else:
                tail = oai.completion_chunk_sse(
                    response_id=rid, model=srv.model_name, created=created,
                    text="", finish_reason=finish,
                    usage=usage if include_usage else None)
            self.wfile.write(tail)
            self.wfile.write(oai.sse("[DONE]"))
            self.wfile.flush()

        def _generate(self, body, prompt, chat, lp_top_n, n, constraint,
                      cmode):
            srv = self.srv
            # the named siblings may hold this prompt's chain: import
            # their pages before admission (the n > 1 fan-out's prompt
            # is fetched once)
            hashes = srv.prefix_hashes(prompt)
            srv.maybe_fleet_fetch(self.headers.get(KV_PEERS_HEADER, ""),
                                  prompt, hashes)
            stream = bool(body.get("stream", False))
            rid = (f"chatcmpl-{uuid.uuid4().hex[:24]}" if chat
                   else f"cmpl-{uuid.uuid4().hex[:24]}")
            created = int(time.time())
            stops = body.get("stop")
            stop_strs = [stops] if isinstance(stops, str) \
                else list(stops or [])
            tenant = self.headers.get(TENANT_HEADER, "")
            priority = ("batch"
                        if self.headers.get(PRIORITY_HEADER, "") == "batch"
                        else "interactive")
            srv._live[rid] = stream
            try:
                self._serve_generation(body, prompt, chat, lp_top_n, n,
                                    constraint, cmode, stream, rid,
                                    created, stop_strs, tenant, priority,
                                    srv.kv_chain_header(hashes))
            finally:
                srv._live.pop(rid, None)

        def _serve_generation(self, body, prompt, chat, lp_top_n, n,
                           constraint, cmode, stream, rid, created,
                           stop_strs, tenant, priority, chain_hdr):
            srv = self.srv
            merged: queue.Queue | None = \
                queue.Queue() if n > 1 and stream else None
            n_prompt = len(prompt)
            trace = None
            if n == 1:
                trace = srv.begin_trace(
                    {k.lower(): v for k, v in self.headers.items()}, rid,
                    str(body.get("model", srv.model_name)), prompt, body,
                    stream, chat)
            try:
                if n > 1:
                    outs = srv.submit_n(prompt, body, n, constraint,
                                        lp_top_n, tenant, merged,
                                        priority=priority)
                else:
                    out, req, box = srv.submit(prompt, body, constraint,
                                               lp_top_n, tenant,
                                               trace=trace,
                                               priority=priority)
            except (EngineOverloadedError, ValueError) as e:
                if trace is not None:
                    srv.end_trace(trace, "rejected", 0, n_prompt,
                                  error=str(e))
                if isinstance(e, EngineOverloadedError):
                    self._error(429, str(e), "rate_limit_error",
                                headers={"retry-after": "1"})
                elif isinstance(e, oai.SchemaError):  # an unknown adapter
                    self._error(404, str(e), "model_not_found")
                else:
                    self._error(400, str(e))
                return
            if n > 1:
                reqs = [r for _q, r, _b in outs]
                try:
                    if stream:
                        self._stream_n(merged, outs, chat, rid, created,
                                       stop_strs, n_prompt, lp_top_n,
                                       oai.include_stream_usage(body),
                                       chain_hdr)
                    else:
                        self._respond_n(outs, chat, rid, created,
                                        stop_strs, n_prompt, lp_top_n,
                                        chain_hdr)
                except (BrokenPipeError, ConnectionResetError):
                    for r in reqs:
                        r.cancelled.set()
                    self.close_connection = True
                return
            if not stream:
                text, n_out, finish, lp_content = srv.collect(
                    out, stop_strs, lp_top_n)
                # a stop-string hit ends generation (a no-op once the
                # engine has finished the request itself)
                req.cancelled.set()
                usage = srv.usage_from_meter(n_prompt, n_out, box)
                srv.end_trace(trace, finish, n_out, n_prompt,
                              error="engine failure" if finish == "error"
                              else "")
                if finish == "error":
                    self._error(500, "engine failure", "server_error")
                    return
                tool_calls = None
                if cmode is not None and cmode["mode"] == "tool":
                    env = constrain.parse_tool_envelope(text, cmode["names"])
                    if env is not None:
                        tool_calls = [{
                            "id": f"call_{uuid.uuid4().hex[:24]}",
                            "type": "function",
                            "function": {"name": env[0],
                                         "arguments": env[1]},
                        }]
                        text = ""
                        if finish == "stop":
                            finish = "tool_calls"
                    # no envelope: auto mode's plain content, or a
                    # required/named reply cut by max_tokens, returned as
                    # content with finish "length"
                if chat:
                    resp = oai.chat_completion_response(
                        model=srv.model_name, content=text,
                        finish_reason=finish, usage=usage, response_id=rid,
                        tool_calls=tool_calls)
                    if lp_content is not None:
                        resp["choices"][0]["logprobs"] = {
                            "content": lp_content}
                else:
                    resp = oai.completion_response(
                        model=srv.model_name, text=text,
                        finish_reason=finish, usage=usage,
                        response_id=rid, created=created)
                    if lp_content is not None:
                        resp["choices"][0]["logprobs"] = \
                            srv.legacy_logprobs(lp_content)
                self._json(200, resp, headers={"x-aigw-request-id": rid,
                                               **chain_hdr})
                return
            if lp_top_n < 0 and constraint is None and cmode is None:
                # a plain stream can be cut by /migrate/export until it
                # ends (a grammar's or logprobs' state rides no blob);
                # the meta is what the continuation's stream needs
                srv._exportable[rid] = (req, {
                    "response_id": rid, "model": srv.model_name,
                    "created": created, "chat": chat,
                    "include_usage": oai.include_stream_usage(body),
                    "stop_strs": stop_strs})
            try:
                self._stream(out, req, box, trace, chat, rid, created,
                             stop_strs, n_prompt,
                             oai.include_stream_usage(body), cmode,
                             lp_top_n, chain_hdr)
            except (BrokenPipeError, ConnectionResetError):
                req.cancelled.set()  # client went away: free the slot
                srv.end_trace(trace, "cancelled", 0, n_prompt)
                self.close_connection = True

        def _respond_n(self, outs, chat, rid, created, stop_strs, n_prompt,
                       lp_top_n, chain_hdr):
            """The buffered ``n > 1`` reply (the reference's
            ``_generate_n``): indexed choices; usage counts the prompt
            once, sums the completions and the choices' cached
            tokens."""
            srv = self.srv
            results = []
            for q, req, _b in outs:
                results.append(srv.collect(q, stop_strs, lp_top_n))
                req.cancelled.set()  # a stop-string hit ends the choice
            n_out = sum(r[1] for r in results)
            usage = self._usage_n(outs, n_prompt, n_out)
            choices = []
            for i, (text, _n, finish, lp_content) in enumerate(results):
                if chat:
                    c: dict[str, Any] = {
                        "index": i,
                        "message": {"role": "assistant", "content": text},
                        "finish_reason": finish}
                    if lp_content is not None:
                        c["logprobs"] = {"content": lp_content}
                else:
                    c = {"index": i, "text": text, "finish_reason": finish}
                    if lp_content is not None:
                        c["logprobs"] = srv.legacy_logprobs(lp_content)
                choices.append(c)
            self._json(200, {
                "id": rid,
                "object": "chat.completion" if chat else "text_completion",
                "created": created, "model": srv.model_name,
                "choices": choices, "usage": oai.usage_dict(usage),
            }, headers={"x-aigw-request-id": rid, **chain_hdr})

        def _start_sse(self, rid, headers=None):
            self.send_response(200)
            self.send_header("content-type", "text/event-stream")
            self.send_header("cache-control", "no-cache")
            self.send_header("x-aigw-request-id", rid)
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.send_header("connection", "close")
            self.end_headers()
            self.close_connection = True

        def _chunk(self, chat, rid, created, piece, lp_entries=None,
                   finish=None, index=0):
            """One content (or finish) frame of choice ``index``; a
            chat finish frame carries an empty delta."""
            srv = self.srv
            if chat:
                return oai.stream_chunk_sse(
                    response_id=rid, model=srv.model_name, created=created,
                    delta={"content": piece} if finish is None else {},
                    finish_reason=finish, index=index,
                    logprobs={"content": lp_entries} if lp_entries
                    else None)
            return oai.completion_chunk_sse(
                response_id=rid, model=srv.model_name, created=created,
                text=piece, finish_reason=finish, index=index,
                logprobs=srv.legacy_logprobs(lp_entries) if lp_entries
                else None)

        def _usage_n(self, outs, n_prompt, n_out):
            """One usage for the ``n`` choices: the prompt once, the
            completions summed, the choices' records summed."""
            merged = self.srv.merge_meter_boxes([b for _q, _r, b in outs])
            return oai.TokenUsage(
                n_prompt, n_out, n_prompt + n_out,
                cached_input_tokens=int(merged.get("prefix_reused", 0)
                                        or 0),
                meter=oai.meter_to_tuple(merged) if merged else ())

        def _stream_n(self, merged, outs, chat, rid, created, stop_strs,
                      n_prompt, lp_top_n, include_usage, chain_hdr):
            """The streamed ``n > 1`` reply (the reference's
            ``_generate_n_stream``): the choices' items arrive on one
            merged queue; each burst becomes one frame per choice that
            moved, then one finish frame per choice, usage when asked
            for, one ``[DONE]``."""
            srv = self.srv
            reqs = [r for _q, r, _b in outs]
            n = len(reqs)
            self._start_sse(rid, chain_hdr)
            w = self.wfile
            if chat:
                for i in range(n):
                    w.write(oai.stream_chunk_sse(
                        response_id=rid, model=srv.model_name,
                        created=created,
                        delta={"role": "assistant", "content": ""},
                        index=i))
                w.flush()
            decoders = [StreamingDecoder(srv.tokenizer) for _ in range(n)]
            emitted = [""] * n
            counts = [0] * n
            done = [False] * n
            want_lp = lp_top_n >= 0
            while not all(done):
                burst = [merged.get()]
                while True:
                    try:
                        burst.append(merged.get_nowait())
                    except queue.Empty:
                        break
                pieces: dict[int, list[str]] = {}
                lps: dict[int, list] = {}
                fins: dict[int, str] = {}
                for i, (tok, fin, lp) in burst:
                    if done[i] or i in fins:
                        # items past a finish (a stop-string hit) count
                        # toward nothing
                        continue
                    if tok >= 0:
                        counts[i] += 1
                        piece = decoders[i].push(tok)
                        if want_lp and lp is not None:
                            lps.setdefault(i, []).append(
                                srv.lp_entry(piece, lp, lp_top_n))
                        if piece:
                            emitted[i] += piece
                            hit = _find_stop(emitted[i], stop_strs)
                            if hit is not None:
                                keep = hit - (len(emitted[i]) - len(piece))
                                pieces.setdefault(i, []).append(
                                    piece[:max(keep, 0)])
                                fins[i] = "stop"
                                reqs[i].cancelled.set()
                                continue
                            pieces.setdefault(i, []).append(piece)
                    if fin is not None and i not in fins:
                        fins[i] = fin
                        if fin != "error":
                            tail = decoders[i].flush()
                            if tail:
                                pieces.setdefault(i, []).append(tail)
                for i in sorted(set(pieces) | set(lps) | set(fins)):
                    text = "".join(pieces.get(i, ()))
                    if text or lps.get(i):
                        w.write(self._chunk(chat, rid, created, text,
                                            lps.get(i), index=i))
                    if i in fins:
                        done[i] = True
                        w.write(self._chunk(chat, rid, created, "",
                                            finish=fins[i] or "stop",
                                            index=i))
                w.flush()
            if include_usage:
                usage = self._usage_n(outs, n_prompt, sum(counts))
                if chat:
                    w.write(oai.stream_chunk_sse(
                        response_id=rid, model=srv.model_name,
                        created=created, usage=usage))
                else:
                    w.write(oai.completion_chunk_sse(
                        response_id=rid, model=srv.model_name,
                        created=created, text=None, usage=usage))
            w.write(oai.sse("[DONE]"))
            w.flush()

        def _stream(self, out, req, box, trace, chat, rid, created,
                    stop_strs, n_prompt, include_usage, cmode, lp_top_n,
                    chain_hdr):
            srv = self.srv
            self._start_sse(rid, chain_hdr)
            want_lp = lp_top_n >= 0

            def write_piece(piece: str, lp_entries=None) -> None:
                # an empty piece (mid-UTF-8) still carries its logprob
                # entries, so the streamed list aligns one to one with
                # the completion tokens
                if not piece and not lp_entries:
                    return
                self.wfile.write(self._chunk(chat, rid, created, piece,
                                             lp_entries))
                self.wfile.flush()

            # tool calls: a required/named reply is a grammar-forced
            # envelope, split into tool_calls deltas as it arrives; auto
            # mode holds text back only while it is still a viable
            # envelope prefix, then streams it as content or a tool call
            tool_stream = auto_detect = None
            if cmode is not None and cmode["mode"] == "tool":
                if cmode["choice"] == "auto":
                    auto_detect = constrain.AutoToolDetector(cmode["names"])
                else:
                    tool_stream = constrain.ToolCallParser()
            tool_call_id = f"call_{uuid.uuid4().hex[:24]}"

            def write_tool_events(events) -> None:
                for ev in events:
                    if ev[0] == "name":
                        call = {"index": 0, "id": tool_call_id,
                                "type": "function",
                                "function": {"name": ev[1],
                                             "arguments": ""}}
                    elif ev[0] == "args" and ev[1]:
                        call = {"index": 0,
                                "function": {"arguments": ev[1]}}
                    else:
                        continue
                    self.wfile.write(oai.stream_chunk_sse(
                        response_id=rid, model=srv.model_name,
                        created=created, delta={"tool_calls": [call]}))
                    self.wfile.flush()

            def emit_text(piece: str, lp_entries) -> None:
                nonlocal tool_stream
                if tool_stream is not None:
                    write_tool_events(tool_stream.feed(piece))
                    return
                if auto_detect is not None and auto_detect.decided is None:
                    decision, text_out = auto_detect.feed(piece)
                    if decision is None:
                        return  # still a viable envelope prefix
                    if decision == "tool":
                        tool_stream = constrain.ToolCallParser()
                        write_tool_events(tool_stream.feed(text_out))
                        return
                    piece = text_out  # diverged: the held text is content
                write_piece(piece, lp_entries)

            if chat:
                self.wfile.write(oai.stream_chunk_sse(
                    response_id=rid, model=srv.model_name, created=created,
                    delta={"role": "assistant", "content": ""}))
                self.wfile.flush()
            decoder = StreamingDecoder(srv.tokenizer)
            emitted = ""
            n_out = 0
            finish = "stop"
            done = False
            while not done:
                burst = [out.get()]
                while True:  # one frame per burst of tokens
                    try:
                        burst.append(out.get_nowait())
                    except queue.Empty:
                        break
                pieces = []
                lp_entries = []
                for tok, fin, lp in burst:
                    if tok >= 0:
                        n_out += 1
                        piece = decoder.push(tok)
                        if want_lp and lp is not None:
                            lp_entries.append(
                                srv.lp_entry(piece, lp, lp_top_n))
                        if piece:
                            emitted += piece
                            hit = _find_stop(emitted, stop_strs)
                            if hit is not None:
                                # the cut token keeps its entry
                                keep = hit - (len(emitted) - len(piece))
                                pieces.append(piece[:max(keep, 0)])
                                finish = "stop"
                                req.cancelled.set()
                                done = True
                                break
                            pieces.append(piece)
                    if fin is not None:
                        finish = fin
                        if fin not in ("error", "migrated"):
                            # a migrated stream's held-back text is
                            # re-derived by the importer's primed decoder
                            pieces.append(decoder.flush())
                        done = True
                        break
                emit_text("".join(pieces), lp_entries)
            if auto_detect is not None and tool_stream is None:
                # ended while still ambiguous: the held text was content
                decision, rest = auto_detect.finish()
                if decision == "content" and rest:
                    write_piece(rest)
            if tool_stream is not None and tool_stream.completed \
                    and finish == "stop":
                finish = "tool_calls"
            usage = srv.usage_from_meter(n_prompt, n_out, box)
            srv.end_trace(trace, finish, n_out, n_prompt)
            if finish == "migrated":
                # the session moved: no finish frame and no [DONE]; the
                # importer's stream carries them under the same id
                self.wfile.flush()
                return
            if not include_usage:
                usage = None
            if chat:
                tail = oai.stream_chunk_sse(
                    response_id=rid, model=srv.model_name, created=created,
                    delta={}, finish_reason=finish, usage=usage)
            else:
                tail = oai.completion_chunk_sse(
                    response_id=rid, model=srv.model_name, created=created,
                    text="", finish_reason=finish, usage=usage)
            self.wfile.write(tail)
            self.wfile.write(oai.sse("[DONE]"))
            self.wfile.flush()

    return Handler
