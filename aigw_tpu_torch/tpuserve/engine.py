"""Continuous-batching engine (counterpart of
``aigw_tpu/tpuserve/engine.py``, the main-path subset).

- **Fixed decode geometry**: every decode step runs the whole
  ``[max_batch_size]`` slot table; finished slots are masked, not
  removed. The model calls see the page table cut to the reference's
  power-of-two page bucket (``_state_bucket``).
- **K-step decode windows**: the reference's ``lax.scan`` becomes a
  Python loop of K steps whose sampled tokens stay on the device; the
  host copies the ``[K, B]`` tokens once per window (started
  asynchronously into pinned memory on CUDA) and settles the window while
  the next one runs — the same 1-deep pipeline as the reference. The
  adaptive ``{min, max}`` window is kept.
- **Compiled programs**: where the reference compiles each window
  (``_decode_fn_for``) and each prefill geometry with ``jax.jit``, the
  port captures a CUDA graph (``tpuserve/programs.py``): one per window
  key ``(k, lean, draft, greedy, adapters)`` and page bucket, and one per
  prefill shape, captured the first time the key is seen or ahead of
  traffic by ``warmup()`` under the reference's two warm knobs. The
  decode state is allocated once per engine and every program updates
  it, and the KV pool, in place. ``compile_tracker`` counts the programs
  (``/state``'s ``warm_programs``, ``xla_compiles``,
  ``xla_compile_ms``). Eager on every device, each for its reason: the
  windowed prefill over quantized pools (its page walk is read on the
  host once per call, ``models/llama._window_pages``), the page movers
  (copy-on-write, export, import, spill and revive: single copies) and
  the decode state's row uploads.
- **Sampling on the device**, keys ``[seed, position]`` per slot, so
  streams are identical to the reference engine's, greedy and seeded.
- **Engine thread**: the loop runs in its own thread; consumers receive
  tokens through each request's ``emit`` callback.

Admission is the reference's: each pass first runs the tenant fairness
guard (``_fair_admission``: a per-tenant slot cap, and deficit order
whenever two or more tenants are pending or live), then classifies its
requests, runs of two or more simple ones (whole prompt, nothing cached
to adopt, at most one new chain head per run) prefill as one packed
burst (``group_prefill``), and every other request goes through
``_admit_one`` in the guard's order, which adopts the longest cached
page-prefix and resumes at its offset (``single_prefill``). Both run the
attention backend (``tpuserve/attention.py``): the bucket ladder
(``xla-bucketed``, the default) or the ragged packer
(``pallas-ragged``). On the bucket ladder a prompt longer than
``prefill_chunk_tokens`` is never batched: the per-request path runs it
as chunks with decode ticks between them. The KV pool (native, or
int8/int4 pages with their scales, ``models/kvq.py``) carries one page
past the allocator's range, the dump page.

**Prefix caching** (``enable_prefix_cache``, on by default as in the
reference; ``tpuserve/kvcache.py``): full prompt pages are registered
under chained content hashes after each prefill. A partial hit adopts
the cached pages and prefills only the suffix; a full hit (a
page-aligned prompt fully cached) adopts every page, copies the last one
into a private page (copy-on-write, ``kvq.copy_page`` on the engine's
stream) and resumes with the single token at n - 1. Each hit is admitted
on its own, one packed call per request, as in the reference. The radix
chain's continuation seeds speculation's lookahead drafts.

**Speculative decoding** (``spec_tokens > 0``, ``tpuserve/
speculation.py``): while an eligible slot's adaptive controller holds a
nonzero draft length D, a window runs K verify steps of width D + 1
(``_spec_window``, the reference's ``_spec_scan``) instead of K decode
steps, each slot advancing by its accepted drafts plus one. The verify
step runs K5 when the decode rung resolves to ``chained-*`` and the
gather path otherwise, as in the reference.

**Grammar-constrained decoding** (``constrained_decoding``, on by
default as in the reference; ``tpuserve/constrain.py``): a request's
``constraint`` (a shared ``TokenFSM``) gives its slot an FSM cursor
whose state's ``[V]`` mask is added to the slot's logit-bias row. The
prefill samples the first token under the initial state's mask. A window
runs under the mask of the state settled at dispatch; the host accepts
its tokens only while the slot's current state demands that same mask
(``_cn_verify``), and at the first token whose mask changed it rolls the
slot back to its last accepted token: the epoch moves, so the window in
flight is discarded for the slot, and the whole row (position, key,
counts, history, mask) is uploaded again behind it. Rows past the cut
that the kernels already wrote are rewritten by the next windows. An
accepted token that moves the state patches only the bias row. Row
uploads on CUDA go through a pinned staging row per slot with
non-blocking copies on the engine's stream.

**Mixture of experts** (a family whose ``ModelFns.moe_stats`` is set,
``models/mixtral.py``): every model call also returns its ``[L, E + 1]``
routing counts (placed per expert, then dropped, per layer). A decode
or speculative window sums them on the device and they reach the host
with the window's token copy; a packed prefill's reach it with its first
tokens. They fold into per-expert and per-layer totals where the
reference folds them (a window's even when a grammar cut discards its
tokens), behind ``/state``'s ``moe_*`` keys: zero or ``[]`` on dense
families, as in the reference.

**Multi-LoRA** (``lora_params``/``adapter_names`` for a fixed stack, or
an ``adapter_store``, ``tpuserve/adapters.py``, for a hot-loaded zoo):
a request's ``adapter`` pins its row at admission (a load into a free or
LRU-evicted row when it is not resident; every row pinned is waited out
like page pressure), every model call gets the stacks and each
sequence's row (the decode state's ``adapter_idx``), and the row is
released wherever its slot is freed. An unknown adapter finishes its
request with ``error``. Mixtral's entry points take the rows and ignore
them, as the reference's do. The prefix cache keys pages on token ids
only, as the reference's does: an adapter request can adopt pages a base
request (or another adapter) computed.

**Per-token logprobs** (``logprobs_topk > 0``; exclusive with
speculation, as in the reference): every sampling step also computes
``sampling.token_logprobs`` over the logits the token was drawn from (the
prefill's ``logits + bias``, a window step's penalized logits), and a
request with ``emit_lp`` receives ``(token, finish, chosen, top)``
instead of ``emit``'s pair. A window's ``[K, B]`` chosen values and
``[K, B, k]`` top ids and values reach the host under the tokens' event.
With ``logprobs_topk == 0`` the window runs exactly the ops it ran
before.

**Operations surface**: a request's ``trace`` (``obs/flight.py``'s
``RequestTrace``) hears queue wait, admission, prefill, first token,
decode and speculative windows, grammar rollbacks, the token copy and
the engine's finish, at the reference's points; the phase histograms
keep a traced request's id as the bucket's exemplar. Each request gets
exactly one MeterRecord (``_meter_finish`` for a slot, ``_meter_zero``
for a request that never held one), handed to its ``meter_sink`` on
the engine thread before its terminal emit and summed into
``EngineStats.meter_*``. All of it is host bookkeeping: no device work
is added.

**KV mobility**: ``migrate_export`` cuts a live session at its next
token boundary (the window in flight settled) and serializes its complete
pages, pinned while they are copied off the device, with its sampling,
penalty, key and meter state; ``migrate_import`` scatters such pages into
the pool and registers them in the prefix cache, where the continuation
(``continuation_request``, ``GenRequest.import_state``) adopts them and
resumes at its offset, sampling its first token with the key the solo run
would have used. ``kv_export_pages`` / ``kv_import_pages`` serve and adopt
pages by chain key for the fleet fetch, and ``kv_chain_digest`` lists the
keys held. With ``kv_host_bytes`` the prefix cache's evictions spill into
the host tier (``tpuserve/kvhost.py``) and a hit on a spilled chain
revives it. Server threads post these jobs on a queue the engine thread
runs (``_process_migrations``).

**The offline batch class** (``priority="batch"``): a never-shed queue
admitted after the interactive pass, only while no interactive request
waits and under the ``batch_slot_frac`` ceiling; an interactive arrival
on a full table parks batch slots through the export cut, and the tier
resumes them, parked sessions first, through the import.

Every default equals the reference's, and so does what it runs: a
replica built from ``EngineConfig()`` prefills on the bucket ladder and
decodes on the gather rung. Knobs of features the port does not
implement (``NOT_PORTED``, empty since the warm knobs were ported)
raise ``NotImplementedError`` naming their ROADMAP entry when set to a
non-default value.
"""

from __future__ import annotations

import heapq
import itertools
import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from aigw_tpu_torch.device import resolve_device
from aigw_tpu_torch.models import kvq
from aigw_tpu_torch.obs.flight import trace_id_of
from aigw_tpu_torch.obs.graph_events import CompileTracker
from aigw_tpu_torch.obs.metrics import EnginePhases
from aigw_tpu_torch.tpuserve import constrain, speculation
from aigw_tpu_torch.tpuserve.adapters import (
    AdapterCapacityError,
    UnknownAdapterError,
)
from aigw_tpu_torch.tpuserve.attention import (
    BACKENDS,
    DECODE_BACKENDS,
    make_attention_backend,
    resolve_decode_backend,
)
from aigw_tpu_torch.tpuserve.kvcache import (
    OutOfPagesError,
    PageAllocator,
    PrefixCache,
    RefcountedAllocator,
    page_chain_hashes,
)
from aigw_tpu_torch.tpuserve.kvhost import HostKVTier
from aigw_tpu_torch.tpuserve.programs import (
    ProgramFamily,
    ProgramPool,
    clone_tree,
)
from aigw_tpu_torch.tpuserve.sampling import (
    SamplingParams,
    apply_penalties,
    sample,
    spec_accept,
    token_logprobs,
)

logger = logging.getLogger(__name__)

#: knobs of features the port does not implement yet: (reference
#: default, ROADMAP queue 1 entry). A non-default value raises
#: NotImplementedError. None since the warm knobs were ported (a
#: captured CUDA graph stands for a compiled program)
NOT_PORTED: dict[str, tuple[Any, str]] = {}

#: defaults that differ from the reference, and why (/state): none
DEFAULTS_DIFFER: dict[str, str] = {}


class EngineOverloadedError(Exception):
    """Admission queue full — callers should surface 429/503."""


class MigrationError(Exception):
    """A page export or import could not be performed (the request is
    not active or finished during the cut, no prefix cache, a malformed
    page). The session is left as it was: a failed export never ends the
    stream it tried to move."""


@dataclass
class EngineConfig:
    """The reference's EngineConfig fields this slice serves, with the
    reference's names and defaults."""

    max_batch_size: int = 8
    max_seq_len: int = 2048
    page_size: int = 128
    num_pages: int = 0  # 0 = auto: enough for max_batch full sequences
    # the smallest rung of the bucketed prefill's ladder
    min_prefill_bucket: int = 64
    # decode steps per host round-trip (the adaptive window's maximum)
    decode_steps_per_tick: int = 8
    # chunked prefill on the bucket ladder: a prompt longer than this
    # runs as fixed-size prefill_suffix chunks with a decode tick between
    # them (0 = whole-prompt prefill)
    prefill_chunk_tokens: int = 256
    enable_prefix_cache: bool = True
    max_queued_requests: int = 256
    adaptive_decode_window: bool = True
    # small window used under pressure; 0 = auto: max(1, K // 4)
    min_decode_steps_per_tick: int = 0
    # copy each window's tokens to the host asynchronously (CUDA)
    async_transfers: bool = True
    # idle-burst coalescing before admitting (ms); 0 disables
    admission_coalesce_ms: float = 3.0
    # a lone arrival to an idle engine probes 1 ms for a second request
    # instead of waiting the whole coalescing window
    first_token_fast_path: bool = True
    # capture programs ahead of traffic: the batched prefill's shapes of
    # the N smallest prompt-bucket octaves (every group size; the ragged
    # backend's token rungs at any N > 0), and the decode window ladder
    # at the N smallest power-of-two page buckets (0 = only the
    # quiesced bucket)
    warm_prefill_buckets: int = 0
    warm_decode_buckets: int = 0
    # bucket ladder rungs per octave: 1 = powers of two, 2 adds 1.5x S,
    # 4 adds 1.25x / 1.5x / 1.75x S
    prefill_bucket_rungs: int = 2
    # the chained decode rung (paged-attention kernel after the scatter)
    pallas_attn: bool = False
    decode_backend: str = "auto"
    attention_backend: str = "xla-bucketed"
    ragged_chunk_tokens: int = 256
    ragged_max_chunks: int = 8
    kv_cache_dtype: str = "bfloat16"
    # speculative decoding: max draft tokens verified per step (0 = off)
    spec_tokens: int = 0
    # adaptive per-slot draft rungs; False pins eligible slots at
    # spec_tokens
    spec_adaptive: bool = True
    # grammar-constrained decoding (response_format json modes and tool
    # calls); False makes the server 400 such requests
    constrained_decoding: bool = True
    # the most in-flight slots one tenant (GenRequest.tenant; "" is one
    # anonymous tenant) may hold; 0 = no cap. Admission is deficit-
    # ordered whenever several tenants are pending or live, cap or not
    tenant_slot_cap: int = 0
    # per-token logprobs: top alternates computed per sampled token (0 =
    # off: the default programs are unchanged); exclusive with
    # spec_tokens, as in the reference
    logprobs_topk: int = 0
    # byte budget of the host spill tier (tpuserve/kvhost.py): with the
    # prefix cache on, a registered page reclaimed under pool pressure is
    # copied to host memory and revived by a later hit instead of being
    # prefilled again; 0 = off (plain eviction)
    kv_host_bytes: int = 0
    # a slot with 1 <= generated <= this counts toward /state's
    # migratable_slots (0 = every decoding slot); exports are not gated
    migration_young_tokens: int = 64
    # the most decode slots the offline batch class may hold, as a
    # fraction of max_batch_size (at least one); batch requests admit
    # only while no interactive request waits, and interactive arrivals
    # preempt them (a shrunk window, then a park through the export)
    batch_slot_frac: float = 0.5

    def __post_init__(self) -> None:
        if self.logprobs_topk > 0 and self.spec_tokens > 0:
            raise ValueError(
                "logprobs_topk and spec_tokens are mutually exclusive")
        if not 0.0 < self.batch_slot_frac <= 1.0:
            raise ValueError(
                f"batch_slot_frac must be in (0, 1] "
                f"(got {self.batch_slot_frac})")
        for name, (default, entry) in NOT_PORTED.items():
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r}: not ported yet "
                    f"(ROADMAP queue 1: {entry})")
        kvq.compute_dtype(self.kv_cache_dtype)  # raises if unknown
        if self.attention_backend not in BACKENDS:
            raise ValueError(f"attention_backend must be one of {BACKENDS} "
                             f"(got {self.attention_backend!r})")
        if self.decode_backend not in DECODE_BACKENDS:
            raise ValueError(f"decode_backend must be one of "
                             f"{DECODE_BACKENDS} "
                             f"(got {self.decode_backend!r})")
        if self.ragged_chunk_tokens < 8 or self.ragged_max_chunks < 1:
            raise ValueError("ragged_chunk_tokens must be >= 8 and "
                             "ragged_max_chunks >= 1")
        if self.prefill_bucket_rungs not in (1, 2, 4):
            raise ValueError(
                f"prefill_bucket_rungs must be 1, 2, or 4 "
                f"(got {self.prefill_bucket_rungs})")
        if self.min_decode_steps_per_tick == 0:
            self.min_decode_steps_per_tick = max(
                1, self.decode_steps_per_tick // 4)
        if self.min_decode_steps_per_tick > self.decode_steps_per_tick:
            raise ValueError(
                f"min_decode_steps_per_tick "
                f"({self.min_decode_steps_per_tick}) exceeds "
                f"decode_steps_per_tick ({self.decode_steps_per_tick})")
        if self.max_seq_len % self.page_size != 0:
            raise ValueError(
                f"max_seq_len ({self.max_seq_len}) must be a multiple of "
                f"page_size ({self.page_size})")
        if self.num_pages == 0:
            self.num_pages = (self.max_batch_size * self.max_seq_len
                              // self.page_size)

    @property
    def max_pages_per_seq(self) -> int:
        return self.max_seq_len // self.page_size


@dataclass
class GenRequest:
    prompt: list[int]
    max_tokens: int
    sampling: SamplingParams
    # (token_id, finish_reason): token_id < 0 means no token, just finish
    emit: Callable[[int, str | None], None] = lambda t, f: None
    id: int = 0
    enqueued_at: float = field(default_factory=time.monotonic)
    # set by the consumer to abandon the request (client disconnect /
    # stop sequence hit); the engine frees the slot at the next tick
    cancelled: threading.Event = field(default_factory=threading.Event)
    # prompt tokens whose KV came from the prefix cache (set at
    # admission; the usage's cached_tokens)
    prefix_reused: int = 0
    # a compiled, shared constrain.TokenFSM (the slot builds its own
    # cursor at admission), or None: unconstrained
    constraint: Any = None
    # LoRA adapter name ("" = the base model)
    adapter: str = ""
    # tenant key of the fairness guard ("" = anonymous); the server sets
    # the x-aigw-tenant header's value, else the adapter
    tenant: str = ""
    # per-token logprobs: with logprobs_topk > 0, called INSTEAD of emit
    # with (token, finish, chosen logprob, [(top id, top logprob)]); a
    # terminal token < 0 carries (None, None)
    emit_lp: Callable[[int, str | None, float | None, list | None],
                      None] | None = None
    # the request's lifecycle sink (``obs.flight.RequestTrace``) or None:
    # queue wait, admission, prefill, first token, decode windows and the
    # engine's finish land in the flight recorder and the span tree
    trace: Any = None
    # called exactly once per request with its MeterRecord dict, on the
    # engine thread and before the terminal emit (so a consumer that has
    # the finish item has the record); None = not metered
    meter_sink: Callable[[dict], None] | None = None
    # "interactive" (the admission queue) or "batch": the never-shed
    # offline queue, admitted only into slots interactive leaves idle
    # (batch_slot_frac), parked host-side when interactive arrivals need
    # its slot and resumed byte-identically later
    priority: str = "interactive"
    # token ids that finish the request like EOS (the export blob's
    # stop_token_ids)
    stop_token_ids: tuple[int, ...] = ()
    # set on a request that RESUMES an exported session (a migration or a
    # parked batch slot): its prompt is the original prompt plus every
    # token generated so far, and this restores the slot state a solo
    # run would have at the cut: orig_prompt_len (tokens past it are
    # generated history: they seed the penalty counts), generated (the
    # usage offset), key_seed and key_counter (the first resumed token
    # samples with the key of position len(prompt) - 1) and meter_carry
    # (the record of the earlier segments). Such requests always take the
    # per-request admission path
    import_state: dict | None = None


@dataclass
class _Slot:
    req: GenRequest
    # position at which the pending input token is written by the next
    # decode step
    pos: int
    generated: int
    key_seed: int
    pending_token: int = 0
    limit: int = 0  # exclusive max write position (page-safety fence)
    page_row: np.ndarray | None = None
    first_emit_at: float = 0.0  # monotonic time of the first token
    # generated-token histogram (repetition penalties)
    token_counts: dict[int, int] = field(default_factory=dict)
    # generated tokens in order (the speculation history row is the
    # prompt followed by these)
    gen_tokens: list[int] = field(default_factory=list)
    # speculation (eligible slots only): the adaptive draft controller,
    # the draft length live on the device, and the lookahead buffer (the
    # radix chain's continuation: tokens from absolute position la_base)
    ctrl: Any = None  # speculation.DraftController | None
    dev_draft_len: int = 0
    la_base: int = 0
    la_tokens: list[int] = field(default_factory=list)
    # grammar constraint: the slot's FSM cursor and its rollback epoch (a
    # window whose captured epoch trails it is discarded for the slot)
    cn: Any = None  # constrain.ConstraintState | None
    cn_epoch: int = 0
    # the adapter row the slot decodes through (pinned while it lives)
    adapter_row: int = 0
    # usage metering accumulators, folded into the MeterRecord at the
    # terminal emit; m_res_t0 is the monotonic time the slot's pages
    # became resident (a slot holds its whole allocation from admission
    # on, so its residency is one segment: pages x bytes x dwell)
    m_prefill_real: int = 0
    m_prefill_padded: int = 0
    m_prefix_reused: int = 0
    m_spec_drafted: int = 0
    m_spec_accepted: int = 0
    m_res_t0: float = 0.0
    # the meter of the earlier segments of a resumed session (its
    # import_state's meter_carry), folded into the one terminal record
    m_carry: dict | None = None


@dataclass
class EngineStats:
    """The reference's stats this engine has, under the same names."""

    active_slots: int = 0
    queued: int = 0
    kv_pages_free: int = 0
    kv_occupancy: float = 0.0
    tokens_generated: int = 0
    prefills: int = 0
    chunked_prefill_steps: int = 0
    decode_steps: int = 0
    # prefix cache: misses count page-eligible prompts (at least one
    # full page) that reused nothing, so the hit rate is over prompts
    # the cache could have served; a full hit resumes at n - 1 against
    # a copy-on-write'd last page
    prefix_cache_hits: int = 0
    prefix_tokens_reused: int = 0
    prefix_cache_misses: int = 0
    prefix_cache_evictions: int = 0
    prefix_full_hits: int = 0
    prefix_cow_copies: int = 0
    prefix_pages_resident: int = 0
    prefix_pages_pinned: int = 0
    prefix_cache_hit_rate: float = 0.0
    decode_window: int = 0
    window_shrinks: int = 0
    window_grows: int = 0
    state_rebuilds: int = 0
    prefill_ms: float = 0.0
    transfer_ms: float = 0.0
    emit_ms: float = 0.0
    first_emit_ms: float = 0.0
    prefill_tokens_real: int = 0
    prefill_tokens_padded: int = 0
    prefill_padded_frac: float = 0.0
    queue_wait_ms: float = 0.0
    # warm-up cost: wall ms of the last warmup() and the programs it left
    # captured; the programs built since the engine came up (a capture,
    # or a CPU program's first call) and their capture ms: growth after
    # warm-up is a capture on the hot path
    warmup_ms: float = 0.0
    warm_programs: int = 0
    xla_compiles: int = 0
    xla_compile_ms: float = 0.0
    device_bytes_in_use: int = 0
    device_bytes_limit: int = 0
    device_memory_frac: float = 0.0
    kv_pool_bytes: int = 0
    kv_bytes_in_use: int = 0
    kv_quant_bits: int = 16
    kv_bytes_per_token: float = 0.0
    prefill_ms_decayed: float = 0.0
    prefill_tokens_decayed: float = 0.0
    # speculative decoding: tokens landed by accepted drafts (beyond the
    # one a step always emits), drafts offered, their ratio, the last
    # dispatched draft width, rung moves, lookahead-seeded slots
    spec_accepted: int = 0
    spec_drafted: int = 0
    spec_accept_rate: float = 0.0
    spec_draft_len: int = 0
    spec_rung_ups: int = 0
    spec_rung_downs: int = 0
    spec_lookahead_slots: int = 0
    # grammar-constrained decoding: live constrained slots, requests
    # admitted with a constraint, rollbacks (a window ran past a mask
    # change: its later tokens were discarded and the row uploaded
    # again), bias-row patches after an accepted token moved the state,
    # and the compiled-grammar cache size
    constrained_slots: int = 0
    constraint_requests: int = 0
    constraint_rollbacks: int = 0
    constraint_mask_updates: int = 0
    constraint_grammars: int = 0
    # host time in the constraint path (verify, rollback, the patches'
    # staging and queueing), and the windows it was spent over; the
    # port's own, not on /state
    constraint_host_ms: float = 0.0
    constraint_windows: int = 0
    # constrained members summed over those windows
    constraint_slot_windows: int = 0
    # mixture of experts: (token, k) assignments placed and dropped by
    # the capacity fence over every row the programs ran, the dropped
    # share, and the hottest expert's load over the mean
    moe_tokens_routed: int = 0
    moe_tokens_dropped: int = 0
    moe_dropped_frac: float = 0.0
    moe_expert_imbalance: float = 0.0
    # adapter serving: loads and evictions of device rows, resident
    # adapters, and live slots decoding through a non-base row
    adapter_loads: int = 0
    adapter_evictions: int = 0
    adapter_resident: int = 0
    adapter_slots: int = 0
    # tenant fairness: tenants holding slots, the most slots one holds,
    # and admissions the per-tenant cap deferred (one per pass waited)
    tenants_active: int = 0
    tenant_max_slots: int = 0
    tenant_deferrals: int = 0
    # the engine's devices (one) and the worst device's memory fraction
    device_count: int = 1
    device_memory_frac_worst: float = 0.0
    # the offline batch class: waiting work (the never-shed queue plus
    # parked sessions), slots it holds (at most the batch_slot_frac
    # ceiling), sessions parked for interactive arrivals and resumed,
    # and the tokens it generated
    batch_queued: int = 0
    batch_active: int = 0
    batch_preemptions: int = 0
    batch_resumed: int = 0
    batch_tokens: int = 0
    # sessions exported to / imported from other replicas, the pages
    # that moved with them, and the live slots young enough to migrate
    migrations_out: int = 0
    migrations_in: int = 0
    migration_pages_out: int = 0
    migration_pages_in: int = 0
    migratable_slots: int = 0
    # the host spill tier (its counters, what it holds now and its
    # budget) and the fleet fetch over /kv/pages (page sets served to
    # siblings and imported from them)
    kv_spills: int = 0
    kv_revives: int = 0
    kv_spill_evictions: int = 0
    kv_spilled_pages: int = 0
    kv_spill_bytes: int = 0
    kv_host_bytes: int = 0
    kv_fetches_out: int = 0
    kv_fetches_in: int = 0
    kv_fetch_pages_out: int = 0
    kv_fetch_pages_in: int = 0
    # engine-thread time in the page movers: spills (the stall a spill
    # adds to the allocation that reclaimed the page), exports and
    # fetches served (device→host) and imports (host→device); the
    # port's own, not on /state
    kv_spill_ms: float = 0.0
    kv_export_ms: float = 0.0
    kv_import_ms: float = 0.0
    # usage metering: cumulative MeterRecord totals, moved only in
    # Engine._meter_emit, so a ledger of the records reconciles against
    # them token for token
    meter_records: int = 0
    meter_prefill_tokens: int = 0
    meter_prefill_padded_tokens: int = 0
    meter_prefix_reused_tokens: int = 0
    meter_decode_tokens: int = 0
    meter_spec_drafted: int = 0
    meter_spec_accepted: int = 0
    meter_hbm_page_byte_s: float = 0.0
    meter_host_page_byte_s: float = 0.0

    PREFILL_RATE_HALF_LIFE_TOKENS = 16384

    def note_prefill_call(self, ms: float, tokens: int) -> None:
        """Fold one prefill call into the token-decayed prefill rate."""
        if tokens <= 0:
            return
        decay = 0.5 ** (tokens / self.PREFILL_RATE_HALF_LIFE_TOKENS)
        self.prefill_ms_decayed = self.prefill_ms_decayed * decay + ms
        self.prefill_tokens_decayed = (
            self.prefill_tokens_decayed * decay + tokens)

    def prefill_ms_per_token(self) -> float:
        if self.prefill_tokens_decayed > 0:
            return self.prefill_ms_decayed / self.prefill_tokens_decayed
        return self.prefill_ms / max(1, self.prefill_tokens_real)


@dataclass
class _Window:
    """One dispatched decode window: its sampled tokens (on their way to
    the host) and what the host needs to settle it."""

    # [K, B] int32 tokens, or for a speculative window [K, B, D + 3]
    # (samples, n_emit, n_prop; see _spec_window); a pinned host copy on
    # CUDA
    sampled: torch.Tensor
    ready: Any  # torch.cuda.Event recorded after the copy, or None
    # (slot index, request) pairs the window computes for
    members: tuple[tuple[int, GenRequest], ...]
    k: int
    # sequence ids whose pages are safe to recycle once it completes
    frees: list[int]
    # speculative draft width (0 = plain window) and the per-slot draft
    # lengths at dispatch ((slot, D_slot) pairs) for the controllers
    draft: int = 0
    draft_lens: tuple[tuple[int, int], ...] = ()
    # constrained members at dispatch: (slot, rollback epoch, the mask
    # the window samples under). A token counts only while the slot's
    # current state demands that very mask
    cn_epochs: tuple[tuple[int, int, Any], ...] = ()
    # the window's summed [L, E + 1] routing counts (host copy), or None
    # on a dense family
    moe: Any = None
    # per-token logprobs (host copies): [K, B] chosen, [K, B, k] top ids
    # and values; None with logprobs_topk == 0
    lp: Any = None


#: per-slot decode state on the device: field → numpy dtype
_STATE_DTYPES = {"tokens": np.int32, "positions": np.int32,
                 "limits": np.int32, "active": np.bool_, "keys": np.int64,
                 "temp": np.float32, "top_p": np.float32,
                 "top_k": np.int32, "freq_pen": np.float32,
                 "pres_pen": np.float32, "page_table": np.int32,
                 "counts": np.int32, "bias": np.float32,
                 "adapter_idx": np.int32}
#: the speculation rows, present when spec_tokens > 0: token history
#: (prompt + generated, valid through the pending token's position),
#: the slot's draft length, and the lookahead draft buffer
_SPEC_DTYPES = {"history": np.int32, "draft_len": np.int32,
                "lookahead": np.int32, "la_base": np.int32,
                "la_len": np.int32}


class Engine:
    """One model instance on one device."""

    def __init__(
        self,
        params: dict[str, torch.Tensor],
        model_cfg: Any,
        cfg: EngineConfig,
        eos_token_ids: tuple[int, ...] = (),
        fns: Any = None,  # models.registry.ModelFns; default = llama
        device: str | torch.device = "cuda",
        lora_params: dict[str, torch.Tensor] | None = None,
        adapter_names: tuple[str, ...] = (),
        # a hot-loaded zoo (tpuserve/adapters.py): refcounted rows with
        # LRU eviction; exclusive with the fixed stack above
        adapter_store: Any = None,
    ):
        from aigw_tpu_torch.models.registry import family_fns

        self.device = resolve_device(device)
        for name, t in {**params, **(lora_params or {})}.items():
            if t.device.type != self.device.type:
                raise ValueError(f"param {name} is on {t.device}, engine "
                                 f"device is {self.device}")
        # multi-LoRA: the stacks and name → row map; the last row of a
        # stack is the all-zeros base-model row (models/lora.py). With a
        # store both are dynamic, resolved through it
        if adapter_store is not None and (lora_params or adapter_names):
            raise ValueError(
                "pass either adapter_store or lora_params/adapter_names, "
                "not both")
        if (adapter_store is not None
                and adapter_store.device.type != self.device.type):
            raise ValueError(f"adapter store is on {adapter_store.device}, "
                             f"engine device is {self.device}")
        self._adapter_store = adapter_store
        self._lora_static = lora_params
        if adapter_store is not None:
            self.adapter_rows: dict[str, int] = {}
            self._base_row = adapter_store.base_row
        else:
            self.adapter_rows = {n: i for i, n in enumerate(adapter_names)}
            self._base_row = len(adapter_names)
        self.fns = fns or family_fns("llama")
        self.params = params
        self.model_cfg = model_cfg
        # MoE routing stats: per-expert placed and per-layer dropped
        # totals, folded from every call's [L, E + 1] leaf
        self._moe = bool(getattr(self.fns, "moe_stats", False))
        self._moe_kw = {"moe_stats": True} if self._moe else {}
        self._moe_experts = (int(getattr(model_cfg, "n_experts", 0))
                             if self._moe else 0)
        self._moe_expert_tokens = np.zeros(max(self._moe_experts, 1),
                                           np.int64)
        self._moe_layer_drops = np.zeros(max(int(model_cfg.n_layers), 1),
                                         np.int64)
        self.cfg = cfg
        self.eos = eos_token_ids
        if cfg.enable_prefix_cache:
            self.allocator = RefcountedAllocator(cfg.num_pages,
                                                 cfg.page_size)
            self.prefix_cache: PrefixCache | None = PrefixCache(
                self.allocator, cfg.page_size)
        else:
            self.allocator = PageAllocator(cfg.num_pages, cfg.page_size)
            self.prefix_cache = None
        # the host spill tier: with the prefix cache on, eviction demotes
        # a registered page into it (its rows copied device→host) and a
        # prefix hit on a spilled chain revives the pages
        self.host_tier: HostKVTier | None = None
        if cfg.kv_host_bytes > 0 and self.prefix_cache is not None:
            self.host_tier = HostKVTier(cfg.kv_host_bytes)
            self.prefix_cache.spill_sink = self._spill_page
        # hex chain keys this replica holds (resident and spilled),
        # rebuilt by the engine thread at most every 0.5 s and read
        # lock-free by /state and the fleet fetch (an atomic swap)
        self._kv_digest: tuple[str, ...] = ()
        self._kv_digest_next = 0.0
        self.stats = EngineStats()
        # serving-phase latency histograms (queue_wait, prefill, ttft,
        # first_emit, decode_per_token, transfer), observed where the
        # reference's engine observes them; /state's phase_percentiles
        self.phases = EnginePhases()
        self.stats.kv_quant_bits = kvq.quant_bits(cfg.kv_cache_dtype)
        # the engine's device: memory (CUDA), its KV pool and weights
        # (``/metrics``' per-device gauges), refreshed with the stats
        self.param_bytes = sum(t.numel() * t.element_size()
                               for t in params.values())
        self.device_stats: list[dict[str, Any]] = []
        # one admission pass's (burst id, size), for the traces
        self._burst_seq = itertools.count(1)
        self._cur_burst: tuple[int, int] = (0, 0)
        self.healthy = True
        self.last_error: str | None = None

        B = cfg.max_batch_size
        self._slots: list[_Slot | None] = [None] * B
        self._queue: "queue.Queue[GenRequest]" = queue.Queue()
        # the offline batch class has its own unbounded queue, so every
        # interactive signal (the window's pressure, queue_wait_ms,
        # /state's queued) stays batch-free; parked sessions are batch
        # slots cut off the device through the export ({"blob", "data",
        # emit, cancelled, meter_sink, parked_at, park_bytes}), resumed
        # oldest first
        self._batch_q: "queue.Queue[GenRequest]" = queue.Queue()
        self._parked_batch: list[dict] = []
        # export, import and fetch jobs posted by server threads, run on
        # the engine thread (the only one that touches the pool and the
        # slot table)
        self._mig_q: "queue.Queue[tuple]" = queue.Queue()
        self._seq_ids = itertools.count()
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: threading.Thread | None = None
        # the pool carries one extra page past the allocator's range:
        # the dump page (never allocated, never in a page table)
        kv_shape = (model_cfg.n_layers, 2,
                    (cfg.num_pages + 1) * cfg.page_size,
                    model_cfg.n_kv_heads, model_cfg.head_dim)
        self.kv_cache = kvq.make_pool(kv_shape, cfg.kv_cache_dtype,
                                      self.device)
        # device bytes of one page: packed elements plus, for a quantized
        # pool, one float32 scale per token row and KV head for K and V
        # (the reference's kv_page_bytes)
        per_elt = kvq.bytes_per_kv_element(cfg.kv_cache_dtype)
        scale = 4 if kvq.is_quantized_dtype(cfg.kv_cache_dtype) else 0
        self.kv_page_bytes = int(
            model_cfg.n_layers * 2 * cfg.page_size * model_cfg.n_kv_heads
            * (model_cfg.head_dim * per_elt + scale))
        self.stats.kv_bytes_per_token = round(
            self.kv_page_bytes / cfg.page_size, 3)
        # per-slot decode state lives ON DEVICE between ticks; membership
        # changes patch single rows (_dirty_rows), never the live rows of
        # in-flight slots
        self._device_state: dict[str, torch.Tensor] | None = None
        self._dirty_rows: set[int] = set()
        # the page-table width the model calls see: the reference's
        # power-of-two page bucket covering every live slot's limit, set
        # when the state is built; an admission that needs a wider one
        # drains the pipeline and rebuilds (``_need_rebuild``), as the
        # reference does. Only rows that attend nothing (past their
        # limit) read the width: they average the whole window, and an
        # MoE layer routes them by that average
        self._state_bucket = 0
        self._need_rebuild = False
        # 1-deep pipeline: the window on the device while the host
        # settles the previous one
        self._inflight: _Window | None = None
        # pages of finished sequences, recycled once every window
        # dispatched while they were active has completed
        self._pending_frees: list[int] = []
        self._cur_window = cfg.decode_steps_per_tick
        self._steady_ticks = 0
        self._mem_next = 0.0
        # the compiled programs: the decode window families of
        # ``_decode_fn_for`` and the prefill families, captured CUDA
        # graphs sharing one memory pool (tpuserve/programs.py), counted
        # by the tracker; the per-slot decode state they update is
        # allocated once (``_state``, by the first build)
        self.compile_tracker = CompileTracker()
        self.programs = ProgramPool(self.device, self.compile_tracker)
        self._decode_fns: dict[tuple, ProgramFamily] = {}
        # prefill entry point → its family (the reference's "prefill",
        # "prefill_suffix" and "prefill_ragged" programs)
        self._prefill_fns: dict[Callable, ProgramFamily] = {
            f: self.compile_tracker.register(name, ProgramFamily(
                lambda key, f=f: self._prefill_body(f, len(key[1]) - 6),
                self.programs))
            for name in ("prefill", "prefill_suffix", "prefill_ragged")
            if (f := getattr(self.fns, name, None)) is not None}
        self._state: dict[str, torch.Tensor] | None = None
        self.decode_attn_impl, self.decode_attn_reason = (
            resolve_decode_backend(cfg, self.device))
        # decode_step's attn_impl: the gather rung is its "" branch
        self._decode_impl = {"fused": "fused", "chained": "chained",
                             "gather": ""}[
            self.decode_attn_impl.split("-")[0]]
        # speculative decoding: a rung ladder of [B, D + 1] verify steps
        # replaces the decode step while an eligible slot's controller
        # holds a nonzero draft length. The verify step keeps the chained
        # path (K5) on the chained rung, and takes the gather path (which
        # also serves quantized pools) on the fused and gather rungs
        self._spec_rungs = (
            speculation.draft_rungs(cfg.spec_tokens)
            if cfg.spec_tokens > 0 and self.fns.verify_step is not None
            else (0,))
        self._spec_max = self._spec_rungs[-1]
        self._accept_prior = speculation.AcceptancePrior()
        self._verify_impl = "chained" if self._decode_impl == "chained" \
            else ""
        # slots whose controller moved rung: only their on-device draft
        # length is patched before the next dispatch
        self._spec_dirty: set[int] = set()
        # constrained slots whose FSM moved on an accepted token: only
        # their bias row (logit_bias + the new state's mask) is patched
        # before the next dispatch; like draft_len it does not depend on
        # the position, so it is safe to patch with a window in flight
        self._cn_dirty: set[int] = set()
        # CUDA row uploads: a pinned staging row per slot (field → host
        # tensor) and the event recorded after its last copies
        self._stage: dict[int, dict[str, torch.Tensor]] = {}
        self._stage_done: list[Any] = [None] * B
        self._state_dtypes = (_STATE_DTYPES | _SPEC_DTYPES if self._spec_max
                              else _STATE_DTYPES)
        self.attn = make_attention_backend(self)
        self._refresh_stats()

    # -- device programs ----------------------------------------------------
    def _model(self, fn, *args, adapter_idx=None, **kw):
        """One model call with the adapter stacks and each sequence's row
        (``adapter_idx``): the pool is kept; returns (logits, the call's
        [L, E + 1] routing counts or None on a dense family)."""
        out = fn(self.params, self.model_cfg, *args, **kw, **self._moe_kw,
                 lora=self.lora_params, adapter_idx=adapter_idx)
        logits, kv, moe = out if self._moe else (*out, None)
        if kv is not self.kv_cache:
            # the captured programs address the pool's tensors: every
            # model entry point updates it in place
            raise RuntimeError(f"{getattr(fn, '__name__', fn)} returned "
                               "another KV pool than it was given")
        return logits, moe

    def _prefill_step(self, fn, args: tuple, sampling: tuple):
        """One prefill call, ``fn(params, cfg, *args[:-1], pool,
        args[-1], page_size)`` (``prefill_ragged``, ``prefill`` or
        ``prefill_suffix``; ``args[-1]`` is the page table), plus
        sampling of each row's first token with ``sampling`` = (keys,
        temp, top_p, top_k, bias, adapter_idx), one row per sequence row
        (key [seed, 0]); returns ([rows] int32 tokens, routing counts or
        None), on the device. With logprobs on, the tokens are a tuple
        (tokens, chosen, top ids [rows, k], top values [rows, k]).

        The call is its family's program at the shapes of its inputs
        and whether adapter stacks are present (the reference's jit
        cache), except the windowed ragged prefill of a quantized pool,
        which reads its page walk on the host and so runs eagerly. The
        outputs are copies the caller may keep past the next program."""
        if fn is self.fns.prefill_ragged and kvq.is_quantized(
                self.kv_cache):
            return self._prefill_body(fn, len(args))(*args, *sampling)
        inputs = (*args, *sampling)
        key = (self.lora_params is not None,
               tuple((tuple(t.shape), t.dtype) for t in inputs))
        out = self._prefill_fns[fn].program(key)(*inputs)
        return clone_tree(out) if self.programs.cuda else out

    def _prefill_body(self, fn, n_args: int):
        """The prefill program's body over ``n_args`` model inputs and
        the six sampling rows (``_prefill_step``)."""

        def body(*inputs):
            args, sampling = inputs[:n_args], inputs[n_args:]
            keys, temp, top_p, top_k, bias, adapter_idx = sampling
            logits, moe = self._model(
                fn, *args[:-1], self.kv_cache, args[-1],
                self.cfg.page_size, adapter_idx=adapter_idx)
            logits = logits + bias
            sampled = sample(logits, keys, temp, top_p, top_k)
            if not self.cfg.logprobs_topk:
                return sampled, moe
            return (sampled, *token_logprobs(
                logits, sampled, self.cfg.logprobs_topk)), moe

        return body

    def _decode_fn_for(self, k: int, lean: bool, greedy: bool,
                       draft: int = 0):
        """The decode program of a window of ``k`` steps at draft rung
        ``draft`` (0 = plain decode) and the current page bucket (the
        reference's ``_decode_fn_for``, cached per key; its jit caches
        per page-bucket shape). ``lean`` selects the penalty-free plain
        variant (a verify window has none: its eligibility reads the
        penalty fields); the port's key adds ``greedy`` (the window
        skips the sampling sort) and whether adapter stacks are present
        (the model calls' ``lora`` is None or the stacks)."""
        if draft:
            lean = False
        lora = self.lora_params is not None
        key = (k, lean, draft, greedy, lora)
        fam = self._decode_fns.get(key)
        if fam is None:
            fam = self._decode_fns[key] = self.compile_tracker.register(
                f"decode[k={k},lean={lean},d={draft},greedy={greedy},"
                f"lora={lora}]",
                ProgramFamily(lambda P: (
                    lambda: self._spec_window(k, draft, greedy, P)
                    if draft else self._decode_window(k, lean, greedy, P)),
                    self.programs))
        return fam.program(self._state_bucket)

    def _decode_window(self, k: int, lean: bool, greedy: bool, P: int
                       ) -> tuple[torch.Tensor, Any, Any]:
        """K decode+sample steps; sampled tokens feed forward on the
        device. ``lean`` skips the repetition-penalty terms (bit-identical
        while no live slot uses penalties: zero penalties subtract
        exactly 0.0), ``greedy`` skips the sort/top-p work when every
        live slot samples greedily (sample() returns argmax for those).
        Returns ([K, B] int32 tokens, the window's summed routing counts
        or None, and with logprobs on ([K, B] chosen, [K, B, k] top ids,
        [K, B, k] top values), else None) on the device. The state and
        the pool are updated in place (the body of a captured program,
        ``_decode_fn_for``), the page table seen at bucket ``P``."""
        st = self._state
        lp_k = self.cfg.logprobs_topk
        pt = st["page_table"][:, :P]
        out = []
        lps = []
        macc = None
        for _ in range(k):
            act = st["active"] & (st["positions"] < st["limits"])
            logits, moe = self._model(
                self.fns.decode_step, st["tokens"], st["positions"],
                self.kv_cache, pt, self.cfg.page_size, act,
                attn_impl=self._decode_impl, adapter_idx=st["adapter_idx"])
            macc = moe if macc is None else macc + moe
            if lean:
                logits = logits + st["bias"]
            else:
                logits = apply_penalties(logits, st["counts"],
                                         st["freq_pen"], st["pres_pen"],
                                         st["bias"])
            if greedy:
                sampled = torch.argmax(logits, dim=-1).to(torch.int32)
            else:
                sampled = sample(logits, st["keys"], st["temp"],
                                 st["top_p"], st["top_k"])
            if lp_k:
                # over the penalized logits: the distribution the token
                # was drawn from
                lps.append(token_logprobs(logits, sampled, lp_k))
            if not lean:
                st["counts"].scatter_add_(1, sampled.long()[:, None],
                                          act.to(torch.int32)[:, None])
            st["tokens"].copy_(torch.where(act, sampled, st["tokens"]))
            st["positions"].add_(act.to(torch.int32))
            st["keys"][:, 1] = (st["keys"][:, 1] + act.long()) & 0xFFFFFFFF
            out.append(sampled)
        lp = (tuple(torch.stack(t) for t in zip(*lps)) if lp_k else None)
        return torch.stack(out), macc, lp

    def _spec_window(self, k: int, D: int, greedy: bool, P: int
                     ) -> tuple[torch.Tensor, Any]:
        """K speculative steps at draft rung D (the reference's
        ``_spec_scan`` body). Each step drafts D tokens per slot
        (lookahead where it covers the position, n-gram elsewhere),
        poisoned to -1 for ineligible slots (sampled or penalized) and
        past the slot's own ``draft_len``; verifies the D + 1 positions
        in one ``verify_step``; samples position d with key ``[seed, pos
        + d]``, the key plain decoding would use there; and advances each
        slot by ``spec_accept``'s n_emit. ``greedy`` takes the argmax,
        which ``sample`` returns for greedy slots anyway. Returns ([K, B,
        D + 3] int32: the samples ``[..., :D + 1]``, then n_emit and
        n_prop (the drafts actually offered); the window's summed
        routing counts or None), on the device. The state and the pool
        are updated in place, the page table seen at bucket ``P``."""
        st = self._state
        dev = self.device
        B = self.cfg.max_batch_size
        H = self.cfg.max_seq_len
        D1 = D + 1
        rows = torch.arange(B, device=dev)
        d_off = torch.arange(D, device=dev)[None, :]
        d_idx = torch.arange(D1, device=dev)[None, :]
        elig = ((st["freq_pen"] == 0.0) & (st["pres_pen"] == 0.0)
                & (st["temp"] <= 0.0))
        pt = st["page_table"][:, :P]
        out = []
        macc = None
        for _ in range(k):
            act = st["active"] & (st["positions"] < st["limits"])
            drafts = speculation.combine_drafts(
                speculation.lookahead_drafts(
                    st["lookahead"], st["la_base"], st["la_len"],
                    st["positions"], D),
                speculation.ngram_drafts(st["history"], st["positions"], D))
            ok = elig[:, None] & (d_off < st["draft_len"][:, None])
            drafts = torch.where(ok, drafts, torch.full_like(drafts, -1))
            inputs = torch.cat([st["tokens"][:, None],
                                torch.clamp(drafts, min=0)], dim=1)
            logits, moe = self._model(
                self.fns.verify_step, inputs, st["positions"],
                self.kv_cache, pt, self.cfg.page_size, act,
                st["limits"], attn_impl=self._verify_impl,
                adapter_idx=st["adapter_idx"])
            macc = moe if macc is None else macc + moe
            # counts are window-start values: exact at d = 0, and later
            # positions accept only on penalty-free slots
            lT = apply_penalties(logits.transpose(0, 1), st["counts"],
                                 st["freq_pen"], st["pres_pen"], st["bias"])
            if greedy:
                sampled = torch.argmax(lT, dim=-1).to(torch.int32)
            else:
                keys = st["keys"][None].repeat(D1, 1, 1)  # [D1, B, 2]
                keys[:, :, 1] = (keys[:, :, 1] + d_idx.T) & 0xFFFFFFFF
                sampled = sample(
                    lT.reshape(D1 * B, -1), keys.reshape(D1 * B, 2),
                    st["temp"].repeat(D1), st["top_p"].repeat(D1),
                    st["top_k"].repeat(D1)).reshape(D1, B)
            sampled = sampled.T.contiguous()  # [B, D1]
            n_emit, emit = spec_accept(drafts, sampled, act,
                                       st["limits"] - st["positions"])
            # sampled[:, d] is the token at position pos + 1 + d. torch
            # has no drop mode: an entry not emitted (or past max_seq_len)
            # rewrites history[pos] with its own value instead
            pos = st["positions"].long()
            col = pos[:, None] + 1 + d_idx
            keep = emit & (col < H)
            here = torch.clamp(pos, 0, H - 1)[:, None].expand(B, D1)
            st["history"].scatter_(
                1, torch.where(keep, col, here),
                torch.where(keep, sampled,
                            torch.gather(st["history"], 1, here)))
            st["counts"].scatter_add_(1, sampled.long(),
                                      emit.to(torch.int32))
            new_pending = sampled[rows, torch.clamp(n_emit.long() - 1, 0, D)]
            st["tokens"].copy_(torch.where(n_emit > 0, new_pending,
                                           st["tokens"]))
            st["positions"].add_(n_emit)
            st["keys"][:, 1] = (st["keys"][:, 1] + n_emit.long()) & 0xFFFFFFFF
            n_prop = torch.cumprod((drafts >= 0).to(torch.int32),
                                   dim=1).sum(dim=1)
            n_prop = torch.where(act, n_prop, torch.zeros_like(n_prop))
            out.append(torch.cat([sampled, n_emit[:, None],
                                  n_prop[:, None].to(torch.int32)], dim=1))
        return torch.stack(out), macc

    # -- adapter rows (tpuserve/adapters.py) ---------------------------------
    @property
    def lora_params(self) -> dict[str, torch.Tensor] | None:
        """The adapter stacks the next model call reads (None without
        adapters). A store loads rows in place, so its stacks never
        change identity."""
        if self._adapter_store is not None:
            return self._adapter_store.params or None
        return self._lora_static

    def _adapter_known(self, name: str) -> bool:
        if self._adapter_store is not None:
            return self._adapter_store.knows(name)
        return name in self.adapter_rows

    def _acquire_adapter(self, name: str) -> int:
        """An adapter name's device row for a new slot, pinned (and
        loaded when not resident) in store mode. Raises
        UnknownAdapterError for a name outside the zoo and
        AdapterCapacityError when every row is pinned (the caller
        requeues, as on KV page pressure)."""
        if self._adapter_store is not None:
            return self._adapter_store.acquire(name)
        row = self.adapter_rows.get(name)
        if row is None:
            raise UnknownAdapterError(name)
        return row

    def _release_adapter_row(self, row: int) -> None:
        """Drop a slot's pin on its row; safe with a window in flight: a
        later load into the row queues behind it on the stream."""
        if self._adapter_store is not None and row != self._base_row:
            self._adapter_store.release(row)

    def _adapter_row_of(self, req: GenRequest) -> int:
        """The device row of an admitted request (its pin was taken at
        admission, so a store lookup must succeed)."""
        if not req.adapter:
            return self._base_row
        if self._adapter_store is not None:
            return self._adapter_store.row_of(req.adapter)
        return self.adapter_rows.get(req.adapter, self._base_row)

    # -- host copies ----------------------------------------------------------
    def _start_host_copy(self, *ts: torch.Tensor | None):
        """Begin the device→host copies of ``ts`` now (None passes
        through); returns (host tensors, one event recorded after them).
        On the CPU the tensors already are the host copies."""
        if self.device.type != "cuda":
            return ts, None
        hosts = []
        for t in ts:
            if t is not None:
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t, non_blocking=True)
                t = host
            hosts.append(t)
        ev = torch.cuda.Event()
        ev.record()
        return tuple(hosts), ev

    # -- adaptive window ------------------------------------------------------
    def _window_ladder(self) -> list[int]:
        K = self.cfg.decode_steps_per_tick
        if not self.cfg.adaptive_decode_window:
            return [K]
        kmin = min(self.cfg.min_decode_steps_per_tick, K)
        return [K] if kmin == K else [kmin, K]

    def _choose_window(self) -> int:
        """Shrink to the small window while requests wait or a stream is
        brand new; regrow after two steady ticks. Only interactive work
        counts: batch waits in its own queue and a young batch stream
        has no TTFT at stake, so a waiting interactive request shrinks
        the window under every live batch slot (the first preemption
        rung)."""
        K = self.cfg.decode_steps_per_tick
        ladder = self._window_ladder()
        if len(ladder) == 1:
            self.stats.decode_window = K
            return K
        pressured = self._queue.qsize() > 0 or any(
            s is not None and s.generated <= 1
            and s.req.priority != "batch" for s in self._slots)
        if pressured:
            self._steady_ticks = 0
            chosen = ladder[0]
        else:
            self._steady_ticks += 1
            chosen = K if self._steady_ticks >= 2 else self._cur_window
        if chosen < self._cur_window:
            self.stats.window_shrinks += 1
        elif chosen > self._cur_window:
            self.stats.window_grows += 1
        self._cur_window = chosen
        self.stats.decode_window = chosen
        return chosen

    # -- public API -------------------------------------------------------------
    def warmup(self) -> None:
        """Build the CUDA kernels and capture the decode programs before
        traffic arrives (the reference's ``warmup``): every window of
        the adaptive ladder, lean and full, greedy and sampled, and every
        nonzero draft rung of the speculative ladder, at each warm page
        bucket (``_warm_page_buckets``), then, with
        ``warm_prefill_buckets > 0``, the attention backend's prefill
        shapes (``AttentionBackend.warm``). The windows run over the
        cleared decode state: every slot inactive, so they write only
        the dump page and move nothing. Records ``warmup_ms`` and the
        programs captured (``warm_programs``).

        The reference also compiles its row-update scatters, the page
        movers (a page export and an import at each rung) and the
        copy-on-write copy here; the port runs those eagerly (single
        copies with no program to build), so there is nothing to warm.
        Runs before ``start()``: the windows use the engine's decode
        state."""
        if self._thread is not None or self._inflight is not None or any(
                s is not None for s in self._slots):
            raise RuntimeError("warmup() runs before the engine starts")
        t0 = time.monotonic()
        if self.device.type == "cuda":
            from aigw_tpu_torch.ops import _build

            _build.library()
        self._build_device_state()
        quiesced = self._state_bucket
        try:
            for P in self._warm_page_buckets():
                self._state_bucket = P
                for k in self._window_ladder():
                    for greedy in (True, False):
                        for lean in (True, False):
                            self._decode_fn_for(k, lean, greedy)()
                        for d in self._spec_rungs:
                            if d:
                                self._decode_fn_for(k, False, greedy, d)()
        finally:
            self._state_bucket = quiesced
        if self._adapter_store is not None:
            self._adapter_store.warm()
        self.attn.warm()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats.warmup_ms = round(1e3 * (time.monotonic() - t0), 3)
        self.stats.warm_programs = self.compile_tracker.program_count()
        self._refresh_stats()

    def _warm_page_buckets(self) -> list[int]:
        """Page buckets warmup() captures the decode ladder at: the
        quiesced bucket, or with ``warm_decode_buckets`` = N the
        power-of-two rungs 1, 2, ..., 2^(N-1) capped at
        ``max_pages_per_seq`` (the reference's), so a first admission at
        any covered sequence length captures nothing on the hot path."""
        n = self.cfg.warm_decode_buckets
        if n <= 0:
            return [self._decode_bucket_pages()]
        buckets: list[int] = []
        b = 1
        for _ in range(n):
            buckets.append(min(b, self.cfg.max_pages_per_seq))
            if b >= self.cfg.max_pages_per_seq:
                break
            b *= 2
        return sorted(set(buckets))

    def _bucket_rungs(self, octave: int) -> list[int]:
        """The prefill-ladder rungs of one octave (octave 0 starts at
        ``min_prefill_bucket``), ascending, capped at ``max_seq_len``
        (the reference's)."""
        S = self.cfg.min_prefill_bucket << octave
        quarters = {1: (4,), 2: (4, 6), 4: (4, 5, 6, 7)}[
            self.cfg.prefill_bucket_rungs]
        return sorted({min(S * q // 4, self.cfg.max_seq_len)
                       for q in quarters})

    def _warm_prefill_shapes(self, S: int) -> None:
        """Run the bucketed prefill's program for every power-of-two
        group size at prompt bucket S with all-zero lengths (the
        reference's): every row is padding, so its K/V go to the dump
        page; the call exists to capture the shape."""
        V = self.model_cfg.vocab_size
        P = self.cfg.max_pages_per_seq
        dev = self.device
        G2 = 1
        while G2 <= self.cfg.max_batch_size:
            z32 = torch.zeros((G2,), dtype=torch.int32, device=dev)
            self._prefill_step(self.fns.prefill, (
                torch.zeros((G2, S), dtype=torch.int32, device=dev), z32,
                torch.zeros((G2, P), dtype=torch.int32, device=dev)), (
                torch.zeros((G2, 2), dtype=torch.int64, device=dev),
                torch.zeros((G2,), dtype=torch.float32, device=dev),
                torch.ones((G2,), dtype=torch.float32, device=dev), z32,
                torch.zeros((G2, V), dtype=torch.float32, device=dev),
                torch.full((G2,), self._base_row, dtype=torch.int32,
                           device=dev)))
            G2 *= 2

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, name="tpuserve-engine", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop the loop; pending requests finish with "error"."""
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
        self._abort_all("engine stopped")

    def submit(self, req: GenRequest) -> None:
        if len(req.prompt) + req.max_tokens > self.cfg.max_seq_len:
            raise ValueError(
                f"prompt+max_tokens {len(req.prompt)}+{req.max_tokens} "
                f"exceeds max_seq_len {self.cfg.max_seq_len}")
        if req.priority == "batch":
            # the offline class never sheds: it queues without bound
            # (the /v1/batches runner bounds its lines in flight)
            self._batch_q.put(req)
            self._wake.set()
            return
        if self._queue.qsize() >= self.cfg.max_queued_requests:
            raise EngineOverloadedError(
                f"queue full ({self.cfg.max_queued_requests} waiting)")
        self._queue.put(req)
        self._wake.set()

    # -- KV mobility: the page movers -----------------------------------------
    def _page_index(self, pages: list[int]) -> torch.Tensor:
        return torch.tensor(pages, dtype=torch.int64, device=self.device)

    def _export_page_dev(self, page: int) -> Any:
        """One page's rows of every layer, copied on the device in the
        pool's layout (``[L, 2, page_size, ...]`` per leaf)."""
        st = kvq.gather_pages(self.kv_cache, self._page_index([page]),
                              self.cfg.page_size)
        if isinstance(st, dict):
            return {k: v[0] for k, v in st.items()}
        return st[0]

    def _export_pages(self, pages: list[int]) -> list:
        """Host pages of ``pages`` (``kvq``'s host page): one gather on
        the device and one copy to the host. The copy waits for every
        launch queued before it on the engine's stream, a decode window
        in flight included, so the rows are the pages' settled content."""
        if not pages:
            return []
        stacked = kvq.gather_pages(self.kv_cache, self._page_index(pages),
                                   self.cfg.page_size)
        return kvq.pages_to_host(stacked, self.cfg.kv_cache_dtype)

    def _import_pages_dev(self, page_ids: list[int], rows: list) -> None:
        """Scatter host pages into ``page_ids`` in one index copy per
        leaf: exactly k pages (the reference pads k to a power of two
        only to bound its compiled programs)."""
        if not page_ids:
            return
        stacked = kvq.host_to_stacked(rows, self.cfg.kv_cache_dtype,
                                      self.device)
        self.kv_cache = kvq.scatter_pages(
            self.kv_cache, self._page_index(page_ids), stacked,
            self.cfg.page_size)

    # -- KV mobility: the host spill tier and the chain digest ---------------
    def _spill_page(self, key: bytes, page: int) -> None:
        """The prefix cache's spill sink: copy the page being reclaimed
        to the host and park it in the tier under its chain key. It runs
        inside the allocator's _pop_page on the engine thread, so the
        page reaches its new owner only after the copy has landed; the
        copy waits for the stream (a window in flight included), and
        that wait is the spill's stall (``kv_spill_ms``)."""
        t0 = time.monotonic()
        self.host_tier.put(key, self._export_pages([page])[0])
        self.stats.kv_spill_ms += 1e3 * (time.monotonic() - t0)

    def _revive_chain(self, chain_keys: list) -> int:
        """Promote the longest spilled run extending the resident prefix
        back into the pool: allocate pages, scatter the host rows, and
        register them in the prefix cache, parked evictable (the caller's
        probe adopts them). Returns the pages revived; 0 under page
        pressure (the rows go back to the tier)."""
        tier = self.host_tier
        resident = len(self.prefix_cache.probe(chain_keys))
        take: list = []
        while (resident + len(take) < len(chain_keys)
               and tier.contains(chain_keys[resident + len(take)])):
            take.append(chain_keys[resident + len(take)])
        if not take:
            return 0
        # out of the tier first: a spill during the allocation below
        # cannot drop the rows mid-revive
        rows = []
        for k in take:
            r = tier.take(k)
            if r is None:
                break
            rows.append(r)
        take = take[:len(rows)]
        if not rows:
            return 0
        seq_id = next(self._seq_ids)
        try:
            self.allocator.allocate_extra(seq_id, len(rows))
        except OutOfPagesError:
            self.allocator.free(seq_id)
            for k, r in zip(take, rows):
                tier.put(k, r)
            return 0
        t0 = time.monotonic()
        page_ids = self.allocator.pages(seq_id)
        self._import_pages_dev(page_ids, rows)
        self.stats.kv_import_ms += 1e3 * (time.monotonic() - t0)
        self.prefix_cache.insert(take, page_ids)
        self.allocator.free(seq_id)
        logger.debug("revived %d spilled pages", len(rows))
        return len(rows)

    def _purge_spilled(self, keys: list) -> None:
        """Strict tiering: a chain a prefill just made resident must not
        also hold host budget."""
        if self.host_tier is not None:
            for k in keys:
                self.host_tier.discard(k)

    #: the digest's floor: a replica always advertises this many keys
    KV_DIGEST_MAX = 4096
    #: full-length chains the digest bound leaves room for
    KV_DIGEST_MIN_CHAINS = 8

    def kv_chain_digest(self) -> tuple:
        """Hex chain keys this replica can serve pages for (resident
        prefix-cache entries, then spilled pages): ``/state``'s
        ``kv_chains`` and the fleet fetch's local presence probe. A
        lock-free read of the tuple the engine thread rebuilds."""
        return self._kv_digest

    def kv_digest_max(self) -> int:
        """The digest bound: ``max(KV_DIGEST_MAX, KV_DIGEST_MIN_CHAINS x
        max_pages_per_seq)`` (keys are per page, so long chains need
        room)."""
        return max(self.KV_DIGEST_MAX,
                   self.KV_DIGEST_MIN_CHAINS * self.cfg.max_pages_per_seq)

    def _refresh_kv_digest(self) -> None:
        """Rebuild the digest on the engine thread, the only thread that
        changes the cache's keys and the tier's."""
        if self.prefix_cache is None:
            return
        keys = list(self.prefix_cache._by_key.keys())
        if self.host_tier is not None:
            keys.extend(self.host_tier.keys())
        out: list[str] = []
        seen: set = set()
        bound = self.kv_digest_max()
        for k in keys:
            if k not in seen:
                seen.add(k)
                out.append(k.hex())
                if len(out) >= bound:
                    break
        self._kv_digest = tuple(out)

    # -- KV mobility: jobs from server threads --------------------------------
    def _post_job(self, kind: str, payload: Any, timeout: float,
                  what: str) -> Any:
        """Queue a job for the engine thread and wait for its result;
        raises MigrationError (its error) or TimeoutError."""
        box: dict = {"evt": threading.Event()}
        self._mig_q.put((kind, payload, box))
        self._wake.set()
        if not box["evt"].wait(timeout):
            raise TimeoutError(f"{what} timed out")
        if "error" in box:
            raise MigrationError(box["error"])
        return box["result"]

    def kv_export_pages(self, keys: list, timeout: float = 30.0) -> list:
        """Pages by chain key for a sibling's fetch (``/kv/pages``):
        resident pages pinned and copied off the device, spilled pages
        from the host tier. Returns [(key, host page)] for the keys held;
        the others are absent."""
        return self._post_job("fetch", keys, timeout, "kv page fetch")

    def kv_import_pages(self, tokens: list[int], pages: list,
                        start: int = 0, timeout: float = 30.0) -> int:
        """Adopt pages fetched from a sibling: chain depths ``[start,
        start + len(pages))`` of ``tokens``, registered as cached pages
        (the migration import's lifecycle, counted as fetches)."""
        return self._post_job("import", (tokens, pages, start, "fetch"),
                              timeout, "kv page import")

    def migrate_export(self, req: GenRequest, timeout: float = 30.0) -> dict:
        """Cut a live session at its next token boundary and serialize it
        for another replica: its full pages (host pages), their chain
        keys and the slot's sampling, penalty and key state. Returns
        {"blob": JSON-able dict, "data": [host pages]}; raises
        MigrationError (the session untouched) or TimeoutError."""
        return self._post_job("export", req, timeout, "migration export")

    def migrate_import(self, tokens: list[int], pages: list,
                       timeout: float = 30.0) -> int:
        """Adopt another replica's exported chain: scatter the pages into
        this pool and register them in the prefix cache, parked evictable
        until the continuation adopts them. Returns the pages imported.
        Page pressure surfaces as MigrationError("OutOfPagesError: ...")."""
        return self._post_job("import", (tokens, pages, 0, "migration"),
                              timeout, "migration import")

    @property
    def migratable(self) -> bool:
        """Whether this engine serves /migrate/* (the refcounted
        prefix-cache allocator): /state's ``migration`` flag."""
        return isinstance(self.allocator, RefcountedAllocator)

    def _process_migrations(self) -> None:
        """Run the queued jobs on the engine thread; an error goes to the
        waiting caller, never into the engine loop."""
        while True:
            try:
                kind, payload, box = self._mig_q.get_nowait()
            except queue.Empty:
                return
            try:
                if kind == "export":
                    box["result"] = self._do_export(payload)
                elif kind == "fetch":
                    box["result"] = self._do_fetch(payload)
                else:
                    box["result"] = self._do_import(*payload)
            except Exception as e:  # noqa: BLE001 — relayed to the caller
                box["error"] = f"{type(e).__name__}: {e}"
            finally:
                box["evt"].set()

    def _do_fetch(self, keys: list) -> list:
        if self.prefix_cache is None:
            return []
        out: list = []
        resident: list = []
        for k in keys:
            page = self.prefix_cache._by_key.get(k)
            if page is not None:
                resident.append((k, page))
            elif self.host_tier is not None:
                rows = self.host_tier.get(k)  # a peek: the rung stays
                if rows is not None:
                    out.append((k, rows))
        if resident:
            # pinned while the rows are copied off the device, as an
            # export's pages are
            t0 = time.monotonic()
            pin = self.allocator.begin_export([p for _, p in resident])
            try:
                host = self._export_pages([p for _, p in resident])
            finally:
                self.allocator.end_export(pin)
            out.extend((k, h) for (k, _p), h in zip(resident, host))
            self.stats.kv_export_ms += 1e3 * (time.monotonic() - t0)
        if out:
            self.stats.kv_fetches_out += 1
            self.stats.kv_fetch_pages_out += len(out)
        return out

    def _do_export(self, req: GenRequest) -> dict:
        """The engine-thread half of migrate_export. Only complete pages,
        every row written, travel: k = (m - 1) // page_size for m tokens
        (the last token's K/V is the pending decode input, not written
        yet); the importer recomputes the tail of at most one page with
        its offset resume."""
        if not isinstance(self.allocator, RefcountedAllocator):
            raise MigrationError(
                "migration requires the prefix cache "
                "(refcounted page allocator)")
        if req.emit_lp is not None:
            raise MigrationError("logprobs sessions are not migratable")
        if req.constraint is not None:
            raise MigrationError(
                "grammar-constrained sessions are not migratable")
        idx = next((i for i, s in enumerate(self._slots)
                    if s is not None and s.req is req), None)
        if idx is None:
            raise MigrationError(
                "request is not active (finished, cancelled, or not "
                "yet admitted)")
        # settle the window in flight: it may still write this sequence's
        # pages, and its tokens land before the cut
        self._drain_inflight()
        self._apply_frees()
        s = self._slots[idx]
        if s is None or s.req is not req:
            raise MigrationError("request finished during the export cut")
        if s.generated < 1:
            raise MigrationError("prefill not finished (no token yet)")
        if req.trace is not None:
            req.trace.engine_finish("migrated")
        out = self._export_cut(idx)
        req.emit(-1, "migrated")
        self.stats.migrations_out += 1
        self.stats.migration_pages_out += len(out["data"])
        logger.info("exported seq %d: %d tokens, %d pages", req.id,
                    len(out["blob"]["tokens"]), len(out["data"]))
        return out

    def _export_cut(self, idx: int) -> dict:
        """Serialize slot ``idx``'s session at the settled token boundary
        and free the slot: the cut behind a migration export and a batch
        park. The caller owns the emit, the trace and the counters.
        Returns {"blob": JSON-able dict, "data": [host pages]}."""
        s = self._slots[idx]
        req = s.req
        ps = self.cfg.page_size
        tokens = list(req.prompt) + list(s.gen_tokens)
        m = len(tokens)
        k = (m - 1) // ps
        pages = self.allocator.pages(req.id)[:k]
        t0 = time.monotonic()
        # pinned for the copy: nothing may free, evict or copy-on-write
        # them meanwhile
        pin = self.allocator.begin_export(pages)
        try:
            data = self._export_pages(pages)
        finally:
            self.allocator.end_export(pin)
        self.stats.kv_export_ms += 1e3 * (time.monotonic() - t0)
        ims = req.import_state or {}
        sp = req.sampling
        blob = {
            "tokens": tokens,
            "page_size": ps,
            "chain": [h.hex() for h in page_chain_hashes(tokens, ps)[:k]],
            "kv_dtype": self.cfg.kv_cache_dtype,
            "orig_prompt_len": ims.get("orig_prompt_len", len(req.prompt)),
            "generated": ims.get("generated", 0) + s.generated,
            "max_tokens": req.max_tokens - s.generated,
            "key_seed": s.key_seed,
            "adapter": req.adapter,
            "tenant": req.tenant,
            "priority": req.priority,
            "stop_token_ids": list(req.stop_token_ids),
            "sampling": {
                "temperature": sp.temperature, "top_p": sp.top_p,
                "top_k": sp.top_k, "seed": sp.seed,
                "frequency_penalty": sp.frequency_penalty,
                "presence_penalty": sp.presence_penalty,
                "logit_bias": [[t, b] for t, b in sp.logit_bias],
            },
            # the cut emits no MeterRecord: this carry rides to the
            # resume, whose terminal record covers the whole session
            "meter": self._meter_fold(s),
        }
        self._pending_frees.append(req.id)
        self._release_adapter_row(s.adapter_row)
        self._slots[idx] = None
        self._dirty_rows.add(idx)
        self._wake.set()
        return {"blob": blob, "data": data}

    def _do_import(self, tokens: list[int], pages_data: list,
                   start: int = 0, source: str = "migration") -> int:
        """The engine-thread half of migrate_import and kv_import_pages:
        allocate pages, scatter the rows, register the chain in the
        prefix cache and release the pages, which park evictable until
        an admission adopts them. ``start`` is the chain depth the pages
        land at (a fetch extends a resident prefix); ``source`` picks the
        counters (migration, fetch, or parked: a batch resume)."""
        if self.prefix_cache is None:
            raise MigrationError(
                "migration import requires the prefix cache")
        ps = self.cfg.page_size
        k = len(pages_data)
        if k == 0:
            return 0
        if start < 0 or start + k > (len(tokens) - 1) // ps:
            raise MigrationError(
                f"pages [{start}, {start + k}) exceed the written-KV "
                f"coverage of {len(tokens)} tokens")
        mc = self.model_cfg
        want = (mc.n_layers, 2, ps, mc.n_kv_heads, mc.head_dim)
        for rows in pages_data:
            if not kvq.page_matches_dtype(rows, self.cfg.kv_cache_dtype):
                raise MigrationError(
                    "page dtype does not match this engine's "
                    f"kv_cache_dtype={self.cfg.kv_cache_dtype!r} "
                    "(quantized pages only scatter into a matching "
                    "quantized pool)")
            if not kvq.page_shape_ok(rows, want):
                raise MigrationError(
                    f"page shape != expected {want} "
                    "(mismatched model or page size)")
        keys = page_chain_hashes(tokens, ps)[start:start + k]
        seq_id = next(self._seq_ids)
        self.allocator.allocate_extra(seq_id, k)  # OutOfPages → caller
        t0 = time.monotonic()
        page_ids = self.allocator.pages(seq_id)
        self._import_pages_dev(page_ids, pages_data)
        self.stats.kv_import_ms += 1e3 * (time.monotonic() - t0)
        self.prefix_cache.insert(keys, page_ids)
        self._purge_spilled(keys)
        # registered pages park evictable; those whose key was already
        # cached here were skipped by insert and go back to the free stack
        self.allocator.free(seq_id)
        if source == "fetch":
            self.stats.kv_fetches_in += 1
            self.stats.kv_fetch_pages_in += k
        elif source == "migration":
            self.stats.migrations_in += 1
            self.stats.migration_pages_in += k
        logger.info("imported %d pages for a %d-token chain (%s)", k,
                    len(tokens), source)
        return k

    # -- the offline batch class ----------------------------------------------
    def _batch_ceiling(self) -> int:
        """The most decode slots the batch class may hold at once."""
        return max(1, int(self.cfg.batch_slot_frac
                          * self.cfg.max_batch_size))

    def _batch_active(self) -> int:
        return sum(1 for s in self._slots
                   if s is not None and s.req.priority == "batch")

    def _park_batch_slot(self, idx: int) -> bool:
        """The second preemption rung: cut a live batch slot off the
        device through the export and keep it host-side (pages, blob and
        the still-attached consumer) until interactive stops wanting the
        slot. True when the slot is free afterwards; False when the
        session cannot park (no token yet, logprobs, a grammar, or no
        refcounted allocator): try another victim."""
        s = self._slots[idx]
        if s is None:
            return True
        req = s.req
        if (not isinstance(self.allocator, RefcountedAllocator)
                or req.emit_lp is not None or req.constraint is not None
                or s.generated < 1):
            return False
        self._drain_inflight()
        self._apply_frees()
        s = self._slots[idx]
        if s is None or s.req is not req:
            return True  # finished while the window settled
        if req.trace is not None:
            req.trace.engine_finish("parked")
        entry = self._export_cut(idx)
        entry["emit"] = req.emit
        entry["cancelled"] = req.cancelled
        # while parked the pages live in host memory: host page-byte-
        # seconds, folded into the carry at resume
        entry["meter_sink"] = req.meter_sink
        entry["parked_at"] = time.monotonic()
        entry["park_bytes"] = len(entry["data"]) * self.kv_page_bytes
        self._parked_batch.append(entry)
        self.stats.batch_preemptions += 1
        logger.info("parked batch seq %d (%d pages) for interactive "
                    "admission", req.id, len(entry["data"]))
        return True

    def _preempt_batch(self) -> bool:
        """Park live batch slots so waiting interactive requests admit (at
        most one per waiting request); True when a slot freed."""
        want = self._queue.qsize()
        if want <= 0:
            return False
        freed = 0
        for i, s in enumerate(self._slots):
            if freed >= want:
                break
            if (s is not None and s.req.priority == "batch"
                    and self._park_batch_slot(i)):
                freed += 1
        return freed > 0

    def _admit_batch_tier(self) -> bool:
        """Admit offline work into slots interactive leaves idle: after
        the interactive pass, only while the interactive queue is empty,
        never past the batch ceiling. Parked sessions resume first,
        oldest first: their pages go back into the pool through the
        import, and the continuation adopts them and resumes at its
        offset, byte-identical to an uninterrupted run. Queued batch
        requests go through the fairness guard, per request."""
        admitted = False
        while True:
            if self._queue.qsize() > 0:
                break  # interactive wants the slots
            room = min(self._free_slot_count(),
                       self._batch_ceiling() - self._batch_active())
            if room <= 0:
                break
            if self._parked_batch:
                park = self._parked_batch[0]
                if park["cancelled"].is_set():
                    # a cancel finish: its consumer is still waiting
                    self._meter_parked(park, "cancelled")
                    park["emit"](-1, "cancelled")
                    self._parked_batch.pop(0)
                    continue
                try:
                    self._do_import(
                        [int(t) for t in park["blob"]["tokens"]],
                        park["data"], 0, "parked")
                except (MigrationError, OutOfPagesError):
                    break  # page pressure: a later pass retries
                carry = park["blob"].get("meter")
                if carry is not None:
                    # close the parked dwell into the carry, and re-anchor
                    # it in case this entry parks again below
                    now = time.monotonic()
                    carry["host_page_byte_s"] = round(
                        float(carry.get("host_page_byte_s", 0.0))
                        + (now - park.get("parked_at", now))
                        * park.get("park_bytes", 0), 6)
                    park["parked_at"] = now
                req = continuation_request(park["blob"], emit=park["emit"])
                req.cancelled = park["cancelled"]
                req.meter_sink = park.get("meter_sink")
                self._parked_batch.pop(0)
                _ok, chain = self._classify(req)
                r = self._admit_one(req, chain)
                if r == "admitted":
                    admitted = True
                    self.stats.batch_resumed += 1
                elif r == "stop":
                    # page pressure mid-admission: the imported pages stay
                    # cached; park again and retry later
                    self._parked_batch.insert(0, park)
                    break
                elif r == "stop_consumed":
                    break
                continue
            pending: list[GenRequest] = []
            try:
                while len(pending) < room:
                    pending.append(self._batch_q.get_nowait())
            except queue.Empty:
                pass
            if not pending:
                break
            admit, requeue, capped = self._fair_admission(pending, room)
            self.stats.tenant_deferrals += capped
            stop = False
            unhandled: list[GenRequest] = []
            for j, req in enumerate(admit):
                if req.cancelled.is_set():
                    self._meter_zero(req, "cancelled")
                    req.emit(-1, "cancelled")
                    continue
                _ok, chain = self._classify(req)
                r = self._admit_one(req, chain)
                if r == "admitted":
                    admitted = True
                elif r in ("stop", "stop_consumed"):
                    if r == "stop":
                        unhandled.append(req)
                    unhandled.extend(admit[j + 1:])
                    stop = True
                    break
            if unhandled or requeue:
                self._requeue_batch_front(unhandled + requeue)
            if stop or requeue:
                break
        return admitted

    def _requeue_batch_front(self, reqs: list[GenRequest]) -> None:
        items = list(reqs)
        try:
            while True:
                items.append(self._batch_q.get_nowait())
        except queue.Empty:
            pass
        for it in items:
            self._batch_q.put(it)

    # -- engine loop --------------------------------------------------------
    def _run(self) -> None:
        logger.info("engine loop started (batch=%d, pages=%d×%d, %s)",
                    self.cfg.max_batch_size, self.cfg.num_pages,
                    self.cfg.page_size, self.device)
        while not self._stop.is_set():
            try:
                self._reap_cancelled()
                self._process_migrations()
                admitted = self._admit()
                # the offline class soaks what interactive left idle
                admitted |= self._admit_batch_tier()
                worked = self._decode_tick()
                if self._stop.is_set():
                    self._drain_inflight()
                    self._apply_frees()
            except Exception as e:  # fail loudly, error every request
                logger.exception("engine tick failed")
                self.healthy = False
                self.last_error = f"{type(e).__name__}: {e}"
                self._abort_all(str(e))
                return
            if not admitted and not worked:
                self._wake.wait(timeout=0.05)
                self._wake.clear()
        self._drain_inflight()
        self._apply_frees()
        logger.info("engine loop stopped")

    def _abort_all(self, reason: str) -> None:
        if self._inflight is not None:
            self._pending_frees.extend(self._inflight.frees)
            self._inflight = None
        self._apply_frees()
        self._device_state = None
        self._need_rebuild = False
        self._dirty_rows.clear()
        self._spec_dirty.clear()
        self._cn_dirty.clear()
        for i, s in enumerate(self._slots):
            if s is not None:
                self._meter_finish(s, "error")
                s.req.emit(-1, "error")
                self.allocator.free(s.req.id)
                self._release_adapter_row(s.adapter_row)
                self._slots[i] = None
        for q in (self._queue, self._batch_q):
            try:
                while True:
                    req = q.get_nowait()
                    self._meter_zero(req, "error")
                    req.emit(-1, "error")
            except queue.Empty:
                pass
        for park in self._parked_batch:
            self._meter_parked(park, "error")
            park["emit"](-1, "error")
        self._parked_batch.clear()
        # waiting export/import callers must not hang until their timeout
        try:
            while True:
                _kind, _payload, box = self._mig_q.get_nowait()
                box["error"] = f"engine aborted: {reason}"
                box["evt"].set()
        except queue.Empty:
            pass

    def _reap_cancelled(self) -> None:
        for i, s in enumerate(self._slots):
            if s is not None and s.req.cancelled.is_set():
                if s.req.trace is not None:
                    s.req.trace.engine_finish("cancel")
                self._meter_finish(s, "cancelled")
                s.req.emit(-1, "cancelled")
                self._pending_frees.append(s.req.id)
                self._release_adapter_row(s.adapter_row)
                self._slots[i] = None
                self._dirty_rows.add(i)

    def _free_slot_count(self) -> int:
        return sum(1 for s in self._slots if s is None)

    def _requeue_front(self, reqs: list[GenRequest]) -> None:
        items = list(reqs)
        try:
            while True:
                items.append(self._queue.get_nowait())
        except queue.Empty:
            pass
        for it in items:
            self._queue.put(it)

    def _pop_pending(self, pending: list[GenRequest], free: int) -> None:
        try:
            while len(pending) < free:
                pending.append(self._queue.get_nowait())
        except queue.Empty:
            pass

    # -- tenant fairness ----------------------------------------------------
    def _tenant_slots(self) -> dict[str, int]:
        counts: dict[str, int] = {}
        for s in self._slots:
            if s is not None:
                t = s.req.tenant
                counts[t] = counts.get(t, 0) + 1
        return counts

    def _fair_admission(self, pending: list[GenRequest], free: int
                        ) -> tuple[list[GenRequest], list[GenRequest], int]:
        """(admit_now, requeue, n_capped): the reference's fairness guard
        over one admission pass. Requests whose tenant already holds (or
        would reach) ``tenant_slot_cap`` slots are deferred; the rest are
        deficit-ordered (fewer live slots first, arrival order within a
        tenant) by a heap keyed (live-slot count, head arrival index),
        which gives the order of the reference's quadratic scan. The
        requeue keeps arrival order. Single-tenant traffic with nothing
        live passes through untouched."""
        cap = self.cfg.tenant_slot_cap
        live = self._tenant_slots()
        if cap <= 0 and len({r.tenant for r in pending} | set(live)) <= 1:
            return pending[:free], pending[free:], 0
        taken: dict[str, int] = {}
        eligible: list[GenRequest] = []
        capped: list[GenRequest] = []
        for req in pending:
            t = req.tenant
            if cap > 0 and live.get(t, 0) + taken.get(t, 0) >= cap:
                capped.append(req)
                continue
            taken[t] = taken.get(t, 0) + 1
            eligible.append(req)
        if len({r.tenant for r in eligible}) > 1:
            fifos: dict[str, list[tuple[int, GenRequest]]] = {}
            for j, req in enumerate(eligible):
                fifos.setdefault(req.tenant, []).append((j, req))
            heap = [(live.get(t, 0), lst[0][0], t)
                    for t, lst in fifos.items()]
            heapq.heapify(heap)
            heads = dict.fromkeys(fifos, 0)
            ordered: list[GenRequest] = []
            while heap:
                cnt, _, t = heapq.heappop(heap)
                lst, h = fifos[t], heads[t]
                ordered.append(lst[h][1])
                heads[t] = h + 1
                if h + 1 < len(lst):
                    heapq.heappush(heap, (cnt + 1, lst[h + 1][0], t))
            eligible = ordered
        admit = eligible[:free]
        left = set(map(id, capped)) | set(map(id, eligible[free:]))
        requeue = [r for r in pending if id(r) in left]  # arrival order
        return admit, requeue, len(capped)

    def _admit(self) -> bool:
        """Admit queued requests: the fairness guard picks and orders
        each pass's requests, each is classified once (its chain keys
        reused up to the cache insert), then contiguous runs of two or
        more simple requests go through the batched prefill and every
        other request through ``_admit_one``, so pages are allocated in
        the order of admission."""
        admitted = False
        while True:
            free = self._free_slot_count()
            if free == 0:
                # interactive arrivals on a full table reclaim slots from
                # the batch class: its sessions park host-side
                if not self._preempt_batch():
                    break
                free = self._free_slot_count()
                if free == 0:
                    break
            pending: list[GenRequest] = []
            self._pop_pending(pending, free)
            if not pending:
                break
            if (self.cfg.admission_coalesce_ms > 0 and len(pending) < free
                    and self._inflight is None
                    and all(s is None for s in self._slots)):
                # idle engine, partial burst: wait once for the rest of
                # it; a lone arrival only probes 1 ms for a second one
                wait_ms = self.cfg.admission_coalesce_ms
                if self.cfg.first_token_fast_path and len(pending) == 1:
                    probe = min(1.0, wait_ms)
                    time.sleep(probe / 1e3)
                    self._pop_pending(pending, free)
                    wait_ms = (0.0 if len(pending) == 1
                               else max(0.0, wait_ms - probe))
                if wait_ms > 0 and len(pending) < free:
                    time.sleep(wait_ms / 1e3)
                    self._pop_pending(pending, free)
            # the fairness guard; when the cap left slots unused, the
            # scan extends over the rest of the queue so deferred heads
            # do not occlude admissible tenants behind them
            admit, fair_requeue, capped = self._fair_admission(pending,
                                                               free)
            if fair_requeue and len(admit) < free:
                more: list[GenRequest] = []
                try:
                    while True:
                        more.append(self._queue.get_nowait())
                except queue.Empty:
                    pass
                if more:
                    admit, fair_requeue, capped = self._fair_admission(
                        pending + more, free)
            self.stats.tenant_deferrals += capped
            pending = admit
            if not pending:
                # everything at cap: back to the queue head, arrival
                # order kept, until a tenant frees a slot
                self._requeue_front(fair_requeue)
                break
            # one admission burst id per pass: the traces show which
            # requests shared a packed prefill
            self._cur_burst = (next(self._burst_seq), len(pending))
            items: list[tuple[GenRequest, bool, list]] = []
            seen_chain_heads: set = set()
            for req in pending:
                if req.cancelled.is_set():
                    # consumed without a slot: still one (zero) record
                    self._meter_zero(req, "cancelled")
                    continue
                if not req.prompt:
                    self._meter_zero(req, "error")
                    req.emit(-1, "error")
                    continue
                ok, chain = self._classify(req)
                if ok and chain:
                    # a batch-mate sharing the first prompt page would
                    # prefill the shared prefix twice: the per-request
                    # path adopts the pages the batch inserts instead
                    if chain[0] in seen_chain_heads:
                        ok = False
                    else:
                        seen_chain_heads.add(chain[0])
                items.append((req, ok, chain))
            stop = False
            unhandled: list[GenRequest] = []
            i = 0
            while i < len(items):
                req, simple, chain = items[i]
                if simple:
                    j = i
                    while j < len(items) and items[j][1]:
                        j += 1
                    if j - i >= 2:
                        run = items[i:j]
                        done, leftover = self._admit_batch(
                            [it[0] for it in run],
                            {id(it[0]): it[2] for it in run})
                        admitted |= done > 0
                        if leftover is not None:  # page pressure
                            unhandled.extend(leftover)
                            unhandled.extend(it[0] for it in items[j:])
                            stop = True
                            break
                        i = j
                        continue
                r = self._admit_one(req, chain)
                if r == "admitted":
                    admitted = True
                elif r in ("stop", "stop_consumed"):
                    if r == "stop":
                        unhandled.append(req)
                    unhandled.extend(it[0] for it in items[i + 1:])
                    stop = True
                    break
                i += 1
            if unhandled or fair_requeue:
                # page-pressure leftovers first (they were at the head),
                # then the fairness deferrals
                self._requeue_front(unhandled + fair_requeue)
            if stop or fair_requeue:
                # a deferral ends the pass: looping would pop the
                # deferred head again until a slot frees
                break
        return admitted

    def _classify(self, req: GenRequest) -> tuple[bool, list]:
        """(simple, chain keys): simple = eligible for the batched
        prefill (no cached prefix to adopt, no longer than
        ``prefill_chunk_tokens`` unless the backend packs long prompts
        itself). The chain keys are hashed once here; the cheap probe is
        redone at adoption (cache state moves within a pass)."""
        n = len(req.prompt)
        chain: list = []
        if self.prefix_cache is not None and n > 1:
            chain = self.prefix_cache.chain_keys(req.prompt)
            hits = len(self.prefix_cache.probe(chain))
            if min(hits, n // self.cfg.page_size) > 0:
                return False, chain
            if (self.host_tier is not None and hits < len(chain)
                    and self.host_tier.contains(chain[hits])):
                # the chain goes on in the spill tier: the per-request
                # path revives it and resumes
                return False, chain
        chunk = self.cfg.prefill_chunk_tokens
        if (not self.attn.packs_long_prompts and chunk > 0
                and self.fns.prefill_suffix is not None and n > chunk):
            # the chunk loop runs on the per-request path
            return False, chain
        if req.adapter and not self._adapter_known(req.adapter):
            return False, chain  # the per-request path reports the error
        if req.constraint is not None:
            # the grammar's initial mask goes into the prefill's bias
            # row: the per-request path builds it
            return False, chain
        if req.import_state is not None:
            # a continuation's key and penalty state is threaded only by
            # the per-request path
            return False, chain
        return True, chain

    def _admit_batch(self, reqs: list[GenRequest], chain_by_req: dict
                     ) -> tuple[int, list[GenRequest] | None]:
        """Allocate and batch-prefill ``reqs`` (all simple). Returns
        (admitted count, leftover): leftover is None without page
        pressure, else the unallocated tail for the caller to requeue."""
        prepared: list[tuple[GenRequest, int, int, int]] = []
        leftover: list[GenRequest] | None = None
        for i, req in enumerate(reqs):
            n = len(req.prompt)
            total = min(n + req.max_tokens, self.cfg.max_seq_len)
            seq_id = next(self._seq_ids)
            try:
                self.allocator.allocate(seq_id, total)
            except OutOfPagesError:
                self.allocator.free(seq_id)
                leftover = reqs[i:]
                break
            if req.adapter:
                # pin (and load, when not resident) the row before the
                # prefill builds its sampling rows; the pin passes to the
                # slot. Every row pinned waits like page pressure
                # (classify already checked the name)
                try:
                    self._acquire_adapter(req.adapter)
                except AdapterCapacityError:
                    self.allocator.free(seq_id)
                    leftover = reqs[i:]
                    break
            req.id = seq_id
            prepared.append((req, seq_id, n, total))
        if not prepared:
            return 0, leftover
        results = self.attn.group_prefill(prepared, chain_by_req)
        t_first = time.monotonic()
        for r in results:
            chain = chain_by_req.get(id(r.req), [])
            if self.prefix_cache is not None and chain:
                # the batched path = classified with no reusable prefix
                self.stats.prefix_cache_misses += 1
                self.prefix_cache.insert(
                    chain, self.allocator.pages(r.seq_id),
                    tokens=r.req.prompt)
                self._purge_spilled(chain)
            slot_idx = self._slots.index(None)
            self._slots[slot_idx] = _Slot(
                req=r.req, pos=r.n - 1, generated=0,
                key_seed=r.req.sampling.seed or r.seq_id,
                limit=r.total, page_row=r.page_row,
                adapter_row=r.adapter_row, ctrl=self._make_ctrl(r.req),
                # metering, as the reference's batched path: the real
                # prompt volume (its padding shows in the aggregate
                # prefill_tokens_* pair), and the residency clock
                m_prefill_real=r.n, m_prefill_padded=r.n,
                m_res_t0=time.monotonic())
            self.stats.prefills += 1
            self._mark_admitted(slot_idx)
            t_m = time.monotonic()
            self._emit_token(slot_idx, r.tok, r.first_lp)
            self.phases.observe("first_emit", 1e3 * (time.monotonic() - t_m),
                                trace_id_of(r.req))
        self.stats.first_emit_ms += 1e3 * (time.monotonic() - t_first)
        return len(results), leftover

    def _pow2_pages(self, need: int) -> int:
        """Smallest power-of-two page count covering ``need`` pages,
        capped at ``max_pages_per_seq`` (a page-window bucket)."""
        bucket = 1
        while bucket < need:
            bucket *= 2
        return min(bucket, self.cfg.max_pages_per_seq)

    def _decode_bucket_pages(self) -> int:
        """The page bucket covering every live slot's limit (the
        reference's decode page bucket)."""
        need = 1
        for s in self._slots:
            if s is not None:
                need = max(need, -(-s.limit // self.cfg.page_size))
        return self._pow2_pages(need)

    def _prefill_bucket(self, n: int) -> int:
        """Smallest prefill-ladder rung covering ``n`` prompt tokens:
        powers of two of ``min_prefill_bucket`` plus, with
        ``prefill_bucket_rungs`` > 1, the rungs at 1.5x S (and 1.25x /
        1.75x S at 4), capped at ``max_seq_len``. (The reference's
        ``multiple_of`` mesh guard waits with the sequence-parallel
        prefill, ROADMAP queue 1 item 7.)"""
        cfg = self.cfg
        S = cfg.min_prefill_bucket
        while S < n:
            if cfg.prefill_bucket_rungs >= 4 and n <= S + S // 4:
                S += S // 4
                break
            if cfg.prefill_bucket_rungs >= 2 and n <= S + S // 2:
                S += S // 2
                break
            if cfg.prefill_bucket_rungs >= 4 and n <= S + 3 * S // 4:
                S += 3 * S // 4
                break
            S *= 2
        return min(S, cfg.max_seq_len)

    def _mark_admitted(self, i: int) -> None:
        """Slot i's whole row is uploaded before the next dispatch (its
        draft length included); a page bucket that must grow rebuilds
        the state instead."""
        self._dirty_rows.add(i)
        if (self._device_state is not None
                and self._decode_bucket_pages() > self._state_bucket):
            self._need_rebuild = True
        self._spec_dirty.discard(i)
        self._cn_dirty.discard(i)  # the row carries the mask too

    def _admit_one(self, req: GenRequest, chain: list) -> str:
        """Per-request admission with prefix-cache adoption. Returns
        "admitted", "skipped" (consumed without a slot), "stop" (page
        pressure or the engine stopping: the caller requeues the request
        and stops admitting) or "stop_consumed" (stop admitting, the
        request needs no requeue)."""
        n = len(req.prompt)
        total = min(n + req.max_tokens, self.cfg.max_seq_len)
        seq_id = next(self._seq_ids)
        ps = self.cfg.page_size
        # adopt the longest cached page-prefix. A full hit (every page of
        # a page-aligned prompt cached) adopts them all, copies the last
        # one into a private page and re-runs only the last prompt token:
        # its forward pass gives the first token's logits, and its
        # recomputed K/V lands in the private copy, never the shared page
        cached_pages: list[int] = []
        full_hit = False
        if self.prefix_cache is not None and chain:
            if self.host_tier is not None:
                # promote a spilled run extending the resident prefix
                # back into the pool first: the probe then adopts it like
                # any cached prefix
                self._revive_chain(chain)
            hit_pages = self.prefix_cache.probe(chain)
            hits = min(len(hit_pages), n // ps)
            full_hit = hits > 0 and hits * ps == n
            cached_pages = hit_pages[:hits]
        prefix_len = n - 1 if full_hit else len(cached_pages) * ps
        try:
            if cached_pages:
                self.allocator.adopt(seq_id, cached_pages)
                extra = self.allocator.pages_for(total) - len(cached_pages)
                if extra > 0:
                    self.allocator.allocate_extra(seq_id, extra)
                if full_hit:
                    shared_last = cached_pages[-1]
                    fresh = self.allocator.cow_page(seq_id, shared_last)
                    self._copy_page_dev(shared_last, fresh)
                    self.stats.prefix_full_hits += 1
                    self.stats.prefix_cow_copies += 1
            else:
                self.allocator.allocate(seq_id, total)
            if self._spec_max and self.prefix_cache is not None:
                # speculation's write invariant: no page the slot's
                # draft K/V may land in ([n, limit)) is shared. Healthy
                # layouts pass by construction; a violation is repaired
                # by a copy-on-write and logged
                for old, new, needs_copy in self.allocator.truncate_to(
                        seq_id, n):
                    logger.warning("speculative admission CoW'd shared "
                                   "tail page %d->%d for seq %d", old, new,
                                   seq_id)
                    if needs_copy:
                        self._copy_page_dev(old, new)
                        self.stats.prefix_cow_copies += 1
        except OutOfPagesError:
            self.allocator.free(seq_id)
            return "stop"
        pages = self.allocator.pages(seq_id)
        req.id = seq_id
        qw = 1e3 * (time.monotonic() - req.enqueued_at)
        self.phases.observe("queue_wait", qw, trace_id_of(req))
        if req.trace is not None:
            burst_id, burst_size = self._cur_burst
            req.trace.queue_wait(qw)
            req.trace.admission(
                path="single", burst_id=burst_id, burst_size=burst_size,
                prefix=("off" if not chain
                        else "full" if full_hit
                        else "partial" if cached_pages else "miss"),
                pages_adopted=len(cached_pages), prefix_tokens=prefix_len)
        adapter_row = self._base_row
        if req.adapter:
            try:
                # pins (and loads, when not resident) the row; the pin
                # passes to the slot and is released when it frees
                adapter_row = self._acquire_adapter(req.adapter)
            except UnknownAdapterError:
                self._meter_zero(req, "error")
                req.emit(-1, "error")
                self.allocator.free(seq_id)
                return "skipped"
            except AdapterCapacityError:
                # every row pinned by live slots: wait like page pressure
                self.allocator.free(seq_id)
                return "stop"
        suffix = req.prompt[prefix_len:]
        page_row = np.zeros((self.cfg.max_pages_per_seq,), np.int32)
        page_row[:len(pages)] = pages
        # grammar constraint: the slot's FSM cursor; the initial state's
        # mask joins the prefill's bias row, so the first sampled token
        # is already valid
        cn = req.constraint.new_state() if req.constraint is not None \
            else None
        t0 = time.monotonic()
        res = self.attn.single_prefill(
            req, seq_id, suffix, prefix_len, page_row, total,
            mask=cn.mask_row() if cn is not None else None)
        if isinstance(res, str):
            # cancelled or the engine stopping: the pin never reached a
            # slot. A request consumed here gets its one (zero) record;
            # a "stop" is requeued and metered where it ends
            self._release_adapter_row(adapter_row)
            self.allocator.free(seq_id)
            if res != "stop":
                self._meter_zero(req, "cancelled")
            return res
        tok, info = res
        if prefix_len:
            self.stats.prefix_cache_hits += 1
            self.stats.prefix_tokens_reused += prefix_len
        elif chain:
            # page-eligible prompt, nothing reusable cached
            self.stats.prefix_cache_misses += 1
        self.stats.prefills += 1
        prefill_ms = max(0.0, 1e3 * (time.monotonic() - t0)
                         - info["tick_ms"])
        self.stats.prefill_ms += prefill_ms
        self.stats.note_prefill_call(prefill_ms, len(suffix))
        self.phases.observe("prefill", prefill_ms, trace_id_of(req))
        if req.trace is not None:
            req.trace.prefill(
                prefill_ms, bucket=info["bucket"],
                padded_frac=info["padded_frac"], chunks=info["chunks"],
                resumed_at=prefix_len + info["consumed"], sp=False)
        t_first = time.monotonic()
        if self.prefix_cache is not None and chain:
            self.prefix_cache.insert(chain, pages, tokens=req.prompt)
            self._purge_spilled(chain)
        # speculative drafts: when the radix chain remembers what followed
        # this prefix, one page of it becomes the slot's lookahead buffer
        ctrl = self._make_ctrl(req)
        la_base = 0
        la_tokens: list[int] = []
        if ctrl is not None and self.prefix_cache is not None and chain:
            cont = self.prefix_cache.continuation(chain)
            if cont is not None and cont[0] * ps + len(cont[1]) > n:
                la_base = cont[0] * ps
                la_tokens = cont[1]
                self.stats.spec_lookahead_slots += 1
        req.prefix_reused = prefix_len
        # a continuation: the generated tokens riding in the prompt's tail
        # keep counting toward the repetition penalties
        ims = req.import_state or {}
        counts: dict[int, int] = {}
        for t in req.prompt[int(ims.get("orig_prompt_len", n)):]:
            counts[t] = counts.get(t, 0) + 1
        slot_idx = self._slots.index(None)
        # metering: the padded volume from the calls' padded share, the
        # reference's formula for every prefill path
        ns = len(suffix)
        pf = info["padded_frac"]
        m_padded = int(round(ns / (1.0 - pf))) if 0.0 < pf < 1.0 else ns
        # pos = n - 1: _emit_token advances it to n, the write position
        # of the just-sampled first token
        self._slots[slot_idx] = _Slot(
            req=req, pos=n - 1, generated=0,
            key_seed=self.first_key(req, seq_id)[0], limit=total,
            page_row=page_row, token_counts=counts, ctrl=ctrl,
            la_base=la_base, la_tokens=la_tokens, cn=cn,
            adapter_row=adapter_row, m_prefill_real=ns,
            m_prefill_padded=m_padded, m_prefix_reused=prefix_len,
            m_res_t0=time.monotonic(), m_carry=ims.get("meter_carry"))
        self._mark_admitted(slot_idx)
        if cn is not None:
            # counted at admission (a requeue under page pressure must
            # not count twice); the first token is mask-valid, and the
            # first window dispatches under the state after it
            self.stats.constraint_requests += 1
            cn.advance(tok)
        self._emit_token(slot_idx, tok, info["first_lp"])
        first_emit_ms = 1e3 * (time.monotonic() - t_first)
        self.stats.first_emit_ms += first_emit_ms
        self.phases.observe("first_emit", first_emit_ms, trace_id_of(req))
        return "admitted"

    @staticmethod
    def first_key(req: GenRequest, seq_id: int) -> tuple[int, int]:
        """(seed, counter) of the key a request's first token samples
        with: ``[seed or seq_id, 0]``, or for a continuation the key the
        solo run would use at the cut (its import_state's seed, and the
        position of the pending token, len(prompt) - 1)."""
        ims = req.import_state or {}
        seed = int(ims.get("key_seed") or (req.sampling.seed or seq_id))
        return seed, int(ims.get("key_counter", 0))

    def _copy_page_dev(self, src: int, dst: int) -> None:
        """Clone one KV page on the device (copy-on-write of a full hit's
        last page). On the engine's stream: it runs after the in-flight
        window's launches, which may read ``src``, and before the resume
        that writes ``dst``."""
        self.kv_cache = kvq.copy_page(self.kv_cache, src, dst,
                                      self.cfg.page_size)

    # -- device state -----------------------------------------------------
    def _row_host_values(self, i: int) -> dict[str, Any]:
        """Host-side row i of the decode state (cleared when empty)."""
        V = self.model_cfg.vocab_size
        P = self.cfg.max_pages_per_seq
        s = self._slots[i]
        row: dict[str, Any] = {
            "tokens": 0, "positions": 0, "limits": 0, "active": False,
            "keys": [0, 0], "temp": 1.0, "top_p": 1.0, "top_k": 0,
            "freq_pen": 0.0, "pres_pen": 0.0,
            "page_table": np.zeros((P,), np.int32),
            "counts": np.zeros((V,), np.int32),
            "bias": np.zeros((V,), np.float32),
            "adapter_idx": self._base_row,
        }
        if self._spec_max:
            row.update(history=np.zeros((self.cfg.max_seq_len,), np.int32),
                       draft_len=0,
                       lookahead=np.zeros((self.cfg.page_size,), np.int32),
                       la_base=0, la_len=0)
        if s is None:
            return row
        sp = s.req.sampling
        row.update(tokens=s.pending_token, positions=s.pos, limits=s.limit,
                   active=True, keys=[s.key_seed & 0xFFFFFFFF, s.pos],
                   temp=sp.temperature, top_p=sp.top_p, top_k=sp.top_k,
                   freq_pen=sp.frequency_penalty,
                   pres_pen=sp.presence_penalty, adapter_idx=s.adapter_row)
        row["page_table"][:] = s.page_row[:P]
        for tok_id, cnt in s.token_counts.items():
            if 0 <= tok_id < V:
                row["counts"][tok_id] = cnt
        row["bias"] = self._bias_row(s)
        if self._spec_max:
            n = len(s.req.prompt)
            row["history"][:n] = s.req.prompt
            row["history"][n:n + len(s.gen_tokens)] = s.gen_tokens
            if s.ctrl is not None:
                row["draft_len"] = s.dev_draft_len = s.ctrl.draft_len()
            if s.la_tokens:
                row["lookahead"][:len(s.la_tokens)] = s.la_tokens
                row.update(la_base=s.la_base, la_len=len(s.la_tokens))
        return row

    def _build_device_state(self) -> dict[str, torch.Tensor]:
        """The full per-slot decode state, uploaded once per busy period
        (membership changes then patch rows) into the engine's state
        tensors: allocated by the first build and written in place
        after, since the captured programs address them."""
        rows = [self._row_host_values(i)
                for i in range(self.cfg.max_batch_size)]
        host = {k: torch.from_numpy(np.asarray([r[k] for r in rows], dt))
                for k, dt in self._state_dtypes.items()}
        if self._state is None:
            self._state = {k: v.to(self.device) for k, v in host.items()}
        else:
            for k, v in host.items():
                self._state[k].copy_(v)
        return self._state

    def _apply_row_updates(self) -> None:
        """Patch dirty slot rows into the live state, like the
        reference's chained row-update program: the writes queue behind
        the in-flight window on the engine's stream."""
        for i in sorted(self._dirty_rows):
            t0 = time.monotonic()
            self._upload_row(i, self._row_host_values(i))
            s = self._slots[i]
            if s is not None and s.cn is not None:
                self.stats.constraint_host_ms += 1e3 * (time.monotonic()
                                                        - t0)
        self._dirty_rows.clear()

    def _upload_row(self, i: int, row: dict[str, Any]) -> None:
        """Write ``row``'s fields into row i of the live state. On CUDA
        the arrays are copied into slot i's pinned staging row and from
        there with non-blocking copies, so the host does not wait for the
        window in flight; the staging row is rewritten only after the
        event of its previous copies has completed."""
        st = self._device_state
        stage = None
        if self.device.type == "cuda":
            if self._stage_done[i] is not None:
                self._stage_done[i].synchronize()
            stage = self._stage.get(i)
            if stage is None:
                stage = self._stage[i] = {}
        for k, v in row.items():
            if not isinstance(v, (np.ndarray, list)):
                st[k][i] = v
                continue
            a = np.asarray(v, self._state_dtypes[k])
            if stage is None:
                st[k][i] = torch.from_numpy(a)
                continue
            buf = stage.get(k)
            if buf is None:
                buf = stage[k] = torch.from_numpy(a.copy()).pin_memory()
            else:
                buf.numpy()[...] = a
            st[k][i].copy_(buf, non_blocking=True)
        if stage is not None:
            ev = torch.cuda.Event()
            ev.record()
            self._stage_done[i] = ev

    def _bias_row(self, s: _Slot) -> np.ndarray:
        """Slot ``s``'s bias row: the request's logit_bias plus, for a
        constrained slot, its FSM state's mask, in float32."""
        V = self.model_cfg.vocab_size
        row = np.zeros((V,), np.float32)
        for tok_id, b in s.req.sampling.logit_bias:
            if 0 <= tok_id < V:
                row[tok_id] = b
        if s.cn is not None:
            row += s.cn.mask_row()
        return row

    # -- grammar constraints (host) ------------------------------------------
    def _apply_cn_row_updates(self) -> None:
        """Patch the bias rows of constrained slots whose state moved.
        Rows due for a whole upload (``_dirty_rows``) carry the mask
        already and are skipped."""
        for i in sorted(self._cn_dirty):
            s = self._slots[i]
            if s is None or s.cn is None or i in self._dirty_rows:
                continue
            self._upload_row(i, {"bias": self._bias_row(s)})
            self.stats.constraint_mask_updates += 1
        self._cn_dirty.clear()

    def _cn_verify(self, i: int, s: _Slot, tok: int, dispatch_mask) -> bool:
        """Verify and advance slot i's FSM with ``tok``, which the window
        sampled under ``dispatch_mask``; True = emit it.

        A token counts only while the slot's current state demands
        exactly the dispatch mask: then the device drew it from the
        distribution a per-step masked decode would have used (same bias
        row, same per-position key), so accepted streams equal true
        per-step constrained decoding. When an advance changes the mask,
        the window is cut there and the slot rolled back to its last
        accepted token (``_cn_rollback``); so is a token the FSM refuses
        (a mask-allowed token must be valid: a disagreement is a cut,
        never a corrupt stream)."""
        t0 = time.monotonic()
        cur = s.cn.mask_row()
        ok = ((cur is dispatch_mask or np.array_equal(cur, dispatch_mask))
              and s.cn.advance(tok))
        if not ok:
            self._cn_rollback(i, s)
        elif tok not in self.eos:
            self._cn_dirty.add(i)
        self.stats.constraint_host_ms += 1e3 * (time.monotonic() - t0)
        return ok

    def _cn_rollback(self, i: int, s: _Slot) -> None:
        """The host state never moved past the cut: a new epoch drops the
        window in flight for this slot, and the whole row is uploaded
        again behind it (position, key, counts, history, mask)."""
        s.cn_epoch += 1
        self._dirty_rows.add(i)
        self._cn_dirty.discard(i)
        self.stats.constraint_rollbacks += 1
        if s.req.trace is not None:
            s.req.trace.constraint_rollback()

    # -- decode ---------------------------------------------------------------
    def _drain_inflight(self) -> None:
        """Settle the in-flight window: finish its host copy, emit its
        tokens, recycle the pages it was carrying."""
        w, self._inflight = self._inflight, None
        if w is None:
            return
        t0 = time.monotonic()
        if w.ready is not None:
            w.ready.synchronize()
        toks = w.sampled.numpy()
        t1 = time.monotonic()
        tr_ms = 1e3 * (t1 - t0)
        self.stats.transfer_ms += tr_ms
        ex = ""
        for _i, req in w.members:
            if req.trace is not None:
                req.trace.transfer(tr_ms)
                ex = ex or req.trace.trace_id
        self.phases.observe("transfer", tr_ms, ex)
        ce = {i: (ep, m) for i, ep, m in w.cn_epochs}
        if w.draft:
            D1 = w.draft + 1
            self._process_spec_window(toks[:, :, :D1], toks[:, :, D1],
                                      toks[:, :, D1 + 1], w.members,
                                      w.draft_lens, ce)
        else:
            lp = (None if w.lp is None
                  else tuple(t.tolist() for t in w.lp))
            self._process_window(toks, w.members, ce, lp)
        self.stats.emit_ms += 1e3 * (time.monotonic() - t1)
        # folded whatever the window's tokens became (a grammar cut may
        # have discarded them): the rows ran all the same
        self._fold_moe(w.moe)
        for seq_id in w.frees:
            self.allocator.free(seq_id)

    def _fold_moe(self, moe) -> None:
        """Fold one program's [L, E + 1] routing counts into the totals
        behind /state's moe_* keys; None (a dense family) is a no-op."""
        if moe is None:
            return
        arr = moe.cpu().numpy().astype(np.int64)
        self._moe_expert_tokens += arr[:, :-1].sum(axis=0)
        self._moe_layer_drops += arr[:, -1]

    def moe_expert_load(self) -> list[int]:
        """Placed (token, k) totals per expert; [] on a dense family."""
        if not self._moe:
            return []
        return [int(x) for x in self._moe_expert_tokens]

    def moe_layer_drops(self) -> list[int]:
        """Capacity-drop totals per layer; [] on a dense family."""
        if not self._moe:
            return []
        return [int(x) for x in self._moe_layer_drops]

    def _process_window(self, toks: np.ndarray, members: tuple,
                        ce: dict, lp=None) -> None:
        """Emit a plain window's tokens [K, B] to the slots that were
        members at dispatch and still hold the same request, each with
        its logprobs (``lp``: [K, B] chosen, [K, B, k] top ids and
        values as nested lists, or None). A constrained slot whose epoch moved past the
        window's (``ce``: slot → (epoch, dispatch mask)) is skipped: the
        window ran past a grammar cut."""
        self.stats.decode_steps += toks.shape[0]
        for k in range(toks.shape[0]):
            for i, req in members:
                s = self._slots[i]
                if s is None or s.req is not req:
                    continue  # finished earlier in this window / reused
                if s.cn is not None and (
                        ce.get(i, (None,))[0] != s.cn_epoch
                        or not self._cn_verify(i, s, int(toks[k, i]),
                                               ce[i][1])):
                    continue  # stale window, or cut here
                step_lp = None
                if lp is not None:
                    chosen, tk_ids, tk_vals = lp
                    step_lp = (chosen[k][i],
                               list(zip(tk_ids[k][i], tk_vals[k][i])))
                self._emit_token(i, int(toks[k, i]), step_lp)

    def _process_spec_window(self, toks: np.ndarray, counts: np.ndarray,
                             props: np.ndarray, members: tuple,
                             draft_lens: tuple, ce: dict) -> None:
        """A speculative window: samples [K, B, D + 1], n_emit [K, B],
        n_prop [K, B]. The leading n_emit samples of each row are
        model-exact and emitted; the rest were conditioned on a rejected
        draft. Then each surviving slot's controller observes the
        window's proposed/accepted counts and may move its rung (patched
        on the device before the next dispatch). Constrained slots are
        cut as in ``_process_window``."""
        self.stats.decode_steps += toks.shape[0]
        dl = dict(draft_lens)
        proposed = dict.fromkeys(dl, 0)
        accepted = dict.fromkeys(dl, 0)
        live = dict.fromkeys(dl, False)
        for k in range(toks.shape[0]):
            for i, req in members:
                s = self._slots[i]
                if s is None or s.req is not req:
                    continue
                if s.cn is not None and ce.get(i, (None,))[0] != s.cn_epoch:
                    continue  # stale window for a rolled-back slot
                n = int(counts[k, i])
                if n > 0:
                    proposed[i] = proposed.get(i, 0) + int(props[k, i])
                    live[i] = True
                    # metered before the emits: a slot finishing in this
                    # step carries the step's drafts in its record
                    s.m_spec_drafted += int(props[k, i])
                emitted = 0
                for d in range(n):
                    cur = self._slots[i]
                    if cur is None or cur.req is not req:
                        break  # EOS or the length limit mid-burst
                    if cur.cn is not None and not self._cn_verify(
                            i, cur, int(toks[k, i, d]), ce[i][1]):
                        break  # cut here: rolled back
                    if emitted > 0:
                        # a landed draft, credited before its emit so a
                        # finish on it still meters it
                        cur.m_spec_accepted += 1
                    self._emit_token(i, int(toks[k, i, d]))
                    emitted += 1
                if emitted > 1:
                    self.stats.spec_accepted += emitted - 1
                    accepted[i] = accepted.get(i, 0) + emitted - 1
        for i, req in members:
            # only slots that decoded under a nonzero draft width this
            # window carry a controller signal
            if not live.get(i, False) or dl.get(i, 0) <= 0:
                continue
            self.stats.spec_drafted += proposed.get(i, 0)
            if req.trace is not None:
                req.trace.spec_window(proposed.get(i, 0),
                                      accepted.get(i, 0))
            s = self._slots[i]
            if s is None or s.req is not req or s.ctrl is None:
                continue
            move = s.ctrl.observe_window(proposed.get(i, 0),
                                         accepted.get(i, 0))
            if move:
                if move > 0:
                    self.stats.spec_rung_ups += 1
                else:
                    self.stats.spec_rung_downs += 1
                if i not in self._dirty_rows:
                    self._spec_dirty.add(i)

    # -- speculation control (host) ------------------------------------------
    def _make_ctrl(self, req: GenRequest):
        """The adaptive draft controller of a fresh slot, or None when
        the request is ineligible (sampled, or with repetition
        penalties: those slots decode plainly and never lift the
        dispatch width)."""
        sp = req.sampling
        if (not self._spec_max or sp.temperature > 0.0
                or sp.frequency_penalty != 0.0
                or sp.presence_penalty != 0.0):
            return None
        return speculation.DraftController(
            self._spec_rungs, self._accept_prior, self.cfg.spec_adaptive)

    def _choose_draft_len(self) -> int:
        """Dispatch draft width: the max of the live eligible slots'
        rungs (0 dispatches the plain window). Ticking the controllers
        also runs the rung-0 re-probe; a rung move is patched on the
        device before the dispatch that follows."""
        if not self._spec_max:
            return 0
        d = 0
        for i, s in enumerate(self._slots):
            if s is None or s.ctrl is None:
                continue
            before = s.ctrl.draft_len()
            nd = s.ctrl.tick()
            if nd > before:
                self.stats.spec_rung_ups += 1  # rung-0 re-probe
            if nd != s.dev_draft_len and i not in self._dirty_rows:
                self._spec_dirty.add(i)
            d = max(d, nd)
        self.stats.spec_draft_len = d
        return d

    def _apply_spec_row_updates(self) -> None:
        """Patch live slots' on-device ``draft_len`` after a rung move.
        Only that field: a live slot's positions and history on the
        device run ahead of the host's view while a window is in
        flight, but the draft length is position-independent."""
        dl = self._device_state["draft_len"]
        for i in sorted(self._spec_dirty):
            s = self._slots[i]
            d = (s.ctrl.draft_len() if s is not None and s.ctrl is not None
                 else 0)
            dl[i] = d
            if s is not None:
                s.dev_draft_len = d
        self._spec_dirty.clear()

    def _apply_frees(self) -> None:
        """Recycle finished sequences' pages (only with no window in
        flight: it may still write into them)."""
        assert self._inflight is None
        for seq_id in self._pending_frees:
            self.allocator.free(seq_id)
        self._pending_frees.clear()

    def _quiesce(self) -> None:
        self._device_state = None
        self._need_rebuild = False
        self._dirty_rows.clear()
        self._spec_dirty.clear()
        self._cn_dirty.clear()
        self.stats.active_slots = 0
        self._refresh_stats()

    def _decode_tick(self) -> bool:
        """Pipelined: dispatch window N+1, then settle window N while the
        device runs it."""
        active_idx = [i for i, s in enumerate(self._slots) if s is not None]
        if not active_idx:
            self._drain_inflight()
            self._apply_frees()
            self._quiesce()
            return False
        if self._device_state is None or self._need_rebuild:
            if self._device_state is not None:
                self.stats.state_rebuilds += 1  # a live pipeline drained
            self._drain_inflight()
            self._apply_frees()
            active_idx = [i for i, s in enumerate(self._slots)
                          if s is not None]
            if not active_idx:
                self._quiesce()
                return True
            self._device_state = self._build_device_state()
            self._state_bucket = self._decode_bucket_pages()
            self._need_rebuild = False
            self._dirty_rows.clear()
            self._spec_dirty.clear()
            self._cn_dirty.clear()  # the full build carried the masks
        elif self._dirty_rows:
            self._apply_row_updates()
        if self._cn_dirty:
            # constrained slots whose state moved since the last
            # dispatch: their bias rows, before this dispatch samples
            # under them
            t0 = time.monotonic()
            self._apply_cn_row_updates()
            self.stats.constraint_host_ms += 1e3 * (time.monotonic() - t0)

        if self._inflight is not None:
            # zombie-window guard: when every slot finishes inside the
            # window already in flight, drain instead of computing K
            # junk steps
            K = self._inflight.k
            in_window = {i: req for i, req in self._inflight.members}
            if all(s is None or (
                    in_window.get(i) is s.req
                    and (s.generated + K >= s.req.max_tokens
                         or s.pos + K >= min(s.limit, self.cfg.max_seq_len)))
                   for i, s in enumerate(self._slots)):
                self._drain_inflight()
                self._apply_frees()
                self.stats.active_slots = sum(
                    s is not None for s in self._slots)
                self._refresh_stats()
                return True

        # the speculative width (and any rung-move patches) settle before
        # the window is chosen
        draft = self._choose_draft_len()
        if self._spec_dirty:
            self._apply_spec_row_updates()
        k = self._choose_window()
        members = tuple((i, self._slots[i].req) for i in active_idx)
        live = [self._slots[i].req.sampling for i in active_idx]
        lean = all(sp.frequency_penalty == 0.0 and sp.presence_penalty == 0.0
                   for sp in live)
        greedy = all(sp.temperature <= 0.0 for sp in live)
        t0 = time.monotonic()
        cn_epochs = tuple((i, self._slots[i].cn_epoch,
                           self._slots[i].cn.mask_row())
                          for i in active_idx
                          if self._slots[i].cn is not None)
        if cn_epochs:
            self.stats.constraint_windows += 1
            self.stats.constraint_slot_windows += len(cn_epochs)
            self.stats.constraint_host_ms += 1e3 * (time.monotonic() - t0)
        frees, self._pending_frees = self._pending_frees, []
        draft_lens: tuple = ()
        lp = None
        if draft:
            draft_lens = tuple((i, self._slots[i].ctrl.draft_len())
                               for i in active_idx
                               if self._slots[i].ctrl is not None)
            sampled, moe = self._decode_fn_for(k, False, greedy, draft)()
        else:
            sampled, moe, lp = self._decode_fn_for(k, lean, greedy)()
        if self.cfg.async_transfers:
            # the logprobs ride the tokens' copy and event
            (host, moe, *lp_host), ready = self._start_host_copy(
                sampled, moe, *(lp or ()))
            lp = tuple(lp_host) if lp is not None else None
        else:
            host, ready = sampled.cpu(), None
            moe = None if moe is None else moe.cpu()
            lp = None if lp is None else tuple(t.cpu() for t in lp)
        # settle the PREVIOUS window while this one runs on the device
        self._drain_inflight()
        self._inflight = _Window(sampled=host, ready=ready, members=members,
                                 k=k, frees=frees, draft=draft,
                                 draft_lens=draft_lens, cn_epochs=cn_epochs,
                                 moe=moe, lp=lp)
        for _i, req in members:
            if req.trace is not None:
                req.trace.decode_window(k, lean and not draft, draft)
        self.stats.active_slots = sum(s is not None for s in self._slots)
        self._refresh_stats()
        return True

    def _emit_token(self, i: int, tok: int, lp=None) -> None:
        """Record one generated token for slot i; finish if stopping.
        ``lp`` = (chosen logprob, [(top id, top logprob)]) with logprobs
        on, else None."""
        s = self._slots[i]
        req = s.req
        s.generated += 1
        if s.generated == 1:
            # engine-side TTFT: arrival to the first sampled token, of
            # interactive requests only (the histogram feeds the SLO
            # monitor and the picker's TTFT price; offline work queuing
            # for minutes is by design)
            s.first_emit_at = time.monotonic()
            if req.priority != "batch":
                self.phases.observe(
                    "ttft", 1e3 * (s.first_emit_at - req.enqueued_at),
                    trace_id_of(req))
            if req.trace is not None:
                req.trace.first_token()
        finish: str | None = None
        send_tok = tok
        if tok in self.eos or tok in req.stop_token_ids:
            finish = "stop"
            send_tok = -1
        else:
            s.pos += 1  # where `tok` will be written by the next decode
            if s.generated >= req.max_tokens or s.pos >= self.cfg.max_seq_len:
                finish = "length"
        if finish is not None:
            # the record before the terminal emit: the consumer that
            # takes the finish item finds it
            self._meter_finish(s, finish)
        if req.emit_lp is None:
            req.emit(send_tok, finish)
        elif lp is None or send_tok < 0:
            req.emit_lp(send_tok, finish, None, None)
        else:
            req.emit_lp(send_tok, finish, lp[0], lp[1])
        self.stats.tokens_generated += 1
        if req.priority == "batch":
            self.stats.batch_tokens += 1
        if finish is not None:
            if s.generated > 1 and s.first_emit_at:
                self.phases.observe(
                    "decode_per_token", 1e3 * (time.monotonic()
                                               - s.first_emit_at)
                    / (s.generated - 1), trace_id_of(req))
            if req.trace is not None:
                req.trace.engine_finish(finish)
            self._pending_frees.append(req.id)
            self._release_adapter_row(s.adapter_row)
            self._slots[i] = None
            self._dirty_rows.add(i)
            self._wake.set()  # maybe admit a queued request
        else:
            s.pending_token = tok
            s.token_counts[tok] = s.token_counts.get(tok, 0) + 1
            s.gen_tokens.append(tok)

    # -- usage metering -------------------------------------------------------
    # One MeterRecord per request lifetime, emitted on the engine thread
    # before the terminal emit; EngineStats.meter_* move only in
    # _meter_emit, so a ledger of the records reconciles against /state
    # token for token.

    _METER_SUM_KEYS = ("prefill_real", "prefill_padded", "prefix_reused",
                       "decode_tokens", "spec_drafted", "spec_accepted",
                       "segments")

    def _meter_fold(self, s: _Slot) -> dict:
        """Slot ``s``'s accumulators as one meter dict (the terminal
        record adds schema and finish). HBM residency: the slot's pages x
        kv_page_bytes x seconds since admission."""
        req = s.req
        hbm = ((time.monotonic() - s.m_res_t0)
               * len(self.allocator.pages(req.id)) * self.kv_page_bytes)
        rec = {
            "prefill_real": s.m_prefill_real,
            "prefill_padded": s.m_prefill_padded,
            "prefix_reused": s.m_prefix_reused,
            "decode_tokens": s.generated,
            "spec_drafted": s.m_spec_drafted,
            "spec_accepted": s.m_spec_accepted,
            "hbm_page_byte_s": round(hbm, 6),
            "host_page_byte_s": 0.0,
            "segments": 1,
            "tenant": req.tenant,
            "priority": req.priority,
        }
        c = s.m_carry
        if c:
            # a resumed session: the earlier segments' meter, so the
            # spliced stream meters once, at its real end
            for key in self._METER_SUM_KEYS:
                rec[key] += int(c.get(key, 0))
            rec["hbm_page_byte_s"] = round(
                rec["hbm_page_byte_s"]
                + float(c.get("hbm_page_byte_s", 0.0)), 6)
            rec["host_page_byte_s"] = round(
                float(c.get("host_page_byte_s", 0.0)), 6)
        return rec

    def _meter_emit(self, rec: dict, sink) -> None:
        """The one place the meter counters move and a record reaches
        its sink."""
        st = self.stats
        st.meter_records += 1
        st.meter_prefill_tokens += rec["prefill_real"]
        st.meter_prefill_padded_tokens += rec["prefill_padded"]
        st.meter_prefix_reused_tokens += rec["prefix_reused"]
        st.meter_decode_tokens += rec["decode_tokens"]
        st.meter_spec_drafted += rec["spec_drafted"]
        st.meter_spec_accepted += rec["spec_accepted"]
        st.meter_hbm_page_byte_s = round(
            st.meter_hbm_page_byte_s + rec["hbm_page_byte_s"], 6)
        st.meter_host_page_byte_s = round(
            st.meter_host_page_byte_s + rec["host_page_byte_s"], 6)
        if sink is not None:
            sink(rec)

    def _meter_finish(self, s: _Slot, finish: str) -> None:
        """The terminal record of a live slot (stop, length, cancelled,
        error)."""
        rec = self._meter_fold(s)
        rec["schema"] = 1
        rec["finish"] = finish
        self._meter_emit(rec, s.req.meter_sink)

    def _meter_zero(self, req: GenRequest, finish: str) -> None:
        """The terminal record of a request that never held a slot
        (cancelled while queued, an unknown adapter, an engine abort):
        zeros, or a queued continuation's carried meter."""
        c = (req.import_state or {}).get("meter_carry") or {}
        self._meter_emit(_carry_record(
            c, finish, req.tenant, req.priority,
            float(c.get("host_page_byte_s", 0.0))), req.meter_sink)

    def _meter_parked(self, park: dict, finish: str) -> None:
        """The terminal record of a parked session that never resumes
        (cancelled while parked, an engine abort): its carry plus the
        host residency accrued while parked."""
        blob = park["blob"]
        c = dict(blob.get("meter") or {})
        now = time.monotonic()
        host = (float(c.get("host_page_byte_s", 0.0))
                + (now - park.get("parked_at", now))
                * park.get("park_bytes", 0))
        self._meter_emit(_carry_record(
            c, finish, str(blob.get("tenant", "")),
            str(blob.get("priority", "batch")), host),
            park.get("meter_sink"))

    def _refresh_device_stats(self) -> None:
        """The engine's device: on CUDA its memory (``mem_get_info``),
        with the KV pool and the weights' bytes; on the CPU the pool and
        weights only."""
        st = self.stats
        if self.device.type == "cuda":
            free_b, total_b = torch.cuda.mem_get_info(self.device)
            used = int(total_b - free_b)
            limit = int(total_b)
            dev_id = (self.device.index if self.device.index is not None
                      else torch.cuda.current_device())
        else:
            used = limit = dev_id = 0
        frac = round(used / limit, 4) if limit else 0.0
        st.device_bytes_in_use = used
        st.device_bytes_limit = limit
        st.device_memory_frac = frac
        st.device_count = 1
        st.device_memory_frac_worst = frac
        self.device_stats = [{
            "id": dev_id,
            "platform": "gpu" if self.device.type == "cuda" else "cpu",
            "bytes_in_use": used,
            "bytes_limit": limit,
            "memory_frac": frac,
            "kv_pool_bytes": st.kv_pool_bytes,
            "kv_bytes_in_use": st.kv_bytes_in_use,
            "kv_occupancy": round(st.kv_occupancy, 4),
            "param_bytes": self.param_bytes,
        }]

    def _refresh_stats(self) -> None:
        st = self.stats
        # ``queued`` is interactive depth only (the picker prices it);
        # the offline backlog rides the batch pair
        st.queued = self._queue.qsize()
        st.batch_queued = self._batch_q.qsize() + len(self._parked_batch)
        st.batch_active = self._batch_active()
        young = self.cfg.migration_young_tokens
        st.migratable_slots = sum(
            1 for s in self._slots
            if s is not None and s.generated >= 1
            and (young <= 0 or s.generated <= young))
        if self.host_tier is not None:
            tier = self.host_tier
            st.kv_spills = tier.spills
            st.kv_revives = tier.revives
            st.kv_spill_evictions = tier.evictions
            st.kv_spilled_pages = tier.count
            st.kv_spill_bytes = tier.bytes_used
            st.kv_host_bytes = tier.max_bytes
        st.constrained_slots = sum(
            1 for s in self._slots if s is not None and s.cn is not None)
        st.constraint_grammars = constrain.grammar_cache_size()
        st.spec_accept_rate = (st.spec_accepted / st.spec_drafted
                               if st.spec_drafted else 0.0)
        if st.prefill_tokens_padded:
            st.prefill_padded_frac = round(
                1.0 - st.prefill_tokens_real / st.prefill_tokens_padded, 4)
        st.xla_compiles = self.compile_tracker.compiles()
        st.xla_compile_ms = round(self.compile_tracker.compiles_total_ms(),
                                  3)
        if self.prefix_cache is not None:
            st.prefix_cache_evictions = self.prefix_cache.evictions
            st.prefix_pages_resident = self.prefix_cache.resident_entries
            st.prefix_pages_pinned = self.allocator.pinned_cached_pages
            hm = st.prefix_cache_hits + st.prefix_cache_misses
            st.prefix_cache_hit_rate = (st.prefix_cache_hits / hm if hm
                                        else 0.0)
        if self._moe:
            # the reference's formulas: dropped over all assignments, and
            # the hottest expert over the mean
            placed = float(self._moe_expert_tokens.sum())
            dropped = float(self._moe_layer_drops.sum())
            st.moe_tokens_routed = int(placed)
            st.moe_tokens_dropped = int(dropped)
            st.moe_dropped_frac = (round(dropped / (placed + dropped), 6)
                                   if placed + dropped else 0.0)
            mean = placed / max(self._moe_experts, 1)
            st.moe_expert_imbalance = (
                round(float(self._moe_expert_tokens.max()) / mean, 4)
                if mean > 0 else 0.0)
        store = self._adapter_store
        if store is not None:
            st.adapter_loads = store.loads
            st.adapter_evictions = store.evictions
            st.adapter_resident = store.resident_count
        else:
            st.adapter_resident = len(self.adapter_rows)
        st.adapter_slots = sum(
            1 for s in self._slots
            if s is not None and s.adapter_row != self._base_row)
        tenants = self._tenant_slots()
        st.tenants_active = len(tenants)
        st.tenant_max_slots = max(tenants.values(), default=0)
        st.kv_pages_free = self.allocator.free_pages
        st.kv_occupancy = self.allocator.occupancy
        st.kv_pool_bytes = self.cfg.num_pages * self.kv_page_bytes
        st.kv_bytes_in_use = round(st.kv_pool_bytes * st.kv_occupancy)
        now = time.monotonic()
        if self.prefix_cache is not None and now >= self._kv_digest_next:
            self._kv_digest_next = now + 0.5
            self._refresh_kv_digest()
        if now >= self._mem_next:
            self._mem_next = now + 0.5  # a CUDA query: not every tick
            self._refresh_device_stats()
        try:
            head = self._queue.queue[0]
            st.queue_wait_ms = 1e3 * (now - head.enqueued_at)
        except IndexError:
            st.queue_wait_ms = 0.0


def _carry_record(c: dict, finish: str, tenant: str, priority: str,
                  host_pbs: float) -> dict:
    """A terminal MeterRecord made of a carried meter alone (all zeros
    without one)."""
    return {
        "schema": 1, "finish": finish,
        "prefill_real": int(c.get("prefill_real", 0)),
        "prefill_padded": int(c.get("prefill_padded", 0)),
        "prefix_reused": int(c.get("prefix_reused", 0)),
        "decode_tokens": int(c.get("decode_tokens", 0)),
        "spec_drafted": int(c.get("spec_drafted", 0)),
        "spec_accepted": int(c.get("spec_accepted", 0)),
        "hbm_page_byte_s": round(float(c.get("hbm_page_byte_s", 0.0)), 6),
        "host_page_byte_s": round(host_pbs, 6),
        "segments": int(c.get("segments", 0)),
        "tenant": tenant, "priority": priority}


def continuation_request(blob: dict,
                         emit: Callable[[int, str | None], None]
                         = lambda t, f: None,
                         trace: Any = None) -> GenRequest:
    """The GenRequest that resumes an exported session from its blob
    (the one reading of the wire format, shared by ``/migrate/import``,
    the batch resume and the tests). The prompt is the whole token
    history; import_state restores the key, penalty and meter state, so
    the resumed stream equals a solo run's."""
    sp = blob.get("sampling") or {}
    sampling = SamplingParams(
        temperature=float(sp.get("temperature", 1.0)),
        top_p=float(sp.get("top_p", 1.0)),
        top_k=int(sp.get("top_k", 0)),
        seed=int(sp.get("seed", 0)),
        frequency_penalty=float(sp.get("frequency_penalty", 0.0)),
        presence_penalty=float(sp.get("presence_penalty", 0.0)),
        logit_bias=tuple((int(t), float(b))
                         for t, b in (sp.get("logit_bias") or ())),
    )
    tokens = [int(t) for t in blob["tokens"]]
    return GenRequest(
        prompt=tokens,
        max_tokens=int(blob["max_tokens"]),
        sampling=sampling,
        stop_token_ids=tuple(int(t) for t in
                             (blob.get("stop_token_ids") or ())),
        emit=emit,
        adapter=str(blob.get("adapter", "")),
        tenant=str(blob.get("tenant", "")),
        priority=str(blob.get("priority", "interactive")),
        import_state={
            "orig_prompt_len": int(blob.get("orig_prompt_len",
                                            len(tokens))),
            "generated": int(blob.get("generated", 0)),
            "key_seed": int(blob.get("key_seed", 0)),
            # the pending token at the cut sat at position m - 1: the
            # resume's first sample uses its key
            "key_counter": len(tokens) - 1,
            "meter_carry": blob.get("meter"),
        },
        trace=trace,
    )
