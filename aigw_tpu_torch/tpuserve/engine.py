"""Continuous-batching engine (counterpart of
``aigw_tpu/tpuserve/engine.py``, the main-path subset).

- **Fixed decode geometry**: every decode step runs the whole
  ``[max_batch_size]`` slot table; finished slots are masked, not
  removed.
- **K-step decode windows**: the reference's ``lax.scan`` becomes a
  Python loop of K steps whose sampled tokens stay on the device; the
  host copies the ``[K, B]`` tokens once per window (started
  asynchronously into pinned memory on CUDA) and settles the window while
  the next one runs — the same 1-deep pipeline as the reference. The
  adaptive ``{min, max}`` window is kept.
- **Sampling on the device**, keys ``[seed, position]`` per slot, so
  streams are identical to the reference engine's, greedy and seeded.
- **Engine thread**: the loop runs in its own thread; consumers receive
  tokens through each request's ``emit`` callback.

Admission is FIFO and the reference's: each pass classifies its
requests, runs of two or more simple ones (whole prompt, nothing cached
to adopt, at most one new chain head per run) prefill as one packed
burst (``group_prefill``), and every other request goes through
``_admit_one`` in arrival order, which adopts the longest cached
page-prefix and resumes at its offset (``single_prefill``). Both run the
ragged backend (``tpuserve/attention.py``). The KV pool (native, or
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

One default differs from the reference: ``constrained_decoding`` is
False (the server answers ``response_format`` and tools with the
reference's knob-off 400), exported on ``/state``. Knobs of features
this slice does not implement raise ``NotImplementedError`` naming their
ROADMAP entry when set to a non-default value.
"""

from __future__ import annotations

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
from aigw_tpu_torch.obs.metrics import EnginePhases
from aigw_tpu_torch.tpuserve import speculation
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
)
from aigw_tpu_torch.tpuserve.sampling import (
    SamplingParams,
    apply_penalties,
    sample,
    spec_accept,
)

logger = logging.getLogger(__name__)

#: knobs of features the port does not implement yet: (reference
#: default, ROADMAP queue 1 entry). A non-default value raises
#: NotImplementedError.
NOT_PORTED = {
    "constrained_decoding": (False, "constrained decoding"),
    "tenant_slot_cap": (0, "host scheduler features"),
    "logprobs_topk": (0, "host scheduler features (logprobs)"),
    "kv_host_bytes": (0, "migration and KV mobility"),
}

#: the default that differs from the reference, and why (/state)
DEFAULTS_DIFFER = {
    "constrained_decoding": "False: grammar constraints are not ported "
                            "yet; response_format and tools get a 400",
}


class EngineOverloadedError(Exception):
    """Admission queue full — callers should surface 429/503."""


@dataclass
class EngineConfig:
    """The reference's EngineConfig fields this slice serves, with the
    reference's names and defaults (see the module docstring for the
    one that differs)."""

    max_batch_size: int = 8
    max_seq_len: int = 2048
    page_size: int = 128
    num_pages: int = 0  # 0 = auto: enough for max_batch full sequences
    # decode steps per host round-trip (the adaptive window's maximum)
    decode_steps_per_tick: int = 8
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
    constrained_decoding: bool = False
    tenant_slot_cap: int = 0
    logprobs_topk: int = 0
    kv_host_bytes: int = 0

    def __post_init__(self) -> None:
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
    warmup_ms: float = 0.0
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


#: per-slot decode state on the device: field → numpy dtype
_STATE_DTYPES = {"tokens": np.int32, "positions": np.int32,
                 "limits": np.int32, "active": np.bool_, "keys": np.int64,
                 "temp": np.float32, "top_p": np.float32,
                 "top_k": np.int32, "freq_pen": np.float32,
                 "pres_pen": np.float32, "page_table": np.int32,
                 "counts": np.int32, "bias": np.float32}
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
    ):
        from aigw_tpu_torch.models.registry import family_fns

        self.device = resolve_device(device)
        for name, t in params.items():
            if t.device.type != self.device.type:
                raise ValueError(f"param {name} is on {t.device}, engine "
                                 f"device is {self.device}")
        self.fns = fns or family_fns("llama")
        self.params = params
        self.model_cfg = model_cfg
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
        self.stats = EngineStats()
        # serving-phase latency histograms (queue_wait, prefill, ttft,
        # first_emit, decode_per_token, transfer), observed where the
        # reference's engine observes them; /state's phase_percentiles
        self.phases = EnginePhases()
        self.stats.kv_quant_bits = kvq.quant_bits(cfg.kv_cache_dtype)
        self.healthy = True
        self.last_error: str | None = None

        B = cfg.max_batch_size
        self._slots: list[_Slot | None] = [None] * B
        self._queue: "queue.Queue[GenRequest]" = queue.Queue()
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
        # 1-deep pipeline: the window on the device while the host
        # settles the previous one
        self._inflight: _Window | None = None
        # pages of finished sequences, recycled once every window
        # dispatched while they were active has completed
        self._pending_frees: list[int] = []
        self._cur_window = cfg.decode_steps_per_tick
        self._steady_ticks = 0
        self._mem_next = 0.0
        self.decode_attn_impl, self.decode_attn_reason = (
            resolve_decode_backend(cfg, self.device))
        self._decode_impl = self.decode_attn_impl.split("-")[0]
        # speculative decoding: a rung ladder of [B, D + 1] verify steps
        # replaces the decode step while an eligible slot's controller
        # holds a nonzero draft length. The verify step keeps the chained
        # path (K5) on the chained rung, and takes the gather path (which
        # also serves quantized pools) on the fused rung
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
        self._state_dtypes = (_STATE_DTYPES | _SPEC_DTYPES if self._spec_max
                              else _STATE_DTYPES)
        self.attn = make_attention_backend(self)
        self._refresh_stats()

    # -- device programs ----------------------------------------------------
    def _prefill_ragged_step(self, tokens, row_seq, positions, last_rows,
                             page_table, keys, temp, top_p, top_k, bias):
        """One packed prefill call plus sampling of each row's first
        token (key [seed, 0]); returns [B] int32 tokens on the device."""
        logits, self.kv_cache = self.fns.prefill_ragged(
            self.params, self.model_cfg, tokens, row_seq, positions,
            last_rows, self.kv_cache, page_table, self.cfg.page_size)
        return sample(logits + bias, keys, temp, top_p, top_k)

    def _decode_window(self, k: int, lean: bool, greedy: bool
                       ) -> torch.Tensor:
        """K decode+sample steps; sampled tokens feed forward on the
        device. ``lean`` skips the repetition-penalty terms (bit-identical
        while no live slot uses penalties: zero penalties subtract
        exactly 0.0), ``greedy`` skips the sort/top-p work when every
        live slot samples greedily (sample() returns argmax for those).
        Returns [K, B] int32 tokens on the device."""
        st = self._device_state
        B = self.cfg.max_batch_size
        rows = torch.arange(B, device=self.device)
        out = []
        for _ in range(k):
            act = st["active"] & (st["positions"] < st["limits"])
            logits, self.kv_cache = self.fns.decode_step(
                self.params, self.model_cfg, st["tokens"], st["positions"],
                self.kv_cache, st["page_table"], self.cfg.page_size, act,
                attn_impl=self._decode_impl)
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
            if not lean:
                st["counts"].index_put_((rows, sampled.long()),
                                        act.to(torch.int32), accumulate=True)
            st["tokens"] = torch.where(act, sampled, st["tokens"])
            st["positions"] = torch.where(act, st["positions"] + 1,
                                          st["positions"])
            st["keys"][:, 1] = (st["keys"][:, 1] + act.long()) & 0xFFFFFFFF
            out.append(sampled)
        return torch.stack(out)

    def _spec_window(self, k: int, D: int, greedy: bool) -> torch.Tensor:
        """K speculative steps at draft rung D (the reference's
        ``_spec_scan`` body). Each step drafts D tokens per slot
        (lookahead where it covers the position, n-gram elsewhere),
        poisoned to -1 for ineligible slots (sampled or penalized) and
        past the slot's own ``draft_len``; verifies the D + 1 positions
        in one ``verify_step``; samples position d with key ``[seed, pos
        + d]``, the key plain decoding would use there; and advances each
        slot by ``spec_accept``'s n_emit. ``greedy`` takes the argmax,
        which ``sample`` returns for greedy slots anyway. Returns [K, B,
        D + 3] int32 on the device: the samples ``[..., :D + 1]``, then
        n_emit and n_prop (the drafts actually offered)."""
        st = self._device_state
        dev = self.device
        B = self.cfg.max_batch_size
        H = self.cfg.max_seq_len
        D1 = D + 1
        rows = torch.arange(B, device=dev)
        d_off = torch.arange(D, device=dev)[None, :]
        d_idx = torch.arange(D1, device=dev)[None, :]
        elig = ((st["freq_pen"] == 0.0) & (st["pres_pen"] == 0.0)
                & (st["temp"] <= 0.0))
        out = []
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
            logits, self.kv_cache = self.fns.verify_step(
                self.params, self.model_cfg, inputs, st["positions"],
                self.kv_cache, st["page_table"], self.cfg.page_size, act,
                st["limits"], attn_impl=self._verify_impl)
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
            st["tokens"] = torch.where(n_emit > 0, new_pending, st["tokens"])
            st["positions"] = st["positions"] + n_emit
            st["keys"][:, 1] = (st["keys"][:, 1] + n_emit.long()) & 0xFFFFFFFF
            n_prop = torch.cumprod((drafts >= 0).to(torch.int32),
                                   dim=1).sum(dim=1)
            n_prop = torch.where(act, n_prop, torch.zeros_like(n_prop))
            out.append(torch.cat([sampled, n_emit[:, None],
                                  n_prop[:, None].to(torch.int32)], dim=1))
        return torch.stack(out)

    # -- host copies ----------------------------------------------------------
    def _start_host_copy(self, t: torch.Tensor):
        """Begin the device→host copy of ``t`` now; returns (host tensor,
        event). On the CPU the tensor already is the host copy."""
        if self.device.type != "cuda":
            return t, None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    # -- adaptive window ------------------------------------------------------
    def _window_ladder(self) -> list[int]:
        K = self.cfg.decode_steps_per_tick
        if not self.cfg.adaptive_decode_window:
            return [K]
        kmin = min(self.cfg.min_decode_steps_per_tick, K)
        return [K] if kmin == K else [kmin, K]

    def _choose_window(self) -> int:
        """Shrink to the small window while requests wait or a stream is
        brand new; regrow after two steady ticks."""
        K = self.cfg.decode_steps_per_tick
        ladder = self._window_ladder()
        if len(ladder) == 1:
            self.stats.decode_window = K
            return K
        pressured = self._queue.qsize() > 0 or any(
            s is not None and s.generated <= 1 for s in self._slots)
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
        """Build the CUDA kernels before traffic arrives (the first
        request must not pay the nvcc build)."""
        t0 = time.monotonic()
        if self.device.type == "cuda":
            from aigw_tpu_torch.ops import _build

            _build.library()
        self.stats.warmup_ms = round(1e3 * (time.monotonic() - t0), 3)

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
        if self._queue.qsize() >= self.cfg.max_queued_requests:
            raise EngineOverloadedError(
                f"queue full ({self.cfg.max_queued_requests} waiting)")
        self._queue.put(req)
        self._wake.set()

    # -- engine loop --------------------------------------------------------
    def _run(self) -> None:
        logger.info("engine loop started (batch=%d, pages=%d×%d, %s)",
                    self.cfg.max_batch_size, self.cfg.num_pages,
                    self.cfg.page_size, self.device)
        while not self._stop.is_set():
            try:
                self._reap_cancelled()
                admitted = self._admit()
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
        self._dirty_rows.clear()
        self._spec_dirty.clear()
        for i, s in enumerate(self._slots):
            if s is not None:
                s.req.emit(-1, "error")
                self.allocator.free(s.req.id)
                self._slots[i] = None
        try:
            while True:
                self._queue.get_nowait().emit(-1, "error")
        except queue.Empty:
            pass

    def _reap_cancelled(self) -> None:
        for i, s in enumerate(self._slots):
            if s is not None and s.req.cancelled.is_set():
                s.req.emit(-1, "cancelled")
                self._pending_frees.append(s.req.id)
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

    def _admit(self) -> bool:
        """Admit queued requests in strict arrival order: classify each
        once (its chain keys reused up to the cache insert), then send
        contiguous runs of two or more simple requests through the
        batched prefill and every other request through ``_admit_one``,
        so pages are always allocated in arrival order."""
        admitted = False
        while True:
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
            items: list[tuple[GenRequest, bool, list]] = []
            seen_chain_heads: set = set()
            for req in pending:
                if req.cancelled.is_set():
                    continue  # consumed without a slot
                if not req.prompt:
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
            if unhandled:  # wait for frees, keep the order
                self._requeue_front(unhandled)
            if stop:
                break
        return admitted

    def _classify(self, req: GenRequest) -> tuple[bool, list]:
        """(simple, chain keys): simple = eligible for the batched
        prefill (no cached prefix to adopt; the ragged backend packs
        long prompts itself). The chain keys are hashed once here; the
        cheap probe is redone at adoption (cache state moves within a
        pass)."""
        n = len(req.prompt)
        chain: list = []
        if self.prefix_cache is not None and n > 1:
            chain = self.prefix_cache.chain_keys(req.prompt)
            hits = len(self.prefix_cache.probe(chain))
            if min(hits, n // self.cfg.page_size) > 0:
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
            slot_idx = self._slots.index(None)
            self._slots[slot_idx] = _Slot(
                req=r.req, pos=r.n - 1, generated=0,
                key_seed=r.req.sampling.seed or r.seq_id,
                limit=r.total, page_row=r.page_row,
                ctrl=self._make_ctrl(r.req))
            self.stats.prefills += 1
            self._mark_admitted(slot_idx)
            t_m = time.monotonic()
            self._emit_token(slot_idx, r.tok)
            self.phases.observe("first_emit", 1e3 * (time.monotonic() - t_m))
        self.stats.first_emit_ms += 1e3 * (time.monotonic() - t_first)
        return len(results), leftover

    def _mark_admitted(self, i: int) -> None:
        """Slot i's whole row is uploaded before the next dispatch (its
        draft length included)."""
        self._dirty_rows.add(i)
        self._spec_dirty.discard(i)

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
        self.phases.observe("queue_wait",
                            1e3 * (time.monotonic() - req.enqueued_at))
        suffix = req.prompt[prefix_len:]
        page_row = np.zeros((self.cfg.max_pages_per_seq,), np.int32)
        page_row[:len(pages)] = pages
        t0 = time.monotonic()
        res = self.attn.single_prefill(req, seq_id, suffix, prefix_len,
                                       page_row)
        if isinstance(res, str):
            self.allocator.free(seq_id)
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
        self.phases.observe("prefill", prefill_ms)
        t_first = time.monotonic()
        if self.prefix_cache is not None and chain:
            self.prefix_cache.insert(chain, pages, tokens=req.prompt)
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
        slot_idx = self._slots.index(None)
        # pos = n - 1: _emit_token advances it to n, the write position
        # of the just-sampled first token
        self._slots[slot_idx] = _Slot(
            req=req, pos=n - 1, generated=0,
            key_seed=req.sampling.seed or seq_id, limit=total,
            page_row=page_row, ctrl=ctrl, la_base=la_base,
            la_tokens=la_tokens)
        self._mark_admitted(slot_idx)
        self._emit_token(slot_idx, tok)
        first_emit_ms = 1e3 * (time.monotonic() - t_first)
        self.stats.first_emit_ms += first_emit_ms
        self.phases.observe("first_emit", first_emit_ms)
        return "admitted"

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
                   pres_pen=sp.presence_penalty)
        row["page_table"][:] = s.page_row[:P]
        for tok_id, cnt in s.token_counts.items():
            if 0 <= tok_id < V:
                row["counts"][tok_id] = cnt
        for tok_id, b in sp.logit_bias:
            if 0 <= tok_id < V:
                row["bias"][tok_id] = b
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
        (membership changes then patch rows)."""
        rows = [self._row_host_values(i)
                for i in range(self.cfg.max_batch_size)]
        return {k: torch.from_numpy(np.asarray(
                    [r[k] for r in rows], dt)).to(self.device)
                for k, dt in self._state_dtypes.items()}

    def _apply_row_updates(self) -> None:
        """Patch dirty slot rows into the live state. On CUDA the writes
        queue behind the in-flight window on the same stream, like the
        reference's chained row-update program."""
        st = self._device_state
        for i in sorted(self._dirty_rows):
            row = self._row_host_values(i)
            for k in self._state_dtypes:
                v = row[k]
                st[k][i] = (torch.from_numpy(np.asarray(v)).to(self.device)
                            if isinstance(v, (np.ndarray, list))
                            else v)
        self._dirty_rows.clear()

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
        self.stats.transfer_ms += 1e3 * (t1 - t0)
        self.phases.observe("transfer", 1e3 * (t1 - t0))
        if w.draft:
            D1 = w.draft + 1
            self._process_spec_window(toks[:, :, :D1], toks[:, :, D1],
                                      toks[:, :, D1 + 1], w.members,
                                      w.draft_lens)
        else:
            self._process_window(toks, w.members)
        self.stats.emit_ms += 1e3 * (time.monotonic() - t1)
        for seq_id in w.frees:
            self.allocator.free(seq_id)

    def _process_window(self, toks: np.ndarray, members: tuple) -> None:
        """Emit a plain window's tokens [K, B] to the slots that were
        members at dispatch and still hold the same request."""
        self.stats.decode_steps += toks.shape[0]
        for k in range(toks.shape[0]):
            for i, req in members:
                s = self._slots[i]
                if s is None or s.req is not req:
                    continue  # finished earlier in this window / reused
                self._emit_token(i, int(toks[k, i]))

    def _process_spec_window(self, toks: np.ndarray, counts: np.ndarray,
                             props: np.ndarray, members: tuple,
                             draft_lens: tuple) -> None:
        """A speculative window: samples [K, B, D + 1], n_emit [K, B],
        n_prop [K, B]. The leading n_emit samples of each row are
        model-exact and emitted; the rest were conditioned on a rejected
        draft. Then each surviving slot's controller observes the
        window's proposed/accepted counts and may move its rung (patched
        on the device before the next dispatch)."""
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
                n = int(counts[k, i])
                if n > 0:
                    proposed[i] = proposed.get(i, 0) + int(props[k, i])
                    live[i] = True
                emitted = 0
                for d in range(n):
                    cur = self._slots[i]
                    if cur is None or cur.req is not req:
                        break  # EOS or the length limit mid-burst
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
        self._dirty_rows.clear()
        self._spec_dirty.clear()
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
        if self._device_state is None:
            self._drain_inflight()
            self._apply_frees()
            active_idx = [i for i, s in enumerate(self._slots)
                          if s is not None]
            if not active_idx:
                self._quiesce()
                return True
            self._device_state = self._build_device_state()
            self._dirty_rows.clear()
            self._spec_dirty.clear()
        elif self._dirty_rows:
            self._apply_row_updates()

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
        frees, self._pending_frees = self._pending_frees, []
        draft_lens: tuple = ()
        if draft:
            draft_lens = tuple((i, self._slots[i].ctrl.draft_len())
                               for i in active_idx
                               if self._slots[i].ctrl is not None)
            sampled = self._spec_window(k, draft, greedy)
        else:
            sampled = self._decode_window(k, lean, greedy)
        if self.cfg.async_transfers:
            host, ready = self._start_host_copy(sampled)
        else:
            host, ready = sampled.cpu(), None
        # settle the PREVIOUS window while this one runs on the device
        self._drain_inflight()
        self._inflight = _Window(sampled=host, ready=ready, members=members,
                                 k=k, frees=frees, draft=draft,
                                 draft_lens=draft_lens)
        self.stats.active_slots = sum(s is not None for s in self._slots)
        self._refresh_stats()
        return True

    def _emit_token(self, i: int, tok: int) -> None:
        """Record one generated token for slot i; finish if stopping."""
        s = self._slots[i]
        req = s.req
        s.generated += 1
        if s.generated == 1:
            # engine-side TTFT: arrival to the first sampled token (every
            # request of the port is interactive: no batch tier yet)
            s.first_emit_at = time.monotonic()
            self.phases.observe("ttft",
                                1e3 * (s.first_emit_at - req.enqueued_at))
        finish: str | None = None
        send_tok = tok
        if tok in self.eos:
            finish = "stop"
            send_tok = -1
        else:
            s.pos += 1  # where `tok` will be written by the next decode
            if s.generated >= req.max_tokens or s.pos >= self.cfg.max_seq_len:
                finish = "length"
        req.emit(send_tok, finish)
        self.stats.tokens_generated += 1
        if finish is not None:
            if s.generated > 1 and s.first_emit_at:
                self.phases.observe(
                    "decode_per_token", 1e3 * (time.monotonic()
                                               - s.first_emit_at)
                    / (s.generated - 1))
            self._pending_frees.append(req.id)
            self._slots[i] = None
            self._dirty_rows.add(i)
            self._wake.set()  # maybe admit a queued request
        else:
            s.pending_token = tok
            s.token_counts[tok] = s.token_counts.get(tok, 0) + 1
            s.gen_tokens.append(tok)

    def _refresh_stats(self) -> None:
        st = self.stats
        st.queued = self._queue.qsize()
        st.spec_accept_rate = (st.spec_accepted / st.spec_drafted
                               if st.spec_drafted else 0.0)
        if st.prefill_tokens_padded:
            st.prefill_padded_frac = round(
                1.0 - st.prefill_tokens_real / st.prefill_tokens_padded, 4)
        if self.prefix_cache is not None:
            st.prefix_cache_evictions = self.prefix_cache.evictions
            st.prefix_pages_resident = self.prefix_cache.resident_entries
            st.prefix_pages_pinned = self.allocator.pinned_cached_pages
            hm = st.prefix_cache_hits + st.prefix_cache_misses
            st.prefix_cache_hit_rate = (st.prefix_cache_hits / hm if hm
                                        else 0.0)
        st.kv_pages_free = self.allocator.free_pages
        st.kv_occupancy = self.allocator.occupancy
        st.kv_pool_bytes = self.cfg.num_pages * self.kv_page_bytes
        st.kv_bytes_in_use = round(st.kv_pool_bytes * st.kv_occupancy)
        now = time.monotonic()
        if self.device.type == "cuda" and now >= self._mem_next:
            self._mem_next = now + 0.5  # a CUDA query: not every tick
            free_b, total_b = torch.cuda.mem_get_info(self.device)
            st.device_bytes_in_use = int(total_b - free_b)
            st.device_bytes_limit = int(total_b)
            st.device_memory_frac = round(
                st.device_bytes_in_use / total_b, 4) if total_b else 0.0
        try:
            head = self._queue.queue[0]
            st.queue_wait_ms = 1e3 * (now - head.enqueued_at)
        except IndexError:
            st.queue_wait_ms = 0.0
