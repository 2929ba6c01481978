"""Prefill backends and the attention resolvers (counterpart of
``aigw_tpu/tpuserve/attention.py``).

Two backends behind one interface (``AttentionBackend``), selected by
``EngineConfig.attention_backend``, as in the reference:

- **xla-bucketed** (the default): prompts right-pad to per-sequence
  buckets (``Engine._prefill_bucket``: powers of two of
  ``min_prefill_bucket`` plus the 1.5x rung at ``prefill_bucket_rungs``
  2), same-bucket bursts prefill as one ``[G2, S]`` call (G2 = G padded
  to a power of two; padding rows have length 0), and the single path
  runs prompts longer than ``prefill_chunk_tokens`` as fixed-size
  ``prefill_suffix`` chunks with a cancellation point and a decode tick
  between chunks, then the tail on its bucketed rung. The attention is
  the dense masked ``_attention`` of ``models/llama.py`` (plain PyTorch:
  the reference runs it in XLA, and has no kernel for it either); the
  weight matmuls go through ``_matmul`` (K6 in W8A16 at decode-sized
  M).
- **pallas-ragged**: a mixed-length admission burst packs into one call
  sized by its total tokens, padded only to a token-budget rung
  (multiples of ``ragged_chunk_tokens`` plus two sub-chunk rungs); bursts
  larger than ``ragged_chunk_tokens x ragged_max_chunks`` split at budget
  boundaries with decode ticks interleaved. Attention runs K1
  (``ops.paged_attention.ragged_prefill_attention``): the CUDA kernel on
  CUDA tensors, its plain version on CPU tensors. An int8/int4 KV pool
  prefills through the windowed program instead (plain PyTorch, as in
  the reference, whose kernel has no quantized rung either). It packs
  long prompts itself (``packs_long_prompts``), so they stay eligible
  for batched admission.

``group_prefill`` serves batched admissions and ``single_prefill`` the
per-request path, which resumes a prefix-cache hit at its cached offset
(a full hit is one row at n - 1). Each sequence's sampling row carries
its request's adapter row, which the call's LoRA deltas read. Both
account real and padded prefill tokens (``prefill_padded_frac``) and
count their intermediate device steps in ``chunked_prefill_steps``.
Every prefill call is one of the engine's programs, keyed by its shapes
(``Engine._prefill_step``); ``warm`` captures the backend's ahead of
traffic when ``warm_prefill_buckets > 0``, the reference's compile
warm-up.

Both resolvers export what the replica actually runs, and why, on
``/state`` (``attention_backend_reason``, ``decode_attn_impl``,
``decode_attn_reason``): the reference's rows less the mesh.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any

import numpy as np
import torch

from aigw_tpu_torch.models.kvq import is_quantized_dtype
from aigw_tpu_torch.obs.flight import trace_id_of

if TYPE_CHECKING:  # pragma: no cover
    from aigw_tpu_torch.tpuserve.engine import Engine

logger = logging.getLogger(__name__)

#: valid EngineConfig.attention_backend values (the reference's names)
BACKENDS = ("xla-bucketed", "pallas-ragged")
#: valid EngineConfig.decode_backend values
DECODE_BACKENDS = ("auto", "chained", "fused")


@dataclass
class GroupResult:
    """One admitted request's prefill outcome."""

    req: Any
    seq_id: int
    n: int
    total: int
    tok: int
    page_row: np.ndarray
    adapter_row: int
    # (chosen logprob, [(top id, top logprob)]) with logprobs on
    first_lp: tuple | None = None


@dataclass
class _Seg:
    """One sequence's prompt segment in the packed stream."""

    g: int  # row of the [B]-wide page table / sampling arrays
    req: Any
    tokens: list[int]
    start: int  # absolute position of tokens[0]
    page_row: np.ndarray  # [max_pages_per_seq] int32
    done: int = 0  # tokens already packed into earlier calls


class AttentionBackend:
    """Owns the engine's prefill programs and their geometry policy."""

    name = "base"
    #: True when the batched-admission path may take prompts longer than
    #: prefill_chunk_tokens (the ragged packer splits them at token-budget
    #: boundaries itself)
    packs_long_prompts = False

    def __init__(self, engine: "Engine") -> None:
        self.eng = engine

    def group_prefill(self, items: list, chain_by_req: dict
                      ) -> list[GroupResult]:
        """Prefill ``items`` ((req, seq_id, n, total) with pages already
        allocated); returns results in item order (the engine creates the
        slots and inserts each prompt's ``chain_by_req[id(req)]`` into
        the prefix cache)."""
        raise NotImplementedError

    def warm(self) -> None:
        """Capture the backend's prefill programs before traffic (with
        ``warm_prefill_buckets > 0``; ``Engine.warmup`` calls it)."""
        raise NotImplementedError

    def single_prefill(self, req, seq_id: int, suffix: list[int],
                       prefix_len: int, page_row: np.ndarray, total: int,
                       mask: np.ndarray | None = None):
        """Prefill one request's ``suffix`` at absolute position
        ``prefix_len`` (0, a cached page-aligned prefix, or n - 1 after a
        full hit) into ``page_row``'s pages, the sequence's limit being
        ``total`` tokens, with the grammar ``mask`` of a constrained
        request in its bias. Returns (first token, info: ``first_lp``,
        ``consumed``, ``tick_ms``, ``bucket``, ``chunks``,
        ``padded_frac``) or an abort status string ("skipped", "stop" or
        "stop_consumed", as the engine's ``_admit_one`` returns them)
        when the request is cancelled or the engine stops at a chunk
        boundary."""
        raise NotImplementedError

    # -- shared helpers ------------------------------------------------------
    def _account(self, real: int, padded: int) -> None:
        st = self.eng.stats
        st.prefill_tokens_real += real
        st.prefill_tokens_padded += padded

    def _observe_admission(self, items: list, chain_by_req: dict,
                           bucket_of) -> None:
        """Queue-wait phases and batched admission trace events for a
        group (``bucket_of(item)``: the backend's padded length, or
        None)."""
        eng = self.eng
        t0 = time.monotonic()
        burst_id, burst_size = eng._cur_burst
        for item in items:
            req, _sid, n, _total = item
            qw = 1e3 * (t0 - req.enqueued_at)
            eng.phases.observe("queue_wait", qw, trace_id_of(req))
            if req.trace is not None:
                req.trace.queue_wait(qw)
                extra = {}
                b = bucket_of(item)
                if b is not None:
                    extra = {"bucket": b,
                             "padded_frac": round(1.0 - n / b, 3)}
                req.trace.admission(
                    path="batched", burst_id=burst_id,
                    burst_size=burst_size,
                    prefix="miss" if chain_by_req.get(id(req)) else "off",
                    **extra)

    def _sampling_rows(self, by_row: dict[int, tuple], width: int,
                       mask: np.ndarray | None = None) -> tuple:
        """``width``-wide sampling tensors from ``row → (req, seq_id)``,
        and each row's adapter row (the base row where no request sits):
        the prefill token samples with key ``[seed or seq_id, 0]`` (a
        continuation's with the key at its cut, ``Engine.first_key``). A
        grammar ``mask`` ([V]) is added to row 0's bias (the single
        path's row)."""
        eng = self.eng
        V = eng.model_cfg.vocab_size
        keys = np.zeros((width, 2), np.int64)
        temp = np.zeros((width,), np.float32)
        top_p = np.ones((width,), np.float32)
        top_k = np.zeros((width,), np.int32)
        bias = np.zeros((width, V), np.float32)
        adapter = np.full((width,), eng._base_row, np.int32)
        for g, (req, seq_id) in by_row.items():
            seed, counter = eng.first_key(req, seq_id)
            keys[g] = (seed & 0xFFFFFFFF, counter)
            temp[g] = req.sampling.temperature
            top_p[g] = req.sampling.top_p
            top_k[g] = req.sampling.top_k
            for tok_id, b in req.sampling.logit_bias:
                if 0 <= tok_id < V:
                    bias[g, tok_id] = b
            adapter[g] = eng._adapter_row_of(req)
        if mask is not None:
            bias[0] += mask
        dev = eng.device
        return tuple(torch.from_numpy(a).to(dev)
                     for a in (keys, temp, top_p, top_k, bias, adapter))


class XlaBucketedBackend(AttentionBackend):
    """The bucket-ladder prefill: same-bucket groups as one dense
    ``[G2, S]`` call, long single prompts as ``prefill_suffix`` chunks
    with decode ticks between them."""

    name = "xla-bucketed"

    def __init__(self, engine: "Engine") -> None:
        super().__init__(engine)
        cfg = engine.cfg
        logger.info("attention backend xla-bucketed: min bucket %d, rungs "
                    "%d, chunk %d tokens", cfg.min_prefill_bucket,
                    cfg.prefill_bucket_rungs, cfg.prefill_chunk_tokens)

    def warm(self) -> None:
        """The ``[G2, S]`` prefill at every group size for each rung of
        the ``warm_prefill_buckets`` smallest octaves (the reference's
        walk: octave 0 always; a later octave once the previous base
        rung is below ``max_seq_len``, so the first octave past the cap
        still gives its capped rung; capped rungs dedupe). Chunks and
        resumes (``prefill_suffix``) are not warmed, as in the
        reference."""
        eng = self.eng
        cfg = eng.cfg
        warmed: set[int] = set()
        for b in range(cfg.warm_prefill_buckets):
            if b > 0 and (cfg.min_prefill_bucket << (b - 1)
                          >= cfg.max_seq_len):
                break
            for S in eng._bucket_rungs(b):
                if S not in warmed:
                    warmed.add(S)
                    eng._warm_prefill_shapes(S)

    def group_prefill(self, items: list, chain_by_req: dict
                      ) -> list[GroupResult]:
        # group by padded bucket: each group is one [G2, S] call
        eng = self.eng
        groups: dict[int, list] = {}
        for item in items:
            groups.setdefault(eng._prefill_bucket(item[2]), []).append(item)
        by_id: dict[int, GroupResult] = {}
        for S, group in groups.items():
            for r in self._prefill_group(S, group, chain_by_req):
                by_id[id(r.req)] = r
        return [by_id[id(item[0])] for item in items]

    def _prefill_group(self, S: int, items: list, chain_by_req: dict
                       ) -> list[GroupResult]:
        """One ``[G2, S]`` prefill for a same-bucket group, G2 = G padded
        to a power of two. Padding rows have length 0: their K/V go to
        the dump page and their sampled token is ignored."""
        eng = self.eng
        cfg = eng.cfg
        G = len(items)
        G2 = 1
        while G2 < G:
            G2 *= 2
        P = cfg.max_pages_per_seq
        tokens = np.zeros((G2, S), np.int32)
        seq_lens = np.zeros((G2,), np.int32)
        pt = np.zeros((G2, P), np.int32)
        t0 = time.monotonic()
        self._observe_admission(items, chain_by_req, lambda it: S)
        by_row = {}
        for g, (req, seq_id, n, _total) in enumerate(items):
            tokens[g, :n] = req.prompt
            seq_lens[g] = n
            pages = eng.allocator.pages(seq_id)
            pt[g, :len(pages)] = pages
            by_row[g] = (req, seq_id)
        sampling = self._sampling_rows(by_row, G2)
        dev = eng.device
        out, moe = eng._prefill_step(
            eng.fns.prefill, tuple(torch.from_numpy(a).to(dev)
                                   for a in (tokens, seq_lens, pt)),
            sampling)
        host = [_unpack_row(out, g) for g in range(G)]
        eng._fold_moe(moe)  # settled with the tokens just read
        real = int(seq_lens.sum())
        self._account(real, G2 * S)
        prefill_ms = 1e3 * (time.monotonic() - t0)
        eng.stats.prefill_ms += prefill_ms
        eng.stats.note_prefill_call(prefill_ms, real)
        adapter = sampling[5].tolist()
        results = []
        for g, (req, seq_id, n, total) in enumerate(items):
            eng.phases.observe("prefill", prefill_ms, trace_id_of(req))
            if req.trace is not None:
                req.trace.prefill(prefill_ms, bucket=S, group=G)
            results.append(GroupResult(
                req=req, seq_id=seq_id, n=n, total=total, tok=host[g][0],
                first_lp=host[g][1], page_row=pt[g],
                adapter_row=adapter[g]))
        logger.debug("batched prefill G=%d S=%d %.1fms", G, S, prefill_ms)
        return results

    def single_prefill(self, req, seq_id: int, suffix: list[int],
                       prefix_len: int, page_row: np.ndarray, total: int,
                       mask: np.ndarray | None = None):
        eng = self.eng
        cfg = eng.cfg
        dev = eng.device
        ns = len(suffix)
        n = prefix_len + ns
        sampling = self._sampling_rows({0: (req, seq_id)}, 1, mask)
        pt = torch.from_numpy(page_row[None, :]).to(dev)
        # the gather window of the suffix steps: the power-of-two page
        # bucket covering the sequence, not the max_seq_len window
        pt_win = pt[:, :eng._pow2_pages(eng.allocator.pages_for(total))]
        tick_ms = 0.0
        moe = None
        # chunked prefill: a long prompt runs as fixed-size suffix steps
        # with a decode tick between them, so live streams keep emitting
        # behind it; each boundary is a cancellation/shutdown yield point
        chunk = cfg.prefill_chunk_tokens
        consumed = 0
        while chunk > 0 and ns - consumed > chunk:
            if req.cancelled.is_set() or eng._stop.is_set():
                if eng._stop.is_set():
                    return ("stop_consumed" if req.cancelled.is_set()
                            else "stop")
                return "skipped"
            start = prefix_len + consumed
            ctokens = torch.tensor([suffix[consumed:consumed + chunk]],
                                   dtype=torch.int32, device=dev)
            _, cmoe = eng._prefill_step(
                eng.fns.prefill_suffix,
                (ctokens, _rows(dev, start), _rows(dev, start + chunk),
                 pt_win), sampling)
            moe = cmoe if moe is None else moe + cmoe
            consumed += chunk
            self._account(chunk, chunk)
            eng.stats.chunked_prefill_steps += 1
            if req.trace is not None:
                req.trace.event("prefill_chunk", tokens=chunk,
                                consumed=prefix_len + consumed)
            t_tick = time.monotonic()
            eng._decode_tick()
            tick_ms += 1e3 * (time.monotonic() - t_tick)
        eff_prefix = prefix_len + consumed
        tail = suffix[consumed:]
        ns_tail = len(tail)
        S = eng._prefill_bucket(ns_tail)
        tokens = np.zeros((1, S), np.int32)
        tokens[0, :ns_tail] = tail
        tokens = torch.from_numpy(tokens).to(dev)
        if eff_prefix:
            out, tmoe = eng._prefill_step(
                eng.fns.prefill_suffix,
                (tokens, _rows(dev, eff_prefix), _rows(dev, n), pt_win),
                sampling)
        else:
            out, tmoe = eng._prefill_step(
                eng.fns.prefill, (tokens, _rows(dev, n), pt), sampling)
        tok, first_lp = _unpack_row(out, 0)
        # the chunks' routing counts settle with the tail's token
        eng._fold_moe(tmoe if moe is None else moe + tmoe)
        self._account(ns_tail, S)
        return tok, {
            "first_lp": first_lp, "consumed": consumed,
            "tick_ms": tick_ms, "bucket": S,
            "chunks": consumed // chunk if chunk else 0,
            "padded_frac": round(1.0 - ns_tail / S, 3) if S else 0.0}


class RaggedPrefillBackend(AttentionBackend):
    """Token-budget-packed prefill over K1 — any batch geometry."""

    name = "pallas-ragged"
    packs_long_prompts = True

    def __init__(self, engine: "Engine") -> None:
        super().__init__(engine)
        logger.info("attention backend pallas-ragged: %s, chunk=%d, "
                    "budget=%d tokens, rungs=%s", engine.attn_reason,
                    engine.cfg.ragged_chunk_tokens, self.budget,
                    self.rungs())

    # -- token-budget ladder ----------------------------------------------
    def rungs(self) -> list[int]:
        """Padded packed-length rungs: two sub-chunk rungs plus every
        chunk multiple up to the per-call budget."""
        c = self.eng.cfg.ragged_chunk_tokens
        rungs = {max(8, c // 4), max(8, c // 2)}
        r = c
        while r <= self.budget:
            rungs.add(r)
            r += c
        return sorted(rungs)

    def _rung_for(self, t: int) -> int:
        for r in self.rungs():
            if r >= t:
                return r
        return self.rungs()[-1]

    @property
    def budget(self) -> int:
        return (self.eng.cfg.ragged_chunk_tokens
                * self.eng.cfg.ragged_max_chunks)

    def warm(self) -> None:
        """Every rung of the token-budget ladder with a zero-token pack
        (all rows padding: their K/V go to the dump page), the
        reference's warm: any admission whose packed total fits the
        budget then replays a captured program. A quantized pool's
        windowed prefill runs eagerly (``Engine._prefill_step``), so it
        has nothing to capture."""
        eng = self.eng
        if eng.cfg.warm_prefill_buckets <= 0 or is_quantized_dtype(
                eng.cfg.kv_cache_dtype):
            return
        B = eng.cfg.max_batch_size
        P = eng.cfg.max_pages_per_seq
        dev = eng.device
        dummy = self._sampling_rows({}, B)
        for T in self.rungs():
            eng._prefill_step(eng.fns.prefill_ragged, (
                torch.zeros((T,), dtype=torch.int32, device=dev),
                torch.full((T,), B, dtype=torch.int32, device=dev),
                torch.zeros((T,), dtype=torch.int32, device=dev),
                torch.zeros((B,), dtype=torch.int32, device=dev),
                torch.zeros((B, P), dtype=torch.int32, device=dev)), dummy)

    # -- packing core ------------------------------------------------------
    def _run_packed(self, segs: list[_Seg], sampling_args: tuple,
                    cancellable: Any = None):
        """Run the segments through budget-sized packed calls. Returns
        ({row g → device tokens of the call that finished g}, info; the
        calls' summed routing counts on the device in ``info["moe"]``,
        None on a dense family), or
        an abort status string (only with ``cancellable``, the single
        path's request, cancelled or the engine stopping at a budget
        boundary: "skipped", "stop" or "stop_consumed" as the engine's
        ``_admit_one`` returns them)."""
        eng = self.eng
        cfg = eng.cfg
        dev = eng.device
        B = cfg.max_batch_size
        P = cfg.max_pages_per_seq
        pt = np.zeros((B, P), np.int32)
        for s in segs:
            pt[s.g] = s.page_row[:P]
        pt_dev = torch.from_numpy(pt).to(dev)
        final_out: dict[int, torch.Tensor] = {}
        macc = None
        calls = 0
        tick_ms = 0.0
        real = padded = 0
        T = 0
        while True:
            call: list[tuple[_Seg, int]] = []  # (seg, take)
            t_used = 0
            for s in segs:
                rem = len(s.tokens) - s.done
                if rem <= 0:
                    continue
                take = min(rem, self.budget - t_used)
                if take <= 0:
                    break
                call.append((s, take))
                t_used += take
                if t_used >= self.budget:
                    break
            if not call:
                break
            if calls > 0:
                # budget boundary: cancellation/shutdown yield point and
                # decode interleave (chunked-prefill liveness — live
                # streams keep decoding)
                if cancellable is not None and (
                        cancellable.cancelled.is_set()
                        or eng._stop.is_set()):
                    if eng._stop.is_set():
                        return ("stop_consumed"
                                if cancellable.cancelled.is_set()
                                else "stop")
                    return "skipped"
                t_tick = time.monotonic()
                eng._decode_tick()
                tick_ms += 1e3 * (time.monotonic() - t_tick)
            T = self._rung_for(t_used)
            tokens = np.zeros((T,), np.int32)
            row_seq = np.full((T,), B, np.int32)
            positions = np.zeros((T,), np.int32)
            last_rows = np.zeros((B,), np.int32)
            o = 0
            for s, take in call:
                tokens[o:o + take] = s.tokens[s.done:s.done + take]
                row_seq[o:o + take] = s.g
                positions[o:o + take] = s.start + s.done + np.arange(
                    take, dtype=np.int32)
                last_rows[s.g] = o + take - 1
                s.done += take
                o += take
            next_tok, moe = eng._prefill_step(
                eng.fns.prefill_ragged,
                (*(torch.from_numpy(a).to(dev)
                   for a in (tokens, row_seq, positions, last_rows)),
                 pt_dev), sampling_args)
            macc = moe if macc is None else macc + moe
            calls += 1
            real += t_used
            padded += T
            for s, take in call:
                if s.done == len(s.tokens):
                    final_out[s.g] = next_tok
                elif s.req.trace is not None:
                    s.req.trace.event("prefill_chunk", tokens=take,
                                      consumed=s.start + s.done)
        # intermediate budget-boundary device steps
        eng.stats.chunked_prefill_steps += max(0, calls - 1)
        self._account(real, padded)
        return final_out, {
            "tick_ms": tick_ms, "calls": calls, "chunks": calls - 1,
            "real": real, "padded": padded, "moe": macc, "bucket": T,
            "padded_frac": (round(1.0 - real / padded, 3) if padded
                            else 0.0)}

    # -- interface ---------------------------------------------------------
    def group_prefill(self, items: list, chain_by_req: dict
                      ) -> list[GroupResult]:
        """Prefill ``items`` ((req, seq_id, n, total) with pages already
        allocated) as one packed stream; returns results in item order
        (the engine creates the slots and inserts each prompt's
        ``chain_by_req[id(req)]`` into the prefix cache)."""
        eng = self.eng
        t0 = time.monotonic()
        self._observe_admission(items, chain_by_req, lambda it: None)
        segs = []
        by_row = {}
        for g, (req, seq_id, _n, _total) in enumerate(items):
            pages = eng.allocator.pages(seq_id)
            page_row = np.zeros((eng.cfg.max_pages_per_seq,), np.int32)
            page_row[: len(pages)] = pages
            segs.append(_Seg(g=g, req=req, tokens=req.prompt, start=0,
                             page_row=page_row))
            by_row[g] = (req, seq_id)
        final_out, info = self._run_packed(
            segs, self._sampling_rows(by_row, eng.cfg.max_batch_size))
        host = {g: _unpack_row(out, g) for g, out in final_out.items()}
        eng._fold_moe(info["moe"])  # settled with the tokens just read
        prefill_ms = max(0.0, 1e3 * (time.monotonic() - t0)
                         - info["tick_ms"])
        eng.stats.prefill_ms += prefill_ms
        eng.stats.note_prefill_call(prefill_ms, info["real"])
        for req, _sid, _n, _total in items:
            eng.phases.observe("prefill", prefill_ms, trace_id_of(req))
            if req.trace is not None:
                req.trace.prefill(
                    prefill_ms, bucket=info["bucket"], group=len(items),
                    padded_frac=info["padded_frac"],
                    chunks=info["chunks"])
        logger.debug("ragged prefill G=%d tokens=%d padded=%d calls=%d",
                     len(items), info["real"], info["padded"],
                     info["calls"])
        return [GroupResult(req=req, seq_id=seq_id, n=n, total=total,
                            tok=host[s.g][0], first_lp=host[s.g][1],
                            page_row=s.page_row,
                            adapter_row=eng._adapter_row_of(req))
                for s, (req, seq_id, n, total) in zip(segs, items)]

    def single_prefill(self, req, seq_id: int, suffix: list[int],
                       prefix_len: int, page_row: np.ndarray, total: int,
                       mask: np.ndarray | None = None):
        """One segment at row 0 of the packed calls, its sampling row
        (its adapter row with it) at row 0 of the ``[B]`` layout."""
        seg = _Seg(g=0, req=req, tokens=suffix, start=prefix_len,
                   page_row=page_row)
        res = self._run_packed(
            [seg], self._sampling_rows({0: (req, seq_id)},
                                       self.eng.cfg.max_batch_size, mask),
            cancellable=req)
        if isinstance(res, str):
            return res
        final_out, info = res
        info["consumed"] = 0  # the packed calls ran the whole suffix
        tok, info["first_lp"] = _unpack_row(final_out[0], 0)
        self.eng._fold_moe(info["moe"])  # settled with the token
        return tok, info


def _rows(dev: torch.device, v: int) -> torch.Tensor:
    """A one-row ``[1]`` int32 length/offset tensor on ``dev``."""
    return torch.tensor([v], dtype=torch.int32, device=dev)


def _unpack_row(out: Any, g: int) -> tuple[int, tuple | None]:
    """(token, first_lp) of row g of one packed call's output: a [B]
    token tensor, or with logprobs on (tokens, chosen, top ids, top
    values)."""
    if not isinstance(out, tuple):
        return int(out[g].item()), None
    toks, chosen, ids, vals = (t[g].tolist() for t in out)
    return toks, (chosen, list(zip(ids, vals)))


def resolve_attention_backend(cfg, device: torch.device) -> tuple[str, str]:
    """The prefill half of the fallback matrix: (resolved backend, WHY).
    ``prefill_ragged`` picks the attention from the pool it is given.

    | requested     | kv dtype  | device | resolved      | attention |
    |---------------|-----------|--------|---------------|-----------|
    | xla-bucketed  | any       | any    | xla-bucketed  | dense, plain PyTorch (the reference's XLA) |
    | pallas-ragged | native    | cuda   | pallas-ragged | K1 CUDA kernel |
    | pallas-ragged | native    | cpu    | pallas-ragged | K1 plain PyTorch |
    | pallas-ragged | int8/int4 | any    | pallas-ragged | windowed program, plain PyTorch (dequant at the read) |
    """
    if cfg.attention_backend != "pallas-ragged":
        return "xla-bucketed", "requested"
    if is_quantized_dtype(cfg.kv_cache_dtype):
        return "pallas-ragged", (
            f"windowed program: {cfg.kv_cache_dtype} KV pages — the ragged "
            "prefill kernel has no quantized-pool rung (nor has the "
            "reference's), so the windowed program dequantizes prefix "
            "pages at the read, in plain PyTorch on every device")
    return "pallas-ragged", ("CUDA kernel (single GPU)"
                             if device.type == "cuda"
                             else "plain PyTorch version (device=cpu)")


def resolve_decode_backend(cfg, device: torch.device) -> tuple[str, str]:
    """The decode half of the fallback matrix: (resolved decode rung,
    WHY), exported on /state as ``decode_attn_impl`` /
    ``decode_attn_reason``. ``auto`` requests the chained rung, as in
    the reference; ``pallas_attn`` names the chained kernel.

    | requested           | kv dtype  | device | resolved       |
    |---------------------|-----------|--------|----------------|
    | auto/chained        | any       | cuda   | gather-cuda    |
    | auto/chained        | any       | cpu    | gather-torch   |
    | auto/chained + pallas_attn | native | cuda | chained-cuda |
    | auto/chained + pallas_attn | native | cpu  | chained-torch |
    | auto/chained + pallas_attn | int8/int4 | any | fused-* (the chained kernel has no quantized rung) |
    | fused               | any       | cuda   | fused-cuda     |
    | fused               | any       | cpu    | fused-torch    |

    The gather rung gathers each slot's page window (an int8/int4 pool
    dequantized at the gather) and runs dense attention in plain
    PyTorch on every device, as the reference runs it in XLA; ``-cuda``
    says it runs on the card. On a quantized pool the fused rung is K7,
    the fused kernel's int8/int4 rung.
    """
    where = "cuda" if device.type == "cuda" else "torch"
    how = ("CUDA kernel" if device.type == "cuda"
           else "plain PyTorch version (device=cpu)")
    quant = is_quantized_dtype(cfg.kv_cache_dtype)
    req = "chained" if cfg.decode_backend == "auto" else cfg.decode_backend
    if req == "chained" and not (cfg.pallas_attn and quant):
        if cfg.pallas_attn:
            return f"chained-{where}", (
                f"pallas_attn requested: RoPE and scatter, then the chained "
                f"paged-attention {how}")
        if quant:
            return f"gather-{where}", (
                f"default chained path; {cfg.kv_cache_dtype} KV pages "
                "dequantize against their per-page scales at the window "
                "gather")
        return f"gather-{where}", "default (pallas_attn off)"
    pool = (f" ({cfg.kv_cache_dtype} pages dequantized in the kernel)"
            if quant else "")
    if req == "fused":
        return f"fused-{where}", (
            f"decode_backend=fused: RoPE + KV append + paged attention in "
            f"one launch per layer{pool}, {how}")
    return f"fused-{where}", (
        f"pallas_attn requested with {cfg.kv_cache_dtype} KV pages: the "
        f"chained kernel has no quantized rung, so the fused rung "
        f"serves{pool}, {how}")


def make_attention_backend(engine: "Engine") -> AttentionBackend:
    """Resolve the prefill backend (logged, exported on /state)."""
    resolved, engine.attn_reason = resolve_attention_backend(
        engine.cfg, engine.device)
    if resolved == "pallas-ragged":
        return RaggedPrefillBackend(engine)
    return XlaBucketedBackend(engine)
