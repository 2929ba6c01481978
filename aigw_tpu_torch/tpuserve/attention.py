"""Prefill backend and the attention resolvers (counterpart of
``aigw_tpu/tpuserve/attention.py``).

This slice has one prefill backend, the ragged one: a mixed-length
admission burst packs into one call sized by its total tokens, padded
only to a token-budget rung (multiples of ``ragged_chunk_tokens`` plus
two sub-chunk rungs); bursts larger than ``ragged_chunk_tokens x
ragged_max_chunks`` split at budget boundaries with decode ticks
interleaved. Attention runs K1 (``ops.paged_attention.
ragged_prefill_attention``): the CUDA kernel on CUDA tensors, its plain
version on CPU tensors. An int8/int4 KV pool prefills through the
windowed program instead (plain PyTorch, as in the reference, whose
kernel has no quantized rung either).

Both resolvers export what the replica actually runs, and why, on
``/state`` (``attention_backend_reason``, ``decode_attn_impl``,
``decode_attn_reason``) — reduced to the rows this slice has.
``group_prefill`` serves batched admissions and ``single_prefill`` the
per-request path, which resumes a prefix-cache hit at its cached offset
as one packed segment at absolute positions (a full hit is one row at
n - 1). The bucketed prefill backend, the gather decode rung and
``sp_chunked_prefill`` wait for later slices (ROADMAP queue 1).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any

import numpy as np
import torch

from aigw_tpu_torch.models.kvq import is_quantized_dtype

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


@dataclass
class _Seg:
    """One sequence's prompt segment in the packed stream."""

    g: int  # row of the [B]-wide page table / sampling arrays
    req: Any
    tokens: list[int]
    start: int  # absolute position of tokens[0]
    page_row: np.ndarray  # [max_pages_per_seq] int32
    done: int = 0  # tokens already packed into earlier calls


class RaggedPrefillBackend:
    """Token-budget-packed prefill over K1 — any batch geometry."""

    name = "pallas-ragged"

    def __init__(self, engine: "Engine") -> None:
        self.eng = engine
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

    # -- packing core ------------------------------------------------------
    def _run_packed(self, segs: list[_Seg], sampling_args: tuple,
                    cancellable: Any = None):
        """Run the segments through budget-sized packed calls. Returns
        ({row g → device tokens of the call that finished g}, info), or
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
        calls = 0
        tick_ms = 0.0
        real = padded = 0
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
            next_tok = eng._prefill_ragged_step(
                *(torch.from_numpy(a).to(dev)
                  for a in (tokens, row_seq, positions, last_rows)),
                pt_dev, *sampling_args)
            calls += 1
            real += t_used
            padded += T
            for s, _take in call:
                if s.done == len(s.tokens):
                    final_out[s.g] = next_tok
        # intermediate budget-boundary device steps
        eng.stats.chunked_prefill_steps += max(0, calls - 1)
        eng.stats.prefill_tokens_real += real
        eng.stats.prefill_tokens_padded += padded
        return final_out, {"tick_ms": tick_ms, "calls": calls,
                           "real": real, "padded": padded}

    def _sampling_rows(self, by_row: dict[int, tuple]) -> tuple:
        """[B]-wide sampling tensors from ``row → (req, seq_id)``: the
        prefill token samples with key ``[seed or seq_id, 0]``."""
        eng = self.eng
        B = eng.cfg.max_batch_size
        V = eng.model_cfg.vocab_size
        keys = np.zeros((B, 2), np.int64)
        temp = np.zeros((B,), np.float32)
        top_p = np.ones((B,), np.float32)
        top_k = np.zeros((B,), np.int32)
        bias = np.zeros((B, V), np.float32)
        for g, (req, seq_id) in by_row.items():
            keys[g, 0] = (req.sampling.seed or seq_id) & 0xFFFFFFFF
            temp[g] = req.sampling.temperature
            top_p[g] = req.sampling.top_p
            top_k[g] = req.sampling.top_k
            for tok_id, b in req.sampling.logit_bias:
                if 0 <= tok_id < V:
                    bias[g, tok_id] = b
        dev = eng.device
        return tuple(torch.from_numpy(a).to(dev)
                     for a in (keys, temp, top_p, top_k, bias))

    # -- interface ---------------------------------------------------------
    def group_prefill(self, items: list, chain_by_req: dict
                      ) -> list[GroupResult]:
        """Prefill ``items`` ((req, seq_id, n, total) with pages already
        allocated) as one packed stream; returns results in item order
        (the engine creates the slots and inserts each prompt's
        ``chain_by_req[id(req)]`` into the prefix cache)."""
        eng = self.eng
        t0 = time.monotonic()
        for req, _sid, _n, _total in items:
            eng.phases.observe("queue_wait", 1e3 * (t0 - req.enqueued_at))
        segs = []
        by_row = {}
        for g, (req, seq_id, _n, _total) in enumerate(items):
            pages = eng.allocator.pages(seq_id)
            page_row = np.zeros((eng.cfg.max_pages_per_seq,), np.int32)
            page_row[: len(pages)] = pages
            segs.append(_Seg(g=g, req=req, tokens=req.prompt, start=0,
                             page_row=page_row))
            by_row[g] = (req, seq_id)
        final_out, info = self._run_packed(segs, self._sampling_rows(by_row))
        host = {g: out.cpu().numpy() for g, out in final_out.items()}
        prefill_ms = max(0.0, 1e3 * (time.monotonic() - t0)
                         - info["tick_ms"])
        eng.stats.prefill_ms += prefill_ms
        eng.stats.note_prefill_call(prefill_ms, info["real"])
        for _item in items:
            eng.phases.observe("prefill", prefill_ms)
        logger.debug("ragged prefill G=%d tokens=%d padded=%d calls=%d",
                     len(items), info["real"], info["padded"],
                     info["calls"])
        return [GroupResult(req=req, seq_id=seq_id, n=n, total=total,
                            tok=int(host[s.g][s.g]), page_row=s.page_row)
                for s, (req, seq_id, n, total) in zip(segs, items)]

    def single_prefill(self, req, seq_id: int, suffix: list[int],
                       prefix_len: int, page_row: np.ndarray):
        """Prefill one request's ``suffix`` at absolute position
        ``prefix_len`` (0, a cached page-aligned prefix, or n - 1 after a
        full hit) as one segment at row 0 of the packed calls, its
        sampling row at row 0 of the ``[B]`` layout. Returns (first token,
        info) or an abort status string (see ``_run_packed``)."""
        seg = _Seg(g=0, req=req, tokens=suffix, start=prefix_len,
                   page_row=page_row)
        res = self._run_packed([seg], self._sampling_rows({0: (req, seq_id)}),
                               cancellable=req)
        if isinstance(res, str):
            return res
        final_out, info = res
        return int(final_out[0].cpu().numpy()[0]), info


def resolve_attention_backend(cfg, device: torch.device) -> tuple[str, str]:
    """The prefill half of the fallback matrix: (resolved backend, WHY).
    ``prefill_ragged`` picks the attention from the pool it is given.

    | requested     | kv dtype  | device | resolved      | attention |
    |---------------|-----------|--------|---------------|-----------|
    | xla-bucketed  | any       | any    | pallas-ragged | as below (bucketed not ported) |
    | pallas-ragged | native    | cuda   | pallas-ragged | K1 CUDA kernel |
    | pallas-ragged | native    | cpu    | pallas-ragged | K1 plain PyTorch |
    | pallas-ragged | int8/int4 | any    | pallas-ragged | windowed program, plain PyTorch (dequant at the read) |
    """
    if is_quantized_dtype(cfg.kv_cache_dtype):
        impl = (
            f"windowed program: {cfg.kv_cache_dtype} KV pages — the ragged "
            "prefill kernel has no quantized-pool rung (nor has the "
            "reference's), so the windowed program dequantizes prefix "
            "pages at the read, in plain PyTorch on every device")
    else:
        impl = ("CUDA kernel (single GPU)" if device.type == "cuda"
                else "plain PyTorch version (device=cpu)")
    if cfg.attention_backend != "pallas-ragged":
        return "pallas-ragged", (
            f"{cfg.attention_backend} is not ported yet (ROADMAP queue 1): "
            f"the ragged backend serves every prefill; {impl}")
    return "pallas-ragged", impl


def resolve_decode_backend(cfg, device: torch.device) -> tuple[str, str]:
    """The decode half of the fallback matrix: (resolved decode rung,
    WHY), exported on /state as ``decode_attn_impl`` /
    ``decode_attn_reason``.

    | requested               | kv dtype  | device | resolved       |
    |-------------------------|-----------|--------|----------------|
    | fused (any pallas_attn) | any       | cuda   | fused-cuda     |
    | fused (any pallas_attn) | any       | cpu    | fused-torch    |
    | auto/chained+pallas_attn| native    | cuda   | chained-cuda   |
    | auto/chained+pallas_attn| native    | cpu    | chained-torch  |
    | auto/chained+pallas_attn| int8/int4 | any    | fused-* (the chained kernel has no quantized rung) |
    | auto                    | any       | any    | fused-* (the gather rung is not ported) |
    | chained                 | any       | any    | NotImplementedError (gather rung) |

    On a quantized pool the fused rung is K7, the fused kernel's
    int8/int4 rung.
    """
    where = "cuda" if device.type == "cuda" else "torch"
    how = ("CUDA kernel" if device.type == "cuda"
           else "plain PyTorch version (device=cpu)")
    quant = is_quantized_dtype(cfg.kv_cache_dtype)
    pool = (f" ({cfg.kv_cache_dtype} pages dequantized in the kernel)"
            if quant else "")
    req = cfg.decode_backend
    if req == "fused":
        return f"fused-{where}", (
            f"decode_backend=fused: RoPE + KV append + paged attention in "
            f"one launch per layer{pool}, {how}")
    if cfg.pallas_attn and quant:
        return f"fused-{where}", (
            f"pallas_attn requested with {cfg.kv_cache_dtype} KV pages: "
            f"the chained kernel has no quantized rung, so the fused rung "
            f"serves{pool}, {how}")
    if cfg.pallas_attn:
        return f"chained-{where}", (
            f"pallas_attn requested: RoPE and scatter, then the chained "
            f"paged-attention {how}")
    if req == "chained":
        raise NotImplementedError(
            "decode_backend=chained without pallas_attn selects the XLA "
            "gather rung, which is ROADMAP queue 1 (gather rung and "
            "bucketed prefill)")
    return f"fused-{where}", (
        "decode_backend=auto: the gather rung is not ported yet (ROADMAP "
        f"queue 1), so auto takes the fused rung{pool}, {how}")


def make_attention_backend(engine: "Engine") -> RaggedPrefillBackend:
    """Resolve the prefill backend (logged, exported on /state)."""
    resolved, engine.attn_reason = resolve_attention_backend(
        engine.cfg, engine.device)
    if engine.cfg.attention_backend != resolved:
        logger.warning("attention backend %s resolves to %s: %s",
                       engine.cfg.attention_backend, resolved,
                       engine.attn_reason)
    return RaggedPrefillBackend(engine)
