#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions;
2. build the hand-written CUDA kernels from ``aigw_tpu_torch/csrc``
   (nvcc, sm_90a), timed;
3. serve Llama-3-8B widths (32 layers, dim 4096, 32/8 heads, vocab
   128256) with seeded random bf16 weights through the port's HTTP
   server: concurrent chat and completion requests, streamed and not,
   prompts from a few tokens to ~1000, 64 new tokens each, on the ragged
   prefill kernel (K1) and the fused decode kernel (K2); then the engine
   restarted on the chained decode rung runs the paged-attention decode
   kernel (K3). Every kernel's launch count over the served run must be
   above zero. The burst is served again on the warm server, then a
   third time under ``torch.profiler`` (the ``serve`` JSON line: cold
   and warm wall times, the warm burst's prefill and TTFT p50 and p95
   from ``/state``'s ``phase_percentiles``, the device's busy share
   while serving). These phases and the ones below run with the prefix
   cache off unless said otherwise, so their lines measure what they
   measured before it was ported;
   prefix caching, on the fused rung (the ``serve_prefix`` line): burst
   A, one chat behind a shared system message whose rendered prompts
   agree on 1089 tokens (8 full pages and part of the 9th, counted with
   ``/tokenize``); burst B, seven chats behind it (partial hits resumed
   at 1024 through K1, each with ``cached_tokens`` 1024); burst C, a
   1024-token completion sent twice (a miss, then a full hit: the last
   page copied on write, one row resumed at 1023, the shared page
   byte-equal to its state before, the copy to its source). ``/state``
   must count 8 hits, 1 full hit, 1 copy, 2 misses and 7 x 1024 + 1023
   reused tokens; B's geometry again with fresh user turns sent one at
   a time for one token each (each prefill alone on an idle engine,
   ``serial_prefill_ms``); then all of it with the cache off, B's
   prefill and TTFT beside the cache on's, and how many greedy streams
   the two share (reported, not gated: bf16 on the card is not
   bit-stable across call shapes);
   grammar-constrained decoding, on the fused rung with the prefix cache
   on (the ``serve_constrained`` line): the grammars compiled in process
   (timed), a warm-up request caching the shared system message's two
   pages, then a burst of 8 chats (256 new tokens at most): two
   ``json_schema`` (a nested object with an enum; an array of at most 3
   strings), one seeded ``json_object`` body sent streamed and not, a
   required and a named tool call over two functions, ``tool_choice:
   "auto"`` and a plain request. Every schema and tool reply must finish
   with ``stop`` or ``tool_calls``, parse and validate; a ``json_object``
   reply that runs to ``length`` must be a prefix the grammar accepts;
   ``constraint_requests`` must rise by exactly 6 and rollbacks be
   above 0; K1 and K2 must launch; the two ``json_object`` replies, and a
   seeded tool call sent both ways, must be equal. Then the chained rung
   at a fixed draft width of 4: two greedy schema replies beside two
   pinned requests (K5), one seeded schema reply alone (K3); both must
   launch and drafts be accepted;
   speculative decoding on the same weights: the chained rung with a
   fixed draft width of 4, so every window verifies through K5 at S = 5,
   serving the burst plus two greedy requests pinned to one token by
   ``logit_bias`` (drafts proposed and accepted; the ``serve_spec``
   line), then the fused rung with the adaptive ladder, whose verify
   takes the gather path (K5 must not launch) and whose plain windows
   run K2 (the ``serve_spec_fused`` line); between them the chained
   rung at width 4 with the prefix cache on, where a prompt cut partway
   into the second page of an earlier one gets the earlier prompt's
   continuation as lookahead drafts, verified through K5 (the
   ``serve_spec_prefix`` line);
4. quantized serving on the same server: the same bf16 weights
   quantized to int8 on the card (W8A16) over an int8 KV pool, fused
   decode. The burst cold and warm (the ``serve_quant`` JSON line: wall
   times, ``/state``'s KV byte gauges, launches per kernel): the W8A16
   matmul (K6) and the fused decode's int8 rung (K7-int8) must launch,
   K1 and K2 must not (quantized pools prefill through the windowed
   program and decode through K7). Then bursts A-C over int8 pages with
   the prefix cache on (the ``serve_prefix_int8`` line: the same counts,
   the copied page's q and scale rows equal to their source's), and two
   requests over an int4 KV pool, which must launch K7-int4;
   the reference's default programs (the ``serve_defaults`` line, after
   ``serve_int4_kv``; launch counts zeroed before each burst, read after
   it): a replica built from ``EngineConfig()`` with only the geometry
   set (8 slots x 2048, 128-token pages), so the bucket-ladder prefill
   (``xla-bucketed``, prompts over 256 tokens chunked with decode ticks
   between chunks) and the gather decode rung, with the prefix cache on,
   serving the burst plus two pinned requests cold and warm, bf16 and
   then W8A16 over int8 pages, each after the same burst on the
   ``pallas-ragged`` + ``fused`` replica. Gates: ``/state`` resolves
   ``xla-bucketed`` and ``gather-cuda``, ``chunked_prefill_steps`` > 0,
   K1, K2 and K3 launch no time, K6 launches in the W8A16 run, every
   stream equals the kernel path's of the same prompt or parts from it
   at a near-tie (``tie_check``), and the pinned texts are equal.
   Reported: wall times, the warm burst's prefill and TTFT p50/p95,
   ``prefill_padded_frac``, the device's busy share (bf16);
   ``/v1/embeddings`` on that replica (the ``embeddings`` line): 8 inputs
   (strings and token ids, 3-1022 tokens), bf16 and W8A16, then 8 of at
   most 8 tokens in W8A16, each served vector held against
   ``hidden_states`` of the same tokens on the card (bf16 against a
   float32 pass within ``EMBED_REL_TOL`` relative L2 a vector; the long
   W8A16 call against ``plain=True`` per element, the route's check, as
   no matmul at M 8192 takes K6; the short one, M 64, K6 against its
   plain version within ``EMBED_REL_TOL``), the call's ms and the
   device's peak memory;
   multi-LoRA (the ``serve_lora`` line; launch counts zeroed before it,
   read after it): a zoo of 4 adapters at the reference's default
   ``LoRAConfig()`` (wq and wv, rank 16) over 2 device rows, the fused
   rung with the prefix cache on, the burst cold and warm with 6 of its
   8 requests on adapters (``<model>:<adapter>`` and a bare name): every
   request 200, ``<model>:nope`` a 404 with the reference's message on
   both routes streamed and not, ``/v1/models`` listing the zoo,
   ``/state`` counting at least 4 loads and 2 evictions, at most 2
   resident, no adapter slot when idle; K1 and K2 must launch. Then the
   chained rung at a fixed draft width of 4 (two pinned requests beside
   a sampled adapter request: K3 and K5, drafts accepted), then W8A16
   weights with the zoo (K6). Reported, not gated: an adapter's load
   time (wq + wv, and all seven targets), one decode step at batch 8
   with 8 adapter slots, 8 base slots and none, and one packed prefill
   of the burst's prompts with and without adapters;
   per-token logprobs, ``n > 1`` and tenant-fair admission (the
   ``serve_logprobs`` line, printed after ``model_check``; launch
   counts zeroed before it, read after it): bf16 weights and pool, the
   fused rung, the prefix cache on, ``logprobs_topk=20``; a burst of 8
   requests over the burst's prompts (two greedy chats with
   ``top_logprobs`` 5, two greedy legacy completions with ``logprobs``
   3, a sampled chat with ``n`` 4 and ``top_logprobs`` 2, a streamed
   completion with ``n`` 3, a greedy chat with ``n`` 2, one without
   logprobs; 14 engine requests) cold and warm (K1, K2), its first four
   on the chained rung (K3), then a sub-burst of tenants a x 6 and b x
   2 (``x-aigw-tenant``) at ``tenant_slot_cap=4`` with ``/state``
   polled throughout. Gates: one entry per completion token with ``k``
   alternates, sorted, <= 0, ``bytes`` the piece's UTF-8, each equal to
   the engine's own value; a greedy token its top-1 (or tied with it),
   its value the top-1's within 1e-5; one finish per streamed index;
   the ``n: 4`` choices not all equal, the greedy ``n: 2`` ones equal;
   the two greedy chats recomputed in float32 through the plain
   functions, each chosen logprob within twice ``model_check``'s bf16
   logit bound (0.1 x its logit scale) of the recompute and a top-1
   flip only at a recomputed top-2 gap under that bound; the tenant cap
   held at every poll, deferrals counted, ``ttft_hist_buckets``' +Inf
   count the sub-burst's 8 requests;
   the operations surface (the ``serve_ops`` line, after
   ``serve_logprobs``; launch counts zeroed before it, read after it):
   bf16, the fused rung, the prefix cache on, tracing on with the
   OTLP/HTTP exporter posting to a trace sink inside this script and a
   ``traceparent`` on every request. The burst with ``/metrics``
   scraped before, during and after it (every scrape parsed line by
   line, its families exactly the port's ``metric_families()``, a live
   slot seen during the burst, the TTFT buckets equal to ``/state``'s
   ``ttft_hist_buckets``, exemplars among the sent trace ids), the
   flight recorder's entries (trace id, tokens, admission, prefill and
   first token), each request's span in the sink with its ``gen_ai.*``
   attributes, and every reply's ``usage.aigw_meter`` reconciled with
   its usage and ``/state``'s ``meter_*`` deltas; the burst again with
   ``POST /drain`` once it decodes (new chat, completion and ``n = 2``
   requests 503 with ``retry-after: 2`` and ``x-aigw-draining: 1``,
   live ones 200 and whole, K2 launching after the drain, then
   ``{"on": false}``); ``/debug/profile`` around the burst (K1's and
   K2's kernels in the Chrome trace, its K2 events the K2 counter's
   delta, a second capture 409); the chained rung at a fixed draft
   width of 4 (the records' accepted drafts equal ``/state``'s, K3 and
   K5); the warm burst traced beside ``serve``'s (reported);
   KV mobility and the batch tier (the ``serve_mobility`` line, after
   ``serve_ops``; launch counts zeroed before each step, read after it):
   the server as replica A and a second server in this process on the
   same weight tensors as replica B, the fused rung, the prefix cache on.
   Four streamed chats (300-1000 prompt tokens, 64 new, two greedy, two
   seeded with penalties) served uncut on A, then again, each cut
   through A's ``/migrate/export`` and continued by B's
   ``/migrate/import``: B's pages equal the exported wire pages string
   for string, B launches K1 and K2, 4 migrations out and in, each
   stream equal to its uncut run up to a near-tie (``tie_check``); the
   same over int8 pools (pages gated, K7-int8 on B, streams reported);
   B fetching a chat's 9 full written pages (``serve_prefix``'s
   1089-token system message and a user turn) from A over ``/kv/pages``
   (``x-aigw-kv-peers``: one fetch, every page, a prefix hit over
   them); A on a 24-page pool with a host tier spilling a first wave of
   prompts under a second and reviving it (spills and revives, the
   revived pages equal the spilled bytes, the streams up to a
   near-tie); a ``/v1/batches`` job of 12 lines at ``batch_slot_frac``
   0.5 with the interactive burst sent while it runs (preemptions, all
   resumed, every line equal to its solo run up to a near-tie).
   Reported: export and import ms a page, wire MB a page, B's resume
   TTFT beside a cold prefill of the same history, the spill stall, the
   interactive TTFT beside ``serve``'s;
   every phase above serves through the engine's captured programs (a
   CUDA graph per decode window key and page bucket and per prefill
   shape, captured on first use; the launch counts are replays'); then
   a replica warmed ahead of traffic (the ``serve_graphs`` line,
   ``GRAPH_WARM``: the decode ladder at page buckets 1, 2 and 4 and the
   ragged prefill's token rungs): ``warmup_ms``, ``warm_programs`` and
   the graph pool's bytes, the burst with its prompts cut to 400 bytes
   (inside 4 pages) cold and warm with no capture after warm-up (gated),
   then the whole burst, whose longest sequences need the 16-page bucket
   (its captures counted), and again warm with none (gated); K1 and K2
   must launch;
5. every kernel against its plain PyTorch version on the card at the
   served shapes (each attention output element within 2**-7 of the
   plain output plus 2e-3, printed beside the mean |output|; K2's and
   K7's pool bytes equal), timed with CUDA events (L2 flushed between
   launches) beside the plain version and the kernel's roofline bound;
   every kernel also back to back over copies of its inputs above
   100 MB, replayed from a CUDA graph (``ms_rotated``: device time with
   no host time and no flush between launches, as a served step runs
   them), K6 twice on the same inputs (bit-identical: its split-K fold
   runs in split order);
   K4 (K3's body), which no engine path selects (nor the reference's),
   at K3's inputs and timed beside K3; K1 in bf16 (tensor cores) and in
   float32 (CUDA cores), its bytes and operations bounds side by side,
   beside one ``scaled_dot_product_attention`` call per sequence (flash
   backend, ``enable_gqa``) on contiguous copies of its keys, the
   library yardstick no part of K1 uses; K1 again at the prefix cache's
   resume geometry (7 suffixes of 150 rows at start 1024 and a full
   hit's one row at 1151, ``ragged_prefill_attention_resume``, its
   launches those of burst B); K5 at the served verify shapes
   (batch 8, S = 5, a slot that is off, windows across a page) and at
   S = 9 (two row groups per sequence and KV head, a window starting at
   -2);
   K6 at each of the five weight shapes a decode step multiplies, at
   M 8 and at a bucketed prefill's M 64 (the ``qmatmul_shapes`` JSON
   line), beside cuBLAS on the same weight dequantized to bf16 ahead of
   time; full-width prefill + 8 decode
   steps of the model through the kernels against the same through the
   plain versions, for bf16, for W8A16 over an int8 pool and for W4A16
   (whose matmuls are plain PyTorch in the reference too), the
   quantized ones also against the bf16 model's greedy tokens; one
   full-width verify step (width 5) through K5 against the same through
   its plain version (the ``model_check`` line's ``verify``); a prompt's
   8 pages prefilled, then its last 150 tokens resumed at 1024, and a
   full hit's copied page with its last token resumed at 1023, each
   against a cold prefill (``resume``); the default programs against the
   kernel path at Llama-3-8B widths and 2 layers, float32 and bf16
   (``defaults``: the bucketed prefill against K1, ``prefill_suffix`` at
   700 against a K1 resume, a gather decode step against K2; float32
   logits and written rows within the attention tolerance, bf16 the
   first layer's rows there and the logits as ``model_check`` holds
   them); K6 on the same programs in W8A16 at 2 layers, every matmul at
   M 64 or 2 through the kernel against ``plain=True``, over float32 and
   bf16 activations, held as ``defaults`` holds them
   (``defaults_w8a16``); LoRA at Llama-3-8B widths and 2
   layers, float32 and bf16, 4 adapters on all seven targets at rank 16
   and the base row mixed over 8 slots: a packed prefill (K1), 8 fused
   (K2) and 8 chained (K3) steps and a verify step (K5), dense and
   W8A16 (K6), kernels against plain versions at ``model_check``'s
   tolerances, the base rows bit-equal to the same calls with
   ``lora=None`` and every adapter row different
   (``model_check_lora``); K3, K4 and K5 beside one
   ``scaled_dot_product_attention`` call over the batch (efficient
   backend, a boolean mask, ``enable_gqa``), their library yardstick;
6. where one full-width decode step's time goes, bf16 on the fused and
   on the chained rung (K3) and W8A16 over int8 pages, and one verify
   step of width 5 through K5: its host wall time against the device
   time ``torch.profiler`` sees, by kernel (the ``decode_profile``,
   ``decode_profile_chained``, ``decode_profile_quant`` and
   ``verify_profile`` JSON lines; ``port_kernels_ms`` sums every K6,
   K2/K7 and K3 or K5 launch of the step), and the gather rung's step
   (``decode_profile_gather``); the same for one full-width
   bf16 prefill of the served burst's prompts, K1's 32 launches summed,
   beside the same prompts on the bucketed programs
   (``served_burst_bucketed``: 14 dense calls),
   and of a prefix-cache resume (150 rows at 1024) beside the same
   prompt's cold prefill (the ``prefill_profile`` line); the bf16 step
   with the engine's per-token logprobs (``log_softmax`` and
   ``topk(20)`` over the step's logits) against without, and the
   launches and host-copy bytes they add (``decode_profile_logprobs``);
   the captured programs (the ``graphs`` line): every program family's
   replay against its eager body at these widths, bit for bit (outputs,
   the decode state and every pool byte but the dump page's), bf16 on
   the kernel path (lean/full x greedy/sampled windows, the bucketed
   prefill, a suffix chunk, the ragged prefill), bf16 on the chained
   rung speculating at width 4 (K3 and K5 windows) and W8A16 over int8
   pages (K6 and K7 windows, the bucketed prefill and a chunk); the
   fused, gather, chained, W8A16 + int8 and verify steps and the burst's
   and a resume's prefill each captured and replayed beside the eager
   step, wall against device ms;
7. the mixtral family (the Llama weights freed first). At Mixtral-8x7B
   widths (dim 4096, 8 experts of ffn 14336, top-2, vocab 32000) and 2
   layers, in float32 and in bf16: a packed prefill of 4 sequences, 8
   fused and 8 chained decode steps and one verify step of width 5
   (K5), each through the kernels against the same call through the
   plain versions, with the ``[L, E + 1]`` routing counts compared
   (the ``model_check_moe`` line): in float32 every row routed
   differently must be a router near-tie (adjacent top-3 logits within
   1e-4; counted) and the other rows' logits agree within 2e-5; in
   bf16 routing differences are reported and the other rows' logits
   held to ``model_check``'s tolerance. Then Mixtral-8x7B served at
   full depth (32 layers, the ``serve_moe`` line): random weights
   drawn and quantized to int8 one tensor at a time (W8A16: the bf16
   model does not fit the card), a bf16 KV pool, the fused rung, the
   prefix cache on; the burst cold, then warm (its cached prefixes
   resumed through K1 at their offsets); K1, K2 and K6 must launch,
   the routing counts cover a whole number of layers x 2 and
   ``moe_expert_load`` has 8 entries; wall times, the warm burst's
   prefill and TTFT p50/p95, the dropped share, the expert imbalance,
   peak device memory and one decode step's time at batch 8; then the
   chained rung at a fixed draft width of 4 (two pinned requests of 32
   tokens and a sampled one of 64, which decodes on alone): K3 and K5
   must launch and drafts be accepted.
   K6 at Mixtral's lm_head shape (4096 x 32000) is on the
   ``qmatmul_shapes`` line;
8. the ``kernels`` JSON line (each row also carries its launches on
   ``serve_moe``, on ``serve_lora``, on ``serve_logprobs``, on
   ``serve_ops``, on ``serve_mobility``, on ``serve_graphs`` (the warm
   burst), on ``serve_defaults`` (bf16 and
   W8A16, the cold bursts) and on ``embeddings``), the card line, then
   the last line
   ``{"ok": true, "device": {...}}``.

Without CUDA, or outside the repository, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import gc
import itertools
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import traceback
import urllib.error
import urllib.request

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak
# bf16 attention output (K1-K5, K7), kernel vs plain, per element: one
# bf16 ulp of the plain output (2**-7 relative: the two float32 results
# may round to neighbouring bf16 values) plus 2e-3, set from K7's
# readings (max error 0.00049 against a mean |output| of ~0.038 at its
# long-context slots); each check prints the mean |output| it held
ATTN_RTOL, ATTN_ATOL = 2.0 ** -7, 2e-3
# K6 with bf16 x, kernel vs plain: one bf16 ulp of the output (2**-7
# relative; the two float32 sums, in different orders, may round to
# neighbouring bf16 values) plus float32 summation order over K (1e-5 of
# the output's scale)
QMM_RTOL, QMM_ATOL = 2.0 ** -7, 1e-5
SERVE_MAX_TOKENS = 64
# the weight shapes one Llama-3-8B decode step multiplies (K, N), and
# how many launches of each a step makes: wq/wo, wk/wv, gate/up, down
# per layer (x 32), the lm_head once; then Mixtral-8x7B's lm_head (its
# attention shapes are Llama-3-8B's), outside the Llama step (0)
QMM_STEP = [((4096, 4096), 64), ((4096, 1024), 64), ((4096, 14336), 64),
            ((14336, 4096), 32), ((4096, 128256), 1), ((4096, 32000), 0)]
T0 = time.monotonic()


def log(msg: str) -> None:
    print(f"[{time.monotonic() - T0:7.1f}s] {msg}", flush=True)


def fail(msg: str, code: int = 1) -> None:
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(code)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of fn() in ms; the 50 MB L2 is flushed before
    each launch (a decode layer finds its KV cold)."""
    import torch

    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        scratch.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


#: bytes the copies a rotated timing cycles through must exceed: twice
#: the H100's 50 MB L2, so no launch finds its inputs cached
ROTATE_BYTES = 100e6


def copies_for(nbytes: float) -> int:
    """Copies of a launch's inputs (``nbytes`` each) that rotated_ms
    cycles through: at least two, together above ROTATE_BYTES."""
    return max(2, int(ROTATE_BYTES // nbytes) + 1)


def rotated_ms(fn, n_copies: int, launches: int = 50,
               warmup: int = 3) -> float:
    """Device time per launch of ``fn(i)`` run back to back, launch j on
    copy ``j % n_copies`` of its inputs (so none finds them in L2), as a
    served step runs its kernels: the launches are captured in a CUDA
    graph and replayed, so no host time sits between them, with one
    event pair around the replay, divided by the launch count (the
    least of three replays)."""
    import torch

    for j in range(warmup):
        fn(j % n_copies)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for j in range(launches):
            fn(j % n_copies)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / launches)
    del graph
    return min(times)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- launch counters -----------------------------------------------------------
def counters() -> dict:
    """kernel name → (wrapper, counter attribute): each wrapper adds one
    to its counter where it launches its kernel, and nowhere else; a
    captured program adds its graph's launches at each replay (the
    engine's windows and prefill calls, ``tpuserve/programs.py``)."""
    from aigw_tpu_torch.ops import decode_fused, paged_attention, qmatmul

    fused = decode_fused.fused_paged_decode
    return {
        "ragged_prefill_attention": (
            paged_attention.ragged_prefill_attention, "launches"),
        "fused_paged_decode": (fused, "launches"),
        "paged_attention_decode_v2": (
            paged_attention.paged_attention_decode_v2, "launches"),
        "w8a16_matmul": (qmatmul.w8a16_matmul, "launches"),
        "fused_paged_decode_int8": (fused, "launches_int8"),
        "fused_paged_decode_int4": (fused, "launches_int4"),
        "paged_attention_decode": (
            paged_attention.paged_attention_decode, "launches"),
        "paged_attention_verify": (
            paged_attention.paged_attention_verify, "launches"),
    }


def stop_engine(srv) -> None:
    """Stop the engine behind ``srv`` and collect the engines stopped
    before it: an engine is cyclic garbage once replaced (its backends
    and program families point back at it), and its KV pool and graph
    pool are freed only by a collection; the phases start many engines
    one after another."""
    srv.engine.stop()
    gc.collect()


def reset_counts() -> None:
    for fn, attr in counters().values():
        setattr(fn, attr, 0)


def read_counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in counters().items()}


# -- phase 3: serving ---------------------------------------------------------
def _http(port: int, path: str, body: dict | None = None,
          headers: dict | None = None):
    url = f"http://127.0.0.1:{port}{path}"
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={
        "content-type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, r.headers.get("content-type", ""), r.read().decode()


def _check_response(kind: str, stream: bool, status: int, ctype: str,
                    raw: str) -> dict:
    """Well-formed JSON or SSE; returns {"n": tokens, "finish": reason}
    (and "text" for a completion that is not streamed)."""
    if status != 200:
        raise AssertionError(f"{kind} status {status}")
    if not stream:
        body = json.loads(raw)
        want = "chat.completion" if kind == "chat" else "text_completion"
        if body["object"] != want:
            raise AssertionError(f"object {body['object']!r}, want {want!r}")
        out = {"n": body["usage"]["completion_tokens"],
               "finish": body["choices"][0]["finish_reason"]}
        if kind == "completion":
            out["text"] = body["choices"][0]["text"]
        return out
    if not ctype.startswith("text/event-stream"):
        raise AssertionError(f"stream content-type {ctype!r}")
    frames = [ln[6:] for ln in raw.split("\n") if ln.startswith("data: ")]
    if len(frames) < 2 or frames[-1] != "[DONE]":
        raise AssertionError("SSE stream not terminated by [DONE]")
    chunks = [json.loads(f) for f in frames[:-1]]
    want = "chat.completion.chunk" if kind == "chat" else "text_completion"
    if any(c["object"] != want for c in chunks):
        raise AssertionError(f"a stream chunk is not {want!r}")
    last = chunks[-1]
    return {"n": last["usage"]["completion_tokens"],
            "finish": last["choices"][0]["finish_reason"]}


def _requests(rng) -> list[tuple[str, bool, dict]]:
    """Mixed-length chat/completion requests, streamed and not."""
    words = "the quick brown fox jumps over a lazy dog while rivers run".split()

    def text(n_bytes: int) -> str:
        out = []
        while sum(len(w) + 1 for w in out) < n_bytes:
            out.append(words[int(rng.integers(len(words)))])
        return " ".join(out)[:n_bytes]

    lens = [3, 40, 130, 250, 511, 700, 1000, 90]
    reqs = []
    for i, n in enumerate(lens):
        chat = i % 2 == 0
        stream = i % 4 in (1, 2)
        body = {"model": "llama-3-8b-random", "max_tokens": SERVE_MAX_TOKENS,
                "temperature": 0.0 if i % 3 else 0.8, "seed": 100 + i,
                "stream": stream}
        if stream:
            body["stream_options"] = {"include_usage": True}
        if chat:
            body["messages"] = [{"role": "user", "content": text(n)}]
        else:
            body["prompt"] = text(n)
        reqs.append(("chat" if chat else "completion", stream, body))
    return reqs


def serve_phase(port: int, reqs) -> list[dict]:
    results: list = [None] * len(reqs)

    def one(i):
        kind, stream, body = reqs[i]
        path = "/v1/chat/completions" if kind == "chat" else "/v1/completions"
        try:
            results[i] = _check_response(kind, stream, *_http(port, path, body))
        except Exception as e:  # noqa: BLE001 — reported below, fails run
            results[i] = e

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    for i, r in enumerate(results):
        if not isinstance(r, dict):
            raise AssertionError(f"request {i} failed: {r!r}")
        if r["n"] != reqs[i][2]["max_tokens"] and r["finish"] != "stop":
            raise AssertionError(f"request {i}: {r}")
    return results


#: the token the pinned requests' logit_bias forces ("a" in the byte
#: tokenizer)
PIN_TOKEN = 97


def _pinned_requests(n: int) -> list[tuple[str, bool, dict]]:
    """Greedy completions whose logit_bias pins every sample to one
    token: the history turns into a repetition, so n-gram drafts are
    proposed and accepted (the reference's ``test_pallas_ops`` case)."""
    return [("completion", False, {
        "model": "llama-3-8b-random", "prompt": f"pinned request {i}: ",
        "max_tokens": SERVE_MAX_TOKENS, "temperature": 0.0,
        "logit_bias": {str(PIN_TOKEN): 100.0}}) for i in range(n)]


def _check_pinned(results, n: int = SERVE_MAX_TOKENS) -> None:
    for r in results:
        if r.get("text") != chr(PIN_TOKEN) * n:
            raise AssertionError(f"a pinned stream is not the pinned token: "
                                 f"{r}")


def attn_check(name: str, got, want) -> tuple[float, float]:
    """Hold a bf16 attention output to its plain version per element
    (ATTN_RTOL * |plain| + ATTN_ATOL); returns (max |error|, mean |plain
    output|: the size the absolute term is read against)."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    err = diff.max().item()
    if (diff > ATTN_RTOL * w.abs() + ATTN_ATOL).any():
        raise AssertionError(f"{name} max error {err} over rtol {ATTN_RTOL} "
                             f"+ atol {ATTN_ATOL}")
    return err, w.abs().mean().item()


# -- phase 4: kernels against their plain versions -----------------------------
def kernel_checks(torch, launches: dict, dev: str = "cuda") -> list[dict]:
    from aigw_tpu_torch.ops import decode_fused, paged_attention

    H, Hkv, D, PS = 32, 8, 128, 128
    g = torch.Generator(device=dev)
    g.manual_seed(1234)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    rows = []
    # K3 / K2: a batch of 8 with lengths straddling pages
    B = 8
    lengths = [1, 127, 128, 129, 500, 1000, 1535, 300]
    P = 16
    n_pages = B * P + 1
    k_pool = randn(n_pages * PS, Hkv, D)
    v_pool = randn(n_pages * PS, Hkv, D)
    perm = torch.randperm(n_pages - 1, generator=g, device=dev)
    pt = perm[: B * P].reshape(B, P).to(torch.int32).contiguous()
    q = randn(B, H, D)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)

    def k3():
        return paged_attention.paged_attention_decode_v2(
            q, k_pool, v_pool, pt, lens, page_size=PS)

    def k3_plain():
        return paged_attention.paged_attention_decode_v2_plain(
            q, k_pool, v_pool, pt, lens, page_size=PS)

    def k4():
        return paged_attention.paged_attention_decode(
            q, k_pool, v_pool, pt, lens, page_size=PS)

    def k4_plain():
        return paged_attention.paged_attention_decode_plain(
            q, k_pool, v_pool, pt, lens, page_size=PS)

    err, mean_out = attn_check("K3", k3(), k3_plain())
    err4, mean_out4 = attn_check("K4", k4(), k4_plain())
    toks = sum(lengths)
    nbytes = 2 * (2 * B * H * D + 2 * toks * Hkv * D) + 4 * B * (P + 1)
    b_ms, b_by = bound(nbytes, 4 * toks * H * D)
    # K3 and K4 compute one function: timed in turns (K3, K4, K4, K3)
    t3a, t4a, t4b, t3b = (cuda_ms(f) for f in (k3, k4, k4, k3))
    # back to back over copies of the pools, as a served step runs them
    n_rot = copies_for(nbytes)
    rot = [(k_pool.clone(), v_pool.clone()) for _ in range(n_rot)]
    rot3, rot4 = (rotated_ms(lambda i, f=f: f(
        q, *rot[i], pt, lens, page_size=PS), n_rot) for f in (
        paged_attention.paged_attention_decode_v2,
        paged_attention.paged_attention_decode))
    del rot
    # one SDPA call over the batch computes K3's (and K4's) function
    lib3 = sdpa_paged_yardstick(torch, q[:, None], k_pool, v_pool, pt,
                                [[n] for n in lengths], PS, k3_plain())
    rows.append(dict(
        name="paged_attention_decode_v2", route="cuda",
        source="aigw_tpu_torch/csrc/paged_attention.cu",
        replaces="aigw_tpu/ops/pallas/paged_attention.py:223",
        launches=launches["paged_attention_decode_v2"], max_abs_err=err,
        ms=(t3a + t3b) / 2, ms_rotated=rot3,
        plain_ms=cuda_ms(k3_plain, iters=5),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib3["ms"],
        library_ms_rotated=lib3["ms_rotated"], library=lib3["call"],
        max_abs_err_library=lib3["max_abs_err"],
        out_mean_abs=mean_out))
    log(f"K3 ok: max err {err:.3g} (mean |out| {mean_out:.3g}), "
        f"{rows[-1]['ms']:.4f} ms, rotated {rot3:.4f} ms (bound "
        f"{b_ms:.4f} ms, plain "
        f"{rows[-1]['plain_ms']:.3f} ms)")
    pps, n_split = paged_attention.split_pages(B, Hkv, P)
    rows.append(dict(
        name="paged_attention_decode", route="cuda",
        source="aigw_tpu_torch/csrc/paged_attention.cu",
        replaces="aigw_tpu/ops/pallas/paged_attention.py:115",
        launches=launches["paged_attention_decode"], max_abs_err=err4,
        ms=(t4a + t4b) / 2, ms_rotated=rot4,
        plain_ms=cuda_ms(k4_plain, iters=5),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib3["ms"],
        library_ms_rotated=lib3["ms_rotated"], library=lib3["call"],
        out_mean_abs=mean_out4, k3_ms_beside=(t3a + t3b) / 2,
        k3_ms_rotated_beside=rot3, splits=n_split, pages_per_split=pps,
        note="K3's body, one launch; off the engine path, as in the "
             "reference: no decode rung selects v1"))
    log(f"K4 ok: max err {err4:.3g} (mean |out| {mean_out4:.3g}), "
        f"{rows[-1]['ms']:.4f} ms, rotated {rot4:.4f} ms, in {n_split} "
        f"splits of {pps} pages "
        f"(K3 beside it {rows[-1]['k3_ms_beside']:.4f} ms; bound "
        f"{b_ms:.4f} ms)")

    # K2: positions = lengths - 1 … with a page-aligned append (128,
    # 1536 is not allocated: use 256) and one inactive slot
    positions = torch.tensor([0, 126, 128, 256, 499, 999, 1534, 299],
                             dtype=torch.int32, device=dev)
    active = torch.tensor([True] * 7 + [False], device=dev)
    kn, vn = randn(B, Hkv, D), randn(B, Hkv, D)
    kp_a, vp_a = k_pool.clone(), v_pool.clone()
    kp_b, vp_b = k_pool.clone(), v_pool.clone()
    tables = decode_fused.rope_tables(positions, D, 500000.0)
    out_k, _, _ = decode_fused.fused_paged_decode(
        q, kn, vn, kp_a, vp_a, pt, positions, active, rope_theta=500000.0,
        page_size=PS, tables=tables)
    out_p, _, _ = decode_fused.fused_paged_decode_plain(
        q, kn, vn, kp_b, vp_b, pt, positions, active, rope_theta=500000.0,
        page_size=PS, tables=tables)
    err, mean_out = attn_check("K2", out_k, out_p)
    if not (torch.equal(kp_a, kp_b) and torch.equal(vp_a, vp_b)):
        diff = (kp_a != kp_b).sum().item() + (vp_a != vp_b).sum().item()
        raise AssertionError(f"K2 pool bytes differ in {diff} elements")

    def k2():
        return decode_fused.fused_paged_decode(
            q, kn, vn, kp_a, vp_a, pt, positions, active,
            rope_theta=500000.0, page_size=PS, tables=tables)

    def k2_plain():
        return decode_fused.fused_paged_decode_plain(
            q, kn, vn, kp_b, vp_b, pt, positions, active,
            rope_theta=500000.0, page_size=PS, tables=tables)

    act = active.tolist()
    pos_l = positions.tolist()
    cached = sum(p for p, a in zip(pos_l, act) if a)
    fresh = sum(1 for p, a in zip(pos_l, act) if (not a) or p % PS == 0)
    nbytes = (2 * (2 * B * H * D + 2 * B * Hkv * D)  # q, out, k/v new
              + 2 * B * D * 4  # cos/sin tables
              + 2 * 2 * cached * Hkv * D  # cached K/V rows read
              + 2 * 2 * (sum(act) + fresh * (PS - 1)) * Hkv * D  # writes
              + 4 * B * (P + 2))
    b_ms, b_by = bound(nbytes, 4 * (cached + sum(act)) * H * D)
    # back to back over copies of the pools, as a served step runs it
    n_rot = copies_for(nbytes)
    rot = [(kp_a.clone(), vp_a.clone()) for _ in range(n_rot)]
    act32 = active.to(torch.int32)
    ms_rot = rotated_ms(lambda i: decode_fused.fused_paged_decode(
        q, kn, vn, *rot[i], pt, positions, act32, rope_theta=500000.0,
        page_size=PS, tables=tables), n_rot)
    del rot
    rows.append(dict(
        name="fused_paged_decode", route="cuda",
        source="aigw_tpu_torch/csrc/decode_fused.cu",
        replaces="aigw_tpu/ops/pallas/decode_fused.py:268",
        launches=launches["fused_paged_decode"], max_abs_err=err,
        ms=cuda_ms(k2), ms_rotated=ms_rot, plain_ms=cuda_ms(k2_plain, iters=5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        out_mean_abs=mean_out))
    log(f"K2 ok: max err {err:.3g} (mean |out| {mean_out:.3g}), pools "
        f"equal, {rows[-1]['ms']:.4f} ms, rotated {ms_rot:.4f} ms (bound "
        f"{b_ms:.4f} ms, plain {rows[-1]['plain_ms']:.3f} ms)")

    # K5 at the served verify shapes: batch 8, S = 5 (4 drafts), windows
    # across page boundaries (126, 1022, 1534), a fresh sequence and a
    # slot that is off (the engine passes -(S + 1))
    S = 5
    pos0 = [126, 0, 500, 1022, -(S + 1), 1534, 300, 127]
    pos_t = torch.tensor(pos0, dtype=torch.int32, device=dev)
    qv = randn(B, S, H, D)

    def k5(kp=k_pool, vp=v_pool):
        return paged_attention.paged_attention_verify(
            qv, kp, vp, pt, pos_t, page_size=PS)

    def k5_plain():
        return paged_attention.paged_attention_verify_plain(
            qv, k_pool, v_pool, pt, pos_t, page_size=PS)

    got = k5()
    err, mean_out = attn_check("K5", got, k5_plain())
    if got[pos0.index(-(S + 1))].abs().max().item() != 0.0:
        raise AssertionError("K5's slot that is off is not zero")
    # S = 9: 36 rows of a (sequence, KV head), two row groups; a window
    # starting at -2 (its first two queries attend nothing) and a slot
    # that is off
    S9 = 9
    pos9 = torch.tensor([-2, -(S9 + 1), 1022, 126, 1530, 0, 700, 255],
                        dtype=torch.int32, device=dev)
    q9 = randn(B, S9, H, D)
    got9 = paged_attention.paged_attention_verify(q9, k_pool, v_pool, pt,
                                                  pos9, page_size=PS)
    err9, _ = attn_check("K5 (S 9)", got9,
                         paged_attention.paged_attention_verify_plain(
                             q9, k_pool, v_pool, pt, pos9, page_size=PS))
    if got9[1].abs().max().item() != 0.0 or got9[0, :2].abs().max() != 0:
        raise AssertionError("K5 (S 9): a query with no keys is not zero")
    # keys each query attends, and the rows each sequence's walk needs
    keys = [max(0, min(p + s + 1, P * PS)) for p in pos0 for s in range(S)]
    rows_read = sum(max(0, min(p + S, P * PS)) for p in pos0)
    nbytes = 2 * (2 * B * S * H * D + 2 * rows_read * Hkv * D) \
        + 4 * B * (P + 1)
    b_ms, b_by = bound(nbytes, 4 * sum(keys) * H * D)
    n_rot = copies_for(nbytes)
    rot = [(k_pool.clone(), v_pool.clone()) for _ in range(n_rot)]
    rot5 = rotated_ms(lambda i: k5(*rot[i]), n_rot)
    del rot
    lib5 = sdpa_paged_yardstick(
        torch, qv, k_pool, v_pool, pt,
        [[max(0, min(p + s + 1, P * PS)) for s in range(S)] for p in pos0],
        PS, k5_plain())
    rows.append(dict(
        name="paged_attention_verify", route="cuda",
        source="aigw_tpu_torch/csrc/paged_attention.cu",
        replaces="aigw_tpu/ops/pallas/paged_attention.py:497",
        launches=launches["paged_attention_verify"], max_abs_err=err,
        ms=cuda_ms(k5), ms_rotated=rot5,
        plain_ms=cuda_ms(k5_plain, iters=5),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib5["ms"],
        library_ms_rotated=lib5["ms_rotated"], library=lib5["call"],
        max_abs_err_library=lib5["max_abs_err"],
        out_mean_abs=mean_out, S=S, max_abs_err_s9=err9))
    log(f"K5 ok: max err {err:.3g} (mean |out| {mean_out:.3g}; S 9: "
        f"{err9:.3g}), {rows[-1]['ms']:.4f} ms, rotated {rot5:.4f} ms "
        f"(bound {b_ms:.4f} ms, plain {rows[-1]['plain_ms']:.3f} ms)")

    # K1: a packed burst with one offset start, padded to a 256 multiple
    # (float32 on the CUDA-core kernel too); then the prefix cache's
    # resume geometry
    rows.insert(0, k1_row(torch, "ragged_prefill_attention", K1_CASE,
                          launches["ragged_prefill_attention"], k_pool,
                          v_pool, perm, randn, f32=True, dev=dev))
    rows.insert(1, k1_row(torch, "ragged_prefill_attention_resume",
                          K1_RESUME_CASE,
                          launches["ragged_prefill_attention_resume"],
                          k_pool, v_pool, perm, randn, dev=dev))
    return rows


def k1_row(torch, name: str, seq, n_launches: int, k_pool, v_pool, perm,
           randn, f32: bool = False, dev: str = "cuda") -> dict:
    """K1 over the packed sequences ``seq`` ((new rows, start position)
    each, on distinct pages of the pool), padded to a multiple of 256:
    held against its plain version (padding rows zero, two calls
    bit-identical), timed flushed and rotated beside its bound and the
    SDPA yardstick; with ``f32``, also the CUDA-core kernel in float32."""
    from aigw_tpu_torch.ops import paged_attention

    H, Hkv, D, PS, P = 32, 8, 128, 128, 16
    total = sum(n for n, _ in seq)
    T = -(-total // 256) * 256
    Bp = len(seq)
    cu = [0]
    for n, _ in seq:
        cu.append(cu[-1] + n)
    cu_t = torch.tensor(cu, dtype=torch.int32, device=dev)
    st_t = torch.tensor([s for _, s in seq], dtype=torch.int32, device=dev)
    pt1 = perm[: Bp * P].reshape(Bp, P).to(torch.int32).contiguous()
    q1 = randn(T, H, D)

    def k1(*a):
        return paged_attention.ragged_prefill_attention(
            *(a or (q1, k_pool, v_pool)), pt1, cu_t, st_t, page_size=PS)

    def k1_plain(*a):
        return paged_attention.ragged_prefill_attention_plain(
            *(a or (q1, k_pool, v_pool)), pt1, cu_t, st_t, page_size=PS)

    got = k1()
    want = k1_plain()[:total]
    err, mean_out = attn_check(name, got[:total], want)
    if got[total:].abs().max().item() != 0.0:
        raise AssertionError(f"{name}: tail rows are not zero")
    if not torch.equal(got, k1()):
        raise AssertionError(f"{name}: two calls differ")
    extra = {}
    if f32:  # the CUDA-core kernel (float32), the same case
        f32_in = (q1.float(), k_pool.float(), v_pool.float())
        got32 = k1(*f32_in)
        want32 = k1_plain(*f32_in)
        extra["max_abs_err_f32"] = (got32 - want32).abs().max().item()
        torch.testing.assert_close(got32, want32, rtol=2e-5, atol=2e-5)
        extra["ms_f32"] = cuda_ms(lambda: k1(*f32_in), iters=5)
        del f32_in, got32, want32
    keys = sum(s + n for n, s in seq)  # pool rows each sequence reads
    nbytes = 2 * (total * H * D + 2 * keys * Hkv * D + T * H * D)
    pairs = sum(sum(s + i + 1 for i in range(n)) for n, s in seq)
    flops = 4 * pairs * H * D
    b_ms, b_by = bound(nbytes, flops)
    n_rot = copies_for(nbytes)
    rot = [(q1.clone(), k_pool.clone(), v_pool.clone())
           for _ in range(n_rot)]
    rot1 = rotated_ms(lambda i: k1(*rot[i]), n_rot)
    del rot
    lib = sdpa_yardstick(torch, q1, k_pool, v_pool, pt1, seq, cu, PS,
                         want)
    row = dict(
        name=name, route="cuda",
        source="aigw_tpu_torch/csrc/paged_attention.cu",
        replaces="aigw_tpu/ops/pallas/paged_attention.py:419",
        launches=n_launches, max_abs_err=err,
        ms=cuda_ms(k1, iters=10), ms_rotated=rot1,
        plain_ms=cuda_ms(k1_plain, iters=3),
        bound_ms=b_ms, bound_by=b_by,
        bound_bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
        bound_operations_ms=flops / BF16_FLOPS_PER_S * 1e3,
        gflop=flops / 1e9, causal_pairs=pairs,
        tflops_rotated=flops / rot1 / 1e9,
        library_ms=lib["ms"], library_ms_rotated=lib["ms_rotated"],
        library=lib["call"], max_abs_err_library=lib["max_abs_err"],
        out_mean_abs=mean_out, sequences=[list(x) for x in seq], **extra)
    log(f"{name} ok: max err {err:.3g} (mean |out| {mean_out:.3g}; "
        f"float32 {extra.get('max_abs_err_f32', float('nan')):.3g}), "
        f"{row['ms']:.4f} ms, rotated {rot1:.4f} ms "
        f"({row['tflops_rotated']:.1f} TFLOP/s; bounds "
        f"{row['bound_bytes_ms']:.5f} bytes, "
        f"{row['bound_operations_ms']:.5f} operations; SDPA "
        f"{lib['ms']:.4f}, rotated {lib['ms_rotated']:.4f}; float32 "
        f"{extra.get('ms_f32', float('nan')):.3f} ms; plain "
        f"{row['plain_ms']:.3f} ms)")
    return row


#: K1's case: (new rows, start position) of 5 packed sequences, one
#: resumed at 77 (1380 rows)
K1_CASE = [(700, 0), (300, 0), (1, 0), (129, 77), (250, 0)]
#: K1 at the prefix cache's resume geometry: 7 suffixes of 150 rows
#: resumed at 1024 (8 cached pages: partial hits), and the one row at
#: 1151 of a full hit (1051 rows)
K1_RESUME_CASE = [(150, 1024)] * 7 + [(1, 1151)]


def sdpa_yardstick(torch, q, k_pool, v_pool, page_table, seq, cu,
                   page_size, want) -> dict:
    """K1's library yardstick: one ``scaled_dot_product_attention`` call
    per sequence with the flash backend and ``enable_gqa``, on
    contiguous copies of that sequence's keys (gathered from the pool
    beforehand, not timed), causal with the lower-right mask for a
    sequence resumed past 0, the calls summed. No single PyTorch call
    computes K1's function over a paged pool; this is the yardstick for
    K1's later passes and no part of K1. Returns its times (flushed and
    back to back over copies, as K1's), the call, and its largest
    difference from ``want``, K1's plain output on the sequences' rows."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.attention.bias import causal_lower_right

    offs = torch.arange(page_size, device=q.device)
    args = []
    for b, (n, s) in enumerate(seq):
        slots = (page_table[b].long()[:, None] * page_size
                 + offs).reshape(-1)[:s + n]
        args.append((q[cu[b]:cu[b + 1]].transpose(0, 1)[None].contiguous(),
                     k_pool[slots].transpose(0, 1)[None].contiguous(),
                     v_pool[slots].transpose(0, 1)[None].contiguous(),
                     causal_lower_right(n, s + n) if s else None))

    def run(a=args):
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
            return [F.scaled_dot_product_attention(
                qb, kb, vb, attn_mask=mask, is_causal=mask is None,
                enable_gqa=True) for qb, kb, vb, mask in a]

    got = torch.cat([o[0].transpose(0, 1) for o in run()])
    err = (got.float() - want.float()).abs().max().item()
    nbytes = sum(x.numel() * 2 for a in args for x in a[:3])
    n_rot = copies_for(nbytes)
    rot = [args] + [[(qb, kb.clone(), vb.clone(), mask)
                     for qb, kb, vb, mask in args]
                    for _ in range(n_rot - 1)]
    return {"ms": cuda_ms(run), "ms_rotated": rotated_ms(
                lambda i: run(rot[i]), n_rot),
            "call": "torch.nn.functional.scaled_dot_product_attention, "
                    "flash backend, enable_gqa=True, one call per "
                    "sequence on contiguous keys",
            "max_abs_err": err}


def sdpa_paged_yardstick(torch, q, k_pool, v_pool, page_table, keys,
                         page_size, want) -> dict:
    """K3's, K4's and K5's library yardstick: one
    ``scaled_dot_product_attention`` call over the whole batch, on
    contiguous copies of every sequence's keys (gathered from the pool
    beforehand, padded to the longest and to a multiple of 16, not
    timed), with a boolean mask: query s of sequence b attends its first
    ``keys[b][s]`` keys (K3: its length; K5: the causal window). The
    efficient backend (flash takes no mask), ``enable_gqa``; where that
    backend refuses grouped heads, the key heads are expanded in the
    copies instead, and the call says so. q is ``[B, S, H, D]``.
    Returns its times (flushed and back to back over copies, as the
    kernels'), the call, and its largest difference from ``want`` (the
    kernel's plain output) over queries with keys."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    B, S, H, D = q.shape
    Hkv = k_pool.shape[1]
    L = -(-max(max(k) for k in keys) // 16) * 16
    offs = torch.arange(page_size, device=q.device)
    slots = (page_table.long()[:, :, None] * page_size
             + offs).reshape(B, -1)[:, :L]
    kc = k_pool[slots].transpose(1, 2).contiguous()  # [B, Hkv, L, D]
    vc = v_pool[slots].transpose(1, 2).contiguous()
    qb = q.transpose(1, 2).contiguous()  # [B, H, S, D]
    n_keys = torch.tensor(keys, device=q.device)  # [B, S]
    mask = (torch.arange(L, device=q.device)[None, None, :]
            < n_keys[:, :, None])[:, None]  # [B, 1, S, L]
    call = ("torch.nn.functional.scaled_dot_product_attention, efficient "
            "backend, one call over the batch on contiguous keys, a "
            "boolean mask")
    gqa = True

    def run(a=None):
        kb, vb = a or (kc, vc)
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            return F.scaled_dot_product_attention(
                qb, kb, vb, attn_mask=mask, enable_gqa=gqa)

    try:
        got = run()
        call += ", enable_gqa=True"
    except RuntimeError:
        gqa = False
        kc = kc.repeat_interleave(H // Hkv, dim=1)
        vc = vc.repeat_interleave(H // Hkv, dim=1)
        got = run()
        call += ", key heads expanded to the query heads"
    has = (n_keys > 0)[:, :, None, None]  # [B, S, 1, 1]
    diff = (got.transpose(1, 2).float()
            - want.reshape(B, S, H, D).float()).abs()
    err = torch.where(has, diff, torch.zeros_like(diff)).max().item()
    n_rot = copies_for(2 * kc.numel() * kc.element_size())
    rot = [(kc, vc)] + [(kc.clone(), vc.clone()) for _ in range(n_rot - 1)]
    out = {"ms": cuda_ms(run), "ms_rotated": rotated_ms(
        lambda i: run(rot[i]), n_rot), "call": call, "max_abs_err": err}
    del rot
    return out


def quant_kernel_checks(torch, launches: dict, dev: str = "cuda") -> list:
    """K6 at every weight shape a decode step multiplies (M = 8) and a
    bucketed prefill's [1, 64] block multiplies (M = 64: the default
    programs' short prompts and chunk tails), and K7's int8 and int4
    rungs at K2's shapes, each against its plain version; K6 also beside
    ``torch.matmul`` on the same weight dequantized to bf16 ahead of
    time (cuBLAS, the library row). The row's step times sum the M = 8
    shapes."""
    from aigw_tpu_torch.models import kvq, llama, quant
    from aigw_tpu_torch.ops import decode_fused, qmatmul

    g = torch.Generator(device=dev)
    g.manual_seed(4321)
    rows, shapes = [], []
    for M, ((K, N), step_launches) in itertools.product((8, 64), QMM_STEP):
        per_step = step_launches if M == 8 else 0
        w = torch.randn((K, N), generator=g, device=dev) / K ** 0.5
        qp = quant.quantize_params({"w_up": w}, consume=True)
        del w
        q, sc = qp["w_up.q"], qp["w_up.scale"]
        x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
        got = qmatmul.w8a16_matmul(x, q, sc)
        want = qmatmul.w8a16_matmul_plain(x, q, sc)
        err = (got.float() - want.float()).abs()
        tol = QMM_RTOL * want.float().abs() \
            + QMM_ATOL * want.float().abs().max()
        if (err > tol).any():
            raise AssertionError(f"K6 {M}x{K}x{N}: max error "
                                 f"{err.max().item()}")
        again = qmatmul.w8a16_matmul(x, q, sc)
        if not torch.equal(got, again):
            raise AssertionError(f"K6 {M}x{K}x{N}: two calls differ")
        w_bf16 = llama._w(qp, "w_up")  # dequantized ahead of time
        nbytes = K * N + 4 * N + 2 * M * K + 2 * M * N
        b_ms, b_by = bound(nbytes, 2 * M * K * N)
        n_rot = copies_for(nbytes)
        rot = [q] + [q.clone() for _ in range(n_rot - 1)]
        ms_rot = rotated_ms(lambda i: qmatmul.w8a16_matmul(x, rot[i], sc),
                            n_rot)
        del rot
        n_lib = copies_for(2 * K * N)
        rot = [w_bf16] + [w_bf16.clone() for _ in range(n_lib - 1)]
        lib_rot = rotated_ms(lambda i: torch.matmul(x, rot[i]), n_lib)
        del rot
        shapes.append(dict(
            K=K, N=N, M=M, per_step=per_step, max_abs_err=err.max().item(),
            ms=cuda_ms(lambda: qmatmul.w8a16_matmul(x, q, sc)),
            ms_rotated=ms_rot,
            plain_ms=cuda_ms(lambda: qmatmul.w8a16_matmul_plain(x, q, sc),
                             iters=5),
            library_ms=cuda_ms(lambda: torch.matmul(x, w_bf16)),
            library_ms_rotated=lib_rot,
            bound_ms=b_ms, bound_by=b_by))
        del qp, q, sc, w_bf16, got, want, again
        log(f"K6 {M}x{K}x{N}: {shapes[-1]['ms']:.4f} ms, rotated {ms_rot:.4f} "
            f"(bound {b_ms:.4f}, cuBLAS on bf16 "
            f"{shapes[-1]['library_ms']:.4f}, rotated {lib_rot:.4f}, "
            f"plain {shapes[-1]['plain_ms']:.3f}), max err "
            f"{shapes[-1]['max_abs_err']:.3g}")
    print(json.dumps({"qmatmul_shapes": shapes}), flush=True)

    def step_sum(key):
        return sum(r[key] * r["per_step"] for r in shapes)

    rows.append(dict(
        name="w8a16_matmul", route="cuda",
        source="aigw_tpu_torch/csrc/qmatmul.cu",
        replaces="aigw_tpu/ops/pallas/qmatmul.py:91",
        launches=launches["w8a16_matmul"],
        max_abs_err=max(r["max_abs_err"] for r in shapes),
        ms=step_sum("ms"), ms_rotated=step_sum("ms_rotated"),
        plain_ms=step_sum("plain_ms"), bound_ms=step_sum("bound_ms"),
        bound_by=("bytes" if all(r["bound_by"] == "bytes" for r in shapes)
                  else "operations"),
        library_ms=step_sum("library_ms"),
        library_ms_rotated=step_sum("library_ms_rotated"),
        per="one Llama-3-8B decode step at batch 8: 225 launches, the "
            "per-shape times of qmatmul_shapes times per_step"))

    # K7: K2's shapes over int8 / int4 pools
    H, Hkv, D, PS = 32, 8, 128, 128
    B, P = 8, 16
    n_pages = B * P + 1
    kf = torch.randn((n_pages * PS, Hkv, D), generator=g, device=dev)
    vf = torch.randn((n_pages * PS, Hkv, D), generator=g, device=dev)
    perm = torch.randperm(n_pages - 1, generator=g, device=dev)
    pt = perm[: B * P].reshape(B, P).to(torch.int32).contiguous()

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    q, kn, vn = randn(B, H, D), randn(B, Hkv, D), randn(B, Hkv, D)
    positions = torch.tensor([0, 126, 128, 256, 499, 999, 1534, 299],
                             dtype=torch.int32, device=dev)
    active = torch.tensor([True] * 7 + [False], device=dev)
    tables = decode_fused.rope_tables(positions, D, 500000.0)
    act32 = active.to(torch.int32)
    act = active.tolist()
    pos_l = positions.tolist()
    cached = sum(p for p, a in zip(pos_l, act) if a)
    fresh = sum(1 for p, a in zip(pos_l, act) if (not a) or p % PS == 0)
    for qdt in ("int8", "int4"):
        kq, ks = kvq.quantize_rows(kf, qdt)
        vq, vs = kvq.quantize_rows(vf, qdt)
        a = [t.clone() for t in (kq, vq, ks, vs)]
        b = [t.clone() for t in (kq, vq, ks, vs)]

        def k7(a=a):
            return decode_fused.fused_paged_decode(
                q, kn, vn, a[0], a[1], pt, positions, active, a[2], a[3],
                rope_theta=500000.0, page_size=PS, tables=tables)

        def k7_plain(b=b):
            return decode_fused.fused_paged_decode_plain(
                q, kn, vn, b[0], b[1], pt, positions, active, b[2], b[3],
                rope_theta=500000.0, page_size=PS, tables=tables)

        out_p = k7_plain()[0].float()
        err, mean_out = attn_check(f"K7-{qdt}", k7()[0], out_p)
        # typical output size at the long-context slots (positions 999,
        # 1534)
        long_scale = out_p[5:7].abs().mean().item()
        # appended q bytes and scales: equal, or (FMA contraction in the
        # RoPE) within one step of q and rtol 1e-5 on the scale, counted
        dq = [(kvq.int_values(x).int() - kvq.int_values(y).int()).abs()
              for x, y in zip(a[:2], b[:2])]
        n_q = sum(int((d > 0).sum()) for d in dq)
        if max(int(d.max()) for d in dq) > 1:
            raise AssertionError(f"K7-{qdt} q bytes differ by more than 1")
        for x, y in zip(a[2:], b[2:]):
            torch.testing.assert_close(x, y, rtol=1e-5, atol=0)
        n_s = sum(int((x != y).sum()) for x, y in zip(a[2:], b[2:]))
        RW = D // 2 if qdt == "int4" else D
        nbytes = (2 * (2 * B * H * D + 2 * B * Hkv * D)  # q, out, k/v new
                  + 2 * B * D * 4  # cos/sin tables
                  + 2 * cached * Hkv * (RW + 4)  # cached rows + scales
                  + 2 * (sum(act) + fresh * (PS - 1)) * Hkv * (RW + 4)
                  + 4 * B * (P + 2))
        b_ms, b_by = bound(nbytes, 4 * (cached + sum(act)) * H * D)
        n_rot = copies_for(nbytes)
        rot = [[t.clone() for t in a] for _ in range(n_rot)]
        ms_rot = rotated_ms(lambda i: decode_fused.fused_paged_decode(
            q, kn, vn, rot[i][0], rot[i][1], pt, positions, act32,
            rot[i][2], rot[i][3], rope_theta=500000.0, page_size=PS,
            tables=tables), n_rot)
        del rot
        name = f"fused_paged_decode_{qdt}"
        rows.append(dict(
            name=name, route="cuda",
            source="aigw_tpu_torch/csrc/decode_fused.cu",
            replaces="aigw_tpu/ops/pallas/decode_fused.py:268",
            launches=launches[name], max_abs_err=err,
            ms=cuda_ms(k7), ms_rotated=ms_rot,
            plain_ms=cuda_ms(k7_plain, iters=5),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            q_bytes_off_by_one=n_q, scales_differ=n_s,
            out_mean_abs=mean_out, out_mean_abs_long=long_scale))
        log(f"K7-{qdt} ok: max err {err:.3g} (mean |out| {mean_out:.3g}, "
            f"{long_scale:.3g} at the long slots), q bytes differing {n_q}, "
            f"scales differing {n_s}, {rows[-1]['ms']:.4f} ms, rotated "
            f"{ms_rot:.4f} ms (bound "
            f"{b_ms:.4f} ms, plain {rows[-1]['plain_ms']:.3f} ms)")
    return rows


def model_check(torch, params, cfg, dev: str = "cuda",
                kv_dtype: str = "bfloat16", ref_params=None) -> dict:
    """One full-width prefill + 8 decode steps, kernels vs plain versions
    (teacher-forced on the kernel path's greedy tokens), over a
    ``kv_dtype`` pool. With ``ref_params`` (the bf16 model), also the
    share of greedy tokens the bf16 model (kernel path, bf16 pool) picks
    the same along those tokens."""
    from aigw_tpu_torch.models import kvq, llama

    PS, P = 128, 16
    lens = [700, 45, 1000, 3]
    B = len(lens)
    g = torch.Generator(device=dev)
    g.manual_seed(99)
    T = -(-sum(lens) // 256) * 256
    tokens = torch.randint(0, cfg.vocab_size, (T,), generator=g, device=dev)
    row_seq = torch.full((T,), B, dtype=torch.int32, device=dev)
    positions = torch.zeros((T,), dtype=torch.int32, device=dev)
    last = torch.zeros((B,), dtype=torch.int32, device=dev)
    o = 0
    for b, n in enumerate(lens):
        row_seq[o:o + n] = b
        positions[o:o + n] = torch.arange(n, device=dev)
        last[b] = o + n - 1
        o += n
    pt = torch.arange(B * P, dtype=torch.int32, device=dev).reshape(B, P)
    shape = (cfg.n_layers, 2, (B * P + 1) * PS, cfg.n_kv_heads, cfg.head_dim)
    kv_k = kvq.make_pool(shape, kv_dtype, dev)
    kv_p = kvq.make_pool(shape, kv_dtype, dev)
    lk, kv_k = llama.prefill_ragged(params, cfg, tokens, row_seq, positions,
                                    last, kv_k, pt, PS)
    lp, kv_p = llama.prefill_ragged(params, cfg, tokens, row_seq, positions,
                                    last, kv_p, pt, PS, plain=True)
    if ref_params is not None:
        kv_r = kvq.make_pool(shape, "bfloat16", dev)
        lr, kv_r = llama.prefill_ragged(ref_params, cfg, tokens, row_seq,
                                        positions, last, kv_r, pt, PS)
    errs, gaps, mism, agree, picks = [], [], 0, 0, 0

    def compare(a, b, ref=None):
        nonlocal mism, agree, picks
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError("non-finite logits")
        if a.shape != (B, cfg.vocab_size):
            raise AssertionError(f"logits of shape {tuple(a.shape)}")
        errs.append((a - b).abs().max().item())
        top2 = torch.topk(b, 2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1])
        differ = a.argmax(-1) != b.argmax(-1)
        if differ.any():
            # tie-aware: a flip is only allowed at a near-tie of the
            # plain path's logits
            worst = gap[differ].max().item()
            gaps.append(worst)
            if worst > 0.1:
                raise AssertionError(f"greedy token differs at a top-2 gap "
                                     f"of {worst}")
            mism += int(differ.sum())
        if ref is not None:
            agree += int((a.argmax(-1) == ref.argmax(-1)).sum())
            picks += B

    compare(lk, lp, lr if ref_params is not None else None)
    tok = lk.argmax(-1).to(torch.int32)
    pos = torch.tensor(lens, dtype=torch.int32, device=dev)
    active = torch.ones((B,), dtype=torch.bool, device=dev)
    for _ in range(8):
        dk, kv_k = llama.decode_step(params, cfg, tok, pos, kv_k, pt, PS,
                                     active)
        dp, kv_p = llama.decode_step(params, cfg, tok, pos, kv_p, pt, PS,
                                     active, plain=True)
        dr = None
        if ref_params is not None:
            dr, kv_r = llama.decode_step(ref_params, cfg, tok, pos, kv_r, pt,
                                         PS, active)
        compare(dk, dp, dr)
        tok = dk.argmax(-1).to(torch.int32)
        pos = pos + 1
    scale = lp.abs().max().item()
    if max(errs) > 0.1 * scale:
        raise AssertionError(f"logits differ by {max(errs)} "
                             f"(logit scale {scale})")
    out = {"max_abs_logit_err": max(errs), "logit_scale": scale,
           "logit_bound": 0.1 * scale,
           "greedy_mismatches": mism, "steps": 9, "kv_dtype": kv_dtype}
    if ref_params is not None:
        out["greedy_agree_with_bf16"] = agree / picks
    return out


def verify_check(torch, params, cfg, dev: str = "cuda") -> dict:
    """One full-width prefill (batch 8), then one verify step of width 5
    through K5 against the same step through K5's plain version, on
    copies of the same pool: the max logit error over the valid rows
    and tie-aware greedy agreement (a flip only at a near-tie of the
    plain logits). One slot is inactive, one fenced by its limit inside
    the window, and windows cross pages (126, 1022, 1534)."""
    from aigw_tpu_torch.models import kvq, llama

    PS, P, S = 128, 16, 5
    lens = [126, 45, 1022, 3, 700, 1534, 300, 1]
    B = len(lens)
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    T = -(-sum(lens) // 256) * 256
    tokens = torch.randint(0, cfg.vocab_size, (T,), generator=g, device=dev)
    row_seq = torch.full((T,), B, dtype=torch.int32, device=dev)
    positions = torch.zeros((T,), dtype=torch.int32, device=dev)
    last = torch.zeros((B,), dtype=torch.int32, device=dev)
    o = 0
    for b, n in enumerate(lens):
        row_seq[o:o + n] = b
        positions[o:o + n] = torch.arange(n, device=dev)
        last[b] = o + n - 1
        o += n
    pt = torch.arange(B * P, dtype=torch.int32, device=dev).reshape(B, P)
    kv = kvq.make_pool((cfg.n_layers, 2, (B * P + 1) * PS, cfg.n_kv_heads,
                        cfg.head_dim), "bfloat16", dev)
    _, kv = llama.prefill_ragged(params, cfg, tokens, row_seq, positions,
                                 last, kv, pt, PS)
    draft = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                          device=dev, dtype=torch.int32)
    pos0 = torch.tensor(lens, dtype=torch.int32, device=dev)
    active = torch.ones((B,), dtype=torch.bool, device=dev)
    active[7] = False
    limits = pos0 + 64
    limits[1] = lens[1] + 2  # fenced after two positions
    out = {}
    for plain in (False, True):
        out[plain], _ = llama.verify_step(
            params, cfg, draft, pos0, kv.clone(), pt, PS, active, limits,
            attn_impl="chained", plain=plain)
    got, want = out[False], out[True]
    pos = pos0[:, None].long() + torch.arange(S, device=dev)
    valid = active[:, None] & (pos < limits[:, None])
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError("non-finite verify logits")
    if got.shape != (B, S, cfg.vocab_size):
        raise AssertionError(f"verify logits of shape {tuple(got.shape)}")
    a, b = got[valid], want[valid]
    err = (a - b).abs().max().item()
    scale = b.abs().max().item()
    top2 = torch.topk(b, 2, dim=-1).values
    differ = a.argmax(-1) != b.argmax(-1)
    worst = (top2[:, 0] - top2[:, 1])[differ].max().item() \
        if differ.any() else 0.0
    if worst > 0.1:
        raise AssertionError(f"verify greedy token differs at a top-2 gap "
                             f"of {worst}")
    if err > 0.1 * scale:
        raise AssertionError(f"verify logits differ by {err} (logit scale "
                             f"{scale})")
    return {"max_abs_logit_err": err, "logit_scale": scale,
            "greedy_mismatches": int(differ.sum()),
            "valid_rows": int(valid.sum()), "S": S}


def serve_profile(torch, port: int, reqs, warm_s: float) -> dict:
    """The device's busy share while the warm server serves the burst:
    the kernel time torch.profiler sees on the card over one more
    serving of the burst, divided by the untraced warm burst's wall time
    ``warm_s``. The trace records every launch on the host and stretches
    its own burst's wall time several times over (reported beside it);
    the device work of a burst does not depend on that pace."""
    from torch.profiler import ProfilerActivity, profile

    t = time.monotonic()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        serve_phase(port, reqs)
        torch.cuda.synchronize()
    wall_s = time.monotonic() - t
    device_ms = sum(
        ev.self_device_time_total for ev in prof.key_averages()
        if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    if device_ms <= 0:
        raise AssertionError("the profiler saw no device time while serving")
    return {"traced_wall_s": wall_s, "traced_device_ms": device_ms,
            "warm_device_busy": device_ms / (warm_s * 1e3)}


def decode_profile(torch, params, cfg, dev: str = "cuda",
                   kv_dtype: str = "bfloat16", verify_width: int = 0,
                   attn_impl: str = "fused", model=None, lora=None,
                   adapter_idx=None, logprobs_topk: int | None = None,
                   captured: bool = False) -> dict:
    """Where one full-width decode step's time goes: host wall clock of a
    step (synchronized) against the device time torch.profiler sees, by
    kernel. Batch 8 at 1000 cached tokens each, a ``kv_dtype`` pool, on
    the ``attn_impl`` rung (K2/K7 fused, K3 chained); with
    ``verify_width`` > 0, a verify step of that width on the chained
    rung (K5) instead. ``model`` is the family's module (llama by
    default); ``lora`` and ``adapter_idx`` give the slots adapter rows.
    With ``logprobs_topk`` set each step also takes the greedy token
    (the argmax), and above 0 the engine's per-token logprobs at it
    (``sampling.token_logprobs``). ``kernel_launches`` counts the device
    kernels a step launches. ``captured`` runs the step as the engine's
    programs run it: captured once in a CUDA graph and replayed."""
    from torch.profiler import ProfilerActivity, profile

    from aigw_tpu_torch.models import kvq, llama
    from aigw_tpu_torch.tpuserve.sampling import token_logprobs

    model = model or llama

    B, PS, P, ctx, steps = 8, 128, 16, 1000, 5
    kv = kvq.make_pool((cfg.n_layers, 2, (B * P + 1) * PS, cfg.n_kv_heads,
                        cfg.head_dim), kv_dtype, dev)
    pt = torch.arange(B * P, dtype=torch.int32, device=dev).reshape(B, P)
    tok = torch.zeros((B,), dtype=torch.int32, device=dev)
    pos = torch.full((B,), ctx, dtype=torch.int32, device=dev)
    act = torch.ones((B,), dtype=torch.bool, device=dev)

    toks = torch.zeros((B, verify_width), dtype=torch.int32, device=dev)
    limits = pos + 64

    ad = {} if lora is None else dict(lora=lora, adapter_idx=adapter_idx)

    def step():
        if verify_width:
            model.verify_step(params, cfg, toks, pos, kv, pt, PS, act,
                              limits, attn_impl="chained", **ad)
        else:
            out = model.decode_step(params, cfg, tok, pos, kv, pt, PS, act,
                                    attn_impl=attn_impl, **ad)
            if logprobs_topk is not None:
                tok_s = out[0].argmax(-1)
                if logprobs_topk:
                    token_logprobs(out[0], tok_s, logprobs_topk)

    if captured:
        step = _captured(torch, step)
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t = time.monotonic()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.monotonic() - t) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    # the port's kernels on this path, every launch of each summed: K6's
    # (W8A16 projections), K2/K7's (the fused decode rung), and the K3/K5
    # body's (mq_*): K5 in a verify step, else K3
    mq = "paged_attention_verify" if verify_width \
        else "paged_attention_decode_v2"
    device_ms, ours, top = device_split(
        torch, prof, steps, (("w8a16_matmul", "w8a16"),
                             ("fused_paged_decode", "fused_decode"),
                             (mq, "mq_")))
    launched = sum(ev.count for ev in prof.key_averages()
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   and ev.self_device_time_total > 0) / steps
    return {"batch": B, "cached_tokens": ctx, "layers": cfg.n_layers,
            "kv_dtype": kv_dtype, "verify_width": verify_width,
            "logprobs_topk": logprobs_topk, "kernel_launches": launched,
            "attn_impl": "chained" if verify_width else attn_impl,
            "captured": captured, "wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy": device_ms / wall_ms,
            "port_kernels_ms": ours, "top_kernels_ms": top}


def _captured(torch, fn):
    """``fn()`` as one of the engine's programs runs: its first call
    runs it eagerly and captures it in a CUDA graph, every later call
    replays the graph (``tpuserve/programs.py``)."""
    from aigw_tpu_torch.obs.graph_events import CompileTracker
    from aigw_tpu_torch.tpuserve.programs import CapturedProgram, ProgramPool

    prog = CapturedProgram(fn, ProgramPool(torch.device("cuda"),
                                           CompileTracker()))
    return lambda: prog()


def device_split(torch, prof, calls: int, tags) -> tuple:
    """From a profile of ``calls`` calls: device ms per call, each
    tagged kernel's ms per call (``tags``: (name, substring of its
    kernels' names); every launch summed) and the six costliest kernels'
    ms per call."""
    by_kernel: dict[str, float] = {}
    ours = {name: 0.0 for name, _ in tags}
    for ev in prof.key_averages():
        us = ev.self_device_time_total
        if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[ev.key[:60]] = by_kernel.get(ev.key[:60], 0.0) + us
            for name, tag in tags:
                if tag in ev.key:
                    ours[name] += us / 1e3 / calls
    device_ms = sum(by_kernel.values()) / 1e3 / calls
    if device_ms <= 0:
        raise AssertionError("the profiler saw no device time")
    top = sorted(by_kernel.items(), key=lambda item: -item[1])[:6]
    return device_ms, ours, {k: us / 1e3 / calls for k, us in top}


def served_prompt_lens(reqs) -> list[int]:
    """Prompt tokens of each request of a burst as the server makes
    them (the byte tokenizer: chat through its template, a completion
    after BOS)."""
    from aigw_tpu_torch.tpuserve.tokenizer import (
        ByteTokenizer,
        apply_chat_template,
    )

    tok = ByteTokenizer()
    return [len(apply_chat_template(body["messages"], tok)) if kind == "chat"
            else 1 + len(tok.encode(body["prompt"]))
            for kind, _stream, body in reqs]


def prefill_profile(torch, params, cfg, seqs, dev: str = "cuda", lora=None,
                    adapter_idx=None, captured: bool = False) -> dict:
    """Where one full-width bf16 prefill's time goes: one
    ``prefill_ragged`` call over the packed sequences ``seqs`` ((new
    tokens, start position) each; the rows padded to a multiple of 256),
    its host wall clock (synchronized) against the device time
    torch.profiler sees, and K1's launches (one per layer) summed;
    ``lora`` and ``adapter_idx`` give the sequences adapter rows;
    ``captured`` replays the call from a CUDA graph, as the engine's
    prefill programs run."""
    from torch.profiler import ProfilerActivity, profile

    from aigw_tpu_torch.models import kvq, llama

    PS, calls = 128, 3
    B = len(seqs)
    P = max(-(-(n + s) // PS) for n, s in seqs)
    total = sum(n for n, _ in seqs)
    T = -(-total // 256) * 256
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (T,), generator=g, device=dev)
    row_seq = torch.full((T,), B, dtype=torch.int32, device=dev)
    positions = torch.zeros((T,), dtype=torch.int32, device=dev)
    last = torch.zeros((B,), dtype=torch.int32, device=dev)
    o = 0
    for b, (n, s) in enumerate(seqs):
        row_seq[o:o + n] = b
        positions[o:o + n] = s + torch.arange(n, device=dev)
        last[b] = o + n - 1
        o += n
    pt = torch.arange(B * P, dtype=torch.int32, device=dev).reshape(B, P)
    kv = kvq.make_pool((cfg.n_layers, 2, (B * P + 1) * PS, cfg.n_kv_heads,
                        cfg.head_dim), "bfloat16", dev)

    def call():
        llama.prefill_ragged(params, cfg, tokens, row_seq, positions, last,
                             kv, pt, PS, lora=lora, adapter_idx=adapter_idx)

    if captured:
        call = _captured(torch, call)
    call()
    torch.cuda.synchronize()
    t = time.monotonic()
    for _ in range(calls):
        call()
    torch.cuda.synchronize()
    wall_ms = (time.monotonic() - t) * 1e3 / calls
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    device_ms, ours, top = device_split(
        torch, prof, calls, (("ragged_prefill_attention", "ragged_prefill"),))
    return {"sequences": [list(x) for x in seqs], "rows": total,
            "padded_rows": T, "layers": cfg.n_layers, "captured": captured,
            "wall_ms": wall_ms,
            "device_ms": device_ms, "k1_in_place_ms":
            ours["ragged_prefill_attention"], "top_kernels_ms": top}


def spec_phases(srv, restart, params, reqs, launches: dict) -> None:
    """Serve with speculative decoding: the chained rung at a fixed
    draft width of 4 (the ``serve_spec`` line), then the fused rung with
    the adaptive ladder (``serve_spec_fused``). ``restart(params, **kw)``
    puts a fresh engine with EngineConfig overrides ``kw`` behind
    ``srv``; K5's and K4's launches of the first go into ``launches``."""
    # speculative decoding on the chained rung, a fixed draft width
    # of 4: every window verifies through K5 at S = 5. The burst plus
    # two greedy requests pinned to one token, whose drafts the
    # verify accepts
    restart(params, decode_backend="chained", pallas_attn=True,
            spec_tokens=4, spec_adaptive=False)
    spec_reqs = reqs + _pinned_requests(2)
    reset_counts()
    t = time.monotonic()
    results_s = serve_phase(srv.port, spec_reqs)
    cold_spec = time.monotonic() - t
    served_s = read_counts()
    _check_pinned(results_s[len(reqs):])
    state_s = json.loads(_http(srv.port, "/state")[2])
    log(f"speculative (chained, width 4): served {len(spec_reqs)} "
        f"requests in {cold_spec:.1f}s; spec_accepted "
        f"{state_s['spec_accepted']} of {state_s['spec_drafted']} "
        f"drafted; launches {served_s}")
    if served_s["paged_attention_verify"] <= 0:
        raise AssertionError(f"K5 not on the speculative served path: "
                             f"{served_s}")
    if state_s["spec_accepted"] <= 0:
        raise AssertionError("no draft accepted on the pinned requests")
    t = time.monotonic()
    serve_phase(srv.port, spec_reqs)
    warm_spec = time.monotonic() - t
    warm_s = json.loads(_http(srv.port, "/state")[2])
    # the pinned pair alone: tokens per verify step per slot
    t = time.monotonic()
    _check_pinned(serve_phase(srv.port, _pinned_requests(2)))
    pinned_s = time.monotonic() - t
    pin = json.loads(_http(srv.port, "/state")[2])
    pin_steps = pin["decode_steps"] - warm_s["decode_steps"]
    # each request's first token comes from its prefill
    pin_tokens = pin["tokens_generated"] - warm_s["tokens_generated"] - 2
    burst_tokens = state_s["tokens_generated"] - len(spec_reqs)
    print(json.dumps({"serve_spec": {
        "decode_attn_impl": state_s["decode_attn_impl"],
        "spec_tokens": 4, "spec_adaptive": False,
        "requests": len(spec_reqs),
        "new_tokens": sum(r["n"] for r in results_s),
        "cold_s": cold_spec, "warm_s": warm_spec,
        "decode_steps": state_s["decode_steps"],
        "spec_drafted": state_s["spec_drafted"],
        "spec_accepted": state_s["spec_accepted"],
        "spec_accept_rate": state_s["spec_accept_rate"],
        "decode_tokens_per_verify_step": burst_tokens
        / state_s["decode_steps"],
        "pinned_pair_wall_s": pinned_s,
        "pinned_decode_steps": pin_steps,
        "pinned_tokens_per_verify_step_per_slot":
            pin_tokens / (2 * pin_steps),
        "launches": served_s}}), flush=True)
    launches["paged_attention_verify"] = \
        served_s["paged_attention_verify"]
    launches["paged_attention_decode"] = \
        served_s["paged_attention_decode"]

    # speculation with the prefix cache on: lookahead drafts
    spec_prefix_phase(srv, restart, params)

    # the fused rung with the adaptive ladder: verify takes the
    # gather path (K5 must not launch) while the pinned greedy request
    # speculates; once it finishes, the sampled one (ineligible: no
    # controller) decodes in plain windows through K2
    restart(params, decode_backend="fused", spec_tokens=4)
    fused_reqs = [_pinned_requests(1)[0], reqs[0]]
    fused_reqs[0][2]["max_tokens"] = 24
    reset_counts()
    t = time.monotonic()
    serve_phase(srv.port, fused_reqs)
    fused_s = time.monotonic() - t
    served_f = read_counts()
    state_f = json.loads(_http(srv.port, "/state")[2])
    print(json.dumps({"serve_spec_fused": {
        "decode_attn_impl": state_f["decode_attn_impl"],
        "spec_tokens": 4, "spec_adaptive": True,
        "requests": len(fused_reqs), "wall_s": fused_s,
        "decode_steps": state_f["decode_steps"],
        "spec_drafted": state_f["spec_drafted"],
        "spec_accepted": state_f["spec_accepted"],
        "spec_rung_downs": state_f["spec_rung_downs"],
        "spec_draft_len": state_f["spec_draft_len"],
        "launches": served_f}}), flush=True)
    if served_f["paged_attention_verify"]:
        raise AssertionError(f"K5 launched on the fused rung: "
                             f"{served_f}")
    if state_f["spec_accepted"] <= 0:
        raise AssertionError("the gather verify path accepted no draft")
    if served_f["fused_paged_decode"] <= 0:
        raise AssertionError(f"K2 not on the fused rung's plain "
                             f"windows: {served_f}")


# -- the prefix cache ---------------------------------------------------------
#: bytes of the system message every chat of the prefix phase shares:
#: the byte tokenizer's rendered prompts ("<system>: ...\n<user>: ")
#: then agree on their first 1070 + 19 = 1089 tokens, 8 full 128-token
#: pages and part of the 9th, so every hit adopts exactly 8 pages
PREFIX_SYSTEM_BYTES = 1070
#: the completion of burst C: BOS + 1023 bytes = exactly 8 pages
PREFIX_C_BYTES = 1023


def _prefix_requests(rng) -> tuple:
    """Burst A (one chat behind the shared system message), burst B
    (seven chats behind it, user turns of 40-300 bytes with distinct
    first letters, streamed and not, greedy and seeded) and the
    completion of burst C (sharing nothing with A), 64 new tokens each."""
    words = "the quick brown fox jumps over a lazy dog while rivers run".split()

    def text(n_bytes: int) -> str:
        out = ""
        while len(out) <= n_bytes:
            out += " " + words[int(rng.integers(len(words)))]
        return out[1:n_bytes + 1]

    system = text(PREFIX_SYSTEM_BYTES)

    def chat(i: int, n_bytes: int, stream: bool, greedy: bool):
        body = {"model": "llama-3-8b-random", "max_tokens": SERVE_MAX_TOKENS,
                "temperature": 0.0 if greedy else 0.8, "seed": 300 + i,
                "stream": stream, "messages": [
                    {"role": "system", "content": system},
                    {"role": "user",
                     "content": "QRSTUVWX"[i] + text(n_bytes - 1)}]}
        if stream:
            body["stream_options"] = {"include_usage": True}
        return ("chat", stream, body)

    a = [chat(0, 120, False, True)]
    b = [chat(i + 1, n, i % 2 == 1, i % 3 != 2)
         for i, n in enumerate([40, 90, 300, 150, 220, 64, 260])]
    c = ("completion", False, {
        "model": "llama-3-8b-random", "max_tokens": SERVE_MAX_TOKENS,
        "temperature": 0.0, "prompt": text(PREFIX_C_BYTES)})
    # B's geometry again with fresh user turns, one token each, sent one
    # at a time to an idle engine: each prefill alone, no decode window
    # in flight to queue behind
    serial = [chat(i + 1, n, False, True)
              for i, n in enumerate([41, 91, 299, 151, 219, 65, 259])]
    for _kind, _stream, body in serial:
        body["max_tokens"] = 1
    return a, b, c, serial


def _prefix_call(port: int, kind: str, stream: bool, body: dict) -> dict:
    """One request: checked as the serve phase checks it, plus its text
    and the usage's cached_tokens (0 when the usage carries none)."""
    path = "/v1/chat/completions" if kind == "chat" else "/v1/completions"
    status, ctype, raw = _http(port, path, body)
    out = _check_response(kind, stream, status, ctype, raw)
    if stream:
        chunks = [json.loads(ln[6:]) for ln in raw.split("\n")
                  if ln.startswith("data: ") and ln[6:] != "[DONE]"]
        pieces = [(c["choices"][0]["delta"].get("content") or ""
                   if kind == "chat" else c["choices"][0]["text"])
                  for c in chunks if c["choices"]]
        text, usage = "".join(pieces), chunks[-1]["usage"]
    else:
        body_out = json.loads(raw)
        choice = body_out["choices"][0]
        text = (choice["message"]["content"] if kind == "chat"
                else choice["text"])
        usage = body_out["usage"]
    out.update(text=text, cached=(usage.get("prompt_tokens_details")
                                  or {}).get("cached_tokens", 0))
    return out


def _prefix_burst(port: int, reqs) -> list[dict]:
    results: list = [None] * len(reqs)

    def one(i):
        try:
            results[i] = _prefix_call(port, *reqs[i])
        except Exception as e:  # noqa: BLE001 — reported below
            results[i] = e

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    for i, r in enumerate(results):
        if not isinstance(r, dict):
            raise AssertionError(f"prefix request {i} failed: {r!r}")
        if r["n"] != reqs[i][2]["max_tokens"] and r["finish"] != "stop":
            raise AssertionError(f"prefix request {i}: {r}")
    return results


def _page_rows(kv, page: int, ps: int) -> dict:
    """Clones of one page's rows in every tensor of the pool."""
    leaves = kv.items() if isinstance(kv, dict) else [("kv", kv)]
    return {k: v[:, :, page * ps:(page + 1) * ps].clone() for k, v in leaves}


def shared_prefix_tokens(port: int, reqs) -> int:
    """Longest token prefix burst A shares with every chat of burst B,
    from /tokenize."""
    def toks(body):
        return json.loads(_http(port, "/tokenize", {
            "model": body["model"], "messages": body["messages"]})[2]
        )["tokens"]

    a, b = reqs[:2]
    ta = toks(a[0][2])
    shared = []
    for _kind, _stream, body in b:
        tb = toks(body)
        n = 0
        while n < min(len(ta), len(tb)) and ta[n] == tb[n]:
            n += 1
        shared.append(n)
    return min(shared)


def prefix_bursts(torch, srv, reqs) -> dict:
    """Serve burst A, then B (the phase histograms emptied before it,
    launches counted over it), then C twice in turn, on ``srv``'s
    engine. With the cache on, C's shared last page is held byte-equal
    to its state before the full hit, and the copy (rows before n - 1)
    to its source, after the second request has decoded."""
    from aigw_tpu_torch.obs.metrics import EnginePhases

    a, b, c, serial = reqs
    port = srv.port
    eng = srv.engine
    cows: list = []
    copy = eng._copy_page_dev

    def recording_copy(src, dst):
        cows.append((src, dst))
        copy(src, dst)

    eng._copy_page_dev = recording_copy
    res_a = _prefix_burst(port, a)
    st0 = json.loads(_http(port, "/state")[2])
    eng.phases = EnginePhases()
    reset_counts()
    t = time.monotonic()
    res_b = _prefix_burst(port, b)
    wall_b = time.monotonic() - t
    counts_b = read_counts()
    st1 = json.loads(_http(port, "/state")[2])
    pp = st1["phase_percentiles"]
    res_c = _prefix_burst(port, [c])
    out = {}
    if eng.prefix_cache is not None:
        ps = eng.cfg.page_size
        tokens = [srv.tokenizer.bos_id] + srv.tokenizer.encode(c[2]["prompt"])
        if len(tokens) != 8 * ps:
            raise AssertionError(f"burst C has {len(tokens)} tokens")
        shared = eng.prefix_cache.probe(eng.prefix_cache.chain_keys(tokens))
        if len(shared) != 8:
            raise AssertionError(f"burst C cached {len(shared)} pages")
        before = _page_rows(eng.kv_cache, shared[-1], ps)
    res_c += _prefix_burst(port, [c])
    st2 = json.loads(_http(port, "/state")[2])
    if eng.prefix_cache is not None:
        if cows[-1][0] != shared[-1]:
            raise AssertionError(f"CoW pair {cows[-1]} is not from the "
                                 f"shared page {shared[-1]}")
        after = _page_rows(eng.kv_cache, shared[-1], ps)
        copied = _page_rows(eng.kv_cache, cows[-1][1], ps)
        for k in before:
            if not torch.equal(after[k], before[k]):
                raise AssertionError(f"the shared page's {k} changed "
                                     f"after the full hit")
            if not torch.equal(copied[k][:, :, :-1], before[k][:, :, :-1]):
                raise AssertionError(f"the CoW'd page's {k} differs from "
                                     f"its source")
        out["cow_page"] = {
            "source": cows[-1][0], "copy": cows[-1][1],
            "leaves": sorted(before),
            "copy_rows_equal": ps - 1,
            "last_row_equal": all(torch.equal(copied[k][:, :, -1],
                                              before[k][:, :, -1])
                                  for k in before)}
    # then each prefill alone (C's pages are checked above: these
    # requests may reuse the copy's page)
    serial_ms, serial_cached = [], []
    for r in serial:
        before_ms = json.loads(_http(port, "/state")[2])["prefill_ms"]
        serial_cached.append(_prefix_burst(port, [r])[0]["cached"])
        serial_ms.append(json.loads(_http(port, "/state")[2])["prefill_ms"]
                         - before_ms)
    out.update(
        results=res_a + res_b + res_c, b_wall_s=wall_b,
        b_prefill_ms=st1["prefill_ms"] - st0["prefill_ms"],
        b_prefills=st1["prefills"] - st0["prefills"],
        b_prefill_tokens_real=st1["prefill_tokens_real"]
        - st0["prefill_tokens_real"],
        b_prefill_p50_ms=pp["prefill"]["p50"],
        b_prefill_p95_ms=pp["prefill"]["p95"],
        b_ttft_p50_ms=pp["ttft"]["p50"], b_ttft_p95_ms=pp["ttft"]["p95"],
        b_launches=counts_b,
        cached_tokens=[r["cached"] for r in res_a + res_b + res_c],
        serial_prefill_ms=serial_ms, serial_cached_tokens=serial_cached,
        **{k: st2[k] for k in PREFIX_STATE_KEYS})
    return out


PREFIX_STATE_KEYS = ("prefix_cache_hits", "prefix_cache_misses",
                     "prefix_full_hits", "prefix_cow_copies",
                     "prefix_tokens_reused", "prefix_cache_hit_rate",
                     "prefix_pages_resident", "prefix_cache_evictions",
                     "kv_pages_free", "kv_occupancy")


def check_prefix_counts(run: dict, what: str) -> None:
    """The exact counts bursts A-C give with the cache on: 7 partial
    hits (B) and a full hit (C's repeat), misses A and C's first."""
    want = {"prefix_cache_hits": 8, "prefix_full_hits": 1,
            "prefix_cow_copies": 1, "prefix_cache_misses": 2,
            "prefix_tokens_reused": 7 * 1024 + 1023}
    got = {k: run[k] for k in want}
    if got != want:
        raise AssertionError(f"{what}: /state prefix counts {got}, want "
                             f"{want}")
    cached = run["cached_tokens"]
    if cached != [0] + [1024] * 7 + [0, 1023]:
        raise AssertionError(f"{what}: cached_tokens {cached}")


def serve_prefix_phase(torch, srv, restart, params, reqs,
                       launches: dict) -> None:
    """Bursts A-C (``reqs``) on the fused rung with the cache on, then on
    an engine restarted with the cache off (the ``serve_prefix`` line);
    K1's launches during B go into ``launches``."""
    restart(params, decode_backend="fused", enable_prefix_cache=True)
    shared = shared_prefix_tokens(srv.port, reqs)
    if not 1024 <= shared < 1152:
        raise AssertionError(f"A and B share {shared} tokens, not 8 full "
                             f"pages and part of the 9th")
    on = prefix_bursts(torch, srv, reqs)
    check_prefix_counts(on, "bf16")
    if on["b_launches"]["ragged_prefill_attention"] <= 0:
        raise AssertionError(f"K1 not launched by burst B's resumes: "
                             f"{on['b_launches']}")
    restart(params, decode_backend="fused", enable_prefix_cache=False)
    off = prefix_bursts(torch, srv, reqs)
    if off["prefix_cache_hits"] or any(off["cached_tokens"]):
        raise AssertionError("the cache-off engine reused a prefix")
    a, b, c, _ = reqs
    bodies = [r[2] for r in a + b] + [c[2], c[2]]
    greedy = [i for i, body in enumerate(bodies)
              if body["temperature"] == 0.0]
    same = sum(on["results"][i]["text"] == off["results"][i]["text"]
               for i in greedy)
    for run in (on, off):
        run["new_tokens"] = sum(r["n"] for r in run.pop("results"))
    print(json.dumps({"serve_prefix": {
        "shared_prefix_tokens": shared, "requests_a_b_c": [1, 7, 2],
        "greedy_streams": len(greedy),
        "greedy_streams_equal_cache_off": same,
        "cache_on": on, "cache_off": off}}), flush=True)
    launches["ragged_prefill_attention_resume"] = \
        on["b_launches"]["ragged_prefill_attention"]


def serve_prefix_int8(torch, srv, restart, qparams, reqs) -> None:
    """Bursts A-C over int8 KV pages with the cache on (the
    ``serve_prefix_int8`` line): the same counts, the CoW'd page's q and
    scale rows equal to their source's, and no K1 launch (quantized pools
    prefill through the windowed program)."""
    restart(qparams, decode_backend="fused", kv_cache_dtype="int8",
            enable_prefix_cache=True)
    run = prefix_bursts(torch, srv, reqs)
    check_prefix_counts(run, "int8")
    if run["cow_page"]["leaves"] != ["q", "scale"]:
        raise AssertionError(f"int8 CoW checked {run['cow_page']}")
    if run["b_launches"]["ragged_prefill_attention"]:
        raise AssertionError("K1 launched on an int8 pool")
    run["new_tokens"] = sum(r["n"] for r in run.pop("results"))
    print(json.dumps({"serve_prefix_int8": run}), flush=True)


def spec_prefix_phase(srv, restart, params) -> None:
    """Speculation with the cache on, on the chained rung at a fixed
    draft width of 4 (the ``serve_spec_prefix`` line): a 300-token
    completion, then its first 200 tokens as a second one. The radix
    chain's continuation of the first page (the first prompt's tokens
    128-255) seeds the second request's lookahead drafts, verified
    through K5."""
    restart(params, decode_backend="chained", pallas_attn=True,
            spec_tokens=4, spec_adaptive=False,
            enable_prefix_cache=True)
    text = "".join(chr(97 + (7 * i) % 26) for i in range(299))
    reqs = [("completion", False, {
        "model": "llama-3-8b-random", "prompt": p, "max_tokens": 32,
        "temperature": 0.0}) for p in (text, text[:199])]
    reset_counts()
    t = time.monotonic()
    for r in reqs:
        _prefix_burst(srv.port, [r])
    counts = read_counts()
    st = json.loads(_http(srv.port, "/state")[2])
    print(json.dumps({"serve_spec_prefix": {
        "wall_s": time.monotonic() - t,
        "decode_attn_impl": st["decode_attn_impl"],
        **{k: st[k] for k in ("spec_lookahead_slots", "spec_drafted",
                              "spec_accepted", "prefix_cache_hits",
                              "prefix_tokens_reused")},
        "launches": counts}}), flush=True)
    if st["spec_lookahead_slots"] < 1:
        raise AssertionError("no lookahead-seeded slot")
    if counts["paged_attention_verify"] <= 0:
        raise AssertionError(f"K5 not launched: {counts}")


# -- grammar-constrained decoding ---------------------------------------------
CN_MAX_TOKENS = 256
#: the schemas and tools of the constrained phase; each one's longest
#: valid output is under 200 characters (the byte tokenizer emits one
#: character a token), so every reply can finish inside CN_MAX_TOKENS
CN_SCHEMA_NESTED = {
    "type": "object", "properties": {
        "name": {"type": "string", "maxLength": 12},
        "kind": {"enum": ["cat", "dog", "bird"]},
        "owner": {"type": "object", "properties": {
            "id": {"type": "integer"}, "vip": {"type": "boolean"}},
            "required": ["id", "vip"]}},
    "required": ["name", "kind", "owner"], "additionalProperties": False}
CN_SCHEMA_ARRAY = {
    "type": "object", "properties": {
        "tags": {"type": "array", "maxItems": 3,
                 "items": {"type": "string", "maxLength": 12}},
        "score": {"type": "number"}},
    "required": ["tags", "score"]}
CN_TOOLS = [
    {"type": "function", "function": {
        "name": "get_weather", "parameters": {
            "type": "object", "properties": {
                "city": {"type": "string", "maxLength": 12},
                "unit": {"enum": ["c", "f"]}},
            "required": ["city", "unit"], "additionalProperties": False}}},
    {"type": "function", "function": {
        "name": "get_time", "parameters": {
            "type": "object", "properties": {
                "tz": {"type": "string", "maxLength": 12}},
            "required": ["tz"], "additionalProperties": False}}}]
#: the shared system message: the rendered prompts of the phase agree on
#: their first two 128-token pages, which the warm-up request caches, so
#: every request of the burst resumes at 256 through K1
CN_SYSTEM = ("You answer in JSON. " * 16)[:300]


def _cn_requests() -> list[tuple[str, bool, dict]]:
    """The burst: (what, streamed, body). Greedy and seeded at 0.8 half
    each, four streamed; the two json_object requests are one seeded
    body sent both ways."""
    def chat(i, what, stream, greedy, **extra):
        body = {"model": "llama-3-8b-random", "max_tokens": CN_MAX_TOKENS,
                "temperature": 0.0 if greedy else 0.8, "seed": 500 + i,
                "stream": stream, "messages": [
                    {"role": "system", "content": CN_SYSTEM},
                    {"role": "user", "content": f"request {i}: {what}"}],
                **extra}
        if stream:
            body["stream_options"] = {"include_usage": True}
        return (what, stream, body)

    def schema(s):
        return {"type": "json_schema",
                "json_schema": {"name": "out", "schema": s}}

    obj = {"response_format": {"type": "json_object"}}
    pair = chat(2, "json_object", False, False, **obj)
    twin = ("json_object", True, {**pair[2], "stream": True,
                                  "stream_options": {"include_usage": True}})
    return [
        chat(0, "json_schema", False, True,
             response_format=schema(CN_SCHEMA_NESTED)),
        chat(1, "json_schema", True, False,
             response_format=schema(CN_SCHEMA_ARRAY)),
        pair, twin,
        chat(4, "required", True, True, tools=CN_TOOLS,
             tool_choice="required"),
        chat(5, "named", False, True, tools=CN_TOOLS, tool_choice={
            "type": "function", "function": {"name": "get_time"}}),
        chat(6, "auto", False, False, tools=CN_TOOLS, tool_choice="auto"),
        chat(7, "plain", True, True),
    ]


def _cn_call(port: int, stream: bool, body: dict) -> dict:
    """One chat request: its finish, completion tokens, content and tool
    call (name, arguments), from the JSON reply or reassembled from the
    stream's deltas; the stream's tool-call deltas are held to the
    OpenAI shape (a first delta with the call's id, type and name, then
    argument deltas)."""
    status, ctype, raw = _http(port, "/v1/chat/completions", body)
    out = _check_response("chat", stream, status, ctype, raw)
    if not stream:
        msg = json.loads(raw)["choices"][0]["message"]
        calls = msg.get("tool_calls") or []
        call = ((calls[0]["function"]["name"],
                 calls[0]["function"]["arguments"]) if calls else None)
        if calls and not (len(calls) == 1 and calls[0]["type"] == "function"
                          and len(calls[0]["id"]) == 29):
            raise AssertionError(f"tool_calls {calls}")
        return {**out, "content": msg.get("content") or "", "call": call}
    chunks = [json.loads(ln[6:]) for ln in raw.split("\n")
              if ln.startswith("data: ") and ln[6:] != "[DONE]"]
    content, name, args, first = "", None, "", None
    for c in chunks:
        for ch in c["choices"]:
            delta = ch["delta"]
            content += delta.get("content") or ""
            for t in delta.get("tool_calls") or []:
                if first is None:
                    first = t
                    name = t["function"]["name"]
                    if not (t.get("id", "").startswith("call_")
                            and len(t["id"]) == 29
                            and t.get("type") == "function"
                            and t["function"]["arguments"] == ""):
                        raise AssertionError(f"first tool-call delta {t}")
                elif set(t) != {"index", "function"}:
                    raise AssertionError(f"tool-call delta {t}")
                args += t["function"].get("arguments") or ""
    return {**out, "content": content,
            "call": (name, args) if name is not None else None}


def _cn_check(constrain, fsm_json_object, what: str, body: dict,
              r: dict) -> None:
    """The phase's gates for one reply."""
    params = {t["function"]["name"]: t["function"]["parameters"]
              for t in CN_TOOLS}
    if what == "json_schema":
        schema = body["response_format"]["json_schema"]["schema"]
        if r["finish"] != "stop" or not constrain.validate_instance(
                schema, json.loads(r["content"])):
            raise AssertionError(f"json_schema reply {r}")
    elif what in ("required", "named"):
        want = (body["tool_choice"]["function"]["name"] if what == "named"
                else None)
        if r["finish"] != "tool_calls" or r["call"] is None \
                or r["content"] or r["call"][0] not in params \
                or want not in (None, r["call"][0]) \
                or not constrain.validate_instance(
                    params[r["call"][0]], json.loads(r["call"][1])):
            raise AssertionError(f"{what} tool reply {r}")
    elif what == "json_object":
        if r["finish"] == "stop":
            if not isinstance(json.loads(r["content"]), dict):
                raise AssertionError(f"json_object reply {r}")
        else:
            st = fsm_json_object.new_state()
            if r["finish"] != "length" or not all(
                    st.advance(b) for b in r["content"].encode()):
                raise AssertionError(f"json_object reply is not a prefix "
                                     f"the grammar accepts: {r}")
    elif what == "auto" and r["call"] is not None:
        if r["finish"] != "tool_calls" or not constrain.validate_instance(
                params[r["call"][0]], json.loads(r["call"][1])):
            raise AssertionError(f"auto tool reply {r}")


def _cn_burst(port: int, reqs) -> tuple[list[dict], float]:
    results: list = [None] * len(reqs)

    def one(i):
        try:
            results[i] = _cn_call(port, reqs[i][1], reqs[i][2])
        except Exception as e:  # noqa: BLE001 — reported below
            results[i] = e

    t = time.monotonic()
    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(reqs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    wall = time.monotonic() - t
    for i, r in enumerate(results):
        if not isinstance(r, dict):
            raise AssertionError(f"constrained request {i} failed: {r!r}")
    return results, wall


CN_STATE_KEYS = ("constraint_requests", "constraint_rollbacks",
                 "constraint_mask_updates", "constraint_grammars",
                 "constrained_slots", "spec_accepted", "spec_drafted",
                 "prefix_cache_hits", "prefix_tokens_reused",
                 "tokens_generated", "decode_steps")


def serve_constrained_phase(srv, restart, params) -> None:
    """Grammar-constrained serving (the ``serve_constrained`` line): the
    fused rung with the prefix cache on, as a default replica serves.
    The grammars compile in process first (timed; the first pays the
    token table over the whole vocabulary); one warm-up request caches
    the system message's pages; then the burst of 8, gated reply by
    reply, ``constraint_requests`` up by exactly 6, rollbacks above 0,
    K1 and K2 launched, and the json_object pair (one seeded body,
    streamed and not) equal. Then the chained rung at a fixed draft
    width of 4 serves two greedy json_schema requests beside the two
    pinned ones (K5 while a
    greedy slot lives), then one seeded json_schema request alone (no
    draft controller: plain windows, K3): K5 and K3 must launch, drafts
    be accepted and the constrained replies validate."""
    from aigw_tpu_torch.tpuserve import constrain

    restart(params, decode_backend="fused", enable_prefix_cache=True)
    eng = srv.engine
    tok, V = srv.tokenizer, srv.model_cfg.vocab_size
    eos = (tok.eos_id,)
    compile_ms = {}
    for name, spec in (
            ("json_schema_nested", constrain.spec_for_response_format(
                "json_schema", CN_SCHEMA_NESTED)),
            ("json_schema_array", constrain.spec_for_response_format(
                "json_schema", CN_SCHEMA_ARRAY)),
            ("json_object", constrain.spec_for_response_format(
                "json_object", None)),
            ("tools", constrain.spec_for_tools(
                constrain.parse_tools(CN_TOOLS)))):
        t = time.monotonic()
        fsm = constrain.compile_constraint(tok, V, eos, spec)
        fsm.mask(fsm.root)
        compile_ms[name] = 1e3 * (time.monotonic() - t)
    fsm_obj = constrain.compile_constraint(
        tok, V, eos, constrain.spec_for_response_format("json_object", None))
    reqs = _cn_requests()
    t = time.monotonic()
    warm, _ = _cn_burst(srv.port, [reqs[0]])
    warmup_s = time.monotonic() - t
    _cn_check(constrain, fsm_obj, reqs[0][0], reqs[0][2], warm[0])

    before = json.loads(_http(srv.port, "/state")[2])
    st0 = {k: getattr(eng.stats, k) for k in (
        "constraint_host_ms", "constraint_windows",
        "constraint_slot_windows")}
    reset_counts()
    results, wall = _cn_burst(srv.port, reqs)
    counts = read_counts()
    after = json.loads(_http(srv.port, "/state")[2])
    st1 = {k: getattr(eng.stats, k) - v for k, v in st0.items()}
    for (what, _stream, body), r in zip(reqs, results):
        _cn_check(constrain, fsm_obj, what, body, r)
    delta = {k: after[k] - before[k] for k in CN_STATE_KEYS}
    if delta["constraint_requests"] != 6:
        raise AssertionError(f"constraint_requests rose by "
                             f"{delta['constraint_requests']}, not 6")
    if delta["constraint_rollbacks"] <= 0:
        raise AssertionError("no constraint rollback in the burst")
    if counts["ragged_prefill_attention"] <= 0 \
            or counts["fused_paged_decode"] <= 0:
        raise AssertionError(f"K1 / K2 not launched: {counts}")
    if results[2]["content"] != results[3]["content"] \
            or results[2]["finish"] != results[3]["finish"]:
        raise AssertionError(f"streamed differs from non-streamed: "
                             f"{results[2]} / {results[3]}")
    cn_idx = [i for i, (what, _s, _b) in enumerate(reqs)
              if what not in ("auto", "plain")]
    # every token but the prefill's first comes from a window
    window_tokens = sum(results[i]["n"] - 1 for i in cn_idx)
    # a seeded tool call sent both ways, alone beside its twin
    call_twin = ("required", True, {**reqs[4][2], "temperature": 0.8,
                                    "seed": 77})
    call = ("required", False, {
        k: v for k, v in call_twin[2].items() if k != "stream_options"}
        | {"stream": False})
    pair, _ = _cn_burst(srv.port, [call, call_twin])
    for (what, _s, body), r in zip((call, call_twin), pair):
        _cn_check(constrain, fsm_obj, what, body, r)
    if pair[0]["call"] != pair[1]["call"]:
        raise AssertionError(f"streamed tool call differs: {pair}")
    fused = {
        "burst_wall_s": wall, "warmup_request_s": warmup_s,
        "grammar_compile_ms": compile_ms,
        "finishes": [r["finish"] for r in results],
        "new_tokens": [r["n"] for r in results],
        "emitted_tokens_per_window_per_constrained_slot":
            window_tokens / max(1, st1["constraint_slot_windows"]),
        "windows_with_constrained_slots": st1["constraint_windows"],
        "constraint_host_ms_per_window":
            st1["constraint_host_ms"] / max(1, st1["constraint_windows"]),
        **delta, "launches": counts}

    # the chained rung at a fixed draft width of 4
    restart(params, decode_backend="chained", pallas_attn=True,
            spec_tokens=4, spec_adaptive=False,
            enable_prefix_cache=True)
    seeded = ("json_schema", False, {
        k: v for k, v in reqs[1][2].items() if k != "stream_options"}
        | {"stream": False})
    spec_reqs = [reqs[0], ("json_schema", False,
                           seeded[2] | {"temperature": 0.0})]
    before = json.loads(_http(srv.port, "/state")[2])
    reset_counts()
    t = time.monotonic()
    pinned: list = []
    th = threading.Thread(target=lambda: pinned.extend(
        serve_phase(srv.port, _pinned_requests(2))))
    th.start()
    spec_results, _ = _cn_burst(srv.port, spec_reqs)
    th.join(timeout=900)
    spec_wall = time.monotonic() - t
    k3_results, k3_wall = _cn_burst(srv.port, [seeded])
    spec_counts = read_counts()
    after = json.loads(_http(srv.port, "/state")[2])
    _check_pinned(pinned)
    for (what, _s, body), r in zip(spec_reqs + [seeded],
                                   spec_results + k3_results):
        _cn_check(constrain, fsm_obj, what, body, r)
    spec_delta = {k: after[k] - before[k] for k in CN_STATE_KEYS}
    if spec_counts["paged_attention_verify"] <= 0 \
            or spec_counts["paged_attention_decode_v2"] <= 0:
        raise AssertionError(f"K5 / K3 not launched: {spec_counts}")
    if spec_delta["spec_accepted"] <= 0:
        raise AssertionError("no draft accepted on the chained rung")
    print(json.dumps({"serve_constrained": {
        "card": nvidia_smi_line(), "fused": fused,
        "chained_spec": {"wall_s": spec_wall, "seeded_alone_wall_s": k3_wall,
                         "finishes": [r["finish"] for r in spec_results
                                      + k3_results],
                         **spec_delta, "launches": spec_counts}}}),
          flush=True)


def resume_check(torch, params, cfg, dev: str = "cuda") -> dict:
    """K1 at the prefix cache's resume geometry in the model: one
    ``prefill_ragged`` of a prompt's 8 full pages, then its remaining 150
    tokens resumed at start 1024 over the same pool, against one cold
    prefill of the whole prompt (last-row logits within model_check's
    tolerance); and a full hit: the 8-page prompt's last page copied
    (``kvq.copy_page``) and its last token resumed at 1023 against the
    cold prefill of the 8 pages, the source page left unchanged."""
    from aigw_tpu_torch.models import kvq, llama

    PS, P, n_pre, n_suf = 128, 10, 1024, 150
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (n_pre + n_suf,),
                           generator=g, device=dev)
    pt = torch.arange(P, dtype=torch.int32, device=dev)[None]
    # pages 0-9 for the sequence, 10 for the copy, 11 the dump page
    shape = (cfg.n_layers, 2, (P + 2) * PS, cfg.n_kv_heads, cfg.head_dim)

    def call(kv, toks, start, table=pt):
        n = len(toks)
        T = -(-n // 256) * 256
        tk = torch.zeros((T,), dtype=toks.dtype, device=dev)
        tk[:n] = toks
        row_seq = torch.ones((T,), dtype=torch.int32, device=dev)
        row_seq[:n] = 0
        pos = torch.zeros((T,), dtype=torch.int32, device=dev)
        pos[:n] = start + torch.arange(n, device=dev)
        last = torch.tensor([n - 1], dtype=torch.int32, device=dev)
        return llama.prefill_ragged(params, cfg, tk, row_seq, pos, last, kv,
                                    table, PS)

    def compare(a, b, what):
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError(f"{what}: non-finite logits")
        err = (a - b).abs().max().item()
        scale = b.abs().max().item()
        top2 = torch.topk(b, 2, dim=-1).values
        if a.argmax(-1) != b.argmax(-1) and \
                (top2[0, 0] - top2[0, 1]).item() > 0.1:
            raise AssertionError(f"{what}: greedy token differs")
        if err > 0.1 * scale:
            raise AssertionError(f"{what}: logits differ by {err} (logit "
                                 f"scale {scale})")
        return {"max_abs_logit_err": err, "logit_scale": scale,
                "greedy_equal": bool(a.argmax(-1) == b.argmax(-1))}

    cold, _ = call(kvq.make_pool(shape, "bfloat16", dev), tokens, 0)
    _, kv = call(kvq.make_pool(shape, "bfloat16", dev), tokens[:n_pre], 0)
    warm, kv = call(kv, tokens[n_pre:], n_pre)
    out = {"partial": compare(warm, cold, "resume at 1024")}
    cold8, kv8 = call(kv, tokens[:n_pre], 0)
    src = kv8[:, :, 7 * PS:8 * PS].clone()
    kvq.copy_page(kv8, 7, P, PS)
    pt_cow = pt.clone()
    pt_cow[0, 7] = P
    hit, kv8 = call(kv8, tokens[n_pre - 1:n_pre], n_pre - 1, pt_cow)
    if not torch.equal(kv8[:, :, 7 * PS:8 * PS], src):
        raise AssertionError("the full-hit resume wrote the source page")
    out["full_hit"] = compare(hit, cold8, "full-hit resume at 1023")
    out["rows"] = [n_pre, n_suf]
    return out


# -- the mixtral family -------------------------------------------------------
#: layers of the full-width MoE check (Mixtral-8x7B's other widths whole)
MOE_CHECK_LAYERS = 2
#: a router near-tie: the smallest gap between adjacent logits among a
#: row's top k + 1 under which the two paths may route it differently
MOE_NEAR_TIE = 1e-4
#: float32 logits, kernels vs plain versions, per element: rtol * |plain|
#: + atol, on rows whose routing agreed all the way
MOE_F32_TOL = 2e-5


class RouteTape:
    """Records each mixtral layer's router while on: the top k + 1
    logits (descending) and the chosen experts of every row, one entry
    per layer call, through ``mixtral.top_k`` (the MoE layer looks it up
    at each call)."""

    def __init__(self, torch, mixtral):
        self.torch, self.mixtral, self.calls = torch, mixtral, []

    def __enter__(self):
        self._orig = orig = self.mixtral.top_k

        def record(logits, k):
            vals, idx = orig(logits, k)
            top = self.torch.sort(logits, dim=-1, descending=True).values
            self.calls.append((top[..., :k + 1].clone(), idx.clone()))
            return vals, idx

        self.mixtral.top_k = record
        return self

    def __exit__(self, *exc):
        self.mixtral.top_k = self._orig


def route_diff(torch, kern: RouteTape, plain: RouteTape, slot_of, tainted,
               near_tie: float | None) -> dict:
    """Rows the two runs of one model call routed differently, layer by
    layer: a row of a slot already ``tainted`` (it differed in an earlier
    layer or call: its hidden state, and its slot's K/V, moved by a whole
    expert) is carried; any other must be a near-tie of the plain run's
    router (under ``near_tie``; None reports the gaps only). ``slot_of``
    maps each row to its slot (None: padding). Taints the slots."""
    out = {"rows": 0, "near_ties": 0, "carried": 0, "max_gap": 0.0}
    if len(kern.calls) != len(plain.calls):
        raise AssertionError("the two runs made different router calls")
    for (tk, ik), (tp, ip) in zip(kern.calls, plain.calls):
        diff = (ik != ip).any(-1)
        if not diff.any():
            continue
        gaps = (tp[:, :-1] - tp[:, 1:]).min(-1).values
        fresh = []
        for r in torch.nonzero(diff)[:, 0].tolist():
            s = slot_of[r]
            out["rows"] += 1
            if s is not None and s in tainted:
                out["carried"] += 1
                continue
            gap = gaps[r].item()
            out["max_gap"] = max(out["max_gap"], gap)
            if near_tie is not None and gap >= near_tie:
                raise AssertionError(f"row {r} routed differently at a "
                                     f"router gap of {gap}")
            out["near_ties"] += 1
            fresh.append(s)
        tainted.update(s for s in fresh if s is not None)
    return out


def model_check_moe(torch, mixtral, dtype, dev: str = "cuda") -> dict:
    """Mixtral-8x7B widths at MOE_CHECK_LAYERS layers, random weights in
    ``dtype`` (float32 or bfloat16) over a pool of that dtype: a packed
    prefill of 4 sequences, 8 fused decode steps, 8 chained steps (K3),
    one verify step of width 5 through K5 (a slot off, one fenced), each
    through the kernels against the same call with ``plain=True``
    (teacher-forced on the kernel path's greedy tokens). Each call's
    [L, E + 1] routing counts are compared. In float32 every row routed
    differently must be a router near-tie (or carried from one) and the
    logits of the other rows agree within MOE_F32_TOL; in bfloat16 the
    routing differences are reported, and the logits of the rows whose
    routing agreed are held to model_check's tolerance (0.1 of the logit
    scale, greedy flips only at a top-2 gap under 0.1)."""
    from dataclasses import replace

    from aigw_tpu_torch.models import kvq

    cfg = replace(mixtral.MIXTRAL_8X7B, n_layers=MOE_CHECK_LAYERS)
    params = mixtral.init_params(21, cfg, dtype, dev)
    PS, P, S = 128, 16, 5
    lens = [700, 45, 250, 3]
    B = len(lens)
    g = torch.Generator(device=dev)
    g.manual_seed(77)
    T = -(-sum(lens) // 256) * 256
    tokens = torch.randint(0, cfg.vocab_size, (T,), generator=g, device=dev)
    row_seq = torch.full((T,), B, dtype=torch.int32, device=dev)
    positions = torch.zeros((T,), dtype=torch.int32, device=dev)
    last = torch.zeros((B,), dtype=torch.int32, device=dev)
    prefill_slot: list = [None] * T
    o = 0
    for b, n in enumerate(lens):
        row_seq[o:o + n] = b
        positions[o:o + n] = torch.arange(n, device=dev)
        last[b] = o + n - 1
        prefill_slot[o:o + n] = [b] * n
        o += n
    pt = torch.arange(B * P, dtype=torch.int32, device=dev).reshape(B, P)
    kv_dtype = "float32" if dtype == torch.float32 else "bfloat16"
    shape = (cfg.n_layers, 2, (B * P + 1) * PS, cfg.n_kv_heads, cfg.head_dim)
    pools = {False: kvq.make_pool(shape, kv_dtype, dev),
             True: kvq.make_pool(shape, kv_dtype, dev)}
    f32 = dtype == torch.float32
    tainted: set = set()
    report = {"calls": 0, "stats_differ": 0, "route_rows": 0,
              "near_ties": 0, "carried": 0, "max_gap": 0.0,
              "max_abs_logit_err": 0.0, "logit_scale": 0.0,
              "greedy_mismatches": 0, "greedy_rows": 0}

    def both(fn, *args, slot_of, **kw):
        """One entry point through the kernels and plain, on each side's
        own pool; returns the kernel path's logits after the checks."""
        out, tapes = {}, {}
        for plain in (False, True):
            with RouteTape(torch, mixtral) as tape:
                logits, pools[plain], stats = fn(
                    params, cfg, *_place(args, pools[plain]), plain=plain,
                    moe_stats=True, **kw)
            out[plain], tapes[plain] = (logits, stats), tape
        (lk, sk), (lp, sp) = out[False], out[True]
        if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
            raise AssertionError("non-finite MoE logits")
        if tuple(sk.shape) != (cfg.n_layers, cfg.n_experts + 1):
            raise AssertionError(f"stats of shape {tuple(sk.shape)}")
        if int(sk.sum()) != len(slot_of) * cfg.n_layers \
                * cfg.experts_per_token:
            raise AssertionError("routing counts do not cover every row")
        d = route_diff(torch, tapes[False], tapes[True], slot_of, tainted,
                       MOE_NEAR_TIE if f32 else None)
        report["calls"] += 1
        report["stats_differ"] += int(not torch.equal(sk, sp))
        report["route_rows"] += d["rows"]
        report["near_ties"] += d["near_ties"]
        report["carried"] += d["carried"]
        report["max_gap"] = max(report["max_gap"], d["max_gap"])
        if not d["rows"] and not torch.equal(sk, sp):
            raise AssertionError("routing counts differ with equal routes")
        return lk, lp

    def gate(lk, lp, slots):
        """The logits of rows whose slot's routing agreed throughout."""
        keep = torch.tensor([s not in tainted for s in slots],
                            device=dev)
        a, b = lk[keep], lp[keep]
        if not len(a):
            return
        err = (a - b).abs()
        scale = b.abs().max().item()
        report["max_abs_logit_err"] = max(report["max_abs_logit_err"],
                                          err.max().item())
        report["logit_scale"] = max(report["logit_scale"], scale)
        differ = a.argmax(-1) != b.argmax(-1)
        report["greedy_mismatches"] += int(differ.sum())
        report["greedy_rows"] += len(a)
        if f32:
            if (err > MOE_F32_TOL * b.abs() + MOE_F32_TOL).any():
                raise AssertionError(f"float32 MoE logits differ by "
                                     f"{err.max().item()}")
            return
        top2 = torch.topk(b, 2, dim=-1).values
        gap = top2[:, 0] - top2[:, 1]
        if differ.any() and gap[differ].max().item() > 0.1:
            raise AssertionError("bf16 MoE greedy token differs at a "
                                 "top-2 gap over 0.1")
        if err.max().item() > 0.1 * scale:
            raise AssertionError(f"bf16 MoE logits differ by "
                                 f"{err.max().item()} (scale {scale})")

    lk, lp = both(mixtral.prefill_ragged, tokens, row_seq, positions, last,
                  None, pt, PS, slot_of=prefill_slot)
    gate(lk, lp, range(B))
    tok = lk.argmax(-1).to(torch.int32)
    pos = torch.tensor(lens, dtype=torch.int32, device=dev)
    active = torch.ones((B,), dtype=torch.bool, device=dev)
    for rung in ("fused", "chained"):
        for _ in range(8):
            lk, lp = both(mixtral.decode_step, tok, pos, None, pt, PS,
                          active, rung, slot_of=list(range(B)))
            gate(lk, lp, range(B))
            tok = lk.argmax(-1).to(torch.int32)
            pos = pos + 1
    draft = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                          device=dev, dtype=torch.int32)
    draft[:, 0] = tok
    active[3] = False
    limits = pos + 64
    limits[1] = pos[1] + 2  # fenced after two positions
    lk, lp = both(mixtral.verify_step, draft, pos, None, pt, PS, active,
                  limits, "chained",
                  slot_of=[b for b in range(B) for _ in range(S)])
    valid = (active[:, None] & (pos[:, None] + torch.arange(
        S, device=dev) < limits[:, None])).reshape(-1)
    rows = [b for b in range(B) for _ in range(S)]
    vk = lk.reshape(B * S, -1)[valid]
    vp = lp.reshape(B * S, -1)[valid]
    gate(vk, vp, [r for r, v in zip(rows, valid.tolist()) if v])
    report["layers"] = cfg.n_layers
    report["tainted_slots"] = sorted(tainted)
    del params, pools
    return report


# -- per-token logprobs, n > 1 and tenant-fair admission ------------------------
LP_TOPK = 20


def _lp_requests(reqs) -> list:
    """The logprobs burst, over ``_requests``' prompts (64 new tokens
    each, every stream asking for its usage): two greedy chats with
    ``top_logprobs`` 5 (one streamed), two greedy legacy completions
    with ``logprobs`` 3 (one streamed), a sampled chat with ``n`` 4 and
    ``top_logprobs`` 2, a streamed completion with ``n`` 3 and no
    logprobs, a greedy chat with ``n`` 2, and a request with no
    logprobs."""
    def text(i):
        b = reqs[i][2]
        return b["prompt"] if "prompt" in b else b["messages"][0]["content"]

    def chat(i, stream, **kw):
        return ("chat", stream, {
            "model": "llama-3-8b-random", "max_tokens": SERVE_MAX_TOKENS,
            "messages": [{"role": "user", "content": text(i)}],
            "stream": stream, **kw})

    def completion(i, stream, **kw):
        return ("completion", stream, {
            "model": "llama-3-8b-random", "max_tokens": SERVE_MAX_TOKENS,
            "prompt": text(i), "stream": stream, **kw})

    greedy = {"temperature": 0.0}
    out = [
        chat(0, True, logprobs=True, top_logprobs=5, **greedy),
        chat(2, False, logprobs=True, top_logprobs=5, **greedy),
        completion(1, False, logprobs=3, **greedy),
        completion(3, True, logprobs=3, **greedy),
        chat(4, False, n=4, temperature=0.8, seed=11, logprobs=True,
             top_logprobs=2),
        completion(5, True, n=3, temperature=0.8, seed=5),
        chat(6, False, n=2, **greedy),
        completion(7, False, temperature=0.8, seed=107),
    ]
    for _kind, stream, body in out:
        if stream:
            body["stream_options"] = {"include_usage": True}
    return out


def _lp_call(port: int, kind: str, stream: bool, body: dict,
             headers: dict | None = None) -> dict:
    """One request → {"choices": [{"text", "finishes", "chat" (content
    entries) or "legacy" (the legacy lists)}], "usage"}; a stream is
    reassembled per index and must end with exactly one [DONE]."""
    path = "/v1/chat/completions" if kind == "chat" else "/v1/completions"
    status, ctype, raw = _http(port, path, body, headers)
    if status != 200:
        raise AssertionError(f"{kind} status {status}")
    choices: dict = {}

    def add(ch, text, lp):
        c = choices.setdefault(ch["index"], {"text": "", "finishes": [],
                                             "chat": None, "legacy": None})
        c["text"] += text or ""
        if ch.get("finish_reason") is not None:
            c["finishes"].append(ch["finish_reason"])
        if lp is None:
            return
        if "content" in lp:
            c["chat"] = (c["chat"] or []) + lp["content"]
        else:
            acc = c["legacy"] or {"tokens": [], "token_logprobs": [],
                                  "top_logprobs": []}
            for k in acc:
                acc[k] = acc[k] + lp[k]
            c["legacy"] = acc

    if not stream:
        resp = json.loads(raw)
        for ch in resp["choices"]:
            add(ch, ch["message"]["content"] if kind == "chat"
                else ch["text"], ch.get("logprobs"))
        usage = resp["usage"]
    else:
        if not ctype.startswith("text/event-stream"):
            raise AssertionError(f"stream content-type {ctype!r}")
        frames = [ln[6:] for ln in raw.split("\n")
                  if ln.startswith("data: ")]
        if frames[-1] != "[DONE]" or frames.count("[DONE]") != 1:
            raise AssertionError("SSE stream not ended by one [DONE]")
        usage = None
        for f in frames[:-1]:
            ev = json.loads(f)
            usage = ev.get("usage") or usage
            for ch in ev["choices"]:
                add(ch, ch["delta"].get("content") if kind == "chat"
                    else ch["text"], ch.get("logprobs"))
    return {"choices": [choices[i] for i in sorted(choices)],
            "usage": usage}


def _lp_gate(kind: str, body: dict, reply: dict) -> None:
    """Every choice present once, one finish per streamed index, and
    with logprobs one entry per completion token: ``k`` alternates,
    values sorted and <= 0, ``bytes`` the piece's UTF-8."""
    n = body.get("n", 1)
    if len(reply["choices"]) != n:
        raise AssertionError(f"{len(reply['choices'])} choices, want {n}")
    if body["stream"] and any(c["finishes"] != [c["finishes"][0]]
                              for c in reply["choices"]):
        raise AssertionError("a streamed index without exactly one finish")
    k = (body.get("top_logprobs", 0) if kind == "chat"
         else body.get("logprobs"))
    if body.get("logprobs") is None:
        if any(c["chat"] or c["legacy"] for c in reply["choices"]):
            raise AssertionError("logprobs on a request without them")
        return
    entries = 0
    for c in reply["choices"]:
        if kind == "chat":
            for e in c["chat"]:
                tops = e["top_logprobs"]
                vals = [t["logprob"] for t in tops]
                if (len(tops) != k or vals != sorted(vals, reverse=True)
                        or max(vals + [e["logprob"]]) > 0.0
                        or e["bytes"] != list(e["token"].encode())
                        or any(t["bytes"] != list(t["token"].encode())
                               for t in tops)):
                    raise AssertionError(f"a malformed entry: {e}")
            entries += len(c["chat"])
        else:
            lg = c["legacy"]
            if not (len(lg["tokens"]) == len(lg["token_logprobs"])
                    == len(lg["top_logprobs"])):
                raise AssertionError("legacy logprobs lists disagree")
            for lp, top in zip(lg["token_logprobs"], lg["top_logprobs"]):
                if lp > 0.0 or not 1 <= len(top) <= k \
                        or max(top.values()) > 0.0:
                    raise AssertionError(f"a malformed legacy entry: {top}")
            entries += len(lg["tokens"])
    if entries != reply["usage"]["completion_tokens"]:
        raise AssertionError(f"{entries} logprobs entries for "
                             f"{reply['usage']['completion_tokens']} tokens")


def _lp_burst(port: int, burst, headers=None) -> list:
    results: list = [None] * len(burst)

    def one(i):
        try:
            results[i] = _lp_call(port, *burst[i],
                                  headers=(headers or [None] * len(burst))[i])
            _lp_gate(burst[i][0], burst[i][2], results[i])
        except Exception as e:  # noqa: BLE001 — reported below, fails run
            results[i] = e

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(burst))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    for i, r in enumerate(results):
        if not isinstance(r, dict):
            raise AssertionError(f"logprobs request {i} failed: {r!r}")
    return results


def teacher_forced(torch, params, cfg, prompt: list, rows: list,
                   dev: str = "cuda") -> dict:
    """Recompute a greedy stream's logprobs in float32 through the plain
    functions: one prefill over prompt + completion whose [m] gathered
    rows are the logits each completion token was drawn from. Returns
    the largest |served - recomputed| chosen logprob, and per token
    whether the served token is the recomputed top-1 and the
    recomputed top-2 logit gap."""
    from aigw_tpu_torch.models import kvq, llama

    PS = 128
    toks = [t for t, _c in rows]
    ids = prompt + toks[:-1]
    T, n, m = len(ids), len(prompt), len(toks)
    P = -(-T // PS)
    kv = kvq.make_pool((cfg.n_layers, 2, (P + 1) * PS, cfg.n_kv_heads,
                        cfg.head_dim), "float32", dev)
    pt = torch.zeros((m, P), dtype=torch.int32, device=dev)
    pt[0] = torch.arange(P, dtype=torch.int32, device=dev)
    logits, _ = llama.prefill_ragged(
        params, cfg, torch.tensor(ids, device=dev),
        torch.zeros((T,), dtype=torch.int32, device=dev),
        torch.arange(T, dtype=torch.int32, device=dev),
        torch.arange(n - 1, n - 1 + m, dtype=torch.int32, device=dev),
        kv, pt, PS, plain=True)
    logp = torch.log_softmax(logits.float(), dim=-1)
    tok = torch.tensor(toks, device=dev)
    want = logp[torch.arange(m, device=dev), tok]
    served = torch.tensor([c for _t, c in rows], device=dev)
    top2 = torch.topk(logits.float(), 2, dim=-1)
    return {"max_err": (served - want).abs().max().item(),
            "top1": (top2.indices[:, 0] == tok).tolist(),
            "gap": (top2.values[:, 0] - top2.values[:, 1]).tolist()}


def serve_logprobs(torch, srv, params, reqs, launches: dict,
                   dev: str = "cuda") -> dict:
    """Per-token logprobs, ``n > 1`` and tenant-fair admission at full
    depth (32 layers, bf16, a bf16 pool, the prefix cache on,
    ``logprobs_topk=20``) through the port's server: the burst
    (``_lp_requests``) cold and warm on the fused rung (K1, K2), its
    first four requests on the chained rung (K3), then a two-tenant
    sub-burst (``x-aigw-tenant`` a x 6 and b x 2) at
    ``tenant_slot_cap=4``, polling ``/state``. Gates: ``_lp_gate`` on
    every reply; every served entry equal to the engine's own value; a
    greedy token its top-1 (or tied with it) and its value the top-1's
    within 1e-5; the ``n: 4`` choices not all equal, the greedy ``n: 2``
    ones equal; the tenant cap held at every poll, deferrals counted,
    ``ttft_hist_buckets``' +Inf count the sub-burst's requests. The two
    greedy chats are recomputed in float32 (``teacher_forced``); their
    bound comes from ``model_check`` and is gated in ``main``. Launches
    go into ``launches`` under ``serve_logprobs``; returns the line's
    fields."""
    from aigw_tpu_torch.models import llama
    from aigw_tpu_torch.obs.metrics import EnginePhases
    from aigw_tpu_torch.tpuserve.engine import Engine, EngineConfig

    cfg = llama.LLAMA3_8B
    t_phase = time.monotonic()
    captured: dict = {}

    def start(**engine_kw):
        stop_engine(srv)
        eng = Engine(params, cfg, EngineConfig(**{
            **dict(max_batch_size=8, max_seq_len=2048, page_size=128,
                   attention_backend="pallas-ragged",
                   decode_backend="fused", logprobs_topk=LP_TOPK),
            **engine_kw}), eos_token_ids=(srv.tokenizer.eos_id,),
            device=dev)
        submit = eng.submit

        def recording(req):
            # the engine's own (token, chosen, top) per request, keyed
            # by prompt: the served entries are held to them
            if req.emit_lp is not None:
                rows: list = []
                captured.setdefault(tuple(req.prompt), []).append(rows)
                emit_lp = req.emit_lp

                def tap(t, f, c, top, rows=rows, emit_lp=emit_lp):
                    if t >= 0:
                        rows.append((t, c, top))
                    emit_lp(t, f, c, top)

                req.emit_lp = tap
            submit(req)

        eng.submit = recording
        srv.engine = eng
        eng.warmup()
        eng.start()

    burst = _lp_requests(reqs)
    out: dict = {"logprobs_topk": LP_TOPK, "requests": len(burst),
                 "engine_requests": sum(b.get("n", 1) for _k, _s, b in burst)}
    start()
    reset_counts()
    t = time.monotonic()
    cold = _lp_burst(srv.port, burst)
    out["cold_s"] = time.monotonic() - t
    cold_rows = dict(captured)
    _wait_idle(srv)
    captured.clear()
    srv.engine.phases = EnginePhases()
    t = time.monotonic()
    warm = _lp_burst(srv.port, burst)
    out["warm_s"] = time.monotonic() - t
    st = _wait_idle(srv)
    pp = st["phase_percentiles"]
    out.update({"warm_ttft_p50_ms": pp["ttft"]["p50"],
                "warm_ttft_p95_ms": pp["ttft"]["p95"],
                "warm_prefill_p50_ms": pp["prefill"]["p50"],
                "warm_prefix_cache_hits": st["prefix_cache_hits"]})
    c_fused = read_counts()

    # the served entries are the engine's values; greedy tokens are
    # their top-1
    greedy_ok = 0
    for (kind, _s, body), reply in zip(burst, cold):
        if body.get("logprobs") is None:
            continue
        prompt = tuple(srv.encode_chat(body) if kind == "chat"
                       else srv.encode_text(body))
        served_rows = cold_rows.get(prompt)
        if not served_rows or len(served_rows) != body.get("n", 1):
            raise AssertionError("a logprobs request was not captured")
        served = [[e["logprob"] for e in c["chat"]] if kind == "chat"
                  else c["legacy"]["token_logprobs"]
                  for c in reply["choices"]]
        engine_side = sorted([[c for _t, c, _top in r]
                              for r in served_rows])
        if sorted(served) != engine_side:
            raise AssertionError("served logprobs differ from the engine's")
        if body.get("temperature", 1.0) > 0:
            continue
        for r in served_rows:
            for tok, chosen, top in r:
                ties = [i for i, v in top if v == top[0][1]]
                if tok not in ties or abs(chosen - top[0][1]) > 1e-5:
                    raise AssertionError(f"greedy token {tok} is not top-1:"
                                         f" {chosen} vs {top[:2]}")
                greedy_ok += 1
    out["greedy_top1_checked"] = greedy_ok
    n4 = [c["text"] for c in cold[4]["choices"]]
    n2 = [c["text"] for c in cold[6]["choices"]]
    if len(set(n4)) < 2 or len(set(n2)) != 1:
        raise AssertionError(f"n choices: {len(set(n4))} distinct of 4 "
                             f"sampled, {len(set(n2))} of 2 greedy")
    out["warm_equals_cold_greedy"] = (
        warm[1]["choices"][0]["text"] == cold[1]["choices"][0]["text"])

    # the teacher-forced recompute of the two greedy chats (float32)
    p32 = {k: v.float() for k, v in params.items()}
    tf = []
    for _kind, _s, body in burst[:2]:
        prompt = srv.encode_chat(body)
        rows = [(t, c) for t, c, _top in cold_rows[tuple(prompt)][0]]
        tf.append(teacher_forced(torch, p32, cfg, prompt, rows, dev))
    del p32
    torch.cuda.empty_cache()
    out["teacher_forced"] = {
        "max_err": max(r["max_err"] for r in tf),
        "tokens": sum(len(r["top1"]) for r in tf),
        "top1_mismatches": [g for r in tf
                            for ok, g in zip(r["top1"], r["gap"]) if not ok]}

    # the chained rung: the first four requests (K3)
    start(pallas_attn=True, decode_backend="auto")
    t = time.monotonic()
    _lp_burst(srv.port, burst[:4])
    out["chained_s"] = time.monotonic() - t
    c_chained = read_counts()
    _wait_idle(srv)

    # two tenants at a slot cap of 4: a x 6, b x 2
    start(tenant_slot_cap=4)
    sub = [(k, s, {key: v for key, v in b.items()
                   if key not in ("logprobs", "top_logprobs", "n")})
           for k, s, b in _lp_requests(reqs)]
    polls: list = []
    stop = threading.Event()

    def poll():
        while not stop.is_set():
            polls.append(json.loads(_http(srv.port, "/state")[2]))
            time.sleep(0.02)

    poller = threading.Thread(target=poll)
    poller.start()
    try:
        t = time.monotonic()
        _lp_burst(srv.port, sub, headers=[{"x-aigw-tenant": "a"}] * 6
                  + [{"x-aigw-tenant": "b"}] * 2)
        out["tenant_burst_s"] = time.monotonic() - t
    finally:
        stop.set()
        poller.join()
    st = _wait_idle(srv)
    c_all = read_counts()
    stop_engine(srv)
    peak = max(p["tenant_max_slots"] for p in polls)
    buckets = st["ttft_hist_buckets"]
    out["tenants"] = {
        "polls": len(polls), "tenant_max_slots_peak": peak,
        "tenants_active_peak": max(p["tenants_active"] for p in polls),
        "tenant_deferrals": st["tenant_deferrals"],
        "tenant_slot_cap": st["tenant_slot_cap"],
        "ttft_hist_inf": buckets["+Inf"]}
    if peak > 4 or st["tenant_deferrals"] <= 0 or buckets["+Inf"] != 8 \
            or list(buckets)[-1] != "+Inf":
        raise AssertionError(f"tenant sub-burst: {out['tenants']}")
    d_chained = {k: c_chained[k] - c_fused[k] for k in c_all}
    if c_fused["ragged_prefill_attention"] <= 0 \
            or c_fused["fused_paged_decode"] <= 0 \
            or d_chained["paged_attention_decode_v2"] <= 0:
        raise AssertionError(f"K1 / K2 / K3 not on the logprobs path: "
                             f"fused {c_fused}, chained {d_chained}")
    out["launches"] = {"fused": c_fused, "chained": d_chained,
                       "all": c_all}
    launches["serve_logprobs"] = c_all
    out["phase_s"] = time.monotonic() - t_phase
    log(f"logprobs burst ({out['engine_requests']} engine requests) cold "
        f"{out['cold_s']:.1f}s, warm {out['warm_s']:.1f}s; teacher-forced "
        f"max error {out['teacher_forced']['max_err']:.4f}; tenants "
        f"{out['tenants']}; phase {out['phase_s']:.1f}s")
    return out


def gate_teacher_forced(lp: dict, check: dict) -> None:
    """The served chosen logprobs of the greedy chats lie within twice
    ``model_check``'s bf16 logit bound of the float32 recompute (a
    log-softmax moves at most twice its logits' largest error), and a
    token that is not the recomputed top-1 sits at a top-2 gap under
    that bound."""
    bound = check["logit_bound"]
    tf = lp["teacher_forced"]
    tf["bound"] = 2 * bound
    if tf["max_err"] > 2 * bound or any(g >= bound
                                        for g in tf["top1_mismatches"]):
        raise AssertionError(f"teacher-forced logprobs: {tf}, logit bound "
                             f"{bound}")


def _place(args, pool):
    """An entry point's arguments with the pool put where ``None``
    stands."""
    return tuple(pool if a is None else a for a in args)


MOE_MODEL = "mixtral-8x7b-random"


def _moe_requests(reqs) -> list:
    """A burst's requests addressed to the Mixtral replica."""
    return [(kind, stream, dict(body, model=MOE_MODEL))
            for kind, stream, body in reqs]


def _aligned_request() -> tuple:
    """A greedy completion of exactly 8 pages (BOS + 1023 bytes): asked
    again, a full prefix-cache hit (its last page copied on write, one
    row resumed at 1023)."""
    text = ("the quick brown fox jumps over a lazy dog " * 30)[
        :PREFIX_C_BYTES]
    return ("completion", False, {
        "model": MOE_MODEL, "prompt": text, "temperature": 0.0,
        "max_tokens": SERVE_MAX_TOKENS})


def serve_moe(torch, mixtral, reqs, launches: dict,
              dev: str = "cuda") -> None:
    """Mixtral-8x7B widths at full depth (32 layers) through the port's
    server: random weights drawn and quantized to int8 one tensor at a
    time (W8A16; the bf16 model does not fit the card), a bf16 KV pool,
    8 slots of 2048 tokens, page 128, the fused rung, the prefix cache
    on. The burst cold, then warm (its prompts' cached pages resumed
    through K1 at their offsets, page-aligned ones as full hits), then
    one decode step's time at batch 8; then the chained rung at a fixed
    draft width of 4 (K3 and K5) over two pinned requests and a sampled
    one of the burst. The burst is chip_smoke's with one 8-page
    completion added (its warm ask a full hit). The ``serve_moe`` JSON line; launches go into
    ``launches`` under ``serve_moe``."""
    from aigw_tpu_torch.models.registry import ModelSpec, register_model
    from aigw_tpu_torch.obs.metrics import EnginePhases
    from aigw_tpu_torch.tpuserve.engine import Engine, EngineConfig
    from aigw_tpu_torch.tpuserve.server import TPUServeServer

    cfg = mixtral.MIXTRAL_8X7B
    register_model(ModelSpec(MOE_MODEL, "mixtral", cfg))
    torch.cuda.reset_peak_memory_stats()
    reqs = _moe_requests(reqs) + [_aligned_request()]
    kw = dict(max_batch_size=8, max_seq_len=2048, page_size=128,
              attention_backend="pallas-ragged")
    t = time.monotonic()
    srv = TPUServeServer(MOE_MODEL, EngineConfig(
        **kw, decode_backend="fused"), device=dev, port=0,
        quantize="int8")
    srv.start()
    torch.cuda.synchronize()
    params = srv.engine.params
    w_gb = sum(v.numel() * v.element_size() for v in params.values()) / 1e9
    log(f"Mixtral-8x7B widths up in {time.monotonic() - t:.1f}s: "
        f"{w_gb:.2f} GB of W8A16 weights, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    # the server's warm-up at the default knobs: the decode ladder at
    # the quiesced page bucket, captured
    out: dict = {"weights_gb": w_gb,
                 "init_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                 "warmup_ms": srv.engine.stats.warmup_ms,
                 "warm_programs": srv.engine.stats.warm_programs,
                 "graph_pool_bytes_after_warmup":
                 srv.engine.programs.bytes()}
    try:
        reset_counts()
        t = time.monotonic()
        results = serve_phase(srv.port, reqs)
        out["cold_s"] = time.monotonic() - t
        cold = json.loads(_http(srv.port, "/state")[2])
        srv.engine.phases = EnginePhases()
        t = time.monotonic()
        serve_phase(srv.port, reqs)
        out["warm_s"] = time.monotonic() - t
        served = read_counts()
        state = json.loads(_http(srv.port, "/state")[2])
        pp = state["phase_percentiles"]
        log(f"Mixtral served the burst cold in {out['cold_s']:.1f}s, warm "
            f"in {out['warm_s']:.1f}s ({state['prefix_cache_hits']} prefix "
            f"hits); launches {served}")
        for k in ("ragged_prefill_attention", "fused_paged_decode",
                  "w8a16_matmul"):
            if served[k] <= 0:
                raise AssertionError(f"{k} not on the Mixtral served path: "
                                     f"{served}")
        total = state["moe_tokens_routed"] + state["moe_tokens_dropped"]
        unit = cfg.n_layers * cfg.experts_per_token
        if total <= 0 or total % unit:
            raise AssertionError(f"routing counts {total} are not a "
                                 f"positive multiple of {unit}")
        if len(state["moe_expert_load"]) != cfg.n_experts:
            raise AssertionError(f"moe_expert_load "
                                 f"{state['moe_expert_load']}")
        if state["prefix_cache_hits"] <= cold["prefix_cache_hits"] \
                or state["prefix_full_hits"] <= cold["prefix_full_hits"]:
            raise AssertionError("the warm burst resumed no cached prefix, "
                                 "or made no full hit")
        out.update({
            "requests": len(reqs), "new_tokens": sum(r["n"] for r in results),
            "prompt_tokens": served_prompt_lens(reqs),
            "warm_prefix_cache_hits": state["prefix_cache_hits"]
            - cold["prefix_cache_hits"],
            "warm_prefix_full_hits": state["prefix_full_hits"]
            - cold["prefix_full_hits"],
            "warm_prefix_tokens_reused": state["prefix_tokens_reused"]
            - cold["prefix_tokens_reused"],
            "warm_decode_steps": state["decode_steps"]
            - cold["decode_steps"],
            "warm_prefill_p50_ms": pp["prefill"]["p50"],
            "warm_prefill_p95_ms": pp["prefill"]["p95"],
            "warm_ttft_p50_ms": pp["ttft"]["p50"],
            "warm_ttft_p95_ms": pp["ttft"]["p95"],
            "warm_decode_per_token_p50_ms": pp["decode_per_token"]["p50"],
            "state_rebuilds": state["state_rebuilds"],
            **{k: state[k] for k in (
                "moe_tokens_routed", "moe_tokens_dropped",
                "moe_dropped_frac", "moe_expert_imbalance",
                "moe_expert_load", "moe_layer_drops", "kv_pool_bytes")},
            "launches": served})
        stop_engine(srv)
        prof = decode_profile(torch, params, cfg, dev, model=mixtral)
        log(f"Mixtral decode step at batch 8: {prof['wall_ms']:.2f} ms "
            f"wall, {prof['device_ms']:.2f} ms on the device; top "
            f"kernels {prof['top_kernels_ms']}")
        out["decode_profile"] = prof

        # the chained rung at a fixed draft width of 4: the pinned pair
        # (32 tokens) speculates through K5; the sampled request (64,
        # ineligible) decodes on alone in plain windows through K3
        srv.engine = Engine(params, cfg, EngineConfig(
            **kw, pallas_attn=True, spec_tokens=4, spec_adaptive=False),
            eos_token_ids=(srv.tokenizer.eos_id,), fns=srv.fns,
            device=dev)
        srv.engine.start()
        spec_reqs = _moe_requests(_pinned_requests(2)) + [reqs[0]]
        for _kind, _stream, body in spec_reqs[:2]:
            body["max_tokens"] = 32
        if reqs[0][2]["temperature"] <= 0:
            raise AssertionError("the spec phase needs a sampled request")
        reset_counts()
        t = time.monotonic()
        results_s = serve_phase(srv.port, spec_reqs)
        spec_s = time.monotonic() - t
        served_s = read_counts()
        _check_pinned(results_s[:2], 32)
        st = json.loads(_http(srv.port, "/state")[2])
        log(f"Mixtral speculative (chained, width 4): {spec_s:.1f}s, "
            f"spec_accepted {st['spec_accepted']} of {st['spec_drafted']}; "
            f"launches {served_s}")
        if served_s["paged_attention_verify"] <= 0 \
                or served_s["paged_attention_decode_v2"] <= 0:
            raise AssertionError(f"K5 / K3 not on the Mixtral chained "
                                 f"path: {served_s}")
        if st["spec_accepted"] <= 0:
            raise AssertionError("no draft accepted on the Mixtral pinned "
                                 "requests")
        out["spec"] = {
            "decode_attn_impl": st["decode_attn_impl"], "requests":
            len(spec_reqs), "wall_s": spec_s,
            "decode_steps": st["decode_steps"],
            "spec_drafted": st["spec_drafted"],
            "spec_accepted": st["spec_accepted"],
            "moe_tokens_routed": st["moe_tokens_routed"],
            "moe_tokens_dropped": st["moe_tokens_dropped"],
            "launches": served_s}
        out["max_memory_allocated_gb"] = \
            torch.cuda.max_memory_allocated() / 1e9
    finally:
        srv.stop()
        srv.engine = None
    print(json.dumps({"serve_moe": out}), flush=True)
    launches["serve_moe"] = {k: served[k] + served_s[k] for k in served}


# -- multi-LoRA -----------------------------------------------------------------
#: every projection a LoRA adapter can target
LORA_TARGETS_ALL = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
LORA_CHECK_LAYERS = 2
#: model_check_lora's slot rows: adapters a0-a3 (rows 0-3), the base row 4
LORA_CHECK_ROWS = [0, 4, 1, 2, 0, 4, 3, 1]
LORA_MODEL = "llama-3-8b-random"


def model_check_lora(torch, dtype, dev: str = "cuda") -> dict:
    """Llama-3-8B widths at ``LORA_CHECK_LAYERS`` layers in ``dtype``, 4
    adapters at rank 16 on all seven targets (``random_b``) plus the base
    row, slots on rows ``LORA_CHECK_ROWS``: a packed prefill of 8
    sequences (K1), 8 fused steps (K2) and 8 chained steps (K3) from it,
    one verify step of width 5 (K5), and the same on the weights in
    W8A16 (K6). Each call runs through the kernels and through their
    plain versions (``model_check``'s tolerances: logits within a tenth
    of their scale, a greedy flip only at a near-tie), and each also
    with ``lora=None``: the base rows' logits must be bit-equal to it,
    every adapter row's must differ. Step tokens are seeded, the same
    for every run."""
    import dataclasses

    from aigw_tpu_torch.models import kvq, llama, lora, quant

    cfg = dataclasses.replace(llama.LLAMA3_8B, n_layers=LORA_CHECK_LAYERS)
    dense = llama.init_params(11, cfg, dtype, dev)
    stacks = lora.init_lora_adapters(
        12, cfg, lora.LoRAConfig(targets=LORA_TARGETS_ALL), 4, dtype,
        random_b=True, device=dev)
    rows = torch.tensor(LORA_CHECK_ROWS, device=dev)
    base = rows == 4
    PS, P, S = 128, 16, 5
    lens = [300, 45, 700, 3, 128, 129, 500, 90]
    B = len(lens)
    g = torch.Generator(device=dev)
    g.manual_seed(13)
    T = -(-sum(lens) // 256) * 256
    tokens = torch.randint(0, cfg.vocab_size, (T,), generator=g, device=dev)
    row_seq = torch.full((T,), B, dtype=torch.int32, device=dev)
    positions = torch.zeros((T,), dtype=torch.int32, device=dev)
    last = torch.zeros((B,), dtype=torch.int32, device=dev)
    o = 0
    for b, n in enumerate(lens):
        row_seq[o:o + n] = b
        positions[o:o + n] = torch.arange(n, device=dev)
        last[b] = o + n - 1
        o += n
    pt = torch.arange(B * P, dtype=torch.int32, device=dev).reshape(B, P)
    shape = (cfg.n_layers, 2, (B * P + 1) * PS, cfg.n_kv_heads,
             cfg.head_dim)
    pos = torch.tensor(lens, dtype=torch.int32, device=dev)
    act = torch.ones((B,), dtype=torch.bool, device=dev)
    steps = torch.randint(0, cfg.vocab_size, (8, B), generator=g,
                          device=dev, dtype=torch.int32)
    drafts = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                           device=dev, dtype=torch.int32)

    def calls(params, plain, lo):
        """Every call's logits: prefill, 8 fused, 8 chained, verify."""
        kw = dict(plain=plain, lora=lo,
                  adapter_idx=rows if lo is not None else None)
        kv = kvq.make_pool(shape, "bfloat16", dev)
        out = [llama.prefill_ragged(params, cfg, tokens, row_seq, positions,
                                    last, kv, pt, PS, **kw)[0]]
        for impl in ("fused", "chained"):
            kv2 = kv.clone()
            for s in range(8):
                out.append(llama.decode_step(params, cfg, steps[s], pos + s,
                                             kv2, pt, PS, act, impl,
                                             **kw)[0])
            del kv2
        out.append(llama.verify_step(params, cfg, drafts, pos, kv, pt, PS,
                                     act, pos + 64, "chained", **kw)[0])
        return out

    result = {}
    for wname in ("dense", "w8a16"):
        params = dense if wname == "dense" else quant.quantize_params(
            dense, consume=False, mode="int8")
        kern, plain = calls(params, False, stacks), calls(params, True, stacks)
        kern0, plain0 = calls(params, False, None), calls(params, True, None)
        errs, flips, worst = [], 0, 0.0
        for a, b, a0, b0 in zip(kern, plain, kern0, plain0):
            if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
                raise AssertionError(f"LoRA {wname}: non-finite logits")
            errs.append((a - b).abs().max().item())
            bb = b.reshape(-1, b.shape[-1])
            top2 = torch.topk(bb, 2, dim=-1).values
            differ = a.reshape(bb.shape).argmax(-1) != bb.argmax(-1)
            if differ.any():
                gap = (top2[:, 0] - top2[:, 1])[differ].max().item()
                worst = max(worst, gap)
                flips += int(differ.sum())
            for x, x0, what in ((a, a0, "kernels"), (b, b0, "plain")):
                if not torch.equal(x[base], x0[base]):
                    raise AssertionError(f"LoRA {wname} ({what}): a base "
                                         f"row differs from lora=None")
                for i in torch.nonzero(~base).flatten().tolist():
                    if torch.equal(x[i], x0[i]):
                        raise AssertionError(f"LoRA {wname} ({what}): "
                                             f"adapter row {i} equals its "
                                             f"base output")
        scale = plain[0].abs().max().item()
        if worst > 0.1:
            raise AssertionError(f"LoRA {wname}: greedy token differs at a "
                                 f"top-2 gap of {worst}")
        if max(errs) > 0.1 * scale:
            raise AssertionError(f"LoRA {wname}: logits differ by "
                                 f"{max(errs)} (logit scale {scale})")
        result[wname] = {"max_abs_logit_err": max(errs),
                         "logit_scale": scale, "greedy_mismatches": flips,
                         "calls": len(kern), "base_rows_bitwise": True}
        del params, kern, plain, kern0, plain0
    result.update(layers=cfg.n_layers, rank=16, targets=list(
        LORA_TARGETS_ALL), rows=LORA_CHECK_ROWS)
    return result


def _lora_zoo(torch, cfg, targets=("wq", "wv"), n: int = 4,
              seed: int = 21, dev: str = "cuda") -> tuple:
    """``n`` adapters at rank 16 on ``targets`` (``random_b``, bf16, on
    ``dev``): the stacks and one dict per adapter."""
    from aigw_tpu_torch.models import lora

    stacks = lora.init_lora_adapters(seed, cfg, lora.LoRAConfig(
        targets=targets), n, torch.bfloat16, random_b=True, device=dev)
    return stacks, {f"a{i}": {k: v[i] for k, v in stacks.items()}
                    for i in range(n)}


def _lora_requests(reqs) -> list:
    """The burst addressed to the zoo: 2 base, ``:a0`` three times (one a
    chat), ``:a1``, the bare name ``a2`` and ``:a3``."""
    models = ["", "", ":a0", ":a0", ":a1", "a2", ":a3", ":a0"]
    out = []
    for (kind, stream, body), m in zip(reqs, models):
        name = LORA_MODEL + m if m.startswith(":") or not m else m
        out.append((kind, stream, dict(body, model=name)))
    return out


def _expect_404(port: int, path: str, body: dict, names) -> str:
    """An unknown adapter suffix: 404 with the reference's message."""
    try:
        _http(port, path, body)
    except urllib.error.HTTPError as e:
        err = json.loads(e.read().decode())["error"]
        want = f"unknown LoRA adapter 'nope'; loaded: {sorted(names)}"
        if e.code != 404 or err["message"] != want \
                or err["type"] != "model_not_found":
            raise AssertionError(f"unknown adapter: {e.code} {err}")
        return err["message"]
    raise AssertionError("an unknown adapter was served")


def _wait_idle(srv, timeout_s: float = 60.0) -> dict:
    """/state once the engine holds no slot and no window."""
    deadline = time.monotonic() + timeout_s
    while True:
        st = json.loads(_http(srv.port, "/state")[2])
        if (st["active_slots"] == 0 and srv.engine._inflight is None) \
                or time.monotonic() > deadline:
            return st
        time.sleep(0.05)


def lora_load_ms(torch, cfg, targets, dev: str = "cuda") -> dict:
    """Host time of one adapter's hot load (a 1-row store, so every
    acquire after the first evicts and loads), synchronized: the median
    of 5, beside its bytes in bf16."""
    from aigw_tpu_torch.tpuserve.adapters import AdapterStore

    _, zoo = _lora_zoo(torch, cfg, targets, n=2, seed=31, dev=dev)
    store = AdapterStore(n_slots=1, device=dev)
    for name, ad in zoo.items():
        store.register(name, ad)
    store.warm()
    nbytes = sum(v.numel() * 2 for v in zoo["a0"].values())
    times = []
    for i in range(6):
        row = store.acquire(f"a{i % 2}")
        torch.cuda.synchronize()
        t = time.monotonic()
        store.release(row)
        row = store.acquire(f"a{(i + 1) % 2}")
        torch.cuda.synchronize()
        times.append((time.monotonic() - t) * 1e3)
        store.release(row)
    return {"targets": list(targets), "bytes": nbytes,
            "load_ms": statistics.median(times[1:]), "loads": store.loads}


def serve_lora(torch, srv, params, qparams, reqs, launches: dict,
               dev: str = "cuda") -> None:
    """Multi-LoRA at full depth (32 layers, bf16) through the port's
    server: a zoo of 4 adapters at the reference's default
    ``LoRAConfig()`` (wq and wv, rank 16) over 2 device rows, the fused
    rung, the prefix cache on. The burst (``_lora_requests``) cold and
    warm: every request 200, ``:nope`` a 404 on both routes,
    ``/v1/models`` listing the 4, ``/state`` counting at least 4 loads
    and 2 evictions, at most 2 resident, no adapter slot when idle; K1
    and K2 launch. Then the chained rung at a fixed draft width of 4:
    two pinned base requests of 32 tokens (K5, drafts accepted) beside a
    sampled ``:a2`` request of 64 that decodes on alone (K3). Then
    W8A16 weights with the zoo (K6). Then, not gated: one adapter's load
    time (wq + wv, and all seven targets), one decode step at batch 8
    with 8 adapter slots, with 8 base slots (the same delta kernels on
    the zero row) and without adapters, and one packed prefill of the
    burst's prompts with and without adapters (the delta's device time
    is the difference). The ``serve_lora`` JSON line; the serving
    runs' launches go into ``launches`` under ``serve_lora``."""
    from aigw_tpu_torch.models import llama
    from aigw_tpu_torch.obs.metrics import EnginePhases
    from aigw_tpu_torch.tpuserve.adapters import AdapterStore
    from aigw_tpu_torch.tpuserve.engine import Engine, EngineConfig

    cfg = llama.LLAMA3_8B
    stacks, zoo = _lora_zoo(torch, cfg, dev=dev)
    names = sorted(zoo)

    def start(p, **engine_kw):
        stop_engine(srv)
        t = time.monotonic()
        store = AdapterStore(n_slots=2, device=dev)
        for name, ad in zoo.items():
            store.register(name, ad)
        register_s = time.monotonic() - t
        srv.adapter_store = store
        srv.engine = Engine(p, cfg, EngineConfig(**{
            **dict(max_batch_size=8, max_seq_len=2048, page_size=128,
                   attention_backend="pallas-ragged",
                   decode_backend="fused"), **engine_kw}),
            eos_token_ids=(srv.tokenizer.eos_id,), device=dev,
            adapter_store=store)
        srv.engine.warmup()
        srv.engine.start()
        return register_s

    out: dict = {"adapters": names, "rows": 2, "rank": 16,
                 "targets": ["wq", "wv"]}
    burst = _lora_requests(reqs)
    try:
        out["register_s"] = start(params)
        reset_counts()
        t = time.monotonic()
        results = serve_phase(srv.port, burst)
        out["cold_s"] = time.monotonic() - t
        cold = _wait_idle(srv)
        srv.engine.phases = EnginePhases()
        t = time.monotonic()
        serve_phase(srv.port, burst)
        out["warm_s"] = time.monotonic() - t
        c_burst = read_counts()
        st = _wait_idle(srv)
        models = [m["id"] for m in json.loads(
            _http(srv.port, "/v1/models")[2])["data"]]
        want_models = [LORA_MODEL] + [f"{LORA_MODEL}:{n}" for n in names]
        if models != want_models:
            raise AssertionError(f"/v1/models lists {models}")
        for path, body in (("/v1/chat/completions", burst[0][2]),
                           ("/v1/completions", burst[1][2])):
            for stream in (False, True):
                out["not_found"] = _expect_404(srv.port, path, dict(
                    body, model=f"{LORA_MODEL}:nope", stream=stream), names)
        keys = {k: st[k] for k in (
            "adapters_registered", "adapters_resident", "adapter_rows",
            "adapter_loads", "adapter_evictions", "adapter_slots")}
        if (keys["adapter_loads"] < 4 or keys["adapter_evictions"] < 2
                or len(keys["adapters_resident"]) > 2
                or keys["adapter_slots"] != 0
                or keys["adapters_registered"] != names):
            raise AssertionError(f"/state adapter keys {keys}")
        if c_burst["ragged_prefill_attention"] <= 0 \
                or c_burst["fused_paged_decode"] <= 0:
            raise AssertionError(f"K1 / K2 not on the LoRA served path: "
                                 f"{c_burst}")
        pp = st["phase_percentiles"]
        out.update({
            "requests": len(burst), "new_tokens": sum(r["n"]
                                                      for r in results),
            "prompt_tokens": served_prompt_lens(burst),
            "cold_state": {k: cold[k] for k in keys}, "state": keys,
            "warm_prefix_cache_hits": st["prefix_cache_hits"]
            - cold["prefix_cache_hits"],
            "warm_prefill_p50_ms": pp["prefill"]["p50"],
            "warm_prefill_p95_ms": pp["prefill"]["p95"],
            "warm_ttft_p50_ms": pp["ttft"]["p50"],
            "warm_ttft_p95_ms": pp["ttft"]["p95"],
            "launches": c_burst})
        log(f"LoRA zoo (4 adapters, 2 rows) served the burst cold in "
            f"{out['cold_s']:.1f}s, warm in {out['warm_s']:.1f}s; {keys}")

        # the chained rung at a fixed draft width of 4: the pinned pair
        # speculates through K5, the sampled adapter request decodes on
        # alone through K3
        start(params, decode_backend="auto", pallas_attn=True,
              spec_tokens=4, spec_adaptive=False)
        spec_reqs = [(k, s, dict(b, model=LORA_MODEL, max_tokens=32))
                     for k, s, b in _pinned_requests(2)]
        sampled = next((k, s, dict(b, model=f"{LORA_MODEL}:a2"))
                       for k, s, b in reqs if b["temperature"] > 0)
        spec_reqs.append(sampled)
        t = time.monotonic()
        results_s = serve_phase(srv.port, spec_reqs)
        spec_s = time.monotonic() - t
        c_spec = read_counts()
        _check_pinned(results_s[:2], 32)
        st = _wait_idle(srv)
        d_spec = {k: c_spec[k] - c_burst[k] for k in c_spec}
        if d_spec["paged_attention_verify"] <= 0 \
                or d_spec["paged_attention_decode_v2"] <= 0:
            raise AssertionError(f"K5 / K3 not on the LoRA chained path: "
                                 f"{d_spec}")
        if st["spec_accepted"] <= 0:
            raise AssertionError("no draft accepted beside the adapter slot")
        out["spec"] = {"wall_s": spec_s, "spec_drafted": st["spec_drafted"],
                       "spec_accepted": st["spec_accepted"],
                       "adapter_loads": st["adapter_loads"],
                       "launches": d_spec}

        # W8A16 weights with the zoo: K6 carries the base projections
        start(qparams)
        t = time.monotonic()
        serve_phase(srv.port, burst[:4])
        q_s = time.monotonic() - t
        c_all = read_counts()
        d_q = {k: c_all[k] - c_spec[k] for k in c_all}
        if d_q["w8a16_matmul"] <= 0:
            raise AssertionError(f"K6 not on the W8A16 LoRA path: {d_q}")
        out["w8a16"] = {"requests": 4, "wall_s": q_s, "launches": d_q}
        stop_engine(srv)
    finally:
        srv.adapter_store = None
    launches["serve_lora"] = c_all

    # the numbers: a load, a decode step, a prefill (not gated)
    out["load"] = [lora_load_ms(torch, cfg, ("wq", "wv"), dev),
                   lora_load_ms(torch, cfg, LORA_TARGETS_ALL, dev)]
    rows_ad = torch.tensor([0, 1, 2, 3] * 2, device=dev)
    rows_base = torch.full((8,), 4, device=dev)
    out["decode_profile"] = {
        name: decode_profile(torch, params, cfg, dev, lora=lo,
                             adapter_idx=idx)
        for name, lo, idx in (("adapters", stacks, rows_ad),
                              ("base", stacks, rows_base),
                              ("none", None, None))}
    seqs = [(n, 0) for n in served_prompt_lens(burst)]
    out["prefill_profile"] = {
        name: prefill_profile(torch, params, cfg, seqs, dev, lora=lo,
                              adapter_idx=idx)
        for name, lo, idx in (("adapters", stacks, rows_ad),
                              ("none", None, None))}
    out["prefill_delta_device_ms"] = (
        out["prefill_profile"]["adapters"]["device_ms"]
        - out["prefill_profile"]["none"]["device_ms"])
    out["decode_delta_device_ms"] = (
        out["decode_profile"]["adapters"]["device_ms"]
        - out["decode_profile"]["none"]["device_ms"])
    log(f"LoRA numbers: loads {out['load']}; decode step with 8 adapter "
        f"slots {out['decode_profile']['adapters']['wall_ms']:.2f} ms wall "
        f"/ {out['decode_profile']['adapters']['device_ms']:.2f} device vs "
        f"base rows {out['decode_profile']['base']['device_ms']:.2f}; "
        f"prefill delta {out['prefill_delta_device_ms']:.2f} ms device")
    print(json.dumps({"serve_lora": out}), flush=True)


# -- the operations surface (serve_ops) ---------------------------------------
class OtlpSink:
    """A local OTLP/HTTP trace collector on the standard library: the
    port's exporter posts protobuf ``ExportTraceServiceRequest`` bodies
    to ``/v1/traces``; ``spans()`` reads them back with the port's
    ``otlp_proto`` decoder."""

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        posts = self.posts = []

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802
                n = int(self.headers.get("content-length") or 0)
                posts.append((self.path, self.headers.get("content-type"),
                              self.rfile.read(n)))
                self.send_response(200)
                self.send_header("content-length", "0")
                self.end_headers()

            def log_message(self, *a):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    @property
    def endpoint(self) -> str:
        return f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def spans(self) -> list[dict]:
        from aigw_tpu_torch.obs.otlp_proto import decode_message as dm

        out = []
        for path, ctype, raw in list(self.posts):
            if path != "/v1/traces" or ctype != "application/x-protobuf":
                raise AssertionError(f"the exporter posted {ctype} to "
                                     f"{path}")
            for rs in dm(raw).get(1, []):
                for ss in dm(rs).get(2, []):
                    for sp in dm(ss).get(2, []):
                        f = dm(sp)
                        out.append({
                            "name": f[5][0].decode(),
                            "trace_id": f[1][0].hex(),
                            "span_id": f[2][0].hex(),
                            "parent": f.get(4, [b""])[0].hex(),
                            "attrs": {dm(kv)[1][0].decode()
                                      for kv in f.get(9, [])}})
        return out

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


def _ops_call(port: int, kind: str, stream: bool, body: dict,
              headers: dict | None = None) -> dict:
    """One generation: status and headers; for a 200 its tokens, finish,
    usage (a stream's usage frame) and response id."""
    path = "/v1/chat/completions" if kind == "chat" else "/v1/completions"
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"content-type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            status, hdrs, raw = r.status, dict(r.headers), r.read().decode()
    except urllib.error.HTTPError as e:
        return {"status": e.code, "headers": dict(e.headers),
                "body": e.read().decode()}
    out = _check_response(kind, stream, status, hdrs.get("content-type", ""),
                          raw)
    if stream:
        frames = [json.loads(ln[6:]) for ln in raw.split("\n")
                  if ln.startswith("data: ") and ln[6:] != "[DONE]"]
        out["usage"] = [f["usage"] for f in frames if f.get("usage")][-1]
    else:
        out["usage"] = json.loads(raw)["usage"]
    out.update(status=status, headers=hdrs,
               rid=hdrs.get("x-aigw-request-id", ""))
    return out


def _ops_burst(port: int, reqs, trace_ids=None) -> list[dict]:
    """The burst concurrently, request i under ``traceparent`` trace id
    ``trace_ids[i]``; every reply 200 with its whole length."""
    results: list = [None] * len(reqs)

    def one(i):
        kind, stream, body = reqs[i]
        headers = ({"traceparent": f"00-{trace_ids[i]}-{i + 1:016x}-01"}
                   if trace_ids else None)
        try:
            results[i] = _ops_call(port, kind, stream, body, headers)
        except Exception as e:  # noqa: BLE001 — reported below, fails run
            results[i] = e

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    for i, r in enumerate(results):
        if not isinstance(r, dict) or r["status"] != 200:
            raise AssertionError(f"ops request {i} failed: {r!r}")
        if r["n"] != reqs[i][2]["max_tokens"] and r["finish"] != "stop":
            raise AssertionError(f"ops request {i}: {r}")
    return results


def _gauge(text: str, name: str) -> float:
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    raise AssertionError(f"/metrics has no {name}")


def _meter_gates(results, before: dict, after: dict, prompt_lens) -> dict:
    """Every reply carries its MeterRecord: decode tokens sum to the
    completion tokens, prefill plus reuse to the prompt tokens, each
    residency is positive, and ``/state``'s ``meter_*`` deltas are the
    records' sums."""
    meters = []
    for r, n_prompt in zip(results, prompt_lens):
        m = r["usage"].get("aigw_meter")
        if not m:
            raise AssertionError(f"a reply without aigw_meter: {r['usage']}")
        if r["usage"]["prompt_tokens"] != n_prompt or m["segments"] != 1 \
                or m["hbm_page_byte_s"] <= 0:
            raise AssertionError(f"meter record {m} for usage {r['usage']}")
        meters.append(m)
    sums = {f: sum(m[f] for m in meters)
            for f in ("prefill_real", "prefill_padded", "prefix_reused",
                      "decode_tokens", "spec_drafted", "spec_accepted")}
    if sums["decode_tokens"] != sum(r["usage"]["completion_tokens"]
                                    for r in results) \
            or sums["prefill_real"] + sums["prefix_reused"] \
            != sum(r["usage"]["prompt_tokens"] for r in results):
        raise AssertionError(f"meter sums {sums} against the usages")
    deltas = {f: after[k] - before[k] for f, k in (
        ("records", "meter_records"),
        ("prefill_real", "meter_prefill_tokens"),
        ("prefill_padded", "meter_prefill_padded_tokens"),
        ("prefix_reused", "meter_prefix_reused_tokens"),
        ("decode_tokens", "meter_decode_tokens"),
        ("spec_drafted", "meter_spec_drafted"),
        ("spec_accepted", "meter_spec_accepted"))}
    hbm = after["meter_hbm_page_byte_s"] - before["meter_hbm_page_byte_s"]
    want = {**sums, "records": len(meters)}
    if deltas != want or abs(hbm - sum(m["hbm_page_byte_s"]
                                       for m in meters)) > 1e-3:
        raise AssertionError(f"/state meter deltas {deltas}, hbm {hbm}, "
                             f"against the records' sums {want}")
    return {**sums, "records": len(meters),
            "hbm_page_byte_s": sum(m["hbm_page_byte_s"] for m in meters)}


#: the profile capture's window, s (the burst inside it takes ~2-4)
OPS_PROFILE_S = 20.0


def serve_ops(torch, srv, params, reqs, launches: dict,
              serve_warm_s: float, dev: str = "cuda") -> dict:
    """The replica's operations surface at full depth (32 layers, bf16
    weights and pool, 8 slots x 2048, the prefix cache on, the fused
    rung), tracing on with the OTLP/HTTP exporter posting to a local
    sink and every request carrying a ``traceparent``:

    - the burst with ``/metrics`` scraped before, during and after it:
      every scrape parses and declares exactly ``metric_families()``;
      ``tpuserve_active_slots`` above 0 in a scrape during the burst; the
      TTFT histogram's buckets equal ``/state``'s ``ttft_hist_buckets``
      and its exemplars name trace ids that were sent;
      ``/debug/requests`` lists the 8 with their trace ids and token
      counts, each detail with its admission, prefill and first token;
      the sink holds each request's span with its ``gen_ai.*``
      attributes and its engine children; every reply's
      ``usage.aigw_meter`` reconciles with the usage and ``/state``;
    - the burst again with ``POST /drain`` once it decodes: new
      chat, completion and ``n = 2`` requests 503 with ``retry-after: 2``
      and ``x-aigw-draining: 1``, every live request 200 and whole, K2
      launching after the drain, ``/state`` draining and empty, then
      ``{"on": false}`` serving again;
    - ``/debug/profile`` over the burst sent wholly inside its window
      (its flight entries between the capture's request and reply): the
      Chrome trace names K1's and K2's kernels, its K2 events equal the
      K2 counter's delta, and a second capture gets 409;
    - the chained rung at a fixed draft width of 4 (two pinned requests
      and a sampled one): the records' ``spec_accepted`` sum equals
      ``/state``'s delta, K3 and K5 launch;
    - the exporter's cost, before the profile: the warm burst with the
      cache off (as ``serve``'s), untraced and traced in turns
      (untraced, traced, traced, untraced; reported beside ``serve``'s
      warm burst).

    Launches go into ``launches`` under ``serve_ops``."""
    import shutil

    from aigw_tpu_torch.models import llama
    from aigw_tpu_torch.obs.flight import FlightRecorder
    from aigw_tpu_torch.obs.metrics import metric_families, parse_exposition
    from aigw_tpu_torch.obs.tracing import Tracer
    from aigw_tpu_torch.tpuserve.engine import Engine, EngineConfig

    t_phase = time.monotonic()
    fams = metric_families()
    out: dict = {}
    prompt_lens = served_prompt_lens(reqs)
    sink = OtlpSink()
    os.environ["OTEL_EXPORTER_OTLP_ENDPOINT"] = sink.endpoint
    os.environ["OTEL_EXPORTER_OTLP_PROTOCOL"] = "http/protobuf"
    srv.tracer = Tracer(exporter="otlp", service_name="tpuserve")
    srv.flight = FlightRecorder(capacity=256)
    srv.enable_profile = True

    def start(**engine_kw):
        stop_engine(srv)
        srv.engine = Engine(params, llama.LLAMA3_8B, EngineConfig(**{
            **dict(max_batch_size=8, max_seq_len=2048, page_size=128,
                   attention_backend="pallas-ragged",
                   decode_backend="fused"), **engine_kw}),
            eos_token_ids=(srv.tokenizer.eos_id,), device=dev)
        srv.engine.warmup()
        srv.engine.start()

    def state() -> dict:
        return json.loads(_http(srv.port, "/state")[2])

    def scrape() -> str:
        status, ctype, text = _http(srv.port, "/metrics")
        got = parse_exposition(text)
        if status != 200 or not ctype.startswith("text/plain") \
                or set(got) != fams:
            raise AssertionError(
                f"/metrics families: missing {sorted(fams - set(got))}, "
                f"extra {sorted(set(got) - fams)}")
        return text

    try:
        reset_counts()
        start()
        # 1. the burst, scraped before, during and after
        ids = [f"{0x0A16C0DE00000000 + i:032x}" for i in range(len(reqs))]
        st0 = state()
        scrape()
        during: list = []
        errors: list = []
        stop = threading.Event()

        def scraper():
            while not stop.is_set():
                try:
                    during.append(_gauge(scrape(), "tpuserve_active_slots"))
                except Exception as e:  # noqa: BLE001 — raised below
                    errors.append(e)
                    return
                time.sleep(0.05)

        th = threading.Thread(target=scraper)
        th.start()
        try:
            t = time.monotonic()
            res_a = _ops_burst(srv.port, reqs, ids)
            out["burst_s"] = time.monotonic() - t
        finally:
            stop.set()
            th.join()
        if errors:
            raise errors[0]
        st1 = _wait_idle(srv)
        text = scrape()
        if not during or max(during) <= 0:
            raise AssertionError(f"no scrape saw a live slot: {during}")
        buckets, exemplars = {}, []
        for line in text.splitlines():
            if line.startswith("tpuserve_ttft_hist_ms_bucket{"):
                le = line.split('le="', 1)[1].split('"', 1)[0]
                buckets[le] = int(line.split("}", 1)[1].split()[0])
                if "# {trace_id=" in line:
                    exemplars.append(line.split('trace_id="')[1][:32])
        if buckets != st1["ttft_hist_buckets"] \
                or buckets["+Inf"] != len(reqs):
            raise AssertionError(f"TTFT buckets {buckets} against /state "
                                 f"{st1['ttft_hist_buckets']}")
        if not exemplars or not set(exemplars) <= set(ids):
            raise AssertionError(f"TTFT exemplars {exemplars} not among "
                                 f"the sent trace ids")
        snap = json.loads(_http(srv.port, "/debug/requests")[2])
        recent = {e["id"]: e for e in snap["recent"]}
        for r, tid in zip(res_a, ids):
            e = recent.get(r["rid"])
            if e is None or e["trace_id"] != tid \
                    or e["tokens_out"] != r["usage"]["completion_tokens"]:
                raise AssertionError(f"flight entry {e} for {r['rid']}")
            d = json.loads(_http(srv.port,
                                 f"/debug/requests/{r['rid']}")[2])
            names = [ev["name"] for ev in d["events"]]
            if "admission" not in names or "first_token" not in names \
                    or d["prefill_ms"] < 0 or d["ttft_ms"] < 0:
                raise AssertionError(f"flight detail {d}")
        deadline = time.monotonic() + 30
        while True:
            spans = sink.spans()
            roots = {s["trace_id"]: s for s in spans
                     if s["name"].startswith("tpuserve.")}
            if set(ids) <= set(roots) or time.monotonic() > deadline:
                break
            time.sleep(0.1)
        want_attrs = {"gen_ai.operation.name", "gen_ai.request.model",
                      "gen_ai.response.model", "gen_ai.provider.name",
                      "gen_ai.usage.input_tokens",
                      "gen_ai.usage.output_tokens"}
        for tid in ids:
            root = roots.get(tid)
            kids = {s["name"] for s in spans if root is not None
                    and s["parent"] == root["span_id"]}
            if root is None or not want_attrs <= root["attrs"] \
                    or not {"engine.queue_wait", "engine.prefill"} <= kids:
                raise AssertionError(f"span of trace {tid}: {root}, "
                                     f"children {kids}")
        out["spans_received"] = len(spans)
        out["scrapes_during"] = len(during)
        out["active_slots_peak_scraped"] = max(during)
        out["ttft_exemplars"] = len(exemplars)
        out["meter"] = _meter_gates(res_a, st0, st1, prompt_lens)
        k_a = read_counts()

        # 2. the burst again, drained once it decodes
        results_b: list = [None] * len(reqs)

        def one_b(i):
            results_b[i] = _ops_call(srv.port, *reqs[i])

        tok0 = srv.engine.stats.tokens_generated
        threads = [threading.Thread(target=one_b, args=(i,))
                   for i in range(len(reqs))]
        for t_ in threads:
            t_.start()
        deadline = time.monotonic() + 120
        while srv.engine.stats.tokens_generated < tok0 + 3 * len(reqs) \
                and time.monotonic() < deadline:
            time.sleep(0.005)
        k2_at = read_counts()["fused_paged_decode"]
        status, _ct, body = _http(srv.port, "/drain", {})
        reply = json.loads(body)
        refused = [_ops_call(srv.port, "chat", False, {
            "model": "llama-3-8b-random", "max_tokens": 4,
            "messages": [{"role": "user", "content": "late"}]}),
            _ops_call(srv.port, "completion", True, {
                "model": "llama-3-8b-random", "prompt": "late",
                "max_tokens": 4, "stream": True}),
            _ops_call(srv.port, "chat", False, {
                "model": "llama-3-8b-random", "max_tokens": 4, "n": 2,
                "temperature": 0.5,
                "messages": [{"role": "user", "content": "late"}]})]
        st_d = state()
        for t_ in threads:
            t_.join(timeout=900)
        k2_end = read_counts()["fused_paged_decode"]
        for r in refused:
            if r["status"] != 503 or r["headers"].get("retry-after") != "2" \
                    or r["headers"].get("x-aigw-draining") != "1":
                raise AssertionError(f"a request during the drain: {r}")
        for i, r in enumerate(results_b):
            if not isinstance(r, dict) or r["status"] != 200 or (
                    r["n"] != reqs[i][2]["max_tokens"]
                    and r["finish"] != "stop"):
                raise AssertionError(f"live request {i} under the drain: "
                                     f"{r}")
        st_e = _wait_idle(srv)
        if status != 200 or not reply["draining"] \
                or reply["active_slots"] + reply["queued"] <= 0 \
                or not st_d["draining"] or not st_e["draining"] \
                or st_e["active_slots"] or st_e["queued"] \
                or k2_end - k2_at <= 0:
            raise AssertionError(f"drain: reply {reply}, K2 {k2_at} -> "
                                 f"{k2_end}, /state {st_e}")
        undrain = json.loads(_http(srv.port, "/drain", {"on": False})[2])
        after = _ops_call(srv.port, *_pinned_requests(1)[0])
        if undrain["draining"] or after["status"] != 200:
            raise AssertionError(f"un-drain: {undrain}, {after}")
        out["drain"] = {"reply": reply, "refused": len(refused),
                        "k2_after_drain": k2_end - k2_at}

        # 3. the exporter's cost: the warm burst with the cache off (as
        # serve's), untraced and traced in turns (the recorder is on in
        # both, as it always is)
        start(enable_prefix_cache=False)
        serve_phase(srv.port, reqs)
        tracer = srv.tracer
        turns = {"untraced": [], "traced": []}
        for arm in ("untraced", "traced", "traced", "untraced"):
            srv.tracer = tracer if arm == "traced" \
                else Tracer(exporter="none")
            t = time.monotonic()
            serve_phase(srv.port, reqs)
            turns[arm].append(time.monotonic() - t)
        srv.tracer = tracer
        out["warm_s"] = turns
        out["warm_s_serve"] = serve_warm_s
        out["traced_over_untraced"] = (sum(turns["traced"])
                                       / sum(turns["untraced"]))

        # 4. a profile over the burst sent inside its window
        _wait_idle(srv)
        prof: dict = {}
        t_req = time.time()
        t_req_m = time.monotonic()

        def capture():
            try:
                prof["r"] = _http(srv.port, f"/debug/profile?seconds="
                                            f"{OPS_PROFILE_S}")
            except urllib.error.HTTPError as e:
                prof["r"] = (e.code, "", e.read().decode())

        th = threading.Thread(target=capture)
        th.start()
        # the profiler's first start in a process (CUPTI's set-up) takes
        # seconds: the burst goes once it is recording
        from torch.autograd import profiler as autograd_profiler

        deadline = time.monotonic() + 60
        while not autograd_profiler._is_profiler_enabled \
                and "r" not in prof:
            if time.monotonic() > deadline:
                raise AssertionError("the profile capture did not start")
            time.sleep(0.01)
        t_on = time.monotonic() - t_req_m
        time.sleep(0.5)
        try:
            _http(srv.port, "/debug/profile?seconds=1")
            busy = 200
        except urllib.error.HTTPError as e:
            busy = e.code
        c_b = read_counts()
        t = time.monotonic()
        res_p = _ops_burst(srv.port, reqs)
        burst_p_s = time.monotonic() - t
        c_p = read_counts()
        # the window was still open when the burst ended
        inside = autograd_profiler._is_profiler_enabled
        th.join(timeout=OPS_PROFILE_S + 300)
        t_resp = time.time()
        c_q = read_counts()
        status, _ct, body = prof["r"]
        if status != 200:
            raise AssertionError(f"/debug/profile: {status} {body}")
        pinfo = json.loads(body)
        trace_path = os.path.join(pinfo["profile_dir"], "trace.json")
        with open(trace_path) as fh:
            events = json.load(fh)["traceEvents"]
        shutil.rmtree(pinfo["profile_dir"])
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        n_k1 = sum("ragged_prefill_tc_kernel" in k for k in kernels)
        n_k2 = sum("fused_decode_kernel" in k for k in kernels)
        d_k2 = c_p["fused_paged_decode"] - c_b["fused_paged_decode"]
        snap = json.loads(_http(srv.port, "/debug/requests")[2])
        recent = {e["id"]: e for e in snap["recent"]}
        inside = inside and all(
            t_req <= recent[r["rid"]]["ts"]
            and recent[r["rid"]]["ts"] + recent[r["rid"]]["total_ms"] / 1e3
            <= t_resp for r in res_p)
        out["profile"] = {
            "seconds": pinfo["seconds"], "trace_events": len(events),
            "kernel_events": len(kernels), "k1_events": n_k1,
            "k2_events": n_k2, "k2_launches": d_k2,
            "second_capture_status": busy, "burst_s": burst_p_s,
            "profiler_start_s": t_on}
        if busy != 409 or n_k1 <= 0 or n_k2 != d_k2 or d_k2 <= 0 \
                or c_q != c_p or not inside:
            raise AssertionError(f"profile: {out['profile']}, inside "
                                 f"{inside}, launches after the burst "
                                 f"{c_q != c_p}")

        # 5. the chained rung, speculating at width 4
        start(pallas_attn=True, decode_backend="auto", spec_tokens=4,
              spec_adaptive=False)
        if not srv.engine.decode_attn_impl.startswith("chained"):
            raise AssertionError(f"not the chained rung: "
                                 f"{srv.engine.decode_attn_impl}")
        c_c = read_counts()
        st_c0 = state()
        spec_reqs = [(k, s, {**b, "max_tokens": 32})
                     for k, s, b in _pinned_requests(2)]
        spec_reqs.append(("completion", False, {
            "model": "llama-3-8b-random", "prompt": "sampled alone",
            "max_tokens": SERVE_MAX_TOKENS, "temperature": 0.8,
            "seed": 5}))
        res_s = _ops_burst(srv.port, spec_reqs)
        _check_pinned(res_s[:2], 32)
        st_c1 = _wait_idle(srv)
        c_s = read_counts()
        acc = sum(r["usage"]["aigw_meter"]["spec_accepted"] for r in res_s)
        d_acc = st_c1["spec_accepted"] - st_c0["spec_accepted"]
        d_k3 = c_s["paged_attention_decode_v2"] \
            - c_c["paged_attention_decode_v2"]
        d_k5 = c_s["paged_attention_verify"] - c_c["paged_attention_verify"]
        out["spec"] = {"spec_accepted_records": acc,
                       "spec_accepted_state": d_acc, "k3": d_k3,
                       "k5": d_k5}
        if acc != d_acc or acc <= 0 or d_k3 <= 0 or d_k5 <= 0:
            raise AssertionError(f"chained rung metering: {out['spec']}")
        counts = read_counts()
        stop_engine(srv)
    finally:
        sink.close()
        srv.tracer = Tracer(exporter="none")
        srv.enable_profile = False
        os.environ.pop("OTEL_EXPORTER_OTLP_ENDPOINT", None)
        os.environ.pop("OTEL_EXPORTER_OTLP_PROTOCOL", None)
    need = ("ragged_prefill_attention", "fused_paged_decode",
            "paged_attention_decode_v2", "paged_attention_verify")
    if any(counts[k] <= 0 for k in need):
        raise AssertionError(f"K1 / K2 / K3 / K5 not on the ops path: "
                             f"{counts}")
    out["launches"] = counts
    out["launches_first_burst"] = k_a
    launches["serve_ops"] = counts
    out["phase_s"] = time.monotonic() - t_phase
    log(f"ops surface: burst {out['burst_s']:.2f}s, {len(during)} scrapes "
        f"during it, {out['spans_received']} spans, drain "
        f"{out['drain']}, profile {out['profile']}, spec {out['spec']}, "
        f"warm bursts {turns} (serve's {serve_warm_s:.2f}s); phase "
        f"{out['phase_s']:.1f}s")
    return out


# -- KV mobility and the batch tier (serve_mobility) --------------------------
#: the near-tie bound a token flip between two bf16 runs of one request
#: is held to: model_check's (a greedy flip only where the float32
#: recompute puts the two tokens within 0.1 of each other; a sampled one
#: where their scores, logits / temperature plus the key's Gumbel noise,
#: lie within 0.1 / temperature)
TIE_BOUND = 0.1
#: tokens a stream has on the source when the script asks for its cut;
#: the cut lands at a settled window boundary after the window in flight
#: (and the one dispatched before the export job runs) settles: asked at
#: 1 it landed at 3, asked at 16 at 39 (the windows grow from 2 to 8
#: steps once the streams are two ticks old)
MOB_CUT_AFTER = 4


class TokenTap:
    """Every token an engine emits, per request: keyed by the response id
    of a traced HTTP request (a migrated continuation keeps its id), else
    by the original prompt (batch lines). Installed on ``submit``; a
    parked batch session resumes through the tapped emit."""

    def __init__(self, engine):
        self.toks: dict = {}
        self.prompts: dict = {}
        self.sampling: dict = {}
        submit = engine.submit

        def tapped_submit(req):
            ims = req.import_state or {}
            prompt = list(req.prompt[:ims.get("orig_prompt_len",
                                               len(req.prompt))])
            key = (req.trace.entry.rid if req.trace is not None
                   else tuple(prompt))
            rec = self.toks.setdefault(key, [])
            self.prompts.setdefault(key, prompt)
            self.sampling.setdefault(key, req.sampling)
            emit = req.emit

            def tapped(tok, fin):
                if tok >= 0:
                    rec.append(tok)
                emit(tok, fin)

            req.emit = tapped
            submit(req)

        engine.submit = tapped_submit


def recompute_row(torch, params, cfg, ids: list, dev: str = "cuda"):
    """float32 logits [V] of the position after ``ids``, through the plain
    functions (one prefill of the whole history)."""
    from aigw_tpu_torch.models import kvq, llama

    PS = 128
    T = len(ids)
    P = -(-T // PS)
    kv = kvq.make_pool((cfg.n_layers, 2, (P + 1) * PS, cfg.n_kv_heads,
                        cfg.head_dim), "float32", dev)
    pt = torch.arange(P, dtype=torch.int32, device=dev)[None]
    logits, _ = llama.prefill_ragged(
        params, cfg, torch.tensor(ids, device=dev),
        torch.zeros((T,), dtype=torch.int32, device=dev),
        torch.arange(T, dtype=torch.int32, device=dev),
        torch.tensor([T - 1], dtype=torch.int32, device=dev), kv, pt, PS,
        plain=True)
    return logits[0].float()


def tie_check(torch, params, cfg, prompt, sp, want, got, eos) -> dict:
    """Where two runs of one request part (``j``, the completion index;
    None when equal), and the float32 recompute's gap there between the
    two tokens they chose, in the sampler's units: for a greedy request
    the logits with the request's penalties and bias, for a sampled one
    those over the temperature plus the Gumbel noise of the key at ``j``
    (counter 0 for the first token, else len(prompt) + j - 1). A run
    that stopped early chose EOS there."""
    from aigw_tpu_torch.tpuserve.sampling import gumbel

    if want == got:
        return {"equal": True, "j": None, "gap": 0.0, "bound": 0.0}
    n = min(len(want), len(got))
    j = next((i for i in range(n) if want[i] != got[i]), n)
    a = want[j] if j < len(want) else eos
    b = got[j] if j < len(got) else eos
    logits = recompute_row(torch, params, cfg, list(prompt) + want[:j])
    counts = torch.zeros_like(logits)
    for t in want[:j]:
        counts[t] += 1
    logits = (logits - sp.frequency_penalty * counts
              - sp.presence_penalty * (counts > 0).float())
    for t, bias in sp.logit_bias:
        logits[t] += bias
    bound = TIE_BOUND
    if sp.temperature > 0.0:
        counter = 0 if j == 0 else len(prompt) + j - 1
        key = torch.tensor([[sp.seed & 0xFFFFFFFF, counter]],
                           dtype=torch.int64, device=logits.device)
        logits = logits / sp.temperature + gumbel(key, logits.shape[0])[0]
        bound = TIE_BOUND / sp.temperature
    gap = abs(logits[a] - logits[b]).item()
    return {"equal": False, "j": j, "gap": gap, "bound": bound}


def _gate_ties(what: str, checks: list) -> None:
    bad = [c for c in checks if not c["equal"] and c["gap"] >= c["bound"]]
    if bad:
        raise AssertionError(f"{what}: streams part away from a near-tie: "
                             f"{bad}")


def _post_raw(port: int, path: str, data: bytes, headers=None):
    """(status, headers, body bytes) of a POST whose body is ``data``."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        headers={"content-type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _state(port: int) -> dict:
    return json.loads(_http(port, "/state")[2])


def _mob_chats(rng, eos: int) -> list[dict]:
    """Four streamed chats of 300-1000 prompt tokens, 64 new tokens each:
    two greedy, two seeded with repetition penalties. A logit bias keeps
    EOS out, so every stream is long enough to be cut."""
    words = "the quick brown fox jumps over a lazy dog while rivers run".split()

    def text(n_bytes: int) -> str:
        out = ""
        while len(out) <= n_bytes:
            out += " " + words[int(rng.integers(len(words)))]
        return out[1:n_bytes + 1]

    chats = []
    for i, n in enumerate([280, 520, 760, 980]):
        body = {"model": "llama-3-8b-random", "max_tokens": SERVE_MAX_TOKENS,
                "stream": True, "stream_options": {"include_usage": True},
                "logit_bias": {str(eos): -100.0},
                "messages": [{"role": "user",
                              "content": "ABCD"[i] + text(n)}]}
        if i % 2:
            body.update(temperature=0.8, seed=500 + i,
                        frequency_penalty=0.5, presence_penalty=0.3)
        else:
            body.update(temperature=0.0)
        chats.append(body)
    return chats


class _Stream:
    """One streamed chat read to its end in a thread: its response id,
    its finish reason and usage, and whether it ended with ``[DONE]``
    (most of the random model's tokens decode to no text, so the
    tokens themselves are read from the engine's ``TokenTap``)."""

    def __init__(self, port: int, body: dict, path="/v1/chat/completions",
                 data: bytes | None = None):
        self.t0 = time.monotonic()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}",
            data=data if data is not None else json.dumps(body).encode(),
            headers={"content-type": "application/json"})
        self.resp = urllib.request.urlopen(req, timeout=600)
        self.rid = self.resp.headers["x-aigw-request-id"]
        self.finish = None
        self.done = False
        self.usage = None
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()

    def _read(self):
        for line in self.resp:
            line = line.strip()
            if not line.startswith(b"data: "):
                continue
            if line[6:] == b"[DONE]":
                self.done = True
                break
            ev = json.loads(line[6:])
            self.usage = ev.get("usage") or self.usage
            for ch in ev.get("choices") or ():
                self.finish = ch.get("finish_reason") or self.finish
        self.resp.close()

    def join(self):
        self.thread.join(timeout=600)
        if self.thread.is_alive():
            raise AssertionError(f"stream {self.rid} never ended")


def _mob_swap(srv, params, base: dict, **kw):
    """Restart ``srv``'s engine with ``base`` + ``kw``; returns its tap."""
    from aigw_tpu_torch.models import llama
    from aigw_tpu_torch.tpuserve.engine import Engine, EngineConfig

    old, srv.engine = srv.engine, None
    old.stop()
    del old
    gc.collect()  # its pool goes before the new one is made
    srv.engine = Engine(params, llama.LLAMA3_8B,
                        EngineConfig(**{**base, **kw}),
                        eos_token_ids=(srv.tokenizer.eos_id,),
                        device="cuda")
    srv.engine.start()
    return TokenTap(srv.engine)


def _mob_migrate(torch, a, b, params, base, chats, kv_dtype: str) -> dict:
    """Step 1 (bf16) or 2 (int8): the chats served uncut on A, then again
    on A, each cut through ``/migrate/export`` (asked once it has
    MOB_CUT_AFTER tokens) and imported into B through
    ``/migrate/import`` (B's continuation streams under the same id).
    Gates: B's pages after the import equal
    the exported wire pages string for string; B launched K1 and K2
    (K7-int8 on an int8 pool); 4 migrations out of A and into B; bf16
    streams equal the uncut ones up to a near-tie."""
    from aigw_tpu_torch.models import llama
    from aigw_tpu_torch.tpuserve.server import encode_wire_page

    cfg = llama.LLAMA3_8B
    tap_a = _mob_swap(a, params, base, kv_cache_dtype=kv_dtype)
    tap_b = _mob_swap(b, params, base, kv_cache_dtype=kv_dtype)
    out: dict = {"kv_cache_dtype": kv_dtype}
    uncut = [_Stream(a.port, body) for body in chats]
    for s in uncut:
        s.join()
        if not (s.done and s.finish in ("length", "stop")):
            raise AssertionError(f"uncut stream {s.rid}: {s.finish}")
    _wait_idle(a)
    st_a0, st_b0 = _state(a.port), _state(b.port)
    ex0 = a.engine.stats.kv_export_ms
    cut = [_Stream(a.port, body) for body in chats]
    # each stream cut from its own thread once it has its tokens, so no
    # stream runs to its end while another's export is being written
    results: list = [None] * len(cut)

    def export(i: int) -> None:
        s = cut[i]
        deadline = time.monotonic() + 300
        while len(tap_a.toks.get(s.rid, ())) < MOB_CUT_AFTER:
            if time.monotonic() > deadline:
                results[i] = f"stream {s.rid} never reached the cut"
                return
            time.sleep(0.002)
        t = time.monotonic()
        status, _h, raw = _post_raw(
            a.port, "/migrate/export",
            json.dumps({"request_id": s.rid}).encode())
        results[i] = (status, 1e3 * (time.monotonic() - t), raw)

    threads = [threading.Thread(target=export, args=(i,))
               for i in range(len(cut))]
    t_ex = time.monotonic()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    export_wall_ms = 1e3 * (time.monotonic() - t_ex)
    exports, export_ms, raw_bytes = [], [], []
    for s, r in zip(cut, results):
        if not isinstance(r, tuple) or r[0] != 200:
            raise AssertionError(
                f"export of {s.rid} after {len(tap_a.toks.get(s.rid, ()))} "
                f"tokens: {str(r)[:300]}")
        export_ms.append(r[1])
        raw_bytes.append(r[2])
        exports.append(json.loads(r[2]))
    for s in cut:
        s.join()
        if s.done or s.finish is not None:
            raise AssertionError(f"the cut stream {s.rid} ended with "
                                 f"terminal frames")
    _wait_idle(a)
    pages = [len(e["pages"]) for e in exports]
    n_pages = sum(pages)
    out["pages"] = pages
    out["cut_at_tokens"] = [e["blob"]["generated"] for e in exports]
    # the four exports run at once: their wall over all their pages, and
    # each one's own wall (the handlers' base64 and JSON share the GIL)
    out["export_ms"] = export_ms
    out["export_ms_per_page"] = export_wall_ms / n_pages
    out["export_copy_ms_per_page"] = (a.engine.stats.kv_export_ms
                                      - ex0) / n_pages
    out["wire_mb_per_page"] = sum(len(r) for r in raw_bytes) / n_pages / 1e6
    # B: every continuation, one after the other's first token
    reset_counts()
    im0 = b.engine.stats.kv_import_ms
    conts = []
    for raw in raw_bytes:
        s = _Stream(b.port, {}, "/migrate/import", data=raw)
        # the reply's headers follow the import; its first token is B's
        # resume
        deadline = time.monotonic() + 300
        while not tap_b.toks.get(s.rid):
            if time.monotonic() > deadline:
                raise AssertionError(f"continuation {s.rid} never started")
            time.sleep(0.001)
        conts.append((s, 1e3 * (time.monotonic() - s.t0)))
    for s, _ms in conts:
        s.join()
        if not (s.done and s.finish in ("length", "stop")):
            raise AssertionError(f"continuation {s.rid}: {s.finish}")
        if s.usage is not None and s.usage["completion_tokens"] \
                != len(tap_a.toks[s.rid]) + len(tap_b.toks[s.rid]):
            raise AssertionError(f"continuation usage {s.usage}")
    _wait_idle(b)
    counts = read_counts()
    out["launches"] = counts
    out["import_copy_ms_per_page"] = (b.engine.stats.kv_import_ms
                                      - im0) / n_pages
    out["resume_ttft_ms"] = [ms for _s, ms in conts]
    need = (("fused_paged_decode_int8",) if kv_dtype == "int8"
            else ("ragged_prefill_attention", "fused_paged_decode"))
    if any(counts[k] <= 0 for k in need):
        raise AssertionError(f"the target's kernels did not launch: {counts}")
    # the pages B holds are the exported pages, byte for byte
    for e in exports:
        keys = [bytes.fromhex(h) for h in e["blob"]["chain"]]
        held = b.engine.kv_export_pages(keys)
        if [k for k, _d in held] != keys or \
                [encode_wire_page(d) for _k, d in held] != e["pages"]:
            raise AssertionError("the imported pages differ from the "
                                 "exported ones")
    st_a1, st_b1 = _state(a.port), _state(b.port)
    moved = (st_a1["migrations_out"] - st_a0["migrations_out"],
             st_b1["migrations_in"] - st_b0["migrations_in"])
    if moved != (4, 4):
        raise AssertionError(f"migrations out/in: {moved}")
    out["migration_pages_in"] = (st_b1["migration_pages_in"]
                                 - st_b0["migration_pages_in"])
    checks = []
    for u, s in zip(uncut, cut):
        checks.append(tie_check(
            torch, params, cfg, tap_a.prompts[u.rid], tap_a.sampling[u.rid],
            tap_a.toks[u.rid], tap_a.toks[s.rid] + tap_b.toks[s.rid],
            a.tokenizer.eos_id))
    out["streams_equal"] = sum(c["equal"] for c in checks)
    out["stream_ties"] = [c for c in checks if not c["equal"]]
    if kv_dtype != "int8":
        _gate_ties("migrated streams", checks)
    out["histories"] = [e["blob"]["tokens"] for e in exports]
    return out


def _cold_ttft_ms(srv, params, base, histories) -> list:
    """Each history prefilled cold (the prefix cache off) for one token,
    alone: enqueue to first token."""
    from aigw_tpu_torch.tpuserve.engine import GenRequest
    from aigw_tpu_torch.tpuserve.sampling import SamplingParams

    _mob_swap(srv, params, base, enable_prefix_cache=False)
    out = []
    for hist in histories:
        done = threading.Event()
        req = GenRequest(prompt=list(hist), max_tokens=1,
                         sampling=SamplingParams(temperature=0.0),
                         emit=lambda t, f: done.set() if f else None)
        t = time.monotonic()
        srv.engine.submit(req)
        if not done.wait(300):
            raise AssertionError("a cold prefill never finished")
        out.append(1e3 * (time.monotonic() - t))
    return out


def _mob_fetch(torch, a, b, params, base, chat: dict) -> dict:
    """Step 3: a chat behind serve_prefix's 1089-token system message on
    A, then the same chat on B naming A in ``x-aigw-kv-peers``. Gates:
    B fetched once, every full written page of the prompt on A, its
    prefix hit covering them; B's stream equals A's up to a near-tie."""
    from aigw_tpu_torch.models import llama

    tap_a = _mob_swap(a, params, base)
    tap_b = _mob_swap(b, params, base)
    body = dict(chat, stream=False)
    raw_body = json.dumps(body).encode()
    status, ha, _raw = _post_raw(a.port, "/v1/chat/completions", raw_body)
    if status != 200:
        raise AssertionError(f"A: {status}")
    _wait_idle(a)
    n = len(tap_a.prompts[ha["x-aigw-request-id"]])
    time.sleep(0.6)  # A's chain digest is rebuilt at most every 0.5 s
    before = _state(b.port)
    reset_counts()
    t = time.monotonic()
    status, hb, _raw = _post_raw(
        b.port, "/v1/chat/completions", raw_body,
        {"x-aigw-kv-peers": f"127.0.0.1:{a.port}"})
    wall_ms = 1e3 * (time.monotonic() - t)
    if status != 200:
        raise AssertionError(f"B: {status}")
    _wait_idle(b)
    after = _state(b.port)
    want_pages = (n - 1) // 128
    got = {k: after[k] - before[k] for k in (
        "kv_fetches_in", "kv_fetch_pages_in", "prefix_cache_hits",
        "prefix_tokens_reused")}
    if got != {"kv_fetches_in": 1, "kv_fetch_pages_in": want_pages,
               "prefix_cache_hits": 1,
               "prefix_tokens_reused": want_pages * 128}:
        raise AssertionError(f"fleet fetch of {want_pages} pages: {got}")
    if hb.get("x-aigw-kv-chain") != ha.get("x-aigw-kv-chain"):
        raise AssertionError("the two replicas name different chains")
    ra, rb = ha["x-aigw-request-id"], hb["x-aigw-request-id"]
    check = tie_check(torch, params, llama.LLAMA3_8B, tap_a.prompts[ra],
                      tap_a.sampling[ra], tap_a.toks[ra], tap_b.toks[rb],
                      a.tokenizer.eos_id)
    _gate_ties("fetched stream", [check])
    return {"prompt_tokens": n, "pages": want_pages, **got,
            "fetch_failures": b.kv_fetch_failures, "b_wall_ms": wall_ms,
            "launches": read_counts(), "stream": check}


#: pool and spill budget of the spill step: 24 pages of 128 tokens (a
#: wave of four ~1000-token prompts registers 28), and 64 pages of host
#: memory
MOB_SPILL_PAGES = 24
MOB_HOST_PAGES = 64


def _mob_spill(torch, a, params, base, rng) -> dict:
    """Step 4: A restarted with a 24-page pool and a 64-page host tier;
    wave one (four ~1000-token completions, 16 new tokens each, one at
    a time), wave two (four others) evicting its chains into the tier,
    then wave one again, revived. Gates: spills and revives above 0; each
    revived page, read back from the pool or the tier, equals the page
    that was spilled, string for string on the wire; the re-asked streams
    equal the first ones up to a near-tie. Reports the stall a spill adds
    to the engine thread."""
    from aigw_tpu_torch.models import llama

    words = "the quick brown fox jumps over a lazy dog while rivers run".split()

    def text(i: int, n_bytes: int) -> str:
        out = "EFGHIJKL"[i]
        while len(out) <= n_bytes:
            out += " " + words[int(rng.integers(len(words)))]
        return out[:n_bytes]

    page_bytes = a.engine.kv_page_bytes
    tap = _mob_swap(a, params, base, num_pages=MOB_SPILL_PAGES,
                    kv_host_bytes=MOB_HOST_PAGES * page_bytes)
    tier = a.engine.host_tier
    taken: dict = {}
    take = tier.take

    def recording_take(key):
        rows = take(key)
        if rows is not None:
            taken[key] = rows  # the spilled bytes, as the tier held them
        return rows

    tier.take = recording_take
    waves = [[text(i + 4 * w, 1000) for i in range(4)] for w in range(2)]
    rids: list = []
    reset_counts()
    for prompt in waves[0] + waves[1] + waves[0]:
        status, h, _raw = _post_raw(a.port, "/v1/completions", json.dumps({
            "model": "llama-3-8b-random", "prompt": prompt,
            "max_tokens": 16, "temperature": 0.0}).encode())
        if status != 200:
            raise AssertionError(f"spill step: {status}")
        rids.append(h["x-aigw-request-id"])
        _wait_idle(a)
    st = a.engine.stats
    a.engine._refresh_stats()
    if st.kv_spills <= 0 or st.kv_revives <= 0 or not taken:
        raise AssertionError(f"spills {st.kv_spills}, revives "
                             f"{st.kv_revives}")
    held = a.engine.kv_export_pages(list(taken))
    if len(held) != len(taken) or any(
            not torch.equal(d, taken[k]) for k, d in held):
        raise AssertionError("a revived page differs from its spilled "
                             "bytes")
    checks = [tie_check(torch, params, llama.LLAMA3_8B, tap.prompts[r0],
                        tap.sampling[r0], tap.toks[r0], tap.toks[r1],
                        a.tokenizer.eos_id)
              for r0, r1 in zip(rids[:4], rids[8:])]
    _gate_ties("revived streams", checks)
    return {"num_pages": MOB_SPILL_PAGES,
            "kv_host_bytes": MOB_HOST_PAGES * page_bytes,
            "kv_spills": st.kv_spills, "kv_revives": st.kv_revives,
            "kv_spill_evictions": st.kv_spill_evictions,
            "pages_revived_checked": len(held),
            "spill_stall_ms_per_page": st.kv_spill_ms / st.kv_spills,
            "revive_copy_ms_per_page": st.kv_import_ms / st.kv_revives,
            "prefix_tokens_reused": st.prefix_tokens_reused,
            "streams_equal": sum(c["equal"] for c in checks),
            "stream_ties": [c for c in checks if not c["equal"]],
            "launches": read_counts()}


def _mob_batch(torch, a, params, base, reqs, rng, serve_pp: dict) -> dict:
    """Step 5: a /v1/batches job of 12 chat lines at batch_slot_frac 0.5,
    and while it runs the serve burst of 8 interactive requests. Gates:
    preemptions above 0 and all resumed; the batch completed with 12
    lines, each equal to the same line served alone up to a near-tie.
    Reports the interactive TTFT p50/p95 beside serve's."""
    from aigw_tpu_torch.models import llama

    words = "the quick brown fox jumps over a lazy dog while rivers run".split()

    def text(i: int, n_bytes: int) -> str:
        out = "MNOPQRSTUVWXYZ"[i]
        while len(out) <= n_bytes:
            out += " " + words[int(rng.integers(len(words)))]
        return out[:n_bytes]

    tap = _mob_swap(a, params, base, batch_slot_frac=0.5)
    lines = [{"custom_id": f"line-{i}", "method": "POST",
              "url": "/v1/chat/completions",
              "body": {"model": "llama-3-8b-random", "max_tokens": 32,
                       "temperature": 0.0, "messages": [
                           {"role": "user", "content": text(i, 100 + 25 * i)}
                       ]}} for i in range(12)]
    data = "\n".join(json.dumps(x) for x in lines).encode()
    reset_counts()
    t = time.monotonic()
    status, _h, raw = _post_raw(a.port, "/v1/files", data)
    fid = json.loads(raw)["id"]
    status, _h, raw = _post_raw(a.port, "/v1/batches", json.dumps({
        "input_file_id": fid, "endpoint": "/v1/chat/completions"}).encode())
    if status != 200:
        raise AssertionError(f"batch create: {status} {raw[:300]}")
    bid = json.loads(raw)["id"]
    deadline = time.monotonic() + 300
    while a.engine.stats.batch_tokens < 8:  # the batch decodes
        if time.monotonic() > deadline:
            raise AssertionError("the batch never started")
        time.sleep(0.005)
    from aigw_tpu_torch.obs.metrics import EnginePhases

    a.engine.phases = EnginePhases()
    t_burst = time.monotonic()
    serve_phase(a.port, reqs)
    burst_s = time.monotonic() - t_burst
    pp = _state(a.port)["phase_percentiles"]
    while True:
        b = json.loads(_http(a.port, f"/v1/batches/{bid}")[2])
        if b["status"] != "in_progress":
            break
        if time.monotonic() > deadline:
            raise AssertionError("the batch never completed")
        time.sleep(0.05)
    batch_s = time.monotonic() - t
    _wait_idle(a)
    st = _state(a.port)
    counts = read_counts()
    if b["status"] != "completed" or b["request_counts"] != {
            "total": 12, "completed": 12, "failed": 0}:
        raise AssertionError(f"batch: {b}")
    if st["batch_preemptions"] <= 0 \
            or st["batch_resumed"] != st["batch_preemptions"]:
        raise AssertionError(f"preemptions {st['batch_preemptions']}, "
                             f"resumed {st['batch_resumed']}")
    outs = [json.loads(ln) for ln in _http(
        a.port, f"/v1/files/{b['output_file_id']}/content")[2].splitlines()
        if ln.strip()]
    if sorted(o["custom_id"] for o in outs) != sorted(
            x["custom_id"] for x in lines) or any(
            o["response"]["status_code"] != 200 for o in outs):
        raise AssertionError("batch output lines")
    batch_keys = [k for k in tap.toks if isinstance(k, tuple)]
    solo = {}
    for line in lines:  # each line alone, interactive
        status, h, _raw = _post_raw(a.port, "/v1/chat/completions",
                                    json.dumps(line["body"]).encode())
        rid = h["x-aigw-request-id"]
        solo[tuple(tap.prompts[rid])] = rid
        _wait_idle(a)
    if sorted(batch_keys) != sorted(solo):
        raise AssertionError("batch lines and solo runs disagree on "
                             "prompts")
    checks = [tie_check(torch, params, llama.LLAMA3_8B, list(k),
                        tap.sampling[solo[k]], tap.toks[solo[k]],
                        tap.toks[k], a.tokenizer.eos_id)
              for k in batch_keys]
    _gate_ties("batch lines", checks)
    return {"lines": 12, "batch_s": batch_s, "burst_s": burst_s,
            "batch_preemptions": st["batch_preemptions"],
            "batch_resumed": st["batch_resumed"],
            "batch_tokens": st["batch_tokens"],
            "interactive_ttft_p50_ms": pp["ttft"]["p50"],
            "interactive_ttft_p95_ms": pp["ttft"]["p95"],
            "serve_warm_ttft_p50_ms": serve_pp["ttft"]["p50"],
            "serve_warm_ttft_p95_ms": serve_pp["ttft"]["p95"],
            "lines_equal_solo": sum(c["equal"] for c in checks),
            "line_ties": [c for c in checks if not c["equal"]],
            "launches": counts}


def serve_mobility(torch, srv, params, reqs, prefix_chat, launches: dict,
                   serve_pp: dict) -> dict:
    """KV mobility and the batch tier at full depth (32 layers, bf16
    weights, 8 slots x 2048, 128-token pages, the prefix cache on, the
    fused rung): the earlier phases' server as replica A, replica B a
    second server in this process on the same weight tensors.

    1. migration, bf16 pools (``_mob_migrate``), with each migrated
       history's cold prefill timed beside B's resume;
    2. the same over int8 pools (bf16 weights): the pages gated byte for
       byte, the streams reported;
    3. the fleet fetch (``_mob_fetch``);
    4. spill and revive (``_mob_spill``);
    5. the batch tier (``_mob_batch``).

    Launch counts are zeroed just before each step and read just after;
    their sum goes into ``launches`` under ``serve_mobility``."""
    import numpy as np

    from aigw_tpu_torch.tpuserve.engine import EngineConfig
    from aigw_tpu_torch.tpuserve.server import TPUServeServer

    t_phase = time.monotonic()
    rng = np.random.default_rng(13)
    base = dict(max_batch_size=8, max_seq_len=2048, page_size=128,
                attention_backend="pallas-ragged", decode_backend="fused",
                enable_prefix_cache=True)
    b = TPUServeServer("llama-3-8b-random", EngineConfig(**base),
                       device="cuda", port=0, params=params)
    b.start()
    out: dict = {}
    try:
        chats = _mob_chats(rng, srv.tokenizer.eos_id)
        t = time.monotonic()
        m16 = _mob_migrate(torch, srv, b, params, base, chats, "bfloat16")
        m16["cold_prefill_ttft_ms"] = _cold_ttft_ms(
            srv, params, base, m16["histories"])
        m16["step_s"] = time.monotonic() - t
        log(f"serve_mobility bf16 migration: {json.dumps(m16)[:2000]}")
        t = time.monotonic()
        m8 = _mob_migrate(torch, srv, b, params, base, chats, "int8")
        m8["step_s"] = time.monotonic() - t
        log(f"serve_mobility int8 migration: {json.dumps(m8)[:1500]}")
        for m in (m16, m8):
            m["history_tokens"] = [len(h) for h in m.pop("histories")]
        t = time.monotonic()
        fetch = _mob_fetch(torch, srv, b, params, base, prefix_chat)
        fetch["step_s"] = time.monotonic() - t
        log(f"serve_mobility fetch: {json.dumps(fetch)}")
        t = time.monotonic()
        spill = _mob_spill(torch, srv, params, base, rng)
        spill["step_s"] = time.monotonic() - t
        log(f"serve_mobility spill: {json.dumps(spill)}")
        t = time.monotonic()
        batch = _mob_batch(torch, srv, params, base, reqs, rng, serve_pp)
        batch["step_s"] = time.monotonic() - t
    finally:
        b.stop()
    out = {"migrate_bf16": m16, "migrate_int8": m8, "fetch": fetch,
           "spill": spill, "batch": batch,
           "phase_s": time.monotonic() - t_phase}
    total: dict = {}
    for step in (m16, m8, fetch, spill, batch):
        for k, v in step["launches"].items():
            total[k] = total.get(k, 0) + v
    launches["serve_mobility"] = total
    log(f"serve_mobility: export {m16['export_ms_per_page']:.1f} ms/page, "
        f"wire {m16['wire_mb_per_page']:.1f} MB/page, resume TTFT "
        f"{m16['resume_ttft_ms']} vs cold {m16['cold_prefill_ttft_ms']}; "
        f"spill stall {spill['spill_stall_ms_per_page']:.2f} ms/page; "
        f"batch preemptions {batch['batch_preemptions']}; phase "
        f"{out['phase_s']:.1f}s")
    return out


# -- the reference's default programs and /v1/embeddings ---------------------
#: layers of the model-level check of the default programs (Llama-3-8B
#: widths): enough for a second layer to read the first's K/V
DEFAULTS_CHECK_LAYERS = 2
#: served embedding vectors in bf16 against the float32 pass, per
#: vector: ||served - f32|| / ||f32||. bf16 rounds each of the 32 layers'
#: activations to 2**-8 relative; the errors add up over the layers
EMBED_REL_TOL = 5e-2
#: the geometry the default replica is given (everything else
#: EngineConfig's defaults: xla-bucketed, the gather rung, 256-token
#: chunks, the prefix cache on)
GEOMETRY = dict(max_batch_size=8, max_seq_len=2048, page_size=128)


def _start_defaults(srv, params, **kw):
    """Put an engine built from EngineConfig(**GEOMETRY, **kw) behind the
    server."""
    from aigw_tpu_torch.models import llama
    from aigw_tpu_torch.tpuserve.engine import Engine, EngineConfig

    stop_engine(srv)
    srv.engine = Engine(params, llama.LLAMA3_8B,
                        EngineConfig(**GEOMETRY, **kw),
                        eos_token_ids=(srv.tokenizer.eos_id,), device="cuda")
    srv.engine.start()


#: the kernels the default programs must not launch
_OFF_PATH = ("ragged_prefill_attention", "fused_paged_decode",
             "paged_attention_decode_v2")


def _defaults_burst(torch, srv, reqs, pinned, what: str) -> dict:
    """The burst plus the pinned pair, cold then warm (the phase
    histograms reset for the warm one), on the engine behind ``srv``;
    launch counts zeroed before and read after each. Gates: the resolved
    programs, chunking, no K1/K2/K3 launch, the pinned streams."""
    from aigw_tpu_torch.obs.metrics import EnginePhases

    out: dict = {}
    st0 = json.loads(_http(srv.port, "/state")[2])
    if (st0["attention_backend"], st0["decode_attn_impl"]) != (
            "xla-bucketed", "gather-cuda"):
        raise AssertionError(f"{what}: the defaults resolve to "
                             f"{st0['attention_backend']} / "
                             f"{st0['decode_attn_impl']}")
    for run in ("cold", "warm"):
        if run == "warm":
            srv.engine.phases = EnginePhases()
        before = json.loads(_http(srv.port, "/state")[2])
        reset_counts()
        t = time.monotonic()
        results = serve_phase(srv.port, reqs + pinned)
        out[f"{run}_s"] = time.monotonic() - t
        counts = read_counts()
        after = json.loads(_http(srv.port, "/state")[2])
        on = [k for k in _OFF_PATH if counts[k]]
        if on:
            raise AssertionError(f"{what} {run}: {on} launched on the "
                                 f"default programs: {counts}")
        _check_pinned(results[len(reqs):])
        out[f"launches_{run}"] = counts
        for key in ("chunked_prefill_steps", "prefills", "prefill_ms",
                    "prefill_tokens_real", "prefill_tokens_padded",
                    "prefix_cache_hits", "decode_steps"):
            out[f"{run}_{key}"] = after[key] - before[key]
        out[f"{run}_prefill_padded_frac"] = round(
            1.0 - out[f"{run}_prefill_tokens_real"]
            / max(1, out[f"{run}_prefill_tokens_padded"]), 4)
        out["pinned_texts"] = [r["text"] for r in results[len(reqs):]]
    if out["cold_chunked_prefill_steps"] <= 0:
        raise AssertionError(f"{what}: no prompt was chunked")
    pp = json.loads(_http(srv.port, "/state")[2])["phase_percentiles"]
    out.update({"warm_prefill_p50_ms": pp["prefill"]["p50"],
                "warm_prefill_p95_ms": pp["prefill"]["p95"],
                "warm_ttft_p50_ms": pp["ttft"]["p50"],
                "warm_ttft_p95_ms": pp["ttft"]["p95"],
                "attention_backend": st0["attention_backend"],
                "decode_attn_impl": st0["decode_attn_impl"],
                "decode_attn_reason": st0["decode_attn_reason"]})
    return out


def _streams_by_prompt(tap: TokenTap) -> dict:
    """prompt tuple -> [(sampling, tokens)] of every request a tap saw."""
    out: dict = {}
    for key, toks in tap.toks.items():
        out.setdefault(tuple(tap.prompts[key]), []).append(
            (tap.sampling[key], toks))
    return out


def _hold_streams(torch, params, cfg, eos, kernel: dict, defaults: dict,
                  what: str) -> dict:
    """Every stream the default replica served against the kernel
    path's stream of the same prompt, tie-aware (``tie_check`` on
    ``params``, ``TIE_BOUND``)."""
    checks = []
    for prompt, runs in defaults.items():
        (sp, want), = kernel[prompt]
        for _sp, got in runs:
            checks.append(tie_check(torch, params, cfg, prompt, sp, want,
                                    got, eos))
    _gate_ties(what, checks)
    flips = [c for c in checks if not c["equal"]]
    return {"streams": len(checks), "equal": len(checks) - len(flips),
            "near_tie_flips": [{"j": c["j"], "gap": c["gap"]}
                               for c in flips]}


def serve_defaults(torch, srv, restart, params, qparams, reqs,
                   launches: dict) -> dict:
    """The burst plus two pinned requests, first on the kernel path
    (``pallas-ragged`` + ``fused``, cold), then on a replica built from
    ``EngineConfig()`` with only the geometry set (cold and warm): bf16
    (the device's busy share over a third, traced burst), then W8A16
    weights over int8 pages, where K6 carries the matmuls at M <= 64.
    Every stream the defaults serve is held to the kernel path's of the
    same prompt, tie-aware; the pinned pair's texts must be equal."""
    from aigw_tpu_torch.models import llama

    pinned = _pinned_requests(2)
    eos = srv.tokenizer.eos_id
    out: dict = {"requests": len(reqs) + len(pinned), "geometry": GEOMETRY,
                 "prompt_tokens": served_prompt_lens(reqs + pinned)}
    for name, p, kw in (("bf16", params, {}),
                        ("w8a16_kv_int8", qparams,
                         {"kv_cache_dtype": "int8"})):
        restart(p, decode_backend="fused", **kw)
        tap = TokenTap(srv.engine)
        kernel_path = serve_phase(srv.port, reqs + pinned)
        kernel = _streams_by_prompt(tap)
        _start_defaults(srv, p, **kw)
        tap = TokenTap(srv.engine)
        run = _defaults_burst(torch, srv, reqs, pinned, name)
        if run["pinned_texts"] != [r["text"] for r in
                                   kernel_path[len(reqs):]]:
            raise AssertionError(f"{name}: the pinned streams differ from "
                                 f"the kernel path's")
        run["against_kernel_path"] = _hold_streams(
            torch, p, llama.LLAMA3_8B, eos, kernel, _streams_by_prompt(tap),
            name)
        if name == "bf16":
            run.update(serve_profile(torch, srv.port, reqs, run["warm_s"]))
            launches["serve_defaults"] = run["launches_cold"]
        else:
            if run["launches_cold"]["w8a16_matmul"] <= 0:
                raise AssertionError(f"K6 not on the W8A16 default "
                                     f"programs: {run['launches_cold']}")
            launches["serve_defaults_w8a16"] = run["launches_cold"]
        out[name] = run
    bf16, w8 = out["bf16"], out["w8a16_kv_int8"]
    log(f"serve_defaults: bf16 {bf16['cold_s']:.2f} / {bf16['warm_s']:.2f} "
        f"s, W8A16+int8 {w8['cold_s']:.2f} / {w8['warm_s']:.2f} s, "
        f"chunked steps {bf16['cold_chunked_prefill_steps']}, K6 "
        f"{w8['launches_cold']['w8a16_matmul']}; against the kernel path "
        f"{bf16['against_kernel_path']}, {w8['against_kernel_path']}")
    return out


def _embed_inputs(rng, vocab: int) -> list:
    """8 inputs up to 1022 tokens: four strings (one byte-tokenizer token
    a character) and four token-id lists (some past the vocabulary,
    which the route takes mod it)."""
    words = "the quick brown fox jumps over a lazy dog while rivers run".split()

    def text(n: int) -> str:
        out = []
        while sum(len(w) + 1 for w in out) < n:
            out.append(words[int(rng.integers(len(words)))])
        return " ".join(out)[:n]

    return [text(1022), text(40), text(300), text(700),
            rng.integers(0, vocab, 1022).tolist(),
            rng.integers(0, 2 * vocab, 64).tolist(),
            rng.integers(0, vocab, 500).tolist(), [7, 8, 9]]


def _embed_short_inputs(rng, vocab: int) -> list:
    """8 inputs of at most 8 tokens (four strings, four id lists): an
    [8, 8] block, so every weight matmul has M = 64 and W8A16 runs K6."""
    return ["the fox", "a dog", "rivers", "run", *(
        rng.integers(0, vocab, n).tolist() for n in (8, 5, 1, 6))]


def embeddings_phase(torch, srv, params, qparams, launches: dict) -> dict:
    """``POST /v1/embeddings`` on the default replica: 8 inputs up to
    1022 tokens (``_embed_inputs``) in bf16 and in W8A16, then 8 inputs
    of at most 8 tokens (``_embed_short_inputs``) in W8A16. Each call's
    ms, the device's peak memory over it, and each served vector against
    the same tokens' ``hidden_states`` on the card, computed here:

    - bf16: against a float32 pass over the same weights,
      ``EMBED_REL_TOL`` relative L2 a vector;
    - W8A16 long: against ``hidden_states(plain=True)``, per element
      within ATTN_RTOL * |x| + ATTN_ATOL. At M = 8 x 1024 no matmul
      takes K6 (it gates M <= 64), so both run ``x @ _w``: this holds
      the route (the padding, the sub-batches, the pool), not K6;
    - W8A16 short: K6 against its plain version (``plain=True``) at
      M = 64, where K6 must launch 7 times a layer; ``EMBED_REL_TOL``
      relative L2 a vector (one-ulp differences in K6's bf16 outputs
      grow over 32 layers as bf16 rounding does).

    The dense pass holds [8, 32, S, S] float32 logits a layer: S is the
    pow2 bucket of the longest input, 1024 for the long inputs (1.07 GB;
    4.3 GB at S 2048, where the route's 2 GiB budget splits the batch
    into sub-batches of 4)."""
    import numpy as np

    from aigw_tpu_torch.models import llama

    cfg = llama.LLAMA3_8B
    rng = np.random.default_rng(11)
    long_in = _embed_inputs(rng, cfg.vocab_size)
    short_in = _embed_short_inputs(rng, cfg.vocab_size)
    out: dict = {}
    counts_w8: dict = {}
    for name, p, kv, inputs in (("bf16", params, "bfloat16", long_in),
                                ("w8a16", qparams, "int8", long_in),
                                ("w8a16_k6", qparams, "int8", short_in)):
        if name != "w8a16_k6":
            _start_defaults(srv, p, kv_cache_dtype=kv)
        res = _embed_call(torch, srv, cfg, p, inputs, name)
        counts = res["launches"]
        if name == "w8a16_k6" and counts["w8a16_matmul"] != 7 * cfg.n_layers:
            raise AssertionError(f"embeddings {name}: K6 launched "
                                 f"{counts['w8a16_matmul']} times, not "
                                 f"{7 * cfg.n_layers}")
        if name == "bf16":
            launches["embeddings_bf16"] = counts
        else:
            counts_w8 = {k: counts_w8.get(k, 0) + v
                         for k, v in counts.items()}
        out[name] = res
        log(f"embeddings {name}: {res['call_ms']:.1f} ms, peak "
            f"{res['peak_bytes'] / 1e9:.2f} GB, rel err "
            f"{res['max_rel_l2_err']:.2e}, K6 {counts['w8a16_matmul']}")
    launches["embeddings_w8a16"] = counts_w8
    return out


def _embed_call(torch, srv, cfg, p, inputs, name: str) -> dict:
    """One embeddings call on ``srv`` (launch counts zeroed before it)
    and its vectors held as ``embeddings_phase`` says for ``name``."""
    from aigw_tpu_torch.models import llama
    from aigw_tpu_torch.tpuserve.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    enc = [tok.encode(x) if isinstance(x, str) else
           [t % cfg.vocab_size for t in x] for x in inputs]
    S = 1 << (max(8, max(map(len, enc))) - 1).bit_length()
    toks = torch.zeros((len(enc), S), dtype=torch.int32, device="cuda")
    for i, e in enumerate(enc):
        toks[i, :len(e)] = torch.tensor(e, dtype=torch.int32)
    lens = torch.tensor([len(e) for e in enc], dtype=torch.int32,
                        device="cuda")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t = time.monotonic()
    status, _ctype, raw = _http(srv.port, "/v1/embeddings",
                                {"model": "llama-3-8b-random",
                                 "input": inputs})
    call_ms = (time.monotonic() - t) * 1e3
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    body = json.loads(raw)
    if status != 200 or [d["index"] for d in body["data"]] != list(
            range(len(inputs))):
        raise AssertionError(f"embeddings {name}: {status}")
    if body["usage"]["prompt_tokens"] != sum(map(len, enc)):
        raise AssertionError(f"embeddings {name}: usage {body['usage']}")
    got = torch.tensor([d["embedding"] for d in body["data"]],
                       dtype=torch.float32, device="cuda")
    if got.shape != (len(inputs), cfg.dim) or not torch.isfinite(got).all():
        raise AssertionError(f"embeddings {name}: {tuple(got.shape)}")
    with torch.inference_mode():
        if name == "bf16":
            # float32 activations over the same bf16 weights: the
            # embedding rows and norms in float32, every matmul promoted
            # to float32
            p32 = {k: (v.float() if k == "embed" or k.endswith("norm")
                       or k == "norm_f" else v) for k, v in p.items()}
            want = llama.hidden_states(p32, cfg, toks, lens)
            del p32
        else:
            want = llama.hidden_states(p, cfg, toks, lens, plain=True)
    err = (got - want).abs()
    rel = ((got - want).norm(dim=1) / want.norm(dim=1)).max().item()
    if name != "w8a16" and rel > EMBED_REL_TOL:
        raise AssertionError(f"embeddings {name}: relative error {rel} "
                             f"over {EMBED_REL_TOL}")
    if name == "w8a16" and (err > ATTN_RTOL * want.abs() + ATTN_ATOL).any():
        raise AssertionError(f"embeddings W8A16: max error "
                             f"{err.max().item()} against the plain call")
    cos = torch.nn.functional.cosine_similarity(got, want, dim=1)
    torch.cuda.empty_cache()
    return {"inputs": len(inputs), "tokens": [len(e) for e in enc], "S": S,
            "call_ms": call_ms, "peak_bytes": peak,
            "peak_above_resident_bytes": peak - base,
            "max_abs_err": err.max().item(), "max_rel_l2_err": rel,
            "min_cosine": cos.min().item(),
            "mean_abs": want.abs().mean().item(),
            "against": {"bf16": "float32 pass", "w8a16": "plain=True, "
                        "no K6 at M 8192", "w8a16_k6": "plain=True, K6 at "
                        "M 64"}[name], "launches": counts}


def defaults_model_check(torch, params, cfg, dev: str = "cuda") -> dict:
    """The default programs against the kernel path at Llama-3-8B widths
    and DEFAULTS_CHECK_LAYERS layers, on the same inputs, in float32 and
    in bf16: the bucketed ``prefill`` of 4 prompts (700, 45, 300, 3
    tokens in one [4, 768] block) against ``prefill_ragged`` (K1) packing
    them; ``prefill_suffix`` continuing the first with 150 tokens at 700
    over its 8-page window against a K1 resume at 700; one gather
    ``decode_step`` against the fused rung (K2) from the same pool.

    Held per element within ATTN_RTOL * |x| + ATTN_ATOL: in float32 every
    logit and every written K/V row; in bf16 the rows of the first
    layer, which no attention output reaches. Past it, bf16 rounds the
    residual stream at every op, and a one-ulp difference in an
    attention output grows to tens of ulps in the next layer's K/V and in
    the logits (on the CPU the plain versions alone differ by 20 ulps),
    so bf16 logits are held as ``model_check`` holds them: within 0.1 of
    the logit scale, greedy tokens equal up to a near-tie (0.1)."""
    import dataclasses

    from aigw_tpu_torch.models import kvq, llama

    L = DEFAULTS_CHECK_LAYERS
    c2 = dataclasses.replace(cfg, n_layers=L)
    p2 = {k: v for k, v in params.items()
          if not (k[0] == "l" and k[1].isdigit())
          or int(k[1:].split(".")[0]) < L}
    PS, P = 128, 16
    lens = [700, 45, 300, 3]
    B, S = len(lens), 768
    g = torch.Generator(device=dev)
    g.manual_seed(31)
    block = torch.randint(0, cfg.vocab_size, (B, S), generator=g, device=dev,
                          dtype=torch.int32)
    sfx = torch.randint(0, cfg.vocab_size, (1, 192), generator=g, device=dev,
                        dtype=torch.int32)
    sfx[0, 150:] = 0
    pt = torch.arange(B * P, dtype=torch.int32, device=dev).reshape(B, P)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)

    def packed(seqs):
        """(tokens, row_seq, positions, last) of ((b, row tokens, start))."""
        T = -(-sum(len(t) for _b, t, _s in seqs) // 256) * 256
        toks = torch.zeros((T,), dtype=torch.int32, device=dev)
        row_seq = torch.full((T,), B, dtype=torch.int32, device=dev)
        positions = torch.zeros((T,), dtype=torch.int32, device=dev)
        last = torch.zeros((B,), dtype=torch.int32, device=dev)
        o = 0
        for b, t, s in seqs:
            n = len(t)
            toks[o:o + n] = t
            row_seq[o:o + n] = b
            positions[o:o + n] = s + torch.arange(n, device=dev)
            last[b] = o + n - 1
            o += n
        return toks, row_seq, positions, last

    def rows(kv, b, lo, hi):
        p = torch.arange(lo, hi, device=dev)
        return kv[:, :, pt[b, p // PS].long() * PS + p % PS]

    out: dict = {"layers": L}
    for name, dtype in (("float32", torch.float32),
                        ("bf16", torch.bfloat16)):
        pd = {k: v.to(dtype) for k, v in p2.items()}
        res: dict = {}
        strict = dtype == torch.float32

        def hold(what, a, b):
            b = b.float()
            err = (a.float() - b).abs()
            if (err > ATTN_RTOL * b.abs() + ATTN_ATOL).any():
                raise AssertionError(f"defaults check {name} {what}: max "
                                     f"error {err.max().item()}")
            res[f"{what}_max_abs_err"] = err.max().item()

        def pages(what, a, b):
            if strict:
                hold(what, a, b)
            else:
                hold(f"{what}_layer0", a[:1], b[:1])
                res[f"{what}_max_abs_err"] = (
                    a.float() - b.float()).abs().max().item()

        def logits(what, a, b):
            if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
                raise AssertionError(f"defaults check {name} {what}: "
                                     f"non-finite")
            if strict:
                hold(f"{what}_logits", a, b)
            err = (a - b).abs().max().item()
            scale = b.abs().max().item()
            if err > 0.1 * scale:
                raise AssertionError(f"defaults check {name} {what}: "
                                     f"logits differ by {err} (scale "
                                     f"{scale})")
            top2 = torch.topk(b, 2, dim=-1).values
            differ = a.argmax(-1) != b.argmax(-1)
            if differ.any() and (top2[:, 0]
                                 - top2[:, 1])[differ].max() > 0.1:
                raise AssertionError(f"defaults check {name} {what}: "
                                     f"greedy differs")
            res[f"{what}_logits_max_abs_err"] = err
            res[f"{what}_logit_scale"] = scale

        shape = (L, 2, (B * P + 1) * PS, cfg.n_kv_heads, cfg.head_dim)
        kv_d = kvq.make_pool(shape, "float32" if strict else "bfloat16", dev)
        kv_r = kvq.make_pool(shape, "float32" if strict else "bfloat16", dev)
        ld, kv_d = llama.prefill(pd, c2, block, lens_t, kv_d, pt, PS)
        lr, kv_r = llama.prefill_ragged(
            pd, c2,
            *packed([(b, block[b, :n], 0) for b, n in enumerate(lens)]),
            kv_r, pt, PS)
        logits("prefill", ld, lr)
        for b, n in enumerate(lens):
            pages(f"prefill_pages_{b}", rows(kv_d, b, 0, n),
                  rows(kv_r, b, 0, n))
        ld, kv_d = llama.prefill_suffix(
            pd, c2, sfx, torch.tensor([700], dtype=torch.int32, device=dev),
            torch.tensor([850], dtype=torch.int32, device=dev), kv_d,
            pt[:1, :8], PS)
        lr, kv_r = llama.prefill_ragged(
            pd, c2, *packed([(0, sfx[0, :150], 700)]), kv_r, pt, PS)
        logits("prefill_suffix", ld, lr[:1])
        pages("prefill_suffix_pages", rows(kv_d, 0, 700, 850),
              rows(kv_r, 0, 700, 850))
        tok = lr.argmax(-1).to(torch.int32)
        pos = torch.tensor([850, 45, 300, 3], dtype=torch.int32, device=dev)
        act = torch.ones((B,), dtype=torch.bool, device=dev)
        step = {rung: llama.decode_step(pd, c2, tok, pos, kv_d.clone(), pt,
                                        PS, act, attn_impl=rung)
                for rung in ("", "fused")}
        logits("gather_decode", step[""][0], step["fused"][0])
        for b in range(B):
            p = int(pos[b])
            pages(f"gather_decode_row_{b}", rows(step[""][1], b, p, p + 1),
                  rows(step["fused"][1], b, p, p + 1))
        out[name] = res
        del pd, kv_d, kv_r, step
    return out


def defaults_w8a16_check(torch, qparams, cfg, dev: str = "cuda") -> dict:
    """K6 on the default programs against its plain version: W8A16
    weights at DEFAULTS_CHECK_LAYERS layers, every weight matmul of a
    bucketed ``prefill`` of 45 and of 20 tokens (each a [1, 64] block,
    M = 64: the ladder's first rung), of a ``prefill_suffix`` of 40
    tokens at 45 (a [1, 64] block over a one-page window) and of one
    gather ``decode_step`` at batch 2 run through the kernel, then the
    same calls with ``plain=True`` from the same inputs and pool.

    Over float32 activations (the embedding rows dequantized to float32,
    the norms cast) every logit and every written K/V row is held per
    element within ATTN_RTOL * |x| + ATTN_ATOL. Over bf16 activations
    (the served replica's) the first layer's rows are held per element,
    and the logits as ``defaults_model_check`` holds bf16 ones (within
    0.1 of the logit scale, greedy equal up to a near-tie): one-ulp
    differences in K6's bf16 outputs grow past the first layer as
    between any two bf16 runs. K6 must launch in the kernel runs."""
    import dataclasses

    from aigw_tpu_torch.models import kvq, llama
    from aigw_tpu_torch.ops import qmatmul

    L = DEFAULTS_CHECK_LAYERS
    c2 = dataclasses.replace(cfg, n_layers=L)
    q2 = {k: v for k, v in qparams.items()
          if not (k[0] == "l" and k[1].isdigit())
          or int(k[1:].split(".")[0]) < L}
    PS, S, B = 128, 64, 2
    g = torch.Generator(device=dev)
    g.manual_seed(37)
    toks = torch.randint(0, cfg.vocab_size, (3, S), generator=g, device=dev,
                         dtype=torch.int32)
    pt = torch.arange(B, dtype=torch.int32, device=dev).reshape(B, 1)

    def t32(*v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    def run(pd, kv, plain):
        """(logits of the four calls, pool) of one pass."""
        out = []
        for b, n in ((0, 45), (1, 20)):
            lg, kv = llama.prefill(pd, c2, toks[b:b + 1], t32(n), kv,
                                   pt[b:b + 1], PS, plain=plain)
            out.append(lg)
        lg, kv = llama.prefill_suffix(pd, c2, toks[2:3], t32(45), t32(85),
                                      kv, pt[:1], PS, plain=plain)
        out.append(lg)
        lg, kv = llama.decode_step(
            pd, c2, toks[:2, 0].contiguous(), t32(85, 20), kv, pt, PS,
            torch.ones((B,), dtype=torch.bool, device=dev), attn_impl="",
            plain=plain)
        out.append(lg)
        return out, kv

    out: dict = {"layers": L, "M": [S, S, S, B]}
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        if dtype == torch.float32:
            pd = {k: v.float() for k, v in q2.items()
                  if v.dtype != torch.int8 and not k.startswith("embed.")}
            pd.update({k: v for k, v in q2.items()
                       if v.dtype == torch.int8 and k != "embed.q"})
            pd["embed"] = q2["embed.q"].float() * q2["embed.scale"]
        else:
            pd = q2
        shape = (L, 2, (B + 1) * PS, cfg.n_kv_heads, cfg.head_dim)
        n0 = qmatmul.w8a16_matmul.launches
        got, kv_k = run(pd, kvq.make_pool(shape, name, dev), False)
        launched = qmatmul.w8a16_matmul.launches - n0
        want, kv_p = run(pd, kvq.make_pool(shape, name, dev), True)
        if launched != 4 * (7 * L + 1):
            raise AssertionError(f"defaults W8A16 {name}: K6 launched "
                                 f"{launched} times, not 4 x {7 * L + 1}")
        res: dict = {"k6_launches": launched}
        for what, a, b in zip(("prefill_45", "prefill_20", "suffix",
                               "gather_decode"), got, want):
            err = (a - b).abs()
            if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
                raise AssertionError(f"defaults W8A16 {name} {what}: "
                                     f"non-finite")
            scale = b.abs().max().item()
            if dtype == torch.float32:
                bad = err > ATTN_RTOL * b.abs() + ATTN_ATOL
            else:
                bad = err.max() > 0.1 * scale
                top2 = torch.topk(b, 2, dim=-1).values
                differ = a.argmax(-1) != b.argmax(-1)
                if differ.any() and (top2[:, 0]
                                     - top2[:, 1])[differ].max() > 0.1:
                    raise AssertionError(f"defaults W8A16 {name} {what}: "
                                         f"greedy differs")
            if bad.any():
                raise AssertionError(f"defaults W8A16 {name} {what}: "
                                     f"logits differ by {err.max().item()}"
                                     f" (scale {scale})")
            res[f"{what}_logits_max_abs_err"] = err.max().item()
            res[f"{what}_logit_scale"] = scale
        rows_k = kv_k[:, :, :B * PS].float()
        rows_p = kv_p[:, :, :B * PS].float()
        held = rows_k if dtype == torch.float32 else rows_k[:1]
        ref = rows_p if dtype == torch.float32 else rows_p[:1]
        err = (held - ref).abs()
        if (err > ATTN_RTOL * ref.abs() + ATTN_ATOL).any():
            raise AssertionError(f"defaults W8A16 {name}: written rows "
                                 f"differ by {err.max().item()}")
        res["pages_held_max_abs_err"] = err.max().item()
        res["pages_max_abs_err"] = (rows_k - rows_p).abs().max().item()
        res["pages_held"] = "all layers" if dtype == torch.float32 \
            else "layer 0"
        out[name] = res
        del pd, kv_k, kv_p
    return out


def prefill_profile_bucketed(torch, params, cfg, lens, dev: str = "cuda"
                             ) -> dict:
    """Where the default prefill programs' time goes for prompts of
    ``lens`` tokens, run as the xla-bucketed backend runs a burst that
    arrives at once: prompts up to 256 tokens grouped by bucket rung,
    one dense [G2, S] ``prefill`` per group; each longer prompt alone,
    256-token ``prefill_suffix`` chunks over its pow2 page window, then
    the tail on its rung. Host wall (synchronized) against device time,
    as ``prefill_profile`` reads the same prompts through one packed K1
    call. The trace records the device only, over one pass: its calls
    launch thousands of small kernels, and a host-side trace of three
    passes took a minute on the card."""
    from types import SimpleNamespace

    from torch.profiler import ProfilerActivity, profile

    from aigw_tpu_torch.models import kvq, llama
    from aigw_tpu_torch.tpuserve.engine import Engine, EngineConfig

    PS, P, chunk, calls = 128, 16, 256, 3
    ladder = SimpleNamespace(cfg=EngineConfig(**GEOMETRY))
    bucket = lambda n: Engine._prefill_bucket(ladder, n)  # noqa: E731
    kv = kvq.make_pool((cfg.n_layers, 2, (len(lens) * P + 1) * PS,
                        cfg.n_kv_heads, cfg.head_dim), "bfloat16", dev)
    pt = torch.arange(len(lens) * P, dtype=torch.int32,
                      device=dev).reshape(len(lens), P)
    g = torch.Generator(device=dev)
    g.manual_seed(6)
    plan = []  # (fn, args)
    groups: dict[int, list[int]] = {}
    for b, n in enumerate(lens):
        if n <= chunk:
            groups.setdefault(bucket(n), []).append(b)
            continue
        win = 1
        while win * PS < n + 64:
            win *= 2
        done = 0
        while n - done > chunk:
            plan.append((llama.prefill_suffix, (
                torch.randint(0, cfg.vocab_size, (1, chunk), generator=g,
                              device=dev, dtype=torch.int32),
                torch.tensor([done], dtype=torch.int32, device=dev),
                torch.tensor([done + chunk], dtype=torch.int32, device=dev),
                pt[b:b + 1, :win])))
            done += chunk
        S = bucket(n - done)
        plan.append((llama.prefill_suffix, (
            torch.randint(0, cfg.vocab_size, (1, S), generator=g, device=dev,
                          dtype=torch.int32),
            torch.tensor([done], dtype=torch.int32, device=dev),
            torch.tensor([n], dtype=torch.int32, device=dev),
            pt[b:b + 1, :win])))
    for S, members in groups.items():
        G2 = 1
        while G2 < len(members):
            G2 *= 2
        seq = torch.zeros((G2,), dtype=torch.int32, device=dev)
        seq[:len(members)] = torch.tensor([lens[b] for b in members])
        table = torch.zeros((G2, P), dtype=torch.int32, device=dev)
        table[:len(members)] = pt[members]
        plan.append((llama.prefill, (
            torch.randint(0, cfg.vocab_size, (G2, S), generator=g,
                          device=dev, dtype=torch.int32), seq, table)))

    def run():
        for fn, (*args, table) in plan:
            fn(params, cfg, *args, kv, table, PS)

    run()
    torch.cuda.synchronize()
    t = time.monotonic()
    for _ in range(calls):
        run()
    torch.cuda.synchronize()
    wall_ms = (time.monotonic() - t) * 1e3 / calls
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    device_ms, _ours, top = device_split(torch, prof, 1, ())
    return {"prompts": list(lens), "program_calls": len(plan),
            "wall_ms": wall_ms, "device_ms": device_ms,
            "top_kernels_ms": top}


# -- captured programs (CUDA graphs) ----------------------------------------
#: the warm knobs of the graphs phase's replica
GRAPH_WARM = dict(warm_decode_buckets=3, warm_prefill_buckets=2)
#: prompt bytes the inside-the-warmed-geometry burst keeps: with 64 new
#: tokens every sequence fits 4 pages of 128, the third warm bucket
GRAPH_SHORT_BYTES = 400


def _graph_live(torch, eng, lens, greedy_only: bool = False) -> None:
    """Admit one request per prompt length on ``eng`` (not started):
    seeded token prompts, greedy, seeded top-p and penalized sampling in
    turn (all greedy with ``greedy_only``), then build the decode state
    as a tick does."""
    import numpy as np

    from aigw_tpu_torch.tpuserve.engine import GenRequest
    from aigw_tpu_torch.tpuserve.sampling import SamplingParams

    rng = np.random.default_rng(15)
    kws = [dict(temperature=0.0), dict(temperature=0.8, top_p=0.9, seed=3),
           dict(temperature=0.7, seed=5, frequency_penalty=0.6)]
    for i, n in enumerate(lens):
        eng.submit(GenRequest(
            prompt=rng.integers(1, eng.model_cfg.vocab_size, n).tolist(),
            max_tokens=64,
            sampling=SamplingParams(**(kws[0] if greedy_only
                                       else kws[i % 3]))))
    eng._admit()
    eng._device_state = eng._build_device_state()
    eng._state_bucket = eng._decode_bucket_pages()


def _leaves(tree) -> list:
    """The tensors of a nest of dicts, tuples and tensors, in order."""
    import torch

    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _leaves(x)]
    return []


def _replay_vs_eager(torch, eng, run) -> dict:
    """One program of ``eng`` through ``run()``: its first call (the body
    run eagerly, then captured), the decode state and the pool put back,
    and its second call (a replay). Returns the comparison: every output,
    state and pool tensor (less the dump page) equal bit for bit, one
    capture, the capture's ms and the replay's wall ms."""
    from aigw_tpu_torch.tpuserve.programs import clone_tree

    ps = eng.cfg.page_size

    def live():
        # the pool less its dump page: padding rows race into it (several
        # may share a row), so its bytes are garbage that nothing reads
        return _leaves(eng._state) + [t[:, :, :-ps]
                                      for t in _leaves(eng.kv_cache)]

    def snap():
        return [t.clone() for t in live()]

    def sync():
        if eng.device.type == "cuda":
            torch.cuda.synchronize()

    before = snap()
    n0 = eng.compile_tracker.compiles()
    ms0 = eng.compile_tracker.compiles_total_ms()
    eager = clone_tree(run())
    sync()
    after = snap()
    for dst, src in zip(live(), before):
        dst.copy_(src)
    del before
    t = time.monotonic()
    replay = clone_tree(run())
    sync()
    replay_ms = (time.monotonic() - t) * 1e3
    got, want = _leaves(replay), _leaves(eager)
    out = {"outputs_equal": len(got) == len(want) > 0 and all(
               torch.equal(a, b) for a, b in zip(got, want)),
           "state_and_pool_equal": all(
               torch.equal(a, b) for a, b in zip(snap(), after)),
           "captures": eng.compile_tracker.compiles() - n0,
           "capture_ms": eng.compile_tracker.compiles_total_ms() - ms0,
           "replay_wall_ms": replay_ms}
    if not (out["outputs_equal"] and out["state_and_pool_equal"]
            and out["captures"] == 1):
        raise AssertionError(f"replay differs from the eager body: {out}")
    return out


def graphs_replay_check(torch, params, qparams, reqs, dev: str = "cuda",
                        cfg=None) -> dict:
    """Each program family's replay against its eager body at Llama-3-8B
    widths (8 slots x 2048, 128-token pages), bit for bit: bf16 on the
    kernel path (the fused window's lean/full x greedy/sampled programs,
    the bucketed ``prefill`` at [2, 512], ``prefill_suffix`` at [1, 256]
    resumed at 768, the ragged prefill (K1) at 1024 rows), bf16 on the
    chained rung speculating at width 4 (a plain window through K3, a
    verify window through K5), and W8A16 over int8 pages (the fused
    window through K6 and K7, the bucketed prefill and a suffix chunk)."""
    from aigw_tpu_torch.models import llama
    from aigw_tpu_torch.tpuserve.engine import Engine, EngineConfig

    cfg = cfg or llama.LLAMA3_8B
    lens = served_prompt_lens(reqs)
    geom = dict(max_batch_size=8, max_seq_len=2048, page_size=128,
                attention_backend="pallas-ragged", decode_backend="fused",
                enable_prefix_cache=False)
    dev = torch.device(dev)

    def prefill_calls(eng, ragged: bool) -> dict:
        g = torch.Generator(device="cpu").manual_seed(16)
        toks = torch.randint(1, cfg.vocab_size, (2, 512), generator=g).to(
            torch.int32).to(dev)
        V = eng.model_cfg.vocab_size

        def rows(n):
            return (torch.tensor([[21, 0], [22, 0]][:n] + [[0, 0]] * (
                        max(0, n - 2)), dtype=torch.int64, device=dev),
                    torch.tensor([0.0, 0.8] + [0.0] * max(0, n - 2),
                                 device=dev)[:n],
                    torch.ones((n,), device=dev),
                    torch.zeros((n,), dtype=torch.int32, device=dev),
                    torch.zeros((n, V), device=dev),
                    torch.full((n,), eng._base_row, dtype=torch.int32,
                               device=dev))

        # pages past the live slots' (the pool's top 16 before the dump)
        top = eng.cfg.num_pages - 16
        pt = torch.arange(top, top + 16, dtype=torch.int32,
                          device=dev).reshape(2, 8)
        pt = torch.cat([pt, torch.zeros((2, 8), dtype=torch.int32,
                                        device=dev)], dim=1)
        i32 = (lambda *v: torch.tensor(v, dtype=torch.int32, device=dev))
        calls = {
            "prefill": (eng.fns.prefill, (toks, i32(400, 512), pt), rows(2)),
            "prefill_suffix": (eng.fns.prefill_suffix, (
                toks[:1, :256], i32(768), i32(1024), pt[:1, :8]), rows(1)),
        }
        if ragged:
            B = eng.cfg.max_batch_size
            T = 1024
            seq = torch.full((T,), B, dtype=torch.int32, device=dev)
            seq[:600], seq[600:1000] = 0, 1
            pos = torch.zeros((T,), dtype=torch.int32, device=dev)
            pos[:600] = torch.arange(600, device=dev)
            pos[600:1000] = torch.arange(400, device=dev)
            ptB = torch.zeros((B, 16), dtype=torch.int32, device=dev)
            ptB[:2] = pt
            calls["prefill_ragged"] = (eng.fns.prefill_ragged, (
                torch.cat([toks[0], toks[1]])[:T], seq, pos,
                i32(599, 999, *[0] * (B - 2)), ptB), rows(B))
        return {name: (lambda c=c: eng._prefill_step(*c))
                for name, c in calls.items()}

    out: dict = {}
    for what, p, over, windows, ragged in (
            ("bf16", params, {}, [(2, True, True, 0), (2, True, False, 0),
                                  (2, False, True, 0), (2, False, False, 0)],
             True),
            ("bf16_chained_spec4", params,
             dict(decode_backend="chained", pallas_attn=True, spec_tokens=4,
                  spec_adaptive=False),
             [(2, False, False, 0), (2, False, True, 4)], None),
            ("w8a16_kv_int8", qparams, dict(kv_cache_dtype="int8"),
             [(2, True, True, 0), (2, False, False, 0)], False)):
        t = time.monotonic()
        eng = Engine(p, cfg, EngineConfig(**{**geom, **over}),
                     eos_token_ids=(257,), device=dev)
        _graph_live(torch, eng, lens, greedy_only=bool(over.get(
            "spec_tokens")))
        fams = {f"decode[k={k},lean={lean},d={d},greedy={gr}]":
                (lambda k=k, lean=lean, gr=gr, d=d:
                 eng._decode_fn_for(k, lean, gr, d)())
                for k, lean, gr, d in windows}
        if ragged is not None:
            fams.update(prefill_calls(eng, ragged))
        out[what] = {name: _replay_vs_eager(torch, eng, run)
                     for name, run in fams.items()}
        out[what]["seconds"] = time.monotonic() - t
        del eng, fams
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _short_requests(reqs, n_bytes: int) -> list:
    """The burst with every prompt cut to ``n_bytes`` bytes."""
    out = []
    for kind, stream, body in reqs:
        body = dict(body)
        if kind == "chat":
            body["messages"] = [{"role": "user", "content":
                                 body["messages"][0]["content"][:n_bytes]}]
        else:
            body["prompt"] = body["prompt"][:n_bytes]
        out.append((kind, stream, body))
    return out


def serve_graphs(torch, srv, params, reqs, launches: dict) -> dict:
    """A replica warmed ahead of traffic (``GRAPH_WARM``: the decode
    ladder at page buckets 1, 2 and 4, the ragged prefill's token rungs),
    bf16 on the kernel path with the prefix cache off: ``warmup()``'s
    ms, the programs it captured and the graph pool's bytes; then the
    burst with its prompts cut to ``GRAPH_SHORT_BYTES`` (every sequence
    inside 4 pages), which must capture nothing, cold and warm; then the
    whole burst, whose longest sequences need the 16-page bucket (three
    warm buckets reach 512 tokens), cold (its captures counted) and warm
    (none). Launch counts zeroed before and read after the warm bursts:
    K1 and K2 must launch."""
    from aigw_tpu_torch.models import llama
    from aigw_tpu_torch.tpuserve.engine import Engine, EngineConfig

    stop_engine(srv)
    srv.engine = None
    gc.collect()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    eng = Engine(params, llama.LLAMA3_8B, EngineConfig(
        max_batch_size=8, max_seq_len=2048, page_size=128,
        attention_backend="pallas-ragged", decode_backend="fused",
        enable_prefix_cache=False, **GRAPH_WARM),
        eos_token_ids=(srv.tokenizer.eos_id,), device="cuda")
    eng.warmup()
    pool_bytes = eng.programs.bytes()
    out = {"warmup_ms": eng.stats.warmup_ms,
           "warm_programs": eng.stats.warm_programs,
           "xla_compile_ms": eng.stats.xla_compile_ms,
           "programs": eng.compile_tracker.programs(),
           "graph_pool_bytes": pool_bytes,
           "device_bytes_above_weights": torch.cuda.memory_allocated()
           - mem0}
    srv.engine = eng
    eng.start()

    def burst(what, rs, gate_zero: bool) -> None:
        st0 = json.loads(_http(srv.port, "/state")[2])
        reset_counts()
        t = time.monotonic()
        serve_phase(srv.port, rs)
        wall = time.monotonic() - t
        counts = read_counts()
        st = json.loads(_http(srv.port, "/state")[2])
        grew = st["xla_compiles"] - st0["xla_compiles"]
        out[what] = {"wall_s": wall, "captures": grew,
                     "capture_ms": st["xla_compile_ms"]
                     - st0["xla_compile_ms"],
                     "prefill_ms": st["prefill_ms"] - st0["prefill_ms"],
                     "launches": counts}
        if gate_zero and grew:
            raise AssertionError(f"{what}: {grew} captures after warm-up "
                                 f"inside the warmed geometry")
        if counts["ragged_prefill_attention"] <= 0 \
                or counts["fused_paged_decode"] <= 0:
            raise AssertionError(f"{what}: K1 / K2 not launched: {counts}")

    short = _short_requests(reqs, GRAPH_SHORT_BYTES)
    burst("short_cold", short, True)
    burst("short_warm", short, True)
    burst("burst_cold", reqs, False)
    burst("burst_warm", reqs, True)
    launches["serve_graphs"] = out["burst_warm"]["launches"]
    st = json.loads(_http(srv.port, "/state")[2])
    out.update(xla_compiles=st["xla_compiles"],
               warm_programs_state=st["warm_programs"],
               graph_pool_bytes_after=eng.programs.bytes())
    if st["warm_programs"] != out["warm_programs"] or out["warm_programs"] \
            != sum(out["programs"].values()):
        raise AssertionError(f"/state's warm_programs {st} against {out}")
    log(f"serve_graphs: warm-up {out['warmup_ms']:.0f} ms, "
        f"{out['warm_programs']} programs, pool {pool_bytes / 1e9:.2f} GB; "
        f"short burst {out['short_cold']['wall_s']:.2f}/"
        f"{out['short_warm']['wall_s']:.2f} s, 0 captures; burst "
        f"{out['burst_cold']['wall_s']:.2f} s ("
        f"{out['burst_cold']['captures']} captures), warm "
        f"{out['burst_warm']['wall_s']:.2f} s")
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed", 2)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs an NVIDIA "
             "GPU", 2)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        from aigw_tpu_torch.models import llama, mixtral, quant
        from aigw_tpu_torch.models.registry import ModelSpec, register_model
        from aigw_tpu_torch.obs.metrics import EnginePhases
        from aigw_tpu_torch.ops import _build
        from aigw_tpu_torch.tpuserve.engine import Engine, EngineConfig
        from aigw_tpu_torch.tpuserve.sampling import token_logprobs
        from aigw_tpu_torch.tpuserve.server import TPUServeServer
    except ImportError as e:
        fail(f"the aigw_tpu_torch package is not beside chip_smoke.py "
             f"({e})", 3)
    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi_line()
    print(f"card: {card}", flush=True)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, "
        f"device {torch.cuda.get_device_name(0)}")

    # 2. build
    t = time.monotonic()
    _build.library()
    log(f"kernels built in {time.monotonic() - t:.1f}s "
        f"(nvcc {_build.last_build_s:.1f}s) -> {_build.library_path().name}")

    # 3. serve at full width
    register_model(ModelSpec("llama-3-8b-random", "llama", llama.LLAMA3_8B))
    # the earlier phases run with the prefix cache off, so their lines
    # keep measuring what they measured (their warm bursts repeat the
    # cold bursts' prompts, which would be full hits)
    cfg = EngineConfig(max_batch_size=8, max_seq_len=2048, page_size=128,
                       attention_backend="pallas-ragged",
                       decode_backend="fused", enable_prefix_cache=False)
    t = time.monotonic()
    srv = TPUServeServer("llama-3-8b-random", cfg, device="cuda", port=0)
    srv.start()
    log(f"server up in {time.monotonic() - t:.1f}s: "
        f"{sum(p.numel() for p in srv.engine.params.values()) / 1e9:.2f}B "
        f"params, decode {srv.engine.decode_attn_impl}")

    def restart(params, **engine_kw):
        stop_engine(srv)
        # the kernel path: the ragged prefill (K1) and, unless a phase
        # names the chained rung, the fused decode (K2)
        kw = dict(max_batch_size=8, max_seq_len=2048, page_size=128,
                  attention_backend="pallas-ragged", decode_backend="fused",
                  enable_prefix_cache=False)
        srv.engine = Engine(
            params, llama.LLAMA3_8B, EngineConfig(**{**kw, **engine_kw}),
            eos_token_ids=(srv.tokenizer.eos_id,), device="cuda")
        srv.engine.start()

    try:
        reqs = _requests(np.random.default_rng(0))
        reset_counts()
        t = time.monotonic()
        results = serve_phase(srv.port, reqs)
        cold_s = time.monotonic() - t
        served = read_counts()
        launches = {k: served[k] for k in ("ragged_prefill_attention",
                                           "fused_paged_decode")}
        log(f"served {len(reqs)} requests in {cold_s:.1f}s: "
            f"{[r['n'] for r in results]} tokens; launches {served}")
        if launches["ragged_prefill_attention"] <= 0 \
                or launches["fused_paged_decode"] <= 0:
            raise AssertionError(f"kernels not on the served path: "
                                 f"{served}")
        state = json.loads(_http(srv.port, "/state")[2])
        log(f"/state: decode {state['decode_attn_impl']}, prefill "
            f"{state['attention_backend_reason']}, padded_frac "
            f"{state['prefill_padded_frac']}, tokens "
            f"{state['tokens_generated']}")
        # the same burst on the warm server: the first one also pays the
        # process's first-use costs (cuBLAS handles, lazily loaded
        # kernels). The phase histograms start empty for it, so /state's
        # phase_percentiles are the warm burst's
        srv.engine.phases = EnginePhases()
        t = time.monotonic()
        serve_phase(srv.port, reqs)
        warm_s = time.monotonic() - t
        warm = json.loads(_http(srv.port, "/state")[2])
        pp = warm["phase_percentiles"]
        print(json.dumps({"serve": {
            "requests": len(reqs),
            "new_tokens": sum(r["n"] for r in results),
            "prompt_tokens": served_prompt_lens(reqs),
            "cold_s": cold_s, "warm_s": warm_s,
            "warm_prefill_ms": warm["prefill_ms"] - state["prefill_ms"],
            "warm_prefills": warm["prefills"] - state["prefills"],
            "warm_decode_steps": warm["decode_steps"]
            - state["decode_steps"],
            "warm_prefill_p50_ms": pp["prefill"]["p50"],
            "warm_prefill_p95_ms": pp["prefill"]["p95"],
            "warm_ttft_p50_ms": pp["ttft"]["p50"],
            "warm_ttft_p95_ms": pp["ttft"]["p95"],
            "warm_phase_percentiles": pp,
            **serve_profile(torch, srv.port, reqs, warm_s)}}), flush=True)
        if min(pp["prefill"]["p50"], pp["ttft"]["p50"]) < 0:
            raise AssertionError(f"no prefill or TTFT observations on "
                                 f"/state: {pp}")

        # the prefix cache on the fused rung, then off (serve_prefix)
        params = srv.engine.params
        prefix_reqs = _prefix_requests(np.random.default_rng(7))
        serve_prefix_phase(torch, srv, restart, params, prefix_reqs,
                           launches)

        # grammar-constrained decoding (serve_constrained)
        serve_constrained_phase(srv, restart, params)

        # the chained rung: restart the engine with pallas_attn
        restart(params, decode_backend="chained", pallas_attn=True)
        reset_counts()
        serve_phase(srv.port, reqs[:2])
        k3 = read_counts()["paged_attention_decode_v2"]
        log(f"chained rung ({srv.engine.decode_attn_impl}): K3 launches {k3}")
        if k3 <= 0:
            raise AssertionError("K3 not on the chained served path")
        launches["paged_attention_decode_v2"] = k3

        # speculative decoding, on the chained rung (K5) and on the fused
        spec_phases(srv, restart, params, reqs, launches)

        # 4. quantized serving: W8A16 weights over int8 KV pages; the
        # bf16 copy stays for the checks below (consume=False)
        t = time.monotonic()
        qparams = quant.quantize_params(params, consume=False, mode="int8")
        torch.cuda.synchronize()
        q_gb = sum(v.numel() * v.element_size()
                   for v in qparams.values()) / 1e9
        log(f"weights quantized to int8 on the card in "
            f"{time.monotonic() - t:.1f}s ({q_gb:.2f} GB)")
        restart(qparams, decode_backend="fused", kv_cache_dtype="int8")
        reset_counts()
        t = time.monotonic()
        results_q = serve_phase(srv.port, reqs)
        cold_q = time.monotonic() - t
        served_q = read_counts()
        log(f"quantized: served {len(reqs)} requests in {cold_q:.1f}s "
            f"({srv.engine.decode_attn_impl}); launches {served_q}")
        if served_q["w8a16_matmul"] <= 0 \
                or served_q["fused_paged_decode_int8"] <= 0:
            raise AssertionError(f"K6 / K7-int8 not on the quantized "
                                 f"served path: {served_q}")
        if served_q["ragged_prefill_attention"] \
                or served_q["fused_paged_decode"]:
            raise AssertionError(f"K1 / K2 launched on a quantized pool: "
                                 f"{served_q}")
        state_q = json.loads(_http(srv.port, "/state")[2])
        t = time.monotonic()
        serve_phase(srv.port, reqs)
        warm_q = time.monotonic() - t
        warm_sq = json.loads(_http(srv.port, "/state")[2])
        print(json.dumps({"serve_quant": {
            "weights": "int8", "kv_cache_dtype": state_q["kv_cache_dtype"],
            "requests": len(reqs),
            "new_tokens": sum(r["n"] for r in results_q),
            "cold_s": cold_q, "warm_s": warm_q,
            "warm_prefill_ms": warm_sq["prefill_ms"] - state_q["prefill_ms"],
            "warm_decode_steps": warm_sq["decode_steps"]
            - state_q["decode_steps"],
            "kv_bytes_per_token": state_q["kv_bytes_per_token"],
            "kv_pool_bytes": state_q["kv_pool_bytes"],
            "kv_bytes_per_token_bf16": state["kv_bytes_per_token"],
            "kv_pool_bytes_bf16": state["kv_pool_bytes"],
            "launches": served_q}}), flush=True)
        launches["w8a16_matmul"] = served_q["w8a16_matmul"]
        launches["fused_paged_decode_int8"] = \
            served_q["fused_paged_decode_int8"]
        # the prefix cache over int8 pages (serve_prefix_int8)
        serve_prefix_int8(torch, srv, restart, qparams, prefix_reqs)

        # the same weights over int4 KV pages, two requests
        restart(qparams, decode_backend="fused", kv_cache_dtype="int4")
        reset_counts()
        t = time.monotonic()
        serve_phase(srv.port, reqs[:2])
        served_4 = read_counts()
        state_4 = json.loads(_http(srv.port, "/state")[2])
        print(json.dumps({"serve_int4_kv": {
            "requests": 2, "wall_s": time.monotonic() - t,
            "kv_bytes_per_token": state_4["kv_bytes_per_token"],
            "kv_pool_bytes": state_4["kv_pool_bytes"],
            "launches": served_4}}), flush=True)
        if served_4["fused_paged_decode_int4"] <= 0:
            raise AssertionError(f"K7-int4 not on the int4 served path: "
                                 f"{served_4}")
        launches["fused_paged_decode_int4"] = \
            served_4["fused_paged_decode_int4"]

        # the reference's default programs: a replica built from
        # EngineConfig() with only the geometry set, bf16 then W8A16
        # over int8 pages (serve_defaults), and /v1/embeddings on it
        print(json.dumps({"serve_defaults": serve_defaults(
            torch, srv, restart, params, qparams, reqs, launches)}),
            flush=True)
        print(json.dumps({"embeddings": embeddings_phase(
            torch, srv, params, qparams, launches)}), flush=True)

        # multi-LoRA: a zoo over 2 rows, bf16 then W8A16 (serve_lora)
        serve_lora(torch, srv, params, qparams, reqs, launches)

        # per-token logprobs, n > 1 and tenant fairness (serve_logprobs;
        # its teacher-forced bound is gated after model_check)
        lp_out = serve_logprobs(torch, srv, params, reqs, launches)

        # the operations surface: /metrics, traces, the flight recorder,
        # metering, drain and the profile capture (serve_ops)
        print(json.dumps({"serve_ops": serve_ops(
            torch, srv, params, reqs, launches, warm_s)}), flush=True)

        # KV mobility and the batch tier: a second replica in this
        # process (serve_mobility)
        print(json.dumps({"serve_mobility": serve_mobility(
            torch, srv, params, reqs, prefix_reqs[0][0][2], launches,
            pp)}), flush=True)

        # a replica warmed ahead of traffic: no capture after warm-up
        # inside the warmed geometry (serve_graphs)
        print(json.dumps({"serve_graphs": serve_graphs(
            torch, srv, params, reqs, launches)}), flush=True)
    finally:
        srv.stop()

    # 5. kernels against their plain versions; the model end to end
    rows = kernel_checks(torch, launches)
    rows += quant_kernel_checks(torch, launches)
    checks = {}
    for name, p_, kv_dtype, ref in (
            ("bf16", params, "bfloat16", None),
            ("w8a16_kv_int8", qparams, "int8", params),
            ("w4a16", None, "bfloat16", params)):
        t = time.monotonic()
        if p_ is None:  # W4A16: plain PyTorch matmuls, as the reference's
            p_ = quant.quantize_params(params, consume=False, mode="int4")
        checks[name] = model_check(torch, p_, llama.LLAMA3_8B,
                                   kv_dtype=kv_dtype, ref_params=ref)
        del p_
        log(f"full-width model {name}, kernels vs plain: {checks[name]} "
            f"({time.monotonic() - t:.1f}s)")
    t = time.monotonic()
    checks["verify"] = verify_check(torch, params, llama.LLAMA3_8B)
    log(f"full-width verify step, K5 vs plain: {checks['verify']} "
        f"({time.monotonic() - t:.1f}s)")
    t = time.monotonic()
    checks["defaults"] = defaults_model_check(torch, params, llama.LLAMA3_8B)
    log(f"the default programs ({DEFAULTS_CHECK_LAYERS} layers) against "
        f"K1 and K2: {checks['defaults']} ({time.monotonic() - t:.1f}s)")
    t = time.monotonic()
    checks["defaults_w8a16"] = defaults_w8a16_check(torch, qparams,
                                                    llama.LLAMA3_8B)
    log(f"K6 on the default programs ({DEFAULTS_CHECK_LAYERS} layers, "
        f"M 64 and 2) against its plain version: "
        f"{checks['defaults_w8a16']} ({time.monotonic() - t:.1f}s)")
    t = time.monotonic()
    checks["resume"] = resume_check(torch, params, llama.LLAMA3_8B)
    log(f"full-width prefix-cache resume (K1 at 1024, the full hit's row "
        f"at 1023) vs a cold prefill: {checks['resume']} "
        f"({time.monotonic() - t:.1f}s)")
    print(json.dumps({"model_check": checks}), flush=True)
    t = time.monotonic()
    graphs = {"replay": graphs_replay_check(torch, params, qparams, reqs)}
    log(f"every program family's replay equals its eager body bit for bit "
        f"({time.monotonic() - t:.1f}s)")
    gate_teacher_forced(lp_out, checks["bf16"])
    print(json.dumps({"serve_logprobs": lp_out}), flush=True)
    checks_lora = {}
    for name, dtype in (("float32", torch.float32),
                        ("bf16", torch.bfloat16)):
        t = time.monotonic()
        checks_lora[name] = model_check_lora(torch, dtype)
        torch.cuda.empty_cache()
        log(f"LoRA at Llama-3-8B widths ({LORA_CHECK_LAYERS} layers, "
            f"{name}), kernels vs plain, base rows vs lora=None: "
            f"{checks_lora[name]} ({time.monotonic() - t:.1f}s)")
    print(json.dumps({"model_check_lora": checks_lora}), flush=True)

    # 6. where a decode step's time goes
    steps: dict = {}

    def captured_beside(name, eager, **kw):
        """The same step captured in a CUDA graph and replayed."""
        cap = decode_profile(torch, kw.pop("p", params), llama.LLAMA3_8B,
                             captured=True, **kw)
        steps[name] = {k: {"wall_ms": d["wall_ms"],
                           "device_ms": d["device_ms"],
                           "device_busy": d["device_busy"],
                           "kernel_launches": d["kernel_launches"]}
                       for k, d in (("eager", eager), ("captured", cap))}
        log(f"{name} step captured: {cap['wall_ms']:.2f} ms wall, "
            f"{cap['device_ms']:.2f} ms on the device; eager "
            f"{eager['wall_ms']:.2f} / {eager['device_ms']:.2f}")

    prof = decode_profile(torch, params, llama.LLAMA3_8B)
    log(f"decode step at full width: {prof['wall_ms']:.2f} ms wall, "
        f"{prof['device_ms']:.2f} ms on the device "
        f"(busy {prof['device_busy']:.2f})")
    print(json.dumps({"decode_profile": prof}), flush=True)
    captured_beside("fused", prof)
    prof_g = decode_profile(torch, params, llama.LLAMA3_8B, attn_impl="")
    log(f"gather decode step (the default rung): {prof_g['wall_ms']:.2f} "
        f"ms wall, {prof_g['device_ms']:.2f} ms on the device (busy "
        f"{prof_g['device_busy']:.2f}); fused {prof['wall_ms']:.2f} / "
        f"{prof['device_ms']:.2f}")
    print(json.dumps({"decode_profile_gather": prof_g}), flush=True)
    captured_beside("gather", prof_g, attn_impl="")
    prof_c = decode_profile(torch, params, llama.LLAMA3_8B,
                            attn_impl="chained")
    log(f"chained decode step (K3): {prof_c['wall_ms']:.2f} ms wall, "
        f"{prof_c['device_ms']:.2f} ms on the device (busy "
        f"{prof_c['device_busy']:.2f})")
    print(json.dumps({"decode_profile_chained": prof_c}), flush=True)
    captured_beside("chained", prof_c, attn_impl="chained")
    prof_lp = decode_profile(torch, params, llama.LLAMA3_8B,
                             logprobs_topk=LP_TOPK)
    prof_lp0 = decode_profile(torch, params, llama.LLAMA3_8B,
                              logprobs_topk=0)
    lp_line = {
        "logprobs_topk": LP_TOPK, "with": prof_lp, "without": prof_lp0,
        "added_wall_ms": prof_lp["wall_ms"] - prof_lp0["wall_ms"],
        "added_device_ms": prof_lp["device_ms"] - prof_lp0["device_ms"],
        "added_launches": prof_lp["kernel_launches"]
        - prof_lp0["kernel_launches"],
        # the window's host copy: [B] chosen f32 and [B, k] ids i32 and
        # values f32 per step
        "added_host_copy_bytes_per_step": 8 * (4 + LP_TOPK * 8)}
    # the logprobs ops alone, at a step's [8, V] float32 logits (the
    # steps' difference sits inside their run-to-run spread)
    g = torch.Generator(device="cuda").manual_seed(5)
    logits = torch.randn((8, llama.LLAMA3_8B.vocab_size), generator=g,
                         device="cuda")
    top = logits.argmax(-1)
    lp_line["logprobs_ops_ms"] = cuda_ms(
        lambda: token_logprobs(logits, top, LP_TOPK))
    log(f"decode step with logprobs (top {LP_TOPK}): the ops alone "
        f"{lp_line['logprobs_ops_ms']:.4f} ms, "
        f"+{lp_line['added_device_ms']:.3f} ms device, "
        f"+{lp_line['added_wall_ms']:.3f} ms wall, "
        f"+{lp_line['added_launches']:.0f} launches")
    print(json.dumps({"decode_profile_logprobs": lp_line}), flush=True)
    prof_q = decode_profile(torch, qparams, llama.LLAMA3_8B,
                            kv_dtype="int8")
    log(f"W8A16 + int8 KV decode step: {prof_q['wall_ms']:.2f} ms wall, "
        f"{prof_q['device_ms']:.2f} ms on the device "
        f"(busy {prof_q['device_busy']:.2f})")
    print(json.dumps({"decode_profile_quant": prof_q}), flush=True)
    captured_beside("w8a16_kv_int8", prof_q, p=qparams, kv_dtype="int8")
    prof_v = decode_profile(torch, params, llama.LLAMA3_8B, verify_width=5)
    log(f"verify step (width 5, K5) at full width: {prof_v['wall_ms']:.2f} "
        f"ms wall, {prof_v['device_ms']:.2f} ms on the device (busy "
        f"{prof_v['device_busy']:.2f})")
    print(json.dumps({"verify_profile": prof_v}), flush=True)
    captured_beside("verify", prof_v, verify_width=5)
    # one bf16 prefill of the served burst's prompts, of K1's case, and
    # of a prefix-cache resume (150 rows at 1024) beside the same
    # prompt's cold prefill (1174 rows)
    prof_p = {name: prefill_profile(torch, params, llama.LLAMA3_8B, seqs)
              for name, seqs in (
                  ("served_burst",
                   [(n, 0) for n in served_prompt_lens(reqs)]),
                  ("k1_case", K1_CASE),
                  ("resume_150_at_1024", [(150, 1024)]),
                  ("cold_1174", [(1174, 0)]))}
    prof_p["served_burst_bucketed"] = prefill_profile_bucketed(
        torch, params, llama.LLAMA3_8B, served_prompt_lens(reqs))
    log(f"the served burst's prompts on the default programs: "
        f"{prof_p['served_burst_bucketed']['wall_ms']:.2f} ms wall, "
        f"{prof_p['served_burst_bucketed']['device_ms']:.2f} ms on the "
        f"device ({prof_p['served_burst_bucketed']['program_calls']} calls)")
    for name, pr in prof_p.items():
        if name == "served_burst_bucketed":
            continue
        log(f"prefill ({name}, {pr['rows']} rows) at full width: "
            f"{pr['wall_ms']:.2f} ms wall, {pr['device_ms']:.2f} ms on the "
            f"device, K1 {pr['k1_in_place_ms']:.3f} ms in 32 launches")
    print(json.dumps({"prefill_profile": prof_p}), flush=True)
    graphs["steps"] = steps
    graphs["prefill"] = {}
    for name in ("served_burst", "resume_150_at_1024"):
        seqs = ([(n, 0) for n in served_prompt_lens(reqs)]
                if name == "served_burst" else [(150, 1024)])
        cap = prefill_profile(torch, params, llama.LLAMA3_8B, seqs,
                              captured=True)
        graphs["prefill"][name] = {
            k: {"wall_ms": d["wall_ms"], "device_ms": d["device_ms"]}
            for k, d in (("eager", prof_p[name]), ("captured", cap))}
        log(f"prefill ({name}) captured: {cap['wall_ms']:.2f} ms wall, "
            f"{cap['device_ms']:.2f} ms on the device; eager "
            f"{prof_p[name]['wall_ms']:.2f} / "
            f"{prof_p[name]['device_ms']:.2f}")
    print(json.dumps({"graphs": graphs}), flush=True)
    srv.engine = None
    del params, qparams, ref  # the model_check loop's ref held params
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # 7. the mixtral family at Mixtral-8x7B widths: the layer and the
    # entry points at 2 layers, kernels vs plain; then served at full
    # depth in W8A16
    checks_moe = {}
    for name, dtype in (("float32", torch.float32),
                        ("bf16", torch.bfloat16)):
        t = time.monotonic()
        checks_moe[name] = model_check_moe(torch, mixtral, dtype)
        torch.cuda.empty_cache()
        log(f"Mixtral-8x7B widths ({MOE_CHECK_LAYERS} layers, {name}), "
            f"kernels vs plain: {checks_moe[name]} "
            f"({time.monotonic() - t:.1f}s)")
    print(json.dumps({"model_check_moe": checks_moe}), flush=True)
    serve_moe(torch, mixtral, reqs, launches)
    for row in rows:
        row["launches_serve_moe"] = launches["serve_moe"].get(row["name"], 0)
        row["launches_serve_lora"] = launches["serve_lora"].get(
            row["name"], 0)
        row["launches_serve_logprobs"] = launches["serve_logprobs"].get(
            row["name"], 0)
        row["launches_serve_ops"] = launches["serve_ops"].get(row["name"], 0)
        row["launches_serve_mobility"] = launches["serve_mobility"].get(
            row["name"], 0)
        row["launches_serve_graphs"] = launches["serve_graphs"].get(
            row["name"], 0)
        for phase in ("serve_defaults", "serve_defaults_w8a16",
                      "embeddings_bf16", "embeddings_w8a16"):
            row[f"launches_{phase}"] = launches[phase].get(row["name"], 0)

    print(json.dumps({"kernels": rows}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # noqa: BLE001 — every failed phase exits 1
        traceback.print_exc()
        print("chip_smoke FAILED", flush=True)
        sys.exit(1)
