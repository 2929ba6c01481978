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
   K6 at each of the five weight shapes a decode step multiplies (the
   ``qmatmul_shapes`` JSON line), beside cuBLAS on the same weight
   dequantized to bf16 ahead of time; full-width prefill + 8 decode
   steps of the model through the kernels against the same through the
   plain versions, for bf16, for W8A16 over an int8 pool and for W4A16
   (whose matmuls are plain PyTorch in the reference too), the
   quantized ones also against the bf16 model's greedy tokens; one
   full-width verify step (width 5) through K5 against the same through
   its plain version (the ``model_check`` line's ``verify``); a prompt's
   8 pages prefilled, then its last 150 tokens resumed at 1024, and a
   full hit's copied page with its last token resumed at 1023, each
   against a cold prefill (``resume``);
6. where one full-width decode step's time goes, bf16 on the fused and
   on the chained rung (K3) and W8A16 over int8 pages, and one verify
   step of width 5 through K5: its host wall time against the device
   time ``torch.profiler`` sees, by kernel (the ``decode_profile``,
   ``decode_profile_chained``, ``decode_profile_quant`` and
   ``verify_profile`` JSON lines; ``port_kernels_ms`` sums every K6,
   K2/K7 and K3 or K5 launch of the step); the same for one full-width
   bf16 prefill of the served burst's prompts, K1's 32 launches summed,
   and of a prefix-cache resume (150 rows at 1024) beside the same
   prompt's cold prefill (the ``prefill_profile`` line);
7. the ``kernels`` JSON line, the card line, then the last line
   ``{"ok": true, "device": {...}}``.

Without CUDA, or outside the repository, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
import time
import traceback
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
# per layer (x 32), the lm_head once
QMM_STEP = [((4096, 4096), 64), ((4096, 1024), 64), ((4096, 14336), 64),
            ((14336, 4096), 32), ((4096, 128256), 1)]
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
    to its counter where it launches its kernel, and nowhere else."""
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


def reset_counts() -> None:
    for fn, attr in counters().values():
        setattr(fn, attr, 0)


def read_counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in counters().items()}


# -- phase 3: serving ---------------------------------------------------------
def _http(port: int, path: str, body: dict | None = None):
    url = f"http://127.0.0.1:{port}{path}"
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"content-type": "application/json"})
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


def _check_pinned(results) -> None:
    for r in results:
        if r.get("text") != chr(PIN_TOKEN) * SERVE_MAX_TOKENS:
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
    rows.append(dict(
        name="paged_attention_decode_v2", route="cuda",
        source="aigw_tpu_torch/csrc/paged_attention.cu",
        replaces="aigw_tpu/ops/pallas/paged_attention.py:223",
        launches=launches["paged_attention_decode_v2"], max_abs_err=err,
        ms=(t3a + t3b) / 2, ms_rotated=rot3,
        plain_ms=cuda_ms(k3_plain, iters=5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
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
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
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
    rows.append(dict(
        name="paged_attention_verify", route="cuda",
        source="aigw_tpu_torch/csrc/paged_attention.cu",
        replaces="aigw_tpu/ops/pallas/paged_attention.py:497",
        launches=launches["paged_attention_verify"], max_abs_err=err,
        ms=cuda_ms(k5), ms_rotated=rot5,
        plain_ms=cuda_ms(k5_plain, iters=5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
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


def quant_kernel_checks(torch, launches: dict, dev: str = "cuda") -> list:
    """K6 at every weight shape a decode step multiplies (M = 8) and
    K7's int8 and int4 rungs at K2's shapes, each against its plain
    version; K6 also beside ``torch.matmul`` on the same weight
    dequantized to bf16 ahead of time (cuBLAS, the library row)."""
    from aigw_tpu_torch.models import kvq, llama, quant
    from aigw_tpu_torch.ops import decode_fused, qmatmul

    g = torch.Generator(device=dev)
    g.manual_seed(4321)
    rows, shapes = [], []
    M = 8
    for (K, N), per_step in QMM_STEP:
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
            raise AssertionError(f"K6 {K}x{N}: max error {err.max().item()}")
        again = qmatmul.w8a16_matmul(x, q, sc)
        if not torch.equal(got, again):
            raise AssertionError(f"K6 {K}x{N}: two calls differ")
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
        log(f"K6 {K}x{N}: {shapes[-1]['ms']:.4f} ms, rotated {ms_rot:.4f} "
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
                   attn_impl: str = "fused") -> dict:
    """Where one full-width decode step's time goes: host wall clock of a
    step (synchronized) against the device time torch.profiler sees, by
    kernel. Batch 8 at 1000 cached tokens each, a ``kv_dtype`` pool, on
    the ``attn_impl`` rung (K2/K7 fused, K3 chained); with
    ``verify_width`` > 0, a verify step of that width on the chained
    rung (K5) instead."""
    from torch.profiler import ProfilerActivity, profile

    from aigw_tpu_torch.models import kvq, llama

    B, PS, P, ctx, steps = 8, 128, 16, 1000, 5
    kv = kvq.make_pool((cfg.n_layers, 2, (B * P + 1) * PS, cfg.n_kv_heads,
                        cfg.head_dim), kv_dtype, dev)
    pt = torch.arange(B * P, dtype=torch.int32, device=dev).reshape(B, P)
    tok = torch.zeros((B,), dtype=torch.int32, device=dev)
    pos = torch.full((B,), ctx, dtype=torch.int32, device=dev)
    act = torch.ones((B,), dtype=torch.bool, device=dev)

    toks = torch.zeros((B, verify_width), dtype=torch.int32, device=dev)
    limits = pos + 64

    def step():
        if verify_width:
            llama.verify_step(params, cfg, toks, pos, kv, pt, PS, act,
                              limits, attn_impl="chained")
        else:
            llama.decode_step(params, cfg, tok, pos, kv, pt, PS, act,
                              attn_impl=attn_impl)

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
    return {"batch": B, "cached_tokens": ctx, "layers": cfg.n_layers,
            "kv_dtype": kv_dtype, "verify_width": verify_width,
            "attn_impl": "chained" if verify_width else attn_impl,
            "wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy": device_ms / wall_ms,
            "port_kernels_ms": ours, "top_kernels_ms": top}


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


def prefill_profile(torch, params, cfg, seqs, dev: str = "cuda") -> dict:
    """Where one full-width bf16 prefill's time goes: one
    ``prefill_ragged`` call over the packed sequences ``seqs`` ((new
    tokens, start position) each; the rows padded to a multiple of 256),
    its host wall clock (synchronized) against the device time
    torch.profiler sees, and K1's launches (one per layer) summed."""
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
                             kv, pt, PS)

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
            "padded_rows": T, "layers": cfg.n_layers, "wall_ms": wall_ms,
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
    restart(params, pallas_attn=True, spec_tokens=4,
            spec_adaptive=False)
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
    restart(params, pallas_attn=True, spec_tokens=4, spec_adaptive=False,
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
        from aigw_tpu_torch.models import llama, quant
        from aigw_tpu_torch.models.registry import ModelSpec, register_model
        from aigw_tpu_torch.obs.metrics import EnginePhases
        from aigw_tpu_torch.ops import _build
        from aigw_tpu_torch.tpuserve.engine import Engine, EngineConfig
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
        srv.engine.stop()
        kw = dict(max_batch_size=8, max_seq_len=2048, page_size=128,
                  attention_backend="pallas-ragged",
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

        # the chained rung: restart the engine with pallas_attn
        restart(params, pallas_attn=True)
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
    checks["resume"] = resume_check(torch, params, llama.LLAMA3_8B)
    log(f"full-width prefix-cache resume (K1 at 1024, the full hit's row "
        f"at 1023) vs a cold prefill: {checks['resume']} "
        f"({time.monotonic() - t:.1f}s)")
    print(json.dumps({"model_check": checks}), flush=True)

    # 6. where a decode step's time goes
    prof = decode_profile(torch, params, llama.LLAMA3_8B)
    log(f"decode step at full width: {prof['wall_ms']:.2f} ms wall, "
        f"{prof['device_ms']:.2f} ms on the device "
        f"(busy {prof['device_busy']:.2f})")
    print(json.dumps({"decode_profile": prof}), flush=True)
    prof_c = decode_profile(torch, params, llama.LLAMA3_8B,
                            attn_impl="chained")
    log(f"chained decode step (K3): {prof_c['wall_ms']:.2f} ms wall, "
        f"{prof_c['device_ms']:.2f} ms on the device (busy "
        f"{prof_c['device_busy']:.2f})")
    print(json.dumps({"decode_profile_chained": prof_c}), flush=True)
    prof_q = decode_profile(torch, qparams, llama.LLAMA3_8B,
                            kv_dtype="int8")
    log(f"W8A16 + int8 KV decode step: {prof_q['wall_ms']:.2f} ms wall, "
        f"{prof_q['device_ms']:.2f} ms on the device "
        f"(busy {prof_q['device_busy']:.2f})")
    print(json.dumps({"decode_profile_quant": prof_q}), flush=True)
    prof_v = decode_profile(torch, params, llama.LLAMA3_8B, verify_width=5)
    log(f"verify step (width 5, K5) at full width: {prof_v['wall_ms']:.2f} "
        f"ms wall, {prof_v['device_ms']:.2f} ms on the device (busy "
        f"{prof_v['device_busy']:.2f})")
    print(json.dumps({"verify_profile": prof_v}), flush=True)
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
    for name, pr in prof_p.items():
        log(f"prefill ({name}, {pr['rows']} rows) at full width: "
            f"{pr['wall_ms']:.2f} ms wall, {pr['device_ms']:.2f} ms on the "
            f"device, K1 {pr['k1_in_place_ms']:.3f} ms in 32 launches")
    print(json.dumps({"prefill_profile": prof_p}), flush=True)
    del params, qparams
    torch.cuda.synchronize()

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
