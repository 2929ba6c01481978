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
   and warm wall times, the device's busy share while serving);
4. every kernel against its plain PyTorch version on the card at the
   served shapes (max |error| within the stated tolerance; K2's pool
   bytes equal), timed with CUDA events (L2 flushed between launches)
   beside the plain version and the kernel's roofline bound; one
   full-width prefill + 8 decode steps of the model through the kernels
   against the same through the plain versions;
5. where one full-width decode step's time goes: its host wall time
   against the device time ``torch.profiler`` sees, by kernel (the
   ``decode_profile`` JSON line);
6. the ``kernels`` JSON line, the card line, then the last line
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
ATTN_TOL = 2e-2  # bf16 attention output, kernel vs plain (abs)
SERVE_MAX_TOKENS = 64
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


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    """Well-formed JSON or SSE; returns {"n": tokens, "finish": reason}."""
    if status != 200:
        raise AssertionError(f"{kind} status {status}")
    if not stream:
        body = json.loads(raw)
        want = "chat.completion" if kind == "chat" else "text_completion"
        if body["object"] != want:
            raise AssertionError(f"object {body['object']!r}, want {want!r}")
        return {"n": body["usage"]["completion_tokens"],
                "finish": body["choices"][0]["finish_reason"]}
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
        if r["n"] != SERVE_MAX_TOKENS and r["finish"] != "stop":
            raise AssertionError(f"request {i}: {r}")
    return results


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

    err = (k3().float() - k3_plain().float()).abs().max().item()
    if not err <= ATTN_TOL:
        raise AssertionError(f"K3 max error {err} > {ATTN_TOL}")
    toks = sum(lengths)
    nbytes = 2 * (2 * B * H * D + 2 * toks * Hkv * D) + 4 * B * (P + 1)
    b_ms, b_by = bound(nbytes, 4 * toks * H * D)
    rows.append(dict(
        name="paged_attention_decode_v2", route="cuda",
        source="aigw_tpu_torch/csrc/paged_attention.cu",
        replaces="aigw_tpu/ops/pallas/paged_attention.py:223",
        launches=launches["paged_attention_decode_v2"], max_abs_err=err,
        ms=cuda_ms(k3), plain_ms=cuda_ms(k3_plain, iters=5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))
    log(f"K3 ok: max err {err:.3g}, {rows[-1]['ms']:.4f} ms "
        f"(bound {b_ms:.4f} ms, plain {rows[-1]['plain_ms']:.3f} ms)")

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
    err = (out_k.float() - out_p.float()).abs().max().item()
    if not err <= ATTN_TOL:
        raise AssertionError(f"K2 max error {err} > {ATTN_TOL}")
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
    rows.append(dict(
        name="fused_paged_decode", route="cuda",
        source="aigw_tpu_torch/csrc/decode_fused.cu",
        replaces="aigw_tpu/ops/pallas/decode_fused.py:268",
        launches=launches["fused_paged_decode"], max_abs_err=err,
        ms=cuda_ms(k2), plain_ms=cuda_ms(k2_plain, iters=5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))
    log(f"K2 ok: max err {err:.3g}, pools equal, {rows[-1]['ms']:.4f} ms "
        f"(bound {b_ms:.4f} ms, plain {rows[-1]['plain_ms']:.3f} ms)")

    # K1: a packed burst with one offset start, padded to a 256 multiple
    seq = [(700, 0), (300, 0), (1, 0), (129, 77), (250, 0)]
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

    def k1():
        return paged_attention.ragged_prefill_attention(
            q1, k_pool, v_pool, pt1, cu_t, st_t, page_size=PS)

    def k1_plain():
        return paged_attention.ragged_prefill_attention_plain(
            q1, k_pool, v_pool, pt1, cu_t, st_t, page_size=PS)

    got = k1()
    err = (got.float() - k1_plain().float()).abs().max().item()
    if not err <= ATTN_TOL:
        raise AssertionError(f"K1 max error {err} > {ATTN_TOL}")
    if got[total:].abs().max().item() != 0.0:
        raise AssertionError("K1 tail rows are not zero")
    keys = sum(s + n for n, s in seq)  # pool rows each sequence reads
    pairs = sum(sum(s + i + 1 for i in range(n)) for n, s in seq)
    nbytes = 2 * (total * H * D + 2 * keys * Hkv * D + T * H * D)
    b_ms, b_by = bound(nbytes, 4 * pairs * H * D)
    rows.insert(0, dict(
        name="ragged_prefill_attention", route="cuda",
        source="aigw_tpu_torch/csrc/paged_attention.cu",
        replaces="aigw_tpu/ops/pallas/paged_attention.py:419",
        launches=launches["ragged_prefill_attention"], max_abs_err=err,
        ms=cuda_ms(k1, iters=10), plain_ms=cuda_ms(k1_plain, iters=3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))
    log(f"K1 ok: max err {err:.3g}, {rows[0]['ms']:.4f} ms "
        f"(bound {b_ms:.4f} ms, plain {rows[0]['plain_ms']:.3f} ms)")
    return rows


def model_check(torch, params, cfg, dev: str = "cuda") -> dict:
    """One full-width prefill + 8 decode steps, kernels vs plain versions
    (teacher-forced on the kernel path's greedy tokens)."""
    from aigw_tpu_torch.models import llama

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
    dtype = next(iter(params.values())).dtype
    kv_k = torch.zeros(shape, dtype=dtype, device=dev)
    kv_p = torch.zeros(shape, dtype=dtype, device=dev)
    lk, kv_k = llama.prefill_ragged(params, cfg, tokens, row_seq, positions,
                                    last, kv_k, pt, PS)
    lp, kv_p = llama.prefill_ragged(params, cfg, tokens, row_seq, positions,
                                    last, kv_p, pt, PS, plain=True)
    errs, gaps, mism = [], [], 0

    def compare(a, b):
        nonlocal mism
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError("non-finite logits")
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

    compare(lk, lp)
    tok = lk.argmax(-1).to(torch.int32)
    pos = torch.tensor(lens, dtype=torch.int32, device=dev)
    active = torch.ones((B,), dtype=torch.bool, device=dev)
    for _ in range(8):
        dk, kv_k = llama.decode_step(params, cfg, tok, pos, kv_k, pt, PS,
                                     active)
        dp, kv_p = llama.decode_step(params, cfg, tok, pos, kv_p, pt, PS,
                                     active, plain=True)
        compare(dk, dp)
        tok = dk.argmax(-1).to(torch.int32)
        pos = pos + 1
    scale = lp.abs().max().item()
    if max(errs) > 0.1 * scale:
        raise AssertionError(f"logits differ by {max(errs)} "
                             f"(logit scale {scale})")
    return {"max_abs_logit_err": max(errs), "logit_scale": scale,
            "greedy_mismatches": mism, "steps": 9}


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


def decode_profile(torch, params, cfg, dev: str = "cuda") -> dict:
    """Where one full-width decode step's time goes: host wall clock of a
    step (synchronized) against the device time torch.profiler sees, by
    kernel. Batch 8 at 1000 cached tokens each, fused rung."""
    from torch.profiler import ProfilerActivity, profile

    from aigw_tpu_torch.models import llama

    B, PS, P, ctx, steps = 8, 128, 16, 1000, 5
    kv = torch.zeros((cfg.n_layers, 2, (B * P + 1) * PS, cfg.n_kv_heads,
                      cfg.head_dim), dtype=torch.bfloat16, device=dev)
    pt = torch.arange(B * P, dtype=torch.int32, device=dev).reshape(B, P)
    tok = torch.zeros((B,), dtype=torch.int32, device=dev)
    pos = torch.full((B,), ctx, dtype=torch.int32, device=dev)
    act = torch.ones((B,), dtype=torch.bool, device=dev)

    def step():
        llama.decode_step(params, cfg, tok, pos, kv, pt, PS, act)

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
    by_kernel: dict[str, float] = {}
    for ev in prof.key_averages():
        us = ev.self_device_time_total
        if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[ev.key[:60]] = by_kernel.get(ev.key[:60], 0.0) + us
    device_ms = sum(by_kernel.values()) / 1e3 / steps
    if device_ms <= 0:
        raise AssertionError("the profiler saw no device time")
    top = sorted(by_kernel.items(), key=lambda item: -item[1])[:6]
    return {"batch": B, "cached_tokens": ctx, "layers": cfg.n_layers,
            "wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy": device_ms / wall_ms,
            "top_kernels_ms": {k: us / 1e3 / steps for k, us in top}}


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
        from aigw_tpu_torch.models import llama
        from aigw_tpu_torch.models.registry import ModelSpec, register_model
        from aigw_tpu_torch.ops import (
            _build,
            decode_fused,
            paged_attention,
        )
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
    cfg = EngineConfig(max_batch_size=8, max_seq_len=2048, page_size=128,
                       attention_backend="pallas-ragged",
                       decode_backend="fused")
    t = time.monotonic()
    srv = TPUServeServer("llama-3-8b-random", cfg, device="cuda", port=0)
    srv.start()
    log(f"server up in {time.monotonic() - t:.1f}s: "
        f"{sum(p.numel() for p in srv.engine.params.values()) / 1e9:.2f}B "
        f"params, decode {srv.engine.decode_attn_impl}")
    counted = (paged_attention.ragged_prefill_attention,
               decode_fused.fused_paged_decode,
               paged_attention.paged_attention_decode_v2)
    try:
        reqs = _requests(np.random.default_rng(0))
        for fn in counted:
            fn.launches = 0
        t = time.monotonic()
        results = serve_phase(srv.port, reqs)
        cold_s = time.monotonic() - t
        launches = {fn.__name__: fn.launches for fn in counted}
        log(f"served {len(reqs)} requests in {cold_s:.1f}s: "
            f"{[r['n'] for r in results]} tokens; launches {launches}")
        if launches["ragged_prefill_attention"] <= 0 \
                or launches["fused_paged_decode"] <= 0:
            raise AssertionError(f"kernels not on the served path: "
                                 f"{launches}")
        state = json.loads(_http(srv.port, "/state")[2])
        log(f"/state: decode {state['decode_attn_impl']}, prefill "
            f"{state['attention_backend_reason']}, padded_frac "
            f"{state['prefill_padded_frac']}, tokens "
            f"{state['tokens_generated']}")
        # the same burst on the warm server: the first one also pays the
        # process's first-use costs (cuBLAS handles, lazily loaded kernels)
        t = time.monotonic()
        serve_phase(srv.port, reqs)
        warm_s = time.monotonic() - t
        warm = json.loads(_http(srv.port, "/state")[2])
        print(json.dumps({"serve": {
            "requests": len(reqs),
            "new_tokens": sum(r["n"] for r in results),
            "cold_s": cold_s, "warm_s": warm_s,
            "warm_prefill_ms": warm["prefill_ms"] - state["prefill_ms"],
            "warm_decode_steps": warm["decode_steps"]
            - state["decode_steps"],
            **serve_profile(torch, srv.port, reqs, warm_s)}}), flush=True)

        # the chained rung: restart the engine with pallas_attn
        params = srv.engine.params
        srv.engine.stop()
        srv.engine = Engine(
            params, llama.LLAMA3_8B,
            EngineConfig(max_batch_size=8, max_seq_len=2048,
                         page_size=128, attention_backend="pallas-ragged",
                         pallas_attn=True),
            eos_token_ids=(srv.tokenizer.eos_id,), device="cuda")
        srv.engine.start()
        for fn in counted:
            fn.launches = 0
        serve_phase(srv.port, reqs[:2])
        k3 = paged_attention.paged_attention_decode_v2.launches
        log(f"chained rung ({srv.engine.decode_attn_impl}): K3 launches {k3}")
        if k3 <= 0:
            raise AssertionError("K3 not on the chained served path")
        launches["paged_attention_decode_v2"] = k3
    finally:
        srv.stop()

    # 4. kernels against their plain versions; the model end to end
    rows = kernel_checks(torch, launches)
    t = time.monotonic()
    mc = model_check(torch, params, llama.LLAMA3_8B)
    log(f"full-width model, kernels vs plain: {mc} "
        f"({time.monotonic() - t:.1f}s)")
    prof = decode_profile(torch, params, llama.LLAMA3_8B)
    log(f"decode step at full width: {prof['wall_ms']:.2f} ms wall, "
        f"{prof['device_ms']:.2f} ms on the device "
        f"(busy {prof['device_busy']:.2f})")
    print(json.dumps({"decode_profile": prof}), flush=True)
    del params
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
