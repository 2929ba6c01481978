#!/usr/bin/env python3
"""Time two builds of the port's attention and W8A16 kernels on one GPU,
in turns (old, new, new, old).

    mkdir -p build/ab_old
    for f in qmatmul.cu decode_fused.cu paged_attention.cu attn_common.cuh \
             attn_staged.cuh; do
        git show <commit>:aigw_tpu_torch/csrc/$f > build/ab_old/$f
    done
    python3 tools/torch_kernel_ab.py --old build/ab_old

The old sources are compiled beside the current library with their
namespaces and C entry points renamed by the preprocessor. K6, K2/K7, K3
and K5 are called through today's wrappers, their launches routed to the
old library (the old commit must share today's C interface for them:
d9a4b67 or later); K1 and K4 through the interfaces of the kernels they
replaced (K1 over an output the wrapper zero-fills; K4 as the split walk
and its fold, ``aigw_paged_decode_split``). Measured for each build:

- K6 at the five weight shapes of a Llama-3-8B decode step (M = 8): the
  median of single launches after a 64 MB L2 flush (``ms``), and
  back-to-back launches over copies of the inputs above 100 MB
  (``ms_rotated``);
- K2 (bf16 pool), K7-int8 and K7-int4 at batch 8 with 1000 cached
  tokens per slot (Llama-3-8B heads, 128-token pages), the same two ways;
- K3 (S 1), K4 and K5 (S 1 and 5) at the same batch and cache, bf16, the
  same two ways; K4 also in place: 32 launches over the 32 layers of a
  full-width pool, as a decode step would make them, under
  ``torch.profiler``;
- K1 (bf16) at chip_smoke's case (5 sequences, 1380 rows, one resumed at
  77) and at the served burst's prompt lengths (8 sequences, 2816 rows),
  the same two ways, and in place: one full-width ``prefill_ragged`` of
  each, its 32 K1 launches summed (``chip_smoke.prefill_profile``);
- served: chip_smoke's bf16 burst (8 requests, 2816 prompt tokens) on a
  warm server at Llama-3-8B widths, K1 on each build in turns: the
  burst's wall time, its prefill time (``/state`` ``prefill_ms``), and
  the prefill and TTFT p50 and p95 of ``/state``'s
  ``phase_percentiles`` (the histograms emptied before each burst);
- in place: one full-width decode step (W8A16 weights over an int8 pool
  and over an int4 pool, bf16 over a bf16 pool on the fused rung and on
  the chained rung) and one verify step of width 5, under
  ``torch.profiler``, with the wrappers pointed at each build: the device
  time of every K6, fused-decode, K3 and K5 launch of the step, summed.

``--kernels`` picks some of these parts (``PARTS``) for a redesign of
one kernel. Each line of output is a JSON object; the last is ``{"ab":
...}``. It needs one CUDA GPU and ``nvcc``; every number is in
milliseconds.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

#: the C entry points of the old build, renamed aigw_old_*
ENTRY_POINTS = ("aigw_w8a16_matmul", "aigw_fused_decode",
                "aigw_ragged_prefill", "aigw_paged_decode",
                "aigw_paged_verify", "aigw_paged_decode_split")
# the old build's names: its namespaces and entry points, renamed
RENAMES = {"aigw": "aigw_old", "aigw_q": "aigw_old_q",
           **{n: "aigw_old_" + n[len("aigw_"):] for n in ENTRY_POINTS}}
_P, _I = ctypes.c_void_p, ctypes.c_int
#: the old K4's C interface (the split walk and its fold)
OLD_K4_SIGNATURE = [_P] * 7 + [_I] * 10 + [_P]
QMM_STEP = [((4096, 4096), 64), ((4096, 1024), 64), ((4096, 14336), 64),
            ((14336, 4096), 32), ((4096, 128256), 1)]
SOURCES = ("qmatmul.cu", "decode_fused.cu", "paged_attention.cu")
#: what --kernels selects: K6 alone, K2/K7 alone, K3/K4/K5 alone, the
#: served burst, K1 alone and in place, the decode and verify steps
PARTS = ("qmatmul", "fused", "mq", "serve", "k1", "in_place")


def build_old(src: Path) -> ctypes.CDLL:
    """Compile the old qmatmul.cu, decode_fused.cu and paged_attention.cu
    (with the headers beside them) into one renamed library."""
    from aigw_tpu_torch.ops import _build

    nvcc = _build._nvcc()
    defs = [f"-D{a}={b}" for a, b in RENAMES.items()]
    out_dir = ROOT / "build" / "ab_old_lib"
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = []
        procs = []
        for name in SOURCES:
            obj = Path(tmp) / (name + ".o")
            objs.append(str(obj))
            procs.append(subprocess.Popen(
                [nvcc, *_build.COMPILE_FLAGS, *defs, f"-I{src}", "-c", "-o",
                 str(obj), str(src / name)]))
        if any(p.wait() for p in procs):
            raise RuntimeError("nvcc failed on the old sources")
        lib_path = out_dir / "libaigw_old.so"
        subprocess.run([nvcc, *_build.ARCH_FLAGS, "-shared", "-o",
                        str(lib_path), *objs], check=True)
    lib = ctypes.CDLL(str(lib_path))
    for name in ENTRY_POINTS:
        if hasattr(lib, RENAMES[name]):  # a build after K4's move lacks
            fn = getattr(lib, RENAMES[name])  # aigw_paged_decode_split
            fn.argtypes = _build.SIGNATURES.get(name, OLD_K4_SIGNATURE)
            fn.restype = ctypes.c_int
    return lib


def _call(lib, name, *args):
    import torch

    rc = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"{name} failed with {rc}")


@contextlib.contextmanager
def on_build(lib, build: str):
    """Inside, the port's kernel wrappers run ``build``'s kernels: "new"
    is today's library; "old" routes K6's, K2/K7's, K3's and K5's
    launches to ``lib`` and replaces K1's and K4's wrappers with the old
    kernels' (``old_wrappers``; K4's only where the old build has the
    split walk)."""
    from aigw_tpu_torch.ops import _build, paged_attention

    if build == "new":
        yield
        return
    launch = _build.launch
    k1, k4 = paged_attention.ragged_prefill_attention, \
        paged_attention.paged_attention_decode
    _build.launch = lambda name, *args: _call(lib, RENAMES[name], *args)
    old_k1, old_k4 = old_wrappers(lib)
    paged_attention.ragged_prefill_attention = old_k1
    if hasattr(lib, "aigw_old_paged_decode_split"):
        paged_attention.paged_attention_decode = old_k4
    try:
        yield
    finally:
        _build.launch = launch
        paged_attention.ragged_prefill_attention = k1
        paged_attention.paged_attention_decode = k4


def old_wrappers(lib):
    """The old K1 and K4 wrappers over the old entry points, with
    today's signatures: K1 over a zero-filled output where the old
    kernel writes the sequences' rows only (every build before K4's
    move, which still has the split walk; after it, bf16 K1 writes every
    row, as today's wrapper expects), K4 as the split walk and its
    fold."""
    import torch

    from aigw_tpu_torch.ops import _build, decode_fused, paged_attention

    k1_fills = not hasattr(lib, "aigw_old_paged_decode_split")

    def k1(q, k_pool, v_pool, page_table, cu_seqlens, start_pos, *,
           page_size, q_block=128):
        T, H, D = q.shape
        out = (torch.empty_like(q)
               if k1_fills and paged_attention._tc(q, k_pool)
               else torch.zeros_like(q))
        _call(lib, "aigw_old_ragged_prefill", q.data_ptr(),
              k_pool.data_ptr(), v_pool.data_ptr(), page_table.data_ptr(),
              cu_seqlens.data_ptr(), start_pos.data_ptr(), out.data_ptr(),
              T, page_table.shape[0], page_table.shape[1], H,
              k_pool.shape[1], D, page_size, _build.dtype_code(q, "q"),
              _build.dtype_code(k_pool, "k_pool"))
        return out

    def k4(q, k_pool, v_pool, page_table, lengths, *, page_size):
        B, H, D = q.shape
        Hkv, P = k_pool.shape[1], page_table.shape[1]
        pps, n_split = decode_fused.split_pages(B, Hkv, P)
        out = torch.empty_like(q)
        part = torch.empty((n_split * B * H * (D + 2),),
                           dtype=torch.float32, device=q.device)
        _call(lib, "aigw_old_paged_decode_split", q.data_ptr(),
              k_pool.data_ptr(), v_pool.data_ptr(), page_table.data_ptr(),
              lengths.data_ptr(), out.data_ptr(), part.data_ptr(), B, P, H,
              Hkv, D, page_size, pps, n_split, _build.dtype_code(q, "q"),
              _build.dtype_code(k_pool, "k_pool"))
        return out

    return k1, k4


def k4_in_place(torch, cs, q, lens, page_size: int) -> dict:
    """K4's 32 launches of a decode step, in place: one per layer of a
    full-width bf16 pool (batch 8, the lengths ``lens``), under
    torch.profiler; the device time of every K4 kernel summed (the old
    build's split walk and fold, or K3's body)."""
    from torch.profiler import ProfilerActivity, profile

    from aigw_tpu_torch.ops import paged_attention

    B, H, D = q.shape
    L, Hkv, P = 32, 8, 16
    g = torch.Generator(device=q.device)
    g.manual_seed(3)
    pool = torch.randn((L, 2, (B * P + 1) * page_size, Hkv, D),
                       generator=g, device=q.device).to(torch.bfloat16)
    pt = torch.arange(B * P, dtype=torch.int32,
                      device=q.device).reshape(B, P)

    def step():
        for i in range(L):
            paged_attention.paged_attention_decode(
                q, pool[i, 0], pool[i, 1], pt, lens, page_size=page_size)

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step()
        torch.cuda.synchronize()
    device_ms, ours, _top = cs.device_split(
        torch, prof, 3, (("split", "paged_split"),
                         ("combine", "paged_combine"), ("mq", "mq_")))
    return {"device_ms": device_ms, "k4_ms": sum(ours.values())}


def serve_in_turns(torch, cs, in_turns) -> tuple[dict, dict]:
    """chip_smoke's bf16 burst on a warm full-width server, once per
    turn of ``in_turns``; returns (the turns, the server's weights)."""
    import time

    import numpy as np

    from aigw_tpu_torch.models import llama
    from aigw_tpu_torch.models.registry import ModelSpec, register_model
    from aigw_tpu_torch.obs.metrics import EnginePhases
    from aigw_tpu_torch.tpuserve.engine import EngineConfig
    from aigw_tpu_torch.tpuserve.server import TPUServeServer

    register_model(ModelSpec("llama-3-8b-random", "llama", llama.LLAMA3_8B))
    srv = TPUServeServer(
        "llama-3-8b-random",
        EngineConfig(max_batch_size=8, max_seq_len=2048, page_size=128,
                     attention_backend="pallas-ragged",
                     decode_backend="fused"), device="cuda", port=0)
    srv.start()
    reqs = cs._requests(np.random.default_rng(0))

    def state():
        return json.loads(cs._http(srv.port, "/state")[2])

    def burst():
        srv.engine.phases = EnginePhases()
        s0 = state()
        t = time.monotonic()
        cs.serve_phase(srv.port, reqs)
        wall = time.monotonic() - t
        s1 = state()
        pp = s1["phase_percentiles"]
        return {"wall_s": wall,
                "prefill_ms": s1["prefill_ms"] - s0["prefill_ms"],
                "prefills": s1["prefills"] - s0["prefills"],
                "prefill_p50_ms": pp["prefill"]["p50"],
                "prefill_p95_ms": pp["prefill"]["p95"],
                "ttft_p50_ms": pp["ttft"]["p50"],
                "ttft_p95_ms": pp["ttft"]["p95"]}

    try:
        cs.serve_phase(srv.port, reqs)  # the cold burst
        return in_turns(burst), srv.engine.params
    finally:
        srv.stop()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True, type=Path,
                    help="directory holding the old qmatmul.cu, "
                         "decode_fused.cu, paged_attention.cu, "
                         "attn_common.cuh and attn_staged.cuh")
    ap.add_argument("--kernels", default=",".join(PARTS),
                    help="comma-separated parts to measure, of "
                         f"{', '.join(PARTS)} (default: all)")
    args = ap.parse_args()
    want = set(args.kernels.split(","))
    if not want <= set(PARTS):
        ap.error(f"unknown parts {sorted(want - set(PARTS))}")
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ab: needs a CUDA GPU", flush=True)
        return 2
    import numpy as np

    import chip_smoke as cs
    from aigw_tpu_torch.models import kvq, llama, quant
    from aigw_tpu_torch.ops import (_build, decode_fused, paged_attention,
                                    qmatmul)

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {cs.nvidia_smi_line()}", flush=True)
    _build.library()
    lib = build_old(args.old.resolve())

    def in_turns(measure) -> dict:
        """measure() on old, new, new, old; {build: [first, second]}."""
        got = {"old": [], "new": []}
        for build in ("old", "new", "new", "old"):
            with on_build(lib, build):
                got[build].append(measure())
        return got

    dev = "cuda"
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    result = {"qmatmul": [], "fused": [], "mq": [], "k1": [],
              "in_place": {}}

    # K6 alone at the decode step's shapes
    for (K, N), per_step in QMM_STEP if "qmatmul" in want else ():
        nbytes = K * N + 4 * N + 2 * 8 * K
        R = cs.copies_for(nbytes)
        qs = [torch.randint(-127, 128, (K, N), generator=g, device=dev,
                            dtype=torch.int8) for _ in range(R)]
        sc = [torch.rand((1, N), generator=g, device=dev) * 0.02
              for _ in range(R)]
        x = torch.randn((8, K), generator=g, device=dev).to(torch.bfloat16)
        with on_build(lib, "old"):
            a = qmatmul.w8a16_matmul(x, qs[0], sc[0]).float()
        b = qmatmul.w8a16_matmul(x, qs[0], sc[0]).float()
        torch.testing.assert_close(b, a, rtol=2.0 ** -6,
                                   atol=1e-4 * a.abs().max().item())
        row = {"K": K, "N": N, "per_step": per_step, "copies": R,
               "ms": in_turns(lambda: cs.cuda_ms(
                   lambda: qmatmul.w8a16_matmul(x, qs[0], sc[0]))),
               "ms_rotated": in_turns(lambda: cs.rotated_ms(
                   lambda i: qmatmul.w8a16_matmul(x, qs[i], sc[i]), R))}
        result["qmatmul"].append(row)
        print(json.dumps({"qmatmul_ab": row}), flush=True)
        del qs, sc

    # K2 / K7, K3 and K5 alone at batch 8, 1000 cached tokens
    B, H, Hkv, D, PS, P, ctx = 8, 32, 8, 128, 128, 16, 1000
    n_slots = (B * P + 1) * PS
    pt = torch.arange(B * P, dtype=torch.int32, device=dev).reshape(B, P)
    positions = torch.full((B,), ctx, dtype=torch.int32, device=dev)
    active = torch.ones((B,), dtype=torch.bool, device=dev)
    tables = decode_fused.rope_tables(positions, D, 500000.0)

    def r(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    q, kn, vn = r(B, H, D), r(B, Hkv, D), r(B, Hkv, D)
    rungs = (("bf16", "int8", "int4") if "fused" in want
             else ("bf16",) if "mq" in want else ())
    for rung in rungs:
        row_b = 2 * D if rung == "bf16" else (D + 4 if rung == "int8"
                                              else D // 2 + 4)
        R = cs.copies_for(2 * B * (ctx + 1) * Hkv * row_b)
        pools = []
        for _ in range(R):
            kf = torch.randn((n_slots, Hkv, D), generator=g, device=dev)
            vf = torch.randn((n_slots, Hkv, D), generator=g, device=dev)
            if rung == "bf16":
                pools.append((kf.to(torch.bfloat16), vf.to(torch.bfloat16)))
            else:
                kq, ks = kvq.quantize_rows(kf, rung)
                vq, vs = kvq.quantize_rows(vf, rung)
                pools.append((kq, vq, ks, vs))
            del kf, vf

        def launch(i):
            pl = pools[i]
            scales = pl[2:] if len(pl) == 4 else ()
            return decode_fused.fused_paged_decode(
                q, kn, vn, pl[0], pl[1], pt, positions, active, *scales,
                rope_theta=500000.0, page_size=PS, tables=tables)

        if "fused" in want:
            row = {"rung": rung, "batch": B, "cached_tokens": ctx,
                   "copies": R,
                   "ms": in_turns(lambda: cs.cuda_ms(lambda: launch(0))),
                   "ms_rotated": in_turns(lambda: cs.rotated_ms(launch, R))}
            result["fused"].append(row)
            print(json.dumps({"fused_ab": row}), flush=True)
        if rung != "bf16" or "mq" not in want:
            del pools
            continue
        # K3 (S 1), K4 and K5 (S 1, 5) over the bf16 pools: each
        # sequence's window ends at its ctx + 1 keys, as the fused
        # step's does
        for kernel, S in (("K3", 1), ("K4", 1), ("K5", 1), ("K5", 5)):
            if kernel in ("K3", "K4"):
                qm, xs = q, positions + 1
                fn = (paged_attention.paged_attention_decode_v2
                      if kernel == "K3" else None)

                def mq(i, fn=fn):
                    # K4's wrapper is looked up at the call: on_build
                    # swaps it
                    return (fn or paged_attention.paged_attention_decode)(
                        qm, *pools[i][:2], pt, xs, page_size=PS)
            else:
                qm, xs = r(B, S, H, D), positions + 1 - S

                def mq(i):
                    return paged_attention.paged_attention_verify(
                        qm, *pools[i][:2], pt, xs, page_size=PS)
            with on_build(lib, "old"):
                a = mq(0).float()
            torch.testing.assert_close(mq(0).float(), a, rtol=2.0 ** -6,
                                       atol=4e-3)
            row = {"kernel": kernel, "S": S, "batch": B,
                   "cached_tokens": ctx, "copies": R,
                   "ms": in_turns(lambda: cs.cuda_ms(lambda: mq(0))),
                   "ms_rotated": in_turns(lambda: cs.rotated_ms(mq, R))}
            if kernel == "K4":
                row["in_place_32"] = in_turns(
                    lambda: k4_in_place(torch, cs, qm, xs, PS))
            result["mq"].append(row)
            print(json.dumps({"mq_ab": row}), flush=True)
        del pools

    # the served burst, K1 on each build
    params = None
    if "serve" in want:
        turns, params = serve_in_turns(torch, cs, in_turns)
        result["serve"] = turns
        print(json.dumps({"serve_ab": turns}), flush=True)
    if params is None and want & {"k1", "in_place"}:
        params = llama.init_params(0, llama.LLAMA3_8B, device=dev)

    # K1 alone and in place: chip_smoke's case and the served burst's
    # prompts, Llama-3-8B heads, bf16
    served = [(n, 0) for n in cs.served_prompt_lens(
        cs._requests(np.random.default_rng(0)))]
    for case, seq in (("k1_case", cs.K1_CASE), ("served_burst", served)
                      ) if "k1" in want else ():
        total = sum(n for n, _ in seq)
        T = -(-total // 256) * 256
        Bp = len(seq)
        P1 = max(-(-(n + s) // PS) for n, s in seq)
        cu = torch.tensor([0] + [sum(n for n, _ in seq[:i + 1])
                                 for i in range(Bp)], dtype=torch.int32,
                          device=dev)
        st = torch.tensor([s for _, s in seq], dtype=torch.int32,
                          device=dev)
        pt1 = torch.randperm(Bp * P1, generator=g, device=dev).reshape(
            Bp, P1).to(torch.int32)
        n_slots1 = (Bp * P1 + 1) * PS
        nbytes = 2 * (2 * total * H * D
                      + 2 * sum(n + s for n, s in seq) * Hkv * D)
        R = cs.copies_for(nbytes)
        ins = [(r(T, H, D), r(n_slots1, Hkv, D), r(n_slots1, Hkv, D))
               for _ in range(R)]

        def k1(i):
            return paged_attention.ragged_prefill_attention(
                *ins[i], pt1, cu, st, page_size=PS)

        with on_build(lib, "old"):
            a = k1(0)[:total].float()
        torch.testing.assert_close(k1(0)[:total].float(), a,
                                   rtol=2.0 ** -6, atol=4e-3)
        row = {"case": case, "sequences": [list(x) for x in seq],
               "rows": total, "copies": R,
               "ms": in_turns(lambda: cs.cuda_ms(lambda: k1(0), iters=10)),
               "ms_rotated": in_turns(lambda: cs.rotated_ms(k1, R)),
               "in_place_32": in_turns(lambda: cs.prefill_profile(
                   torch, params, llama.LLAMA3_8B, seq))}
        del ins
        result["k1"].append(row)
        print(json.dumps({"k1_ab": row}), flush=True)

    # in place: full-width steps with the wrappers on each build
    qparams = (quant.quantize_params(params, consume=False, mode="int8")
               if "in_place" in want else None)
    for name, p_, kw in () if qparams is None else (
            ("w8a16_kv_int8", qparams, {"kv_dtype": "int8"}),
            ("w8a16_kv_int4", qparams, {"kv_dtype": "int4"}),
            ("bf16", params, {}),
            ("bf16_chained", params, {"attn_impl": "chained"}),
            ("bf16_verify_5", params, {"verify_width": 5})):
        def profile(p_=p_, kw=kw):
            prof = cs.decode_profile(torch, p_, llama.LLAMA3_8B, **kw)
            return {"device_ms": prof["device_ms"],
                    **prof["port_kernels_ms"]}

        turns = in_turns(profile)
        result["in_place"][name] = turns
        print(json.dumps({"in_place_ab": {name: turns}}), flush=True)
    print(json.dumps({"ab": result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
