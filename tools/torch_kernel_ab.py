#!/usr/bin/env python3
"""Time two builds of the port's K6 and K2/K7 kernels on one GPU, in
turns (old, new, new, old).

    mkdir -p build/ab_old
    for f in qmatmul.cu decode_fused.cu attn_common.cuh; do
        git show <commit>:aigw_tpu_torch/csrc/$f > build/ab_old/$f
    done
    python3 tools/torch_kernel_ab.py --old build/ab_old

The old sources are compiled beside the current library with their
namespaces and C entry points renamed by the preprocessor, and called
through the argument lists they had (K6: ``aigw_w8a16_matmul`` with one
scratch pointer and a second reduction launch; K2/K7:
``aigw_fused_decode`` on a (B, Hkv) grid). Measured for each build:

- K6 at the five weight shapes of a Llama-3-8B decode step (M = 8): the
  median of single launches after a 64 MB L2 flush (``ms``), and
  back-to-back launches over copies of the inputs above 100 MB
  (``ms_rotated``);
- K2 (bf16 pool), K7-int8 and K7-int4 at batch 8 with 1000 cached
  tokens per slot (Llama-3-8B heads, 128-token pages), the same two ways;
- in place: one full-width decode step (W8A16 weights over an int8 pool
  and over an int4 pool, and bf16 over a bf16 pool) under
  ``torch.profiler``, with the
  wrappers pointed at each build: the device time of every K6 and
  fused-decode launch of the step, summed.

Each line of output is a JSON object; the last is ``{"ab": ...}``. It
needs one CUDA GPU and ``nvcc``; every number is in milliseconds.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# the old build's names: its namespaces and entry points, renamed
RENAMES = {"aigw": "aigw_old", "aigw_q": "aigw_old_q",
           "aigw_w8a16_matmul": "aigw_old_w8a16_matmul",
           "aigw_fused_decode": "aigw_old_fused_decode"}
_P, _I = ctypes.c_void_p, ctypes.c_int
OLD_SIGNATURES = {"aigw_old_w8a16_matmul": [_P] * 5 + [_I] * 6 + [_P],
                  "aigw_old_fused_decode": [_P] * 13 + [_I] * 9 + [_P]}
QMM_STEP = [((4096, 4096), 64), ((4096, 1024), 64), ((4096, 14336), 64),
            ((14336, 4096), 32), ((4096, 128256), 1)]


def build_old(src: Path) -> ctypes.CDLL:
    """Compile the old qmatmul.cu and decode_fused.cu (with the
    attn_common.cuh beside them) into one renamed library."""
    from aigw_tpu_torch.ops import _build

    nvcc = _build._nvcc()
    defs = [f"-D{a}={b}" for a, b in RENAMES.items()]
    out_dir = ROOT / "build" / "ab_old_lib"
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = []
        procs = []
        for name in ("qmatmul.cu", "decode_fused.cu"):
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
    for name, argtypes in OLD_SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


def old_wrappers(lib):
    """The PR-era wrappers of the old entry points: same signatures as
    today's ``w8a16_matmul`` and ``fused_paged_decode``."""
    import torch

    from aigw_tpu_torch.ops import _build, decode_fused

    def call(name, *args):
        rc = getattr(lib, name)(*args,
                                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{name} failed with {rc}")

    def w8a16(x, q, scale):
        M, K = x.shape
        N = q.shape[1]
        # the old split: 128-row steps, about 528 blocks
        steps = K // 128
        want = max(1, -(-528 // (N // 128)))
        per = -(-steps // min(steps, want))
        splits = -(-steps // per)
        out = torch.empty((M, N), dtype=x.dtype, device=x.device)
        part = (torch.empty((splits, M, N), dtype=torch.float32,
                            device=x.device) if splits > 1 else out)
        call("aigw_old_w8a16_matmul", x.data_ptr(), q.data_ptr(),
             scale.data_ptr(), part.data_ptr(), out.data_ptr(), M, K, N,
             splits, per * 128, _build.dtype_code(x, "x"))
        return out

    def fused(q, k_new, v_new, k_rows, v_rows, page_table, positions,
              active, k_scale=None, v_scale=None, *, rope_theta, page_size,
              tables=None):
        B, H, D = q.shape
        n_slots, Hkv, _ = k_rows.shape
        cos, sin = tables or decode_fused.rope_tables(positions, D,
                                                      rope_theta)
        pos32 = positions.to(torch.int32).contiguous()
        act32 = active.to(torch.int32).contiguous()
        out = torch.empty_like(q)
        quant = k_scale is not None
        call("aigw_old_fused_decode", q.data_ptr(), k_new.data_ptr(),
             v_new.data_ptr(), cos.data_ptr(), sin.data_ptr(),
             k_rows.data_ptr(), v_rows.data_ptr(),
             k_scale.data_ptr() if quant else None,
             v_scale.data_ptr() if quant else None, page_table.data_ptr(),
             pos32.data_ptr(), act32.data_ptr(), out.data_ptr(), B,
             page_table.shape[1], H, Hkv, D, page_size, n_slots,
             _build.dtype_code(q, "q"),
             _build.dtype_code(k_rows, "k_rows", tuple(_build.DTYPE_CODE)))
        res = (out, k_rows, v_rows)
        return res + (k_scale, v_scale) if quant else res

    return w8a16, fused


def in_turns(fns: dict, measure) -> dict:
    """measure(fn) for old, new, new, old; {build: [first, second]}."""
    got = {"old": [], "new": []}
    for build in ("old", "new", "new", "old"):
        got[build].append(measure(fns[build]))
    return got


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True, type=Path,
                    help="directory holding the old qmatmul.cu, "
                         "decode_fused.cu and attn_common.cuh")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ab: needs a CUDA GPU", flush=True)
        return 2
    import chip_smoke as cs
    from aigw_tpu_torch.models import kvq, llama, quant
    from aigw_tpu_torch.ops import _build, decode_fused, qmatmul

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {cs.nvidia_smi_line()}", flush=True)
    _build.library()
    old_mm, old_fused = old_wrappers(build_old(args.old.resolve()))
    new_mm, new_fused = qmatmul.w8a16_matmul, decode_fused.fused_paged_decode
    dev = "cuda"
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    result = {"qmatmul": [], "fused": [], "in_place": {}}

    # K6 alone at the decode step's shapes
    for (K, N), per_step in QMM_STEP:
        nbytes = K * N + 4 * N + 2 * 8 * K
        R = cs.copies_for(nbytes)
        qs = [torch.randint(-127, 128, (K, N), generator=g, device=dev,
                            dtype=torch.int8) for _ in range(R)]
        sc = [torch.rand((1, N), generator=g, device=dev) * 0.02
              for _ in range(R)]
        x = torch.randn((8, K), generator=g, device=dev).to(torch.bfloat16)
        a, b = old_mm(x, qs[0], sc[0]).float(), new_mm(x, qs[0], sc[0]).float()
        torch.testing.assert_close(b, a, rtol=2.0 ** -6,
                                   atol=1e-4 * a.abs().max().item())
        fns = {"old": old_mm, "new": new_mm}
        row = {"K": K, "N": N, "per_step": per_step, "copies": R,
               "ms": in_turns(fns, lambda f: cs.cuda_ms(
                   lambda: f(x, qs[0], sc[0]))),
               "ms_rotated": in_turns(fns, lambda f: cs.rotated_ms(
                   lambda i: f(x, qs[i], sc[i]), R))}
        result["qmatmul"].append(row)
        print(json.dumps({"qmatmul_ab": row}), flush=True)
        del qs, sc

    # K2 / K7 alone at batch 8, 1000 cached tokens
    B, H, Hkv, D, PS, P, ctx = 8, 32, 8, 128, 128, 16, 1000
    n_slots = (B * P + 1) * PS
    pt = torch.arange(B * P, dtype=torch.int32, device=dev).reshape(B, P)
    positions = torch.full((B,), ctx, dtype=torch.int32, device=dev)
    active = torch.ones((B,), dtype=torch.bool, device=dev)
    tables = decode_fused.rope_tables(positions, D, 500000.0)

    def r(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    q, kn, vn = r(B, H, D), r(B, Hkv, D), r(B, Hkv, D)
    for rung in ("bf16", "int8", "int4"):
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

        def launch(f, i):
            pl = pools[i]
            scales = pl[2:] if len(pl) == 4 else ()
            return f(q, kn, vn, pl[0], pl[1], pt, positions, active,
                     *scales, rope_theta=500000.0, page_size=PS,
                     tables=tables)

        fns = {"old": old_fused, "new": new_fused}
        row = {"rung": rung, "batch": B, "cached_tokens": ctx, "copies": R,
               "ms": in_turns(fns, lambda f: cs.cuda_ms(
                   lambda: launch(f, 0))),
               "ms_rotated": in_turns(fns, lambda f: cs.rotated_ms(
                   lambda i: launch(f, i), R))}
        result["fused"].append(row)
        print(json.dumps({"fused_ab": row}), flush=True)
        del pools

    # in place: full-width decode steps with the wrappers on each build
    params = llama.init_params(0, llama.LLAMA3_8B, device=dev)
    qparams = quant.quantize_params(params, consume=False, mode="int8")
    for name, p_, kv_dtype in (("w8a16_kv_int8", qparams, "int8"),
                               ("w8a16_kv_int4", qparams, "int4"),
                               ("bf16", params, "bfloat16")):
        def profile(build, p_=p_, kv_dtype=kv_dtype):
            mm, fused = (old_mm, old_fused) if build == "old" else \
                (new_mm, new_fused)
            qmatmul.w8a16_matmul, decode_fused.fused_paged_decode = mm, fused
            try:
                prof = cs.decode_profile(torch, p_, llama.LLAMA3_8B,
                                         kv_dtype=kv_dtype)
            finally:
                qmatmul.w8a16_matmul = new_mm
                decode_fused.fused_paged_decode = new_fused
            return {"device_ms": prof["device_ms"],
                    **prof["port_kernels_ms"]}

        turns = in_turns({"old": "old", "new": "new"}, profile)
        result["in_place"][name] = turns
        print(json.dumps({"in_place_ab": {name: turns}}), flush=True)
    print(json.dumps({"ab": result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
