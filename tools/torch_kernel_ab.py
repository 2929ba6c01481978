#!/usr/bin/env python3
"""Time two builds of the port's attention and W8A16 kernels on one GPU,
in turns (old, new, new, old).

    mkdir -p build/ab_old
    for f in qmatmul.cu decode_fused.cu paged_attention.cu attn_common.cuh; do
        git show <commit>:aigw_tpu_torch/csrc/$f > build/ab_old/$f
    done
    python3 tools/torch_kernel_ab.py --old build/ab_old

The old sources are compiled beside the current library with their
namespaces and C entry points renamed by the preprocessor. K6 and K2/K7
are called through today's wrappers, their launches routed to the old
library (the old commit must share today's C interface for them); K3
and K5 through the interface of the single-query kernels the
multi-query body replaced (``aigw_paged_decode`` on a (B, Hkv) grid,
``aigw_paged_verify`` on (B, Hkv, S), no scratch). Measured for each
build:

- K6 at the five weight shapes of a Llama-3-8B decode step (M = 8): the
  median of single launches after a 64 MB L2 flush (``ms``), and
  back-to-back launches over copies of the inputs above 100 MB
  (``ms_rotated``);
- K2 (bf16 pool), K7-int8 and K7-int4 at batch 8 with 1000 cached
  tokens per slot (Llama-3-8B heads, 128-token pages), the same two ways;
- K3 (S 1) and K5 (S 1 and 5) at the same batch and cache, bf16, the
  same two ways;
- in place: one full-width decode step (W8A16 weights over an int8 pool
  and over an int4 pool, bf16 over a bf16 pool on the fused rung and on
  the chained rung) and one verify step of width 5, under
  ``torch.profiler``, with the wrappers pointed at each build: the device
  time of every K6, fused-decode, K3 and K5 launch of the step, summed.

Each line of output is a JSON object; the last is ``{"ab": ...}``. It
needs one CUDA GPU and ``nvcc``; every number is in milliseconds.
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
#: the single-query K3 and K5 kernels' C interfaces
OLD_MQ_SIGNATURES = {"aigw_old_paged_decode": [_P] * 6 + [_I] * 8 + [_P],
                     "aigw_old_paged_verify": [_P] * 6 + [_I] * 9 + [_P]}
QMM_STEP = [((4096, 4096), 64), ((4096, 1024), 64), ((4096, 14336), 64),
            ((14336, 4096), 32), ((4096, 128256), 1)]
SOURCES = ("qmatmul.cu", "decode_fused.cu", "paged_attention.cu")


def build_old(src: Path) -> ctypes.CDLL:
    """Compile the old qmatmul.cu, decode_fused.cu and paged_attention.cu
    (with the attn_common.cuh beside them) into one renamed library."""
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
    for name in ("aigw_w8a16_matmul", "aigw_fused_decode"):
        fn = getattr(lib, RENAMES[name])
        fn.argtypes = _build.SIGNATURES[name]
        fn.restype = ctypes.c_int
    for name, argtypes in OLD_MQ_SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


def _call(lib, name, *args):
    import torch

    rc = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"{name} failed with {rc}")


@contextlib.contextmanager
def on_build(lib, build: str):
    """Inside, the port's K6, K2/K7, K3 and K5 wrappers run ``build``'s
    kernels: "new" is today's library; "old" routes K6's and K2/K7's
    launches to ``lib`` and replaces K3's and K5's wrappers with the
    single-query kernels' (``old_mq_wrappers``)."""
    from aigw_tpu_torch.ops import _build, paged_attention

    if build == "new":
        yield
        return
    launch = _build.launch
    k3, k5 = paged_attention.paged_attention_decode_v2, \
        paged_attention.paged_attention_verify
    _build.launch = lambda name, *args: _call(lib, RENAMES[name], *args)
    (paged_attention.paged_attention_decode_v2,
     paged_attention.paged_attention_verify) = old_mq_wrappers(lib)
    try:
        yield
    finally:
        _build.launch = launch
        paged_attention.paged_attention_decode_v2 = k3
        paged_attention.paged_attention_verify = k5


def old_mq_wrappers(lib):
    """The single-query K3 and K5 wrappers over the old entry points: same
    signatures as today's."""
    import torch

    from aigw_tpu_torch.ops import _build

    def k3(q, k_pool, v_pool, page_table, lengths, *, page_size):
        B, H, D = q.shape
        out = torch.empty_like(q)
        _call(lib, "aigw_old_paged_decode", q.data_ptr(), k_pool.data_ptr(),
              v_pool.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
              out.data_ptr(), B, page_table.shape[1], H, k_pool.shape[1], D,
              page_size, _build.dtype_code(q, "q"),
              _build.dtype_code(k_pool, "k_pool"))
        return out

    def k5(q, k_pool, v_pool, page_table, positions, *, page_size):
        B, S, H, D = q.shape
        out = torch.empty_like(q)
        _call(lib, "aigw_old_paged_verify", q.data_ptr(), k_pool.data_ptr(),
              v_pool.data_ptr(), page_table.data_ptr(), positions.data_ptr(),
              out.data_ptr(), B, S, page_table.shape[1], H, k_pool.shape[1],
              D, page_size, _build.dtype_code(q, "q"),
              _build.dtype_code(k_pool, "k_pool"))
        return out

    return k3, k5


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True, type=Path,
                    help="directory holding the old qmatmul.cu, "
                         "decode_fused.cu, paged_attention.cu and "
                         "attn_common.cuh")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ab: needs a CUDA GPU", flush=True)
        return 2
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
    result = {"qmatmul": [], "fused": [], "mq": [], "in_place": {}}

    # K6 alone at the decode step's shapes
    for (K, N), per_step in QMM_STEP:
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

        def launch(i):
            pl = pools[i]
            scales = pl[2:] if len(pl) == 4 else ()
            return decode_fused.fused_paged_decode(
                q, kn, vn, pl[0], pl[1], pt, positions, active, *scales,
                rope_theta=500000.0, page_size=PS, tables=tables)

        row = {"rung": rung, "batch": B, "cached_tokens": ctx, "copies": R,
               "ms": in_turns(lambda: cs.cuda_ms(lambda: launch(0))),
               "ms_rotated": in_turns(lambda: cs.rotated_ms(launch, R))}
        result["fused"].append(row)
        print(json.dumps({"fused_ab": row}), flush=True)
        if rung != "bf16":
            del pools
            continue
        # K3 (S 1) and K5 (S 1, 5) over the bf16 pools: each sequence's
        # window ends at its ctx + 1 keys, as the fused step's does
        for kernel, S in (("K3", 1), ("K5", 1), ("K5", 5)):
            if kernel == "K3":
                qm, xs = q, positions + 1

                def mq(i):
                    return paged_attention.paged_attention_decode_v2(
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
            result["mq"].append(row)
            print(json.dumps({"mq_ab": row}), flush=True)
        del pools

    # in place: full-width steps with the wrappers on each build
    params = llama.init_params(0, llama.LLAMA3_8B, device=dev)
    qparams = quant.quantize_params(params, consume=False, mode="int8")
    for name, p_, kw in (
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
