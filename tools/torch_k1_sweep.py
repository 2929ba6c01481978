#!/usr/bin/env python3
"""Where K1's time goes: the bf16 ragged prefill kernel with parts of
its work taken out, timed in turns on one GPU.

    python3 tools/torch_k1_sweep.py

Each variant is ``csrc/paged_attention.cu`` with one part of the
tensor-core kernel's per-stage work replaced by a cheap stand-in that
keeps the rest alive (the text edits are listed in ``VARIANTS``; an edit
that no longer matches the source fails the run). Each is compiled with
its namespace and entry points renamed and timed back to back over input
copies above 100 MB (``chip_smoke.rotated_ms``), twice, in the order of
``VARIANTS``, at chip_smoke's case (5 sequences, 1380 rows, one resumed
at 77) and at the served burst's prompts (8 sequences, 2816 rows),
Llama-3-8B heads, 128-token pages:

- ``full``: the kernel as it is;
- ``no_lo``: P v without the lo term of P (one bf16 term);
- ``no_s_mma``: no S = q k^T products (K still read by ldmatrix);
- ``no_pv``: no P v (no V ldmatrix, no products; P still computed);
- ``loads_only``: no compute at all: the tile search, the q tile, the
  cp.async ring with its barriers, and the output stores.

Only ``full`` computes K1's function (its error against the plain
version is printed). One JSON line per case, then ``{"k1_sweep": ...}``;
every time is in milliseconds.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
CSRC = ROOT / "aigw_tpu_torch" / "csrc"

_PV = """    for (int kg = 0; kg < KS / 16; ++kg) {
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vf[4];  // B of columns 16 dp + [0, 8), + [8, 16)
        const int rr = kb0 + 16 * kg + vr;
        ldsm_x4_t(vf, vs + rr * RB + swz(rr, 2 * dp + qc, NC) * 16);
        mma_bf16(acc[2 * dp], ph[kg], vf[0], vf[1]);
        mma_bf16(acc[2 * dp], pl[kg], vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], ph[kg], vf[2], vf[3]);
        mma_bf16(acc[2 * dp + 1], pl[kg], vf[2], vf[3]);
      }
    }"""
#: variant -> [(text of paged_attention.cu, its replacement)]
VARIANTS = {
    "full": [],
    "no_lo": [("""        mma_bf16(acc[2 * dp], pl[kg], vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], ph[kg], vf[2], vf[3]);
        mma_bf16(acc[2 * dp + 1], pl[kg], vf[2], vf[3]);""",
               """        mma_bf16(acc[2 * dp + 1], ph[kg], vf[2], vf[3]);""")],
    "no_s_mma": [("""        mma_bf16(sc[2 * nk], qf, kf[0], kf[1]);
        mma_bf16(sc[2 * nk + 1], qf, kf[2], kf[3]);""",
                  """        sc[2 * nk][0] += __uint_as_float(qf[0] ^ kf[0] ^ kf[3]);""")],
    "no_pv": [(_PV, """    for (int kg = 0; kg < KS / 16; ++kg)
      acc[kg][0] += __uint_as_float(ph[kg][0] ^ pl[kg][3]);""")],
    "loads_only": [("""      [&](int c, int slot) {
        if (!busy) return;""", """      [&](int c, int slot) {
        if (!busy || c >= 0) return;""")],
}


def build(name: str, edits, out: Path) -> tuple[subprocess.Popen, Path]:
    """Start compiling one variant into ``out/name``; returns the nvcc
    process and the library it writes."""
    from aigw_tpu_torch.ops import _build

    src = (CSRC / "paged_attention.cu").read_text()
    for a, b in edits:
        if a not in src:
            raise RuntimeError(f"variant {name}: its edit no longer matches "
                               f"csrc/paged_attention.cu")
        src = src.replace(a, b)
    d = out / name
    d.mkdir(parents=True, exist_ok=True)
    for h in ("attn_common.cuh", "attn_staged.cuh"):
        (d / h).write_text((CSRC / h).read_text())
    (d / "paged_attention.cu").write_text(src)
    renames = [f"-Daigw=aigw_{name}"] + [
        f"-D{e}={e.replace('aigw_', f'aigw_{name}_')}"
        for e in ("aigw_ragged_prefill", "aigw_paged_decode",
                  "aigw_paged_verify")]
    lib = d / "lib.so"
    return subprocess.Popen(
        [_build._nvcc(), *_build.COMPILE_FLAGS, *renames, "-shared", "-o",
         str(lib), str(d / "paged_attention.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_k1_sweep: needs a CUDA GPU", flush=True)
        return 2
    import chip_smoke as cs
    from aigw_tpu_torch.ops import _build, paged_attention

    print(f"card: {cs.nvidia_smi_line()}", flush=True)
    out = ROOT / "build" / "k1_sweep"
    procs = {name: build(name, edits, out)
             for name, edits in VARIANTS.items()}
    fns = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        fn = getattr(ctypes.CDLL(str(lib)), f"aigw_{name}_ragged_prefill")
        fn.argtypes = _build.SIGNATURES["aigw_ragged_prefill"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    dev = "cuda"
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    H, Hkv, D, PS = 32, 8, 128, 128
    served = [(n, 0) for n in cs.served_prompt_lens(
        cs._requests(np.random.default_rng(0)))]
    result = {}
    for case, seq in (("k1_case", cs.K1_CASE), ("served_burst", served)):
        total = sum(n for n, _ in seq)
        T = -(-total // 256) * 256
        B = len(seq)
        P = max(-(-(n + s) // PS) for n, s in seq)
        cu = torch.tensor([0] + [sum(n for n, _ in seq[:i + 1])
                                 for i in range(B)], dtype=torch.int32,
                          device=dev)
        st = torch.tensor([s for _, s in seq], dtype=torch.int32, device=dev)
        pt = torch.randperm(B * P, generator=g, device=dev).reshape(
            B, P).to(torch.int32)
        n_slots = (B * P + 1) * PS
        nbytes = 2 * (2 * total * H * D + 2 * sum(n + s for n, s in seq)
                      * Hkv * D)
        R = cs.copies_for(nbytes)
        ins = [tuple(torch.randn(shape, generator=g, device=dev).to(
            torch.bfloat16) for shape in ((T, H, D), (n_slots, Hkv, D),
                                          (n_slots, Hkv, D)))
               for _ in range(R)]

        def call(fn, i):
            q, k, v = ins[i]
            o = torch.empty_like(q)
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pt.data_ptr(),
                    cu.data_ptr(), st.data_ptr(), o.data_ptr(), T, B, P, H,
                    Hkv, D, PS, 1, 1, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed with {rc}")
            return o

        want = paged_attention.ragged_prefill_attention_plain(
            *ins[0], pt, cu, st, page_size=PS)[:total].float()
        err = (call(fns["full"], 0)[:total].float() - want).abs().max().item()
        times: dict[str, list[float]] = {name: [] for name in fns}
        for _ in range(2):
            for name, fn in fns.items():
                times[name].append(cs.rotated_ms(
                    lambda i, fn=fn: call(fn, i), R))
        result[case] = {"rows": total, "copies": R,
                        "max_abs_err_full": err, "ms_rotated": times}
        print(json.dumps({"k1_sweep_case": {case: result[case]}}),
              flush=True)
        del ins
    print(json.dumps({"k1_sweep": result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
