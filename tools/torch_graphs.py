#!/usr/bin/env python3
"""Run chip_smoke.py's phases of the captured programs alone on one
NVIDIA GPU, at Llama-3-8B widths, and print their JSON lines:

- ``serve``: the burst on the kernel path (bf16, K1 and K2, the prefix
  cache off), cold and warm, through the engine's captured programs,
  with ``/state``'s ``xla_compiles`` and ``xla_compile_ms`` after each;
- ``serve_graphs``: chip_smoke's replica warmed at
  ``warm_decode_buckets=3, warm_prefill_buckets=2``;
- ``graphs``: every program family's replay against its eager body in
  bf16 and in W8A16 over int8 pages, and the fused, chained, W8A16 +
  int8, verify and gather steps and two prefills, eager and captured,
  wall against device ms;
- ``capture_mode`` (last): why ``chip_smoke.rotated_ms`` captures in
  ``relaxed`` mode. A kernel's very first launch in a process (a fresh
  dynamic shared memory size: the wrapper's one ``cudaFuncSetAttribute``
  call) captured under ``global`` and under ``thread_local`` mode with
  no eager launch before it, then a second launch under ``global``; the
  engine's programs run their body eagerly before every capture.

    python3 tools/torch_graphs.py

It needs CUDA; any failed gate exits non-zero.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def capture_mode(torch) -> dict:
    """K2's float32 kernel captured with nothing launched before it: a
    first launch of its G 2 instantiation under ``global`` mode, a first
    launch of its G 8 one under ``thread_local``, then the G 2 one again
    under ``global`` (its shared memory size now set); each outcome."""
    from aigw_tpu_torch.ops import decode_fused

    dev = torch.device("cuda")
    B, D, ps, P = 4, 64, 16, 4
    out = {}
    for what, mode, H, Hkv in (("first_launch_global", "global", 4, 2),
                               ("first_launch_thread_local", "thread_local",
                                8, 1),
                               ("second_launch_global", "global", 4, 2)):
        g = torch.Generator(device=dev).manual_seed(0)
        n = (B * P + 1) * ps

        def r(*shape):
            return torch.randn(shape, generator=g, device=dev)

        kp, vp, q, kn = r(n, Hkv, D), r(n, Hkv, D), r(B, H, D), r(B, Hkv, D)
        pt = torch.arange(B * P, dtype=torch.int32, device=dev).reshape(B, P)
        pos = torch.tensor([3, 17, 30, 60], dtype=torch.int32, device=dev)
        act = torch.ones((B,), dtype=torch.bool, device=dev)
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        try:
            with torch.cuda.stream(side):
                graph.capture_begin(capture_error_mode=mode)
                try:
                    decode_fused.fused_paged_decode(
                        q, kn, kn, kp, vp, pt, pos, act, rope_theta=1e4,
                        page_size=ps)
                finally:
                    graph.capture_end()
            graph.replay()
            torch.cuda.synchronize()
            out[what] = "captured"
        except RuntimeError as e:
            out[what] = f"{type(e).__name__}: {str(e)[:200]}"
    return out


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this needs an NVIDIA "
                "GPU", 2)
    from aigw_tpu_torch.models import llama, quant
    from aigw_tpu_torch.models.registry import ModelSpec, register_model
    from aigw_tpu_torch.obs.metrics import EnginePhases
    from aigw_tpu_torch.ops import _build
    from aigw_tpu_torch.tpuserve.engine import EngineConfig
    from aigw_tpu_torch.tpuserve.server import TPUServeServer

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {cs.nvidia_smi_line()}", flush=True)
    _build.library()
    register_model(ModelSpec("llama-3-8b-random", "llama", llama.LLAMA3_8B))
    srv = TPUServeServer("llama-3-8b-random", EngineConfig(
        max_batch_size=8, max_seq_len=2048, page_size=128,
        attention_backend="pallas-ragged", decode_backend="fused",
        enable_prefix_cache=False), device="cuda", port=0)
    srv.start()
    reqs = cs._requests(np.random.default_rng(0))
    launches: dict = {}
    params = srv.engine.params
    try:
        serve = {"warmup_ms": srv.engine.stats.warmup_ms,
                 "warm_programs": srv.engine.stats.warm_programs}
        for what in ("cold", "warm", "warm2"):
            srv.engine.phases = EnginePhases()
            t = time.monotonic()
            cs.serve_phase(srv.port, reqs)
            st = json.loads(cs._http(srv.port, "/state")[2])
            serve[what] = {
                "wall_s": time.monotonic() - t,
                "xla_compiles": st["xla_compiles"],
                "xla_compile_ms": st["xla_compile_ms"],
                "prefill_p50_ms": st["phase_percentiles"]["prefill"]["p50"],
                "ttft_p50_ms": st["phase_percentiles"]["ttft"]["p50"]}
        print(json.dumps({"serve": serve}), flush=True)
        print(json.dumps({"serve_graphs": cs.serve_graphs(
            torch, srv, params, reqs, launches)}), flush=True)
    finally:
        srv.stop()
    srv.engine = None
    qparams = quant.quantize_params(params, consume=False, mode="int8")
    graphs = {"replay": cs.graphs_replay_check(torch, params, qparams,
                                               reqs)}
    steps = {}
    for name, p, kw in (("fused", params, {}),
                        ("chained", params, dict(attn_impl="chained")),
                        ("w8a16_kv_int8", qparams, dict(kv_dtype="int8")),
                        ("verify", params, dict(verify_width=5)),
                        ("gather", params, dict(attn_impl=""))):
        steps[name] = {}
        for how in ("eager", "captured"):
            d = cs.decode_profile(torch, p, llama.LLAMA3_8B,
                                  captured=how == "captured", **kw)
            steps[name][how] = {k: d[k] for k in (
                "wall_ms", "device_ms", "device_busy", "kernel_launches")}
    graphs["steps"] = steps
    graphs["prefill"] = {}
    for name, seqs in (("served_burst",
                        [(n, 0) for n in cs.served_prompt_lens(reqs)]),
                       ("resume_150_at_1024", [(150, 1024)])):
        graphs["prefill"][name] = {
            how: {k: d[k] for k in ("wall_ms", "device_ms")}
            for how, d in (
                (how, cs.prefill_profile(torch, params, llama.LLAMA3_8B,
                                         seqs, captured=how == "captured"))
                for how in ("eager", "captured"))}
    print(json.dumps({"graphs": graphs}), flush=True)
    # last: a refused capture may leave the allocator's capture state
    print(json.dumps({"capture_mode": capture_mode(torch)}), flush=True)
    print(f"card: {cs.nvidia_smi_line()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
