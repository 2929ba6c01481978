#!/usr/bin/env python3
"""Run chip_smoke.py's phases of the reference's default programs alone on
one NVIDIA GPU, at Llama-3-8B widths: ``serve_defaults`` (a replica built
from ``EngineConfig()`` with only the geometry set, bf16 and W8A16 over
int8 pages), ``embeddings`` (``POST /v1/embeddings`` against
``hidden_states`` on the card, K6 against its plain version at M 64),
the default programs against the kernel path at 2 layers
(``model_check``'s ``defaults``) and K6 on them against its plain
version (``defaults_w8a16``), K6 at the decode's and the bucketed
prefill's M (8, 64) and K7 against their plain versions, and one gather
decode step and the served burst's prompts on the bucketed programs
beside the fused step and the packed K1 prefill.

    python3 tools/torch_serve_defaults.py

It builds the kernels, starts the bf16 replica on the kernel path
(``pallas-ragged``, ``fused``), quantizes its weights to int8 on the
card, runs the phases and prints their JSON lines; any failed gate exits
non-zero.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this needs an NVIDIA "
                "GPU", 2)
    from aigw_tpu_torch.models import llama, quant
    from aigw_tpu_torch.models.registry import ModelSpec, register_model
    from aigw_tpu_torch.ops import _build
    from aigw_tpu_torch.tpuserve.engine import Engine, EngineConfig
    from aigw_tpu_torch.tpuserve.server import TPUServeServer

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {cs.nvidia_smi_line()}", flush=True)
    _build.library()
    register_model(ModelSpec("llama-3-8b-random", "llama", llama.LLAMA3_8B))
    kw = dict(max_batch_size=8, max_seq_len=2048, page_size=128,
              attention_backend="pallas-ragged", decode_backend="fused",
              enable_prefix_cache=False)
    srv = TPUServeServer("llama-3-8b-random", EngineConfig(**kw),
                         device="cuda", port=0)
    srv.start()

    def restart(params, model_cfg=llama.LLAMA3_8B, **engine_kw):
        srv.engine.stop()
        srv.engine = Engine(params, model_cfg,
                            EngineConfig(**{**kw, **engine_kw}),
                            eos_token_ids=(srv.tokenizer.eos_id,),
                            device="cuda")
        srv.engine.start()

    launches: dict = {}
    reqs = cs._requests(np.random.default_rng(0))
    params = srv.engine.params
    try:
        qparams = quant.quantize_params(params, consume=False, mode="int8")
        t = time.monotonic()
        print(json.dumps({"serve_defaults": cs.serve_defaults(
            torch, srv, restart, params, qparams, reqs, launches)}),
            flush=True)
        print(json.dumps({"embeddings": cs.embeddings_phase(
            torch, srv, params, qparams, launches)}), flush=True)
        cs.log(f"serve phases {time.monotonic() - t:.1f}s")
    finally:
        srv.stop()
    srv.engine = None
    print(json.dumps({"model_check": {
        "defaults_w8a16": cs.defaults_w8a16_check(torch, qparams,
                                                  llama.LLAMA3_8B)}}),
        flush=True)
    del qparams
    torch.cuda.empty_cache()
    cs.quant_kernel_checks(torch, {"w8a16_matmul": 0,
                                   "fused_paged_decode_int8": 0,
                                   "fused_paged_decode_int4": 0})
    torch.cuda.empty_cache()
    print(json.dumps({"model_check": {"defaults": cs.defaults_model_check(
        torch, params, llama.LLAMA3_8B)}}), flush=True)
    print(json.dumps({"decode_profile_gather": {
        rung or "gather": cs.decode_profile(torch, params, llama.LLAMA3_8B,
                                            attn_impl=rung)
        for rung in ("", "fused")}}), flush=True)
    lens = cs.served_prompt_lens(reqs)
    print(json.dumps({"prefill_profile": {
        "served_burst": cs.prefill_profile(torch, params, llama.LLAMA3_8B,
                                           [(n, 0) for n in lens]),
        "served_burst_bucketed": cs.prefill_profile_bucketed(
            torch, params, llama.LLAMA3_8B, lens)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
