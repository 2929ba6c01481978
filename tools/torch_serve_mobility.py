#!/usr/bin/env python3
"""Run chip_smoke.py's ``serve_mobility`` phase alone on one NVIDIA GPU:
KV mobility and the batch tier at Llama-3-8B widths (four streams cut on
replica A and resumed on replica B through ``/migrate/*`` over bf16 and
int8 pools, a fleet fetch over ``/kv/pages``, spill and revive through
the host tier, a ``/v1/batches`` job preempted by an interactive burst).

    python3 tools/torch_serve_mobility.py

It builds the kernels, starts the bf16 replica, serves ``serve``'s burst
twice (the second warm, its TTFT percentiles the phase's yardstick),
runs the phase and prints its JSON line; any failed gate exits non-zero.
A few minutes on an H100, against chip_smoke.py's ten.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this needs an NVIDIA "
                "GPU", 2)
    from aigw_tpu_torch.models import llama
    from aigw_tpu_torch.models.registry import ModelSpec, register_model
    from aigw_tpu_torch.obs.metrics import EnginePhases
    from aigw_tpu_torch.ops import _build
    from aigw_tpu_torch.tpuserve.engine import EngineConfig
    from aigw_tpu_torch.tpuserve.server import TPUServeServer

    print(f"card: {cs.nvidia_smi_line()}", flush=True)
    _build.library()
    register_model(ModelSpec("llama-3-8b-random", "llama", llama.LLAMA3_8B))
    srv = TPUServeServer("llama-3-8b-random", EngineConfig(
        max_batch_size=8, max_seq_len=2048, page_size=128,
        attention_backend="pallas-ragged", decode_backend="fused",
        enable_prefix_cache=False), device="cuda", port=0)
    srv.start()
    try:
        reqs = cs._requests(np.random.default_rng(0))
        cs.serve_phase(srv.port, reqs)
        srv.engine.phases = EnginePhases()
        cs.serve_phase(srv.port, reqs)
        pp = cs._state(srv.port)["phase_percentiles"]
        prefix_reqs = cs._prefix_requests(np.random.default_rng(7))
        out = cs.serve_mobility(torch, srv, srv.engine.params, reqs,
                                prefix_reqs[0][0][2], {}, pp)
    finally:
        srv.stop()
    print(json.dumps({"serve_mobility": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
