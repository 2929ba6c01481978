#!/usr/bin/env python3
"""Run chip_smoke.py's ``serve_ops`` phase alone on one NVIDIA GPU: the
operations surface at Llama-3-8B widths cut to ``OPS_LAYERS`` layers
(``/metrics`` scraped through a burst, spans posted to a local OTLP
sink, metering against ``/state``, a drain mid-burst, ``/debug/profile``
around a burst, the chained rung speculating, the traced warm burst
against the untraced).

    python3 tools/torch_serve_ops.py

It builds the kernels, starts the bf16 replica with the prefix cache
off, sends ``serve``'s burst once, runs the phase and prints its JSON line; any failed gate exits non-zero. About two
minutes on an H100, against chip_smoke.py's nine.
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
        out = cs.serve_ops(torch, srv, srv.engine.params, reqs, {})
    finally:
        srv.stop()
    print(json.dumps({"serve_ops": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
