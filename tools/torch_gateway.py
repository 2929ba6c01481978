#!/usr/bin/env python3
"""Run chip_smoke.py's ``serve_gateway`` phase alone on one NVIDIA GPU:
two port replicas at Llama-3-8B widths cut to ``GW_LAYERS`` layers on
the kernel path, the port's gateway in front of them in its own process
(``python -m aigw_tpu_torch run``), the phase's six gates, the
direct-versus-gateway TTFT p50 and burst tokens/s, and the phase's
blocks on the same replicas (the fronts, the hosted hop, the MCP turn,
and the control plane's: ``--workers``, a ``--reuse-port`` roll, a
manifest directory, autoconfig).

    python3 tools/torch_gateway.py

It builds the kernels, draws the Llama-3-8B-width weights from the
registry's seed (the phase serves their first layers), runs the phase
and prints its JSON line; any failed gate exits non-zero.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main() -> int:
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
    t = time.monotonic()
    _build.library()
    cs.log(f"kernels built in {time.monotonic() - t:.1f}s")
    register_model(ModelSpec("llama-3-8b-random", "llama", llama.LLAMA3_8B))
    srv = TPUServeServer("llama-3-8b-random", EngineConfig(**cs.TP_CFG),
                         device="cuda", port=0)
    launches: dict = {}
    try:
        print(json.dumps({"serve_gateway": cs.serve_gateway(
            torch, srv.engine.params, launches)}), flush=True)
    finally:
        srv.engine = None
    for block in ("serve_gateway", "serve_fronts", "serve_hosted",
                  "serve_mcp", "serve_control"):
        cs.log(f"launches on {block}: {launches[block]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
