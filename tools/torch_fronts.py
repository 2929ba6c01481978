#!/usr/bin/env python3
"""Run chip_smoke.py's ``serve_gateway`` phase, with its client fronts
and its hosted-provider hop, alone on one NVIDIA GPU: two port replicas
at Llama-3-8B widths cut to ``GW_LAYERS`` layers on the kernel path, the
port's gateway in front of them in its own process (``python -m
aigw_tpu_torch run``), the phase's gates, then ``/v1/messages``,
``/v1/responses``, ``/tokenize`` and a batch through ``/v1/files`` and
``/v1/batches`` on the same replicas and gateway, held to chat and to
the replicas served directly; then a second gateway whose
``Anthropic``-schema backend (an ``AnthropicAPIKey`` from a ``file:``
secret) is the first gateway, its chat, Responses and Messages held to
the same requests sent to the first, an emptied key answering 401;
then an agent's MCP turn through a third gateway with tracing, an
access log and the debug routes on (``_gw_mcp``): its tools over HTTP
and a bridged stdio server, authorization, and the tools' text as a
traced chat onto the replicas.

    python3 tools/torch_fronts.py

It builds the kernels, draws the Llama-3-8B-width weights from the
registry's seed (the phase serves their first layers), runs the phase
and prints its JSON line, the fronts' and the hosted hop's launch
counts, the MCP turn's and the card; any failed gate exits non-zero.
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
        out = cs.serve_gateway(torch, srv.engine.params, launches)
    finally:
        srv.engine = None
    print(json.dumps({"serve_gateway": out}), flush=True)
    print(json.dumps({"fronts": out["fronts"],
                      "launches_serve_fronts": launches["serve_fronts"]}),
          flush=True)
    print(json.dumps({"hosted": out["hosted"],
                      "launches_serve_hosted": launches["serve_hosted"]}),
          flush=True)
    print(json.dumps({"mcp": out["mcp"],
                      "launches_serve_mcp": launches["serve_mcp"]}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
