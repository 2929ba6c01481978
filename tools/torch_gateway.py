#!/usr/bin/env python3
"""Run chip_smoke.py's ``serve_gateway`` phase alone on one NVIDIA GPU:
two port replicas at Llama-3-8B widths cut to ``GW_LAYERS`` layers on
the kernel path, the port's gateway in front of them in its own process
(``python -m aigw_tpu_torch run``), the phase's six gates, the
direct-versus-gateway TTFT p50 and burst tokens/s, and the phase's
blocks on the same replicas (the fronts, the hosted hop, the MCP turn,
the control plane's: ``--workers``, a ``--reuse-port`` roll, a manifest
directory, autoconfig; the live cluster source's; and the native proxy
core's in front of a Python gateway).

    python3 tools/torch_gateway.py          # the whole phase
    python3 tools/torch_gateway.py --kube   # the cluster block alone
    python3 tools/torch_gateway.py --core   # the native core block alone

It builds the kernels (and, with g++ beside nvcc, the native scanners and
``aigw-core``), draws the Llama-3-8B-width weights from the registry's
seed (the phase serves their first layers), runs the phase (or, with
``--kube`` or ``--core``, only ``_gw_kube`` or ``_gw_core`` on the
phase's two replicas, the launch counts zeroed before it) and prints its
JSON line; any failed gate exits non-zero.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def block(params, run, line, what: str) -> dict:
    """One of ``serve_gateway``'s blocks alone (``run``: ``_gw_kube`` or
    ``_gw_core``), on two replicas built as ``serve_gateway`` builds
    them; ``line`` prints its line."""
    from aigw_tpu_torch.models import llama
    from aigw_tpu_torch.models.registry import ModelSpec, register_model
    from aigw_tpu_torch.tpuserve.engine import EngineConfig
    from aigw_tpu_torch.tpuserve.server import TPUServeServer

    cfg = dataclasses.replace(llama.LLAMA3_8B, n_layers=cs.GW_LAYERS)
    register_model(ModelSpec(cs.GW_MODEL, "llama", cfg))
    p = cs._first_layers(params, cs.GW_LAYERS)
    reps = [TPUServeServer(cs.GW_MODEL, EngineConfig(**cs.TP_CFG),
                           device="cuda", port=0, params=p) for _ in range(2)]
    for r in reps:
        r.start()
    try:
        cs.reset_counts()
        out = run(reps)
        counts = cs.read_counts()
    finally:
        for r in reps:
            r.stop()
    if counts["ragged_prefill_attention"] <= 0 \
            or counts["fused_paged_decode"] <= 0:
        raise AssertionError(f"K1/K2 not on the {what} block's path: "
                             f"{counts}")
    card = cs.nvidia_smi_line()
    cs.log(line(out, counts, card))
    out.update(card=card, launches=counts)
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--kube", action="store_true",
                    help="run the live cluster block alone")
    ap.add_argument("--core", action="store_true",
                    help="run the native proxy core block alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this needs an NVIDIA "
                "GPU", 2)
    from aigw_tpu_torch.models import llama
    from aigw_tpu_torch.models.registry import ModelSpec, register_model
    from aigw_tpu_torch.ops import _build
    from aigw_tpu_torch.tpuserve.engine import EngineConfig
    from aigw_tpu_torch.tpuserve.server import TPUServeServer

    print(f"card: {cs.nvidia_smi_line()}", flush=True)
    cs.start_native_builds()
    t = time.monotonic()
    _build.library()
    cs.log(f"kernels built in {time.monotonic() - t:.1f}s")
    register_model(ModelSpec("llama-3-8b-random", "llama", llama.LLAMA3_8B))
    srv = TPUServeServer("llama-3-8b-random", EngineConfig(**cs.TP_CFG),
                         device="cuda", port=0)
    launches: dict = {}
    try:
        if args.kube:
            print(json.dumps({"serve_gateway_kube": block(
                srv.engine.params, cs._gw_kube, cs._kube_line,
                "cluster")}), flush=True)
            return 0
        if args.core:
            print(json.dumps({"serve_gateway_core": block(
                srv.engine.params, cs._gw_core, cs._core_line,
                "native core")}), flush=True)
            return 0
        print(json.dumps({"serve_gateway": cs.serve_gateway(
            torch, srv.engine.params, launches)}), flush=True)
    finally:
        srv.engine = None
    for name in ("serve_gateway", "serve_fronts", "serve_hosted",
                 "serve_mcp", "serve_control", "serve_kube", "serve_core"):
        cs.log(f"launches on {name}: {launches[name]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
