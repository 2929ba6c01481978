#!/usr/bin/env python3
"""Run chip_smoke.py's parallel phases alone on one NVIDIA GPU:
``serve_tp`` (Llama-3-8B widths at tp = 2, two ranks on the card over
gloo, bf16 then W8A16 over int8 pages, streams held to one rank's),
``serve_tp_nccl`` (one rank over NCCL, collectives captured, streams
bit-equal to no mesh), ``kernels_tp`` (every kernel at a tp = 2 rank's
shard shapes against its plain version, timed), ``serve_sp``
(Llama-3-8B widths at sp = 2, two ranks on the card over gloo: long
prompts as ring-attention chunk steps, short arrivals admitted at chunk
boundaries, a prefix resume, then W8A16 over int8 pages) and
``serve_ep`` (Mixtral-8x7B widths at 2 layers, W8A16, ep = 2).

    python3 tools/torch_parallel.py [--skip serve_tp,serve_ep,...]

It builds the kernels, starts a one-rank Llama-3-8B-width server on
random bf16 weights (the phases' one-rank replica), runs the phases and
prints their JSON lines; any failed gate exits non-zero.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

PHASES = ("serve_tp", "serve_tp_nccl", "kernels_tp", "serve_sp",
          "serve_ep")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip", default="",
                    help=f"comma-separated phases to leave out of {PHASES}")
    skip = set(filter(None, ap.parse_args().skip.split(",")))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this needs an NVIDIA "
                "GPU", 2)
    from aigw_tpu_torch.models import llama, mixtral, quant
    from aigw_tpu_torch.models.registry import ModelSpec, register_model
    from aigw_tpu_torch.ops import _build
    from aigw_tpu_torch.tpuserve.engine import Engine, EngineConfig
    from aigw_tpu_torch.tpuserve.server import TPUServeServer

    card = cs.nvidia_smi_line()
    print(f"card: {card}", flush=True)
    t = time.monotonic()
    _build.library()
    cs.log(f"kernels built in {time.monotonic() - t:.1f}s")
    reqs = cs._requests(np.random.default_rng(0))
    launches: dict = {"serve_tp": {}, "serve_tp_w8a16": {}}
    if not {"serve_tp", "serve_tp_nccl", "serve_sp"} <= skip:
        register_model(ModelSpec("llama-3-8b-random", "llama",
                                 llama.LLAMA3_8B))
        srv = TPUServeServer("llama-3-8b-random", EngineConfig(**cs.TP_CFG),
                             device="cuda", port=0)
        srv.start()
        params = srv.engine.params
        qparams = quant.quantize_params(params, consume=False, mode="int8")

        def restart(p, model_cfg=llama.LLAMA3_8B, **kw):
            cs.stop_engine(srv)
            srv.engine = Engine(p, model_cfg,
                                EngineConfig(**{**cs.TP_CFG, **kw}),
                                eos_token_ids=(srv.tokenizer.eos_id,),
                                device="cuda")
            srv.engine.start()

        try:
            if "serve_tp" not in skip:
                print(json.dumps({"serve_tp": cs.serve_tp(
                    torch, srv, params, qparams, reqs, launches)}),
                    flush=True)
            if "serve_tp_nccl" not in skip:
                print(json.dumps({"serve_tp_nccl": cs.serve_tp_nccl(
                    torch, srv, params, reqs)}), flush=True)
            if "serve_sp" not in skip:
                print(json.dumps({"serve_sp": cs.serve_sp(
                    torch, srv, restart, params, qparams, launches)}),
                    flush=True)
        finally:
            srv.stop()
        del params, qparams, srv
    if "kernels_tp" not in skip:
        tp = {k: launches["serve_tp"].get(k, 0)
              + launches["serve_tp_w8a16"].get(k, 0) for k in cs.counters()}
        tp["ragged_prefill_attention_resume"] = 0
        rows = cs.kernel_checks(torch, tp, heads=(16, 4))
        rows += cs.quant_kernel_checks(torch, tp, heads=(16, 4),
                                       qmm=cs.QMM_TP2,
                                       line="qmatmul_shapes_tp")
        print(json.dumps({"kernels_tp": {"heads": [16, 4], "card": card,
                                         "rows": rows}}), flush=True)
    if "serve_ep" not in skip:
        print(json.dumps({"serve_ep": cs.serve_ep(torch, mixtral, reqs,
                                                  {})}), flush=True)
    cs.log("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
