"""Serve chip_smoke's Llama-3-8B-width burst from the tree in the
working directory and print one JSON line: one cold burst (bf16, fused
rung, prefix cache off, random weights) with its wall time, then four
warm ones, each with its wall time and ``/state``'s prefill and TTFT
p50, and the engine's ``state_rebuilds``, ``decode_steps`` and (on a
tree that has them) ``warm_programs`` and ``xla_compiles`` at the
end.

To compare two commits on one card, unpack each into a directory of
the repo that ``.gitignore`` lists and run this script from each, in
turns (old, new, new, old), with the tree as the working directory:

    mkdir -p build/old && git archive <commit> | tar -x -C build/old
    for t in old new new old; do
        (cd build/$t && python ../../tools/torch_serve_turns.py)
    done

(``build/new`` holding the working tree's files). It needs CUDA.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from aigw_tpu_torch.models import llama  # noqa: E402
from aigw_tpu_torch.models.registry import (  # noqa: E402
    ModelSpec,
    register_model,
)
from aigw_tpu_torch.obs.metrics import EnginePhases  # noqa: E402
from aigw_tpu_torch.tpuserve.engine import EngineConfig  # noqa: E402
from aigw_tpu_torch.tpuserve.server import TPUServeServer  # noqa: E402


def main() -> int:
    register_model(ModelSpec("llama-3-8b-random", "llama",
                             llama.LLAMA3_8B))
    srv = TPUServeServer("llama-3-8b-random", EngineConfig(
        max_batch_size=8, max_seq_len=2048, page_size=128,
        attention_backend="pallas-ragged", decode_backend="fused",
        enable_prefix_cache=False), device="cuda", port=0)
    srv.start()
    reqs = cs._requests(np.random.default_rng(0))
    t = time.monotonic()
    cs.serve_phase(srv.port, reqs)
    cold_s = time.monotonic() - t
    walls, p50 = [], []
    for _ in range(4):
        srv.engine.phases = EnginePhases()
        t = time.monotonic()
        cs.serve_phase(srv.port, reqs)
        walls.append(time.monotonic() - t)
        st = json.loads(cs._http(srv.port, "/state")[2])
        p50.append((st["phase_percentiles"]["prefill"]["p50"],
                    st["phase_percentiles"]["ttft"]["p50"]))
    srv.stop()
    print(json.dumps({"tree": os.path.basename(os.getcwd()),
                      "cold_s": cold_s, "warm_s": walls,
                      "prefill_ttft_p50": p50,
                      "state_rebuilds": st["state_rebuilds"],
                      "decode_steps": st["decode_steps"],
                      "warm_programs": st.get("warm_programs"),
                      "xla_compiles": st.get("xla_compiles")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
