#!/usr/bin/env python3
"""Run chip_smoke.py's ``checkpoint`` phase alone on one NVIDIA GPU: HF
safetensors shards at Llama-3-8B widths cut to 4 layers written with
the standard library, imported onto the card bit-exact, and the burst
served from them and from the same tensors in memory, bf16 and W8A16,
streams identical, the GenAI histograms and ``/state``'s device keys
gated.

    python3 tools/torch_checkpoint.py

It builds the kernels, runs the phase and prints its JSON line; any
failed gate exits non-zero. About a minute on an H100 with the build.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this needs an NVIDIA "
                "GPU", 2)
    from aigw_tpu_torch.ops import _build

    print(f"card: {cs.nvidia_smi_line()}", flush=True)
    _build.library()
    out = cs.checkpoint_phase(torch, cs._requests(np.random.default_rng(0)),
                              ROOT, {})
    print(json.dumps({"checkpoint": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
