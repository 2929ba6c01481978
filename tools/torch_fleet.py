#!/usr/bin/env python3
"""Run chip_smoke.py's ``serve_fleet`` phase alone on one NVIDIA GPU:
replica B at Llama-3-8B widths cut to ``FLEET_LAYERS`` layers on the
kernel path in this process, the port's gateway in this process with a
``controller`` whose launcher starts replica A as a child process on
the card, a stream drained off A through the migrator onto B, and the
token quota's 429.

    python3 tools/torch_fleet.py

It builds the kernels (the child loads the same library), runs the
phase and prints its JSON line; any failed gate exits non-zero.
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
    from aigw_tpu_torch.ops import _build

    print(f"card: {cs.nvidia_smi_line()}", flush=True)
    t = time.monotonic()
    _build.library()
    cs.log(f"kernels built in {time.monotonic() - t:.1f}s")
    launches: dict = {}
    print(json.dumps({"serve_fleet": cs.serve_fleet(torch, launches)}),
          flush=True)
    cs.log(f"launches {launches['serve_fleet']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
