"""A replica process started from a JSON spec: the child the fleet
controller's ``LocalProcessLauncher`` runs (``gateway/controller.py``).

    python -m aigw_tpu_torch.tpuserve.child '{"model": "m", "cfg": {...},
        "batch": 8, "page": 128, "k": 8, "engine": {...}}'

The spec keys are the reference child's: ``model`` (the name it
registers and serves), ``family`` (``llama`` or ``mixtral``), ``cfg``
(the family config's fields), ``batch``, ``page``, ``k`` (decode steps
a tick), ``quantize`` (``""``, ``int8`` or ``int4``), ``engine`` (more
``EngineConfig`` fields), ``param_dtype`` (``bfloat16`` by default, or
``float32``) and ``tp``; and two of the port's: ``seed`` (0 by default)
and ``device`` (``cuda`` unless the spec says ``cpu``). The weights are
the family's ``init_params(seed, cfg)`` drawn on that device, so two
children of one spec, or a child and a replica built in another process
from the same seed, config and device type, hold the same weights; with
``quantize`` they are quantized after the draw.

The child builds nothing itself: on CUDA it loads the kernel library
``ops/_build.py`` keeps under ``build/kernels/`` (building it only if
the checkout has none). Once listening it prints ``SERVE_BOOT_S=<s>``
(seconds since the process imported it, at its start) and
``SERVE_PORT=<port>`` on its standard output, and logs to its standard
error. SIGTERM or SIGINT drains it (new generations get 503 while live ones finish or are
migrated off, ``AIGW_DRAIN_GRACE_S`` seconds at most, 60 by default)
and it exits 0; a second signal stops it at once.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import sys
import threading
import time

_T0 = time.monotonic()


def build_server(spec: dict):
    """The spec's replica, its model registered and its weights drawn,
    not yet started: the reference child's ``EngineConfig`` fields
    (``max_seq_len`` from the model config, two warmed prefill buckets)
    under the spec's ``engine`` overrides, and the family's
    ``init_params(seed, cfg)`` on the spec's device, quantized when the
    spec says so."""
    import torch

    from aigw_tpu_torch.device import resolve_device
    from aigw_tpu_torch.models import llama, mixtral
    from aigw_tpu_torch.models.quant import quantize_params
    from aigw_tpu_torch.models.registry import (
        ModelSpec,
        family_fns,
        register_model,
    )
    from aigw_tpu_torch.tpuserve.engine import EngineConfig
    from aigw_tpu_torch.tpuserve.server import TPUServeServer

    family = spec.get("family", "llama")
    if family not in ("llama", "mixtral"):
        raise ValueError(f"unknown model family {family!r}")
    cfg = (mixtral.MixtralConfig if family == "mixtral"
           else llama.LlamaConfig)(**spec["cfg"])
    device = resolve_device(spec.get("device", "cuda"))
    if device.type == "cuda":
        from aigw_tpu_torch.ops import _build

        _build.library()
    dtype = {"bfloat16": torch.bfloat16, "": torch.bfloat16,
             "float32": torch.float32}[spec.get("param_dtype", "")]
    params = family_fns(family).init_params(int(spec.get("seed", 0)), cfg,
                                            dtype, device)
    if spec.get("quantize", ""):
        params = quantize_params(params, consume=True,
                                 mode=spec["quantize"])
    register_model(ModelSpec(spec["model"], family, cfg))
    engine_cfg = EngineConfig(
        max_batch_size=spec["batch"], max_seq_len=cfg.max_seq_len,
        page_size=spec["page"], decode_steps_per_tick=spec["k"],
        warm_prefill_buckets=2, **spec.get("engine", {}))
    return TPUServeServer(spec["model"], engine_cfg, device=device, port=0,
                          params=params, tp=int(spec.get("tp", 1)))


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python -m aigw_tpu_torch.tpuserve.child SPEC_JSON",
              file=sys.stderr)
        return 2
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s "
                               "%(message)s")
    server = build_server(json.loads(argv[0]))
    # the handler only records the signal; the loop below drains (the
    # first) or stops at once (the second)
    signalled = threading.Event()
    insist = threading.Event()

    def on_signal(*_) -> None:
        if signalled.is_set():
            insist.set()
        signalled.set()

    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, on_signal)
    server.start()
    print(f"SERVE_BOOT_S={time.monotonic() - _T0:.3f}", flush=True)
    print(f"SERVE_PORT={server.port}", flush=True)
    try:
        while not signalled.wait(0.5):
            pass
        grace = float(os.environ.get("AIGW_DRAIN_GRACE_S", "60") or 60)
        drained = server.drain(grace, stop=insist)
        logging.getLogger(__name__).info(
            "drain %s; exiting", "complete" if drained else "cut short")
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
