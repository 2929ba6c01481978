#!/usr/bin/env python3
"""What torch.distributed carries on one card: the facts the multi-rank
serving harness rests on.

    python3 tools/torch_dist_probe.py

Runs, each in fresh processes with a finite timeout:

1. two ranks on ``cuda:0`` over NCCL (expected to be refused: NCCL does
   not put two ranks of one communicator on one device); the error is
   printed;
2. two ranks on ``cuda:0`` over gloo with CUDA tensors: ``broadcast``,
   ``all_reduce``, ``all_gather``, ``all_to_all_single`` (Ulysses'
   exchange, ``ops/ring_attention.py``) and ``send`` / ``recv``, each
   checked against its expected values;
3. one rank over NCCL: an ``all_reduce`` and an ``all_gather`` captured
   in a CUDA graph and replayed, checked.

Prints one JSON line per case and exits 0 whatever they show (the
output is the finding).
"""

from __future__ import annotations

import json
import multiprocessing as mp
import os
import sys
import tempfile
import traceback
from datetime import timedelta

TIMEOUT_S = 60


def _case(rank: int, world: int, init: str, backend: str, what: str,
          out) -> None:
    import torch
    import torch.distributed as dist

    res: dict = {"rank": rank}
    try:
        torch.cuda.set_device(0)
        dist.init_process_group(backend, init_method=init, rank=rank,
                                world_size=world,
                                timeout=timedelta(seconds=TIMEOUT_S))
        dev = torch.device("cuda:0")
        if what == "collectives":
            t = torch.full((4,), float(rank + 1), device=dev)
            dist.all_reduce(t)
            res["all_reduce"] = t.tolist()
            b = torch.full((3,), float(rank + 7), device=dev)
            dist.broadcast(b, src=0)
            res["broadcast"] = b.tolist()
            parts = [torch.empty(2, device=dev) for _ in range(world)]
            dist.all_gather(parts, torch.full((2,), float(rank), device=dev))
            res["all_gather"] = [p.tolist() for p in parts]
            try:
                # rank r sends [10 r + j] to rank j: rank j gets
                # [j, 10 + j]
                a2a = torch.empty(world, device=dev)
                dist.all_to_all_single(a2a, torch.arange(
                    world, dtype=torch.float32, device=dev) + 10.0 * rank)
                res["all_to_all_single"] = a2a.tolist()
                res["all_to_all_ok"] = a2a.tolist() == [
                    10.0 * j + rank for j in range(world)]
            except Exception as e:  # noqa: BLE001 — the finding
                res["all_to_all_error"] = f"{type(e).__name__}: {e}"[:400]
            try:
                if rank == 0:
                    dist.send(torch.arange(5, dtype=torch.float32,
                                           device=dev), dst=1)
                    res["send"] = "ok"
                else:
                    r = torch.empty(5, device=dev)
                    dist.recv(r, src=0)
                    res["recv"] = r.tolist()
            except Exception as e:  # noqa: BLE001 — the finding
                res["p2p_error"] = f"{type(e).__name__}: {e}"[:400]
        elif what == "capture":
            x = torch.ones(8, device=dev)
            g_out = [torch.empty(8, device=dev)]
            dist.all_reduce(x)  # initializes the communicator
            dist.all_gather(g_out, x)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(side):
                graph.capture_begin(capture_error_mode="thread_local")
                y = x * 2
                dist.all_reduce(y)
                dist.all_gather(g_out, y)
                graph.capture_end()
            torch.cuda.current_stream().wait_stream(side)
            x.fill_(3.0)
            graph.replay()
            torch.cuda.synchronize()
            res["replayed"] = g_out[0].tolist()[:2]
            res["ok"] = g_out[0].tolist() == [6.0] * 8
        else:
            t = torch.ones(4, device=dev)
            dist.all_reduce(t)
            torch.cuda.synchronize()
            res["all_reduce"] = t.tolist()
        dist.destroy_process_group()
    except Exception as e:  # noqa: BLE001 — the finding
        res["error"] = f"{type(e).__name__}: {e}"[:600]
        res["trace"] = traceback.format_exc()[-800:]
    out.put(res)


def run(world: int, backend: str, what: str) -> dict:
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory() as d:
        init = f"file://{os.path.join(d, 'rdv')}"
        procs = [ctx.Process(target=_case, args=(r, world, init, backend,
                                                 what, out))
                 for r in range(world)]
        for p in procs:
            p.start()
        got = []
        for _ in procs:
            try:
                got.append(out.get(timeout=TIMEOUT_S + 60))
            except Exception as e:  # noqa: BLE001 — a hung rank
                got.append({"error": f"no answer: {type(e).__name__}"})
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
        return {"world": world, "backend": backend, "case": what,
                "ranks": sorted(got, key=lambda r: r.get("rank", 99)),
                "exitcodes": [p.exitcode for p in procs]}


def main() -> int:
    import torch

    print(json.dumps({"torch": torch.__version__,
                      "cuda": torch.version.cuda,
                      "nccl": ".".join(map(str, torch.cuda.nccl.version())),
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    for world, backend, what in ((2, "nccl", "plain"),
                                 (2, "gloo", "collectives"),
                                 (1, "nccl", "capture")):
        print(json.dumps(run(world, backend, what)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
