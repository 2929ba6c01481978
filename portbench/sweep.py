"""The rate sweep that finds an open-loop cell's knee (run once, when
the cell's rate is chosen; the benchmark's runs do not run it).

    python3 portbench/sweep.py --workload <cell> --seed <n> \\
        --seconds <s> --rates 2,3,4,5

One replica (and gateway) is set up for the cell, then each rate in
turn is offered for one window of the cell's mix with its rate
replaced, and one line is printed per rate: the TTFT and TPOT tails, the generator's lateness, and the backlog (requests
queued and in flight at the window's close, and due requests that had
not finished when the grace ran out).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import run


def idle(rig, timeout: float = 120.0) -> None:
    """Wait for the replica to have nothing queued or in flight."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        st = rig.server.state()
        if not st["queued"] and not st["active_slots"]:
            return
        time.sleep(0.5)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    with open(run.os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next(c for c in bench["workloads"] if c["name"] == args.workload)
    cfg, traffic, _limits = run.resolve(bench, cell)
    rig = run.Rig(cfg, traffic, args.seed, "cuda")
    try:
        for i, rate in enumerate(float(r) for r in args.rates.split(",")):
            tr = dict(traffic, rate=rate)
            ctx = run.measure(rig, tr, args.seed + i, args.seconds, False)
            tpot = run.reader("e2e", "tpot_p95_ms")(ctx)
            s = run.summary(ctx)
            close = ctx.snaps["close"]["state"]
            print(json.dumps({
                "rate": rate, "ttft_p95_ms": s["ttft_ms_p95"],
                "tpot_p95_ms": tpot,
                "ttft_p50_ms": s["ttft_ms_p50"],
                "tpot_p50_ms": s["tpot_ms_p50"],
                "late_ms_max": s["late_ms_max"],
                "queued_at_close": close["queued"],
                "active_at_close": close["active_slots"],
                "due": s["requests_in_window"],
                "unfinished": s["requests_in_window"] - s["finished"],
                "setup_s": ctx.setup_s if i == 0 else None}), flush=True)
            idle(rig)
    finally:
        rig.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
