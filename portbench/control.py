"""The control of the output check (run on the card when a cell's limits
are set; the benchmark's runs do not run it).

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \\
        --seconds <s> [--lowp fp8|int4]

For each seed, one run of the cell at its own load and sizes for a
short window, then the check with the control in the program's place:
the reference computed in the precision below the configuration's
(``--lowp``: float8 e4m3 weights and activations for a bfloat16 model,
int4 weights for a W8A16 one), its best pinned token at each position
of the same prompts and served tokens standing for the served one, held
to the cell's limits. One JSON line per seed: the control's ``correct``
and numbers, beside the program's numbers (the lower reading's) over
the same positions.
"""

from __future__ import annotations

import argparse
import json
import sys

import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--lowp", required=True, choices=("fp8", "int4"))
    args = ap.parse_args(argv)
    with open(run.os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next(c for c in bench["workloads"] if c["name"] == args.workload)
    cfg, traffic, limits = run.resolve(bench, cell)
    for seed in (int(s) for s in args.seeds.split(",")):
        res = run.run_cell(bench, cell, cfg, traffic, limits, seed,
                           args.seconds, False, control=args.lowp)
        print(json.dumps({
            "seed": seed, "correct": res["correct"],
            "control": {k: v["value"] for k, v in res["check"].items()},
            "program": {k: v["value"]
                        for k, v in res["program_check"].items()},
            "limits": {k: v["limit"] for k, v in res["check"].items()},
            "gaps": res["check_info"]["gaps"],
            "router_margin": res["check_info"].get("router_margin"),
            "positions": res["check_info"]["positions"],
            "requests": res["check_info"]["requests"],
            "metrics": {k: v["value"] for k, v in res["metrics"].items()},
            "peak": res["device"]["memory_peak_bytes"]}), flush=True)
        del res
        run.gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
