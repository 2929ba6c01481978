#!/usr/bin/env python
"""aigw-check CLI for the port: run the invariant lint suite over
aigw_tpu_torch/ (the counterpart of tools/staticcheck.py, same flags).

    python tools/torch_staticcheck.py                # the whole port
    python tools/torch_staticcheck.py aigw_tpu_torch/tpuserve
    python tools/torch_staticcheck.py --rule engine-thread --json
    python tools/torch_staticcheck.py --list-rules

Exit codes: 0 clean, 1 unsuppressed findings, 2 internal error.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO_ROOT))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to check (default: aigw_tpu_torch/)")
    ap.add_argument("--rule", action="append", dest="rules",
                    help="run only this rule (repeatable)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable findings on stdout")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    from aigw_tpu_torch.analysis.core import run_checks
    from aigw_tpu_torch.analysis.passes import ALL_PASSES, RULES

    if args.list_rules:
        for mod in ALL_PASSES:
            head = (mod.__doc__ or "").strip().splitlines()[0]
            print(f"{mod.RULE:18s} {head}")
        return 0

    rules = set(args.rules) if args.rules else None
    if rules is not None:
        unknown = rules - set(RULES) - {"suppression"}
        if unknown:
            print(f"unknown rule(s): {', '.join(sorted(unknown))} "
                  f"(known: {', '.join(RULES)})", file=sys.stderr)
            return 2

    t0 = time.monotonic()
    findings, suppressed = run_checks(
        REPO_ROOT, paths=args.paths or None, rules=rules)
    dt_ms = round(1e3 * (time.monotonic() - t0))

    if args.json:
        print(json.dumps({
            "findings": [f.__dict__ for f in findings],
            "suppressed": [f.__dict__ for f in suppressed],
            "elapsed_ms": dt_ms,
        }, indent=2))
    else:
        for f in findings:
            print(f.render())
        status = "FAIL" if findings else "ok"
        print(f"aigw-check: {status} — {len(findings)} finding(s), "
              f"{len(suppressed)} suppressed, {dt_ms}ms",
              file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:  # noqa: BLE001 — a crashed linter must be
        # distinguishable from a lint failure in CI
        print(f"aigw-check: internal error: {type(e).__name__}: {e}",
              file=sys.stderr)
        raise SystemExit(2)
