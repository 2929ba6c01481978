"""Rule ``gauge-drift``: /state ↔ gauge-map agreement at analysis time.

A renamed EngineStats field silently drops a dashboard signal, a
picker input or a benchmark observable. This pass checks the whole
contract statically against the generated manifest
(``analysis.manifest``):

- every literal key of the ``TPUServeServer.state`` payload dict must
  be an ``ENGINE_GAUGES`` attr or carry a ``STATE_ONLY`` exemption;
- every ``ENGINE_GAUGES`` attr must appear on /state or carry a
  ``METRICS_ONLY`` exemption;
- every ``FLEET_GAUGES`` key must appear among the literal keys of
  ``FleetState.rollup``'s return dict;
- every ``USAGE_GAUGES`` key must appear among the literal keys of
  ``UsageLedger.snapshot``'s return dict (the metering ledger).

The manifest module validates its own exemption tables at import, so a
stale exemption fails here too.
"""

from __future__ import annotations

import ast

from aigw_tpu_torch.analysis.core import Finding, Source
from aigw_tpu_torch.analysis.registry import AnalysisConfig

RULE = "gauge-drift"


def _function(tree: ast.AST, name: str) -> ast.AST | None:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name == name:
            return node
    return None


def _largest_dict(fn: ast.AST) -> ast.Dict | None:
    best: ast.Dict | None = None
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            if best is None or len(node.keys) > len(best.keys):
                best = node
    return best


def _literal_keys(d: ast.Dict) -> dict[str, int]:
    """str key → line. ``**spread`` entries (key=None) are skipped —
    they carry dynamic surfaces (device_topology) outside the literal
    contract."""
    out: dict[str, int] = {}
    for k, v in zip(d.keys, d.values):
        if isinstance(k, ast.Constant) and isinstance(k.value, str):
            out[k.value] = k.lineno
    return out


def check(sources: list[Source], config: AnalysisConfig) -> list[Finding]:
    from aigw_tpu_torch.analysis import manifest

    out: list[Finding] = []
    by_rel = {s.rel: s for s in sources}

    src = by_rel.get(config.state_server)
    if src is not None:
        fn = _function(src.tree, config.state_handler)
        if fn is None:
            out.append(Finding(
                RULE, src.rel, 1,
                f"state handler {config.state_handler!r} not found in "
                f"{config.state_server} — update AnalysisConfig"))
        else:
            payload = _largest_dict(fn)
            if payload is None:
                out.append(Finding(
                    RULE, src.rel, fn.lineno,
                    "state handler builds no dict literal — the "
                    "gauge-drift contract needs literal keys"))
            else:
                keys = _literal_keys(payload)
                expected = manifest.expected_state_keys()
                for key, line in sorted(keys.items()):
                    if key not in expected:
                        out.append(Finding(
                            RULE, src.rel, line,
                            f"/state field {key!r} is neither an "
                            "ENGINE_GAUGES attr nor a STATE_ONLY "
                            "exemption — declare it in obs/metrics.py "
                            "or analysis/manifest.py"))
                for key in sorted(expected - set(keys)):
                    out.append(Finding(
                        RULE, src.rel, payload.lineno,
                        f"/state lost field {key!r} (expected from "
                        "ENGINE_GAUGES/STATE_ONLY) — a dashboard/"
                        "picker/bench consumer just went blind"))

    fsrc = by_rel.get(config.fleetstate_module)
    if fsrc is not None:
        fn = _function(fsrc.tree, "rollup")
        if fn is None:
            out.append(Finding(
                RULE, fsrc.rel, 1,
                "FleetState.rollup not found — update AnalysisConfig"))
        else:
            payload = _largest_dict(fn)
            keys = _literal_keys(payload) if payload is not None else {}
            for key in manifest.FLEET_GAUGE_KEYS:
                if key not in keys:
                    out.append(Finding(
                        RULE, fsrc.rel, fn.lineno,
                        f"FLEET_GAUGES key {key!r} missing from "
                        "FleetState.rollup()'s literal keys — the "
                        "/fleet/metrics federation scrape loses the "
                        "aggregate"))

    usrc = by_rel.get(config.usage_module)
    if usrc is not None:
        fn = _function(usrc.tree, "snapshot")
        if fn is None:
            out.append(Finding(
                RULE, usrc.rel, 1,
                "UsageLedger.snapshot not found — update AnalysisConfig"))
        else:
            payload = _largest_dict(fn)
            keys = _literal_keys(payload) if payload is not None else {}
            for key in manifest.USAGE_GAUGE_KEYS:
                if key not in keys:
                    out.append(Finding(
                        RULE, usrc.rel, fn.lineno,
                        f"USAGE_GAUGES key {key!r} missing from "
                        "UsageLedger.snapshot()'s literal keys — the "
                        "gateway /metrics scrape loses the metering "
                        "gauge"))
    return out
