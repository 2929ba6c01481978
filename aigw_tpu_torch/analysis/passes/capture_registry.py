"""Rule ``capture-registry``: no uncounted programs on the serving path.

The port's compiled programs are CUDA graphs (the reference's are
``jax.jit`` programs, which its ``jit-registry`` rule holds to the
compile tracker). Every capture inside the serving modules — a
``torch.cuda.CUDAGraph()``, a ``torch.cuda.graph(...)`` context, a
``torch.cuda.make_graphed_callables(...)`` — must be accounted for by
the compile tracker: the function that captures reports it
(``<tracker>.note_compile(...)`` in the same function, as the engine's
program pool ``tpuserve/programs.py`` ``CapturedProgram._capture``
does, so ``/state``'s ``warm_programs`` and ``xla_compiles`` count it),
or the function is declared in ``analysis.registry.CAPTURE_SURFACE``
with the reason it is accounted for anyway. A capture that is neither is
a program warm-up cannot see: its capture runs on the hot path the
first time traffic reaches it, and the zero-capture tripwires miss it.

Stale ``CAPTURE_SURFACE`` keys are also findings — a renamed function
cannot leave a dangling exemption.
"""

from __future__ import annotations

import ast

from aigw_tpu_torch.analysis.core import (
    Finding,
    Source,
    build_parents,
    dotted_name,
    iter_functions,
)
from aigw_tpu_torch.analysis.registry import AnalysisConfig

RULE = "capture-registry"

#: the last segment of a capturing call (``graph`` only as
#: ``<...>.cuda.graph`` or ``<...>.graphs.graph``: a bare ``graph`` is
#: too common a name)
_CAPTURE_HEADS = {"CUDAGraph", "make_graphed_callables"}
_GRAPH_CONTEXTS = ("cuda.graph", "graphs.graph")


def _is_capture(call: ast.Call) -> bool:
    name = dotted_name(call.func)
    if not name:
        return False
    if name.rsplit(".", 1)[-1] in _CAPTURE_HEADS:
        return True
    return any(name == p or name.endswith("." + p) for p in _GRAPH_CONTEXTS)


def _reports_compile(fn: ast.AST) -> bool:
    """``fn`` calls ``<x>.note_compile(...)`` itself (not in a nested
    def: that one reports for its own calls)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "note_compile"):
            return True
        stack.extend(ast.iter_child_nodes(node))
    return False


def _enclosing(node: ast.AST, parents: dict[ast.AST, ast.AST]):
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur
        cur = parents.get(cur)
    return None


def check(sources: list[Source], config: AnalysisConfig) -> list[Finding]:
    out: list[Finding] = []
    seen_keys: set[str] = set()
    scoped = [s for s in sources
              if any(s.rel == p or s.rel.startswith(p)
                     for p in config.capture_scope)]
    for src in scoped:
        parents = build_parents(src.tree)
        qual_of = {node: q for q, node in iter_functions(src.tree)}
        for node in ast.walk(src.tree):
            if not (isinstance(node, ast.Call) and _is_capture(node)):
                continue
            fn = _enclosing(node, parents)
            qual = qual_of.get(fn, "") if fn is not None else ""
            key = f"{src.rel}::{qual or '<module>'}"
            if key in config.capture_surface:
                seen_keys.add(key)
                continue
            if fn is not None and _reports_compile(fn):
                continue
            out.append(Finding(
                RULE, src.rel, node.lineno,
                f"CUDA graph capture {dotted_name(node.func)} in "
                f"{qual or '<module>'} is not reported to the "
                "CompileTracker (note_compile) and not declared in "
                "CAPTURE_SURFACE — a program warm-up cannot see, captured "
                "on the hot path; capture through tpuserve/programs.py's "
                "pool or declare how it is accounted for in "
                "analysis/registry.py"))

    # stale registry entries for files actually under check
    checked = {s.rel for s in scoped}
    for key in config.capture_surface:
        rel = key.split("::", 1)[0]
        if rel in checked and key not in seen_keys:
            out.append(Finding(
                RULE, rel, 1,
                f"CAPTURE_SURFACE entry {key!r} matches no capture site — "
                "stale registry entry (renamed/deleted function); remove "
                "it from analysis/registry.py"))
    return out
