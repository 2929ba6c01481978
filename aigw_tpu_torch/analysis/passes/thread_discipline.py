"""Rule ``engine-thread``: single-writer discipline for engine state.

The hardest bugs in the reference's stack were cross-thread writes to
state the engine loop owns: a warm-up race published a throwaway device
state through ``self._device_state`` while the loop's quiesce path was
nulling it; a crash read stale window membership after a drain.
This pass makes the discipline a lint: every mutation of a guarded
field (declared in ``analysis.registry.THREAD_DOMAINS``) must sit in a
method annotated ``@engine_thread_only``, in the loop entry itself, or
in construction. The decorator doubles as the runtime sanitizer under
``AIGW_TSAN=1``, so the static annotation and the runtime check cannot
drift.

Mutations recognized: plain/augmented assignment and deletion of
``self.<field>`` (including tuple targets and ``self.<field>[i] = x``)
and calls of mutating container methods (``add``/``append``/``clear``/
…) on ``self.<field>``.
"""

from __future__ import annotations

import ast

from aigw_tpu_torch.analysis.core import Finding, Source, dotted_name
from aigw_tpu_torch.analysis.registry import AnalysisConfig, ThreadDomain

RULE = "engine-thread"

_MUTATORS = {
    "add", "append", "extend", "clear", "discard", "insert", "pop",
    "popitem", "remove", "setdefault", "update",
}


def _is_engine_thread_decorator(dec: ast.AST) -> bool:
    name = dotted_name(dec)
    return name == "engine_thread_only" or name.endswith(
        ".engine_thread_only")


def _guarded_target(node: ast.AST, guarded: tuple[str, ...]) -> str | None:
    """'field' when ``node`` is self.<field> or self.<field>[...]."""
    if isinstance(node, ast.Subscript):
        node = node.value
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
            and node.attr in guarded):
        return node.attr
    return None


def _method_mutations(fn: ast.AST, guarded: tuple[str, ...]):
    """Yield (line, field, how) for every guarded-field mutation inside
    ``fn``, not descending into nested defs (they get their own entry
    from the caller's qualname walk — and a nested fn is dispatched by
    the function that makes it, whose discipline is what matters)."""
    for node in ast.walk(fn):
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            flat: list[ast.AST] = []
            for t in targets:
                flat.extend(t.elts if isinstance(t, (ast.Tuple, ast.List))
                            else [t])
            for t in flat:
                f = _guarded_target(t, guarded)
                if f is not None:
                    yield node.lineno, f, "assigned"
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                f = _guarded_target(t, guarded)
                if f is not None:
                    yield node.lineno, f, "deleted"
        elif isinstance(node, ast.Call):
            fun = node.func
            if (isinstance(fun, ast.Attribute)
                    and fun.attr in _MUTATORS):
                f = _guarded_target(fun.value, guarded)
                if f is not None:
                    yield node.lineno, f, f"mutated via .{fun.attr}()"


def _check_domain(src: Source, domain: ThreadDomain) -> list[Finding]:
    out: list[Finding] = []
    cls = next((n for n in ast.walk(src.tree)
                if isinstance(n, ast.ClassDef) and n.name == domain.cls),
               None)
    if cls is None:
        return [Finding(RULE, src.rel, 1,
                        f"registry names class {domain.cls!r} which does "
                        f"not exist in {domain.path} — update "
                        "analysis/registry.py THREAD_DOMAINS")]

    methods = [n for n in cls.body
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    by_name = {m.name: m for m in methods}
    annotated = {m.name for m in methods
                 if any(_is_engine_thread_decorator(d)
                        for d in m.decorator_list)}
    allowed = annotated | set(domain.entry_methods) | set(
        domain.allowed_methods)

    for name in (*domain.entry_methods, *domain.allowed_methods):
        if name not in by_name:
            out.append(Finding(
                RULE, src.rel, cls.lineno,
                f"registry lists {domain.cls}.{name} but the method "
                "does not exist — update THREAD_DOMAINS"))

    seen_fields: set[str] = set()
    for m in methods:
        for line, fld, how in _method_mutations(m, domain.guarded_fields):
            seen_fields.add(fld)
            if m.name not in allowed:
                out.append(Finding(
                    RULE, src.rel, line,
                    f"engine-thread-only field self.{fld} {how} in "
                    f"{domain.cls}.{m.name}, which is not marked "
                    "@engine_thread_only (and is not the loop entry or "
                    "__init__) — the warm-up race bug class"))

    for fld in domain.guarded_fields:
        if fld not in seen_fields:
            out.append(Finding(
                RULE, src.rel, cls.lineno,
                f"guarded field {fld!r} is never mutated inside "
                f"{domain.cls} — stale THREAD_DOMAINS entry (renamed "
                "field silently loses its guard)"))
    return out


def check(sources: list[Source], config: AnalysisConfig) -> list[Finding]:
    out: list[Finding] = []
    by_rel = {s.rel: s for s in sources}
    for domain in config.thread_domains:
        src = by_rel.get(domain.path)
        if src is None:
            continue  # tree subset under check does not include it
        out.extend(_check_domain(src, domain))
    return out
