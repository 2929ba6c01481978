"""aigw-check core: source loading, suppression syntax, pass runner
(the port's copy of ``aigw_tpu/analysis/core.py``, over
``aigw_tpu_torch/``).

The framework is deliberately small: a pass is a module exposing
``RULE`` (its name) and ``check(sources, config) -> list[Finding]``.
``run_checks`` parses every file once, runs the passes, then applies
the inline suppression syntax:

    # aigw: lint-ok(<rule>): <reason>

placed on the offending line or the line directly above it. The reason
string is MANDATORY — a bare ``lint-ok`` is itself a finding (rule
``suppression``), so every suppression in the tree documents why the
violation is intentional.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path

from aigw_tpu_torch.analysis.registry import DEFAULT_CONFIG, AnalysisConfig

_SUPPRESS_RE = re.compile(
    r"#\s*aigw:\s*lint-ok\(\s*(?P<rule>[A-Za-z0-9_-]+)\s*\)"
    r"(?P<rest>.*)$")
_REASON_RE = re.compile(r"^\s*:\s*\S")


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str  # repo-relative, forward slashes
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclass
class Source:
    """One parsed file plus its suppression table."""

    path: Path
    rel: str
    text: str
    tree: ast.AST
    #: line → set of rule names suppressed on that line
    suppressions: dict[int, set[str]] = field(default_factory=dict)
    #: malformed suppressions (missing reason): (line, raw comment)
    bad_suppressions: list[tuple[int, str]] = field(default_factory=list)

    @classmethod
    def load(cls, path: Path, root: Path) -> "Source":
        text = path.read_text(encoding="utf-8")
        rel = path.relative_to(root).as_posix()
        src = cls(path=path, rel=rel, text=text,
                  tree=ast.parse(text, filename=str(path)))
        for lineno, line in enumerate(text.splitlines(), start=1):
            m = _SUPPRESS_RE.search(line)
            if m is None:
                continue
            if not _REASON_RE.match(m.group("rest")):
                src.bad_suppressions.append((lineno, m.group(0).strip()))
                continue
            src.suppressions.setdefault(lineno, set()).add(m.group("rule"))
        return src

    def suppressed(self, rule: str, line: int) -> bool:
        for at in (line, line - 1):
            if rule in self.suppressions.get(at, ()):  # noqa: SIM110
                return True
        return False


def discover(root: Path, paths: list[str] | None = None) -> list[Path]:
    """Files under check: the port's package tree by default, or an
    explicit path list (files or directories) relative to ``root``."""
    if paths:
        out: list[Path] = []
        for p in paths:
            q = (root / p) if not Path(p).is_absolute() else Path(p)
            if q.is_dir():
                out.extend(sorted(q.rglob("*.py")))
            else:
                out.append(q)
        return out
    return sorted((root / "aigw_tpu_torch").rglob("*.py"))


def load_sources(root: Path, paths: list[str] | None = None) -> list[Source]:
    return [Source.load(p, root) for p in discover(root, paths)
            if "__pycache__" not in p.parts]


def all_passes():
    from aigw_tpu_torch.analysis.passes import ALL_PASSES

    return ALL_PASSES


def run_checks(
    root: Path,
    paths: list[str] | None = None,
    config: AnalysisConfig = DEFAULT_CONFIG,
    rules: set[str] | None = None,
) -> tuple[list[Finding], list[Finding]]:
    """Run every pass over the tree. Returns ``(findings, suppressed)``
    — the first list is what should fail the build."""
    sources = load_sources(root, paths)
    return run_passes(sources, config, rules)


def run_passes(
    sources: list[Source],
    config: AnalysisConfig = DEFAULT_CONFIG,
    rules: set[str] | None = None,
) -> tuple[list[Finding], list[Finding]]:
    raw: list[Finding] = []
    known_rules: set[str] = set()
    for mod in all_passes():
        known_rules.add(mod.RULE)
        if rules is not None and mod.RULE not in rules:
            continue
        raw.extend(mod.check(sources, config))

    by_rel = {s.rel: s for s in sources}
    findings: list[Finding] = []
    suppressed: list[Finding] = []
    for f in raw:
        src = by_rel.get(f.path)
        if src is not None and src.suppressed(f.rule, f.line):
            suppressed.append(f)
        else:
            findings.append(f)

    # the suppression syntax polices itself: a reasonless lint-ok or a
    # suppression naming a rule that does not exist is a finding
    if rules is None or "suppression" in rules:
        for src in sources:
            for line, raw_comment in src.bad_suppressions:
                findings.append(Finding(
                    "suppression", src.rel, line,
                    f"suppression without a reason: {raw_comment!r} — "
                    "write '# aigw: lint-ok(<rule>): <why this is "
                    "intentional>'"))
            for line, ruleset in src.suppressions.items():
                for rule in sorted(ruleset - known_rules):
                    findings.append(Finding(
                        "suppression", src.rel, line,
                        f"suppression names unknown rule {rule!r} "
                        f"(known: {', '.join(sorted(known_rules))})"))

    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    suppressed.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings, suppressed


# -- shared AST helpers used by several passes ---------------------------

def dotted_name(node: ast.AST) -> str:
    """'torch.cuda.CUDAGraph' for that attribute chain; '' when the
    expression is not a plain dotted chain."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def iter_functions(tree: ast.AST):
    """Yield (qualname, node) for every function/method, including
    nested ones ('Cls.meth', 'Cls.meth.inner')."""

    def walk(node: ast.AST, prefix: str):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{prefix}{child.name}"
                yield q, child
                yield from walk(child, q + ".")
            elif isinstance(child, ast.ClassDef):
                yield from walk(child, f"{prefix}{child.name}.")
            else:
                yield from walk(child, prefix)

    yield from walk(tree, "")


def build_parents(tree: ast.AST) -> dict[ast.AST, ast.AST]:
    parents: dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents
