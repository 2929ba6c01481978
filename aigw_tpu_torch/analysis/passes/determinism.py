"""Rule ``determinism``: the byte-identical f32 contract, statically.

Every decode-path change is held against byte-identical token streams
in the deterministic f32 rig (the reference's standing constraint, and
the port's CPU tests against it). That contract dies the moment
anything on the decode or sampling path draws from an unseeded global
RNG or folds a wall-clock read into sampled values. The port's sampling
and weight draws take explicit seeds (a seeded ``torch.Generator``, the
per-request seed keys); this pass keeps it that way:

- in ``DETERMINISM_MODULES``: calls into the stdlib ``random`` module's
  global instance (``random.random()``, ``random.choice`` …), numpy's
  legacy global RNG (``np.random.rand`` …) and torch's global generator
  (``torch.randn(...)``, ``torch.multinomial(...)`` … without a
  ``generator=``) are findings. Explicitly seeded constructors
  (``random.Random(seed)``, ``np.random.default_rng(seed)``,
  ``np.random.Generator``, ``torch.Generator``), a torch draw given its
  ``generator=``, and ``jax.random.*`` (keyed) are fine.
- in ``WALLCLOCK_MODULES`` (the pure decode/sampling math, where no
  timing telemetry belongs at all): ``time.time`` / ``monotonic`` /
  ``perf_counter`` / ``datetime.now`` are findings too.
"""

from __future__ import annotations

import ast

from aigw_tpu_torch.analysis.core import Finding, Source, dotted_name
from aigw_tpu_torch.analysis.registry import AnalysisConfig

RULE = "determinism"

_SEEDED_OK = {"Random", "SystemRandom", "Generator", "default_rng",
              "PRNGKey", "key", "seed"}
_WALLCLOCK = {
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns",
    "datetime.now", "datetime.utcnow", "datetime.datetime.now",
    "datetime.datetime.utcnow",
}
#: torch draws that read the global generator unless given their own
_TORCH_DRAWS = {
    "rand", "randn", "randint", "rand_like", "randn_like", "randint_like",
    "randperm", "multinomial", "normal", "bernoulli", "poisson",
}


def _matches(rel: str, prefixes: tuple[str, ...]) -> bool:
    return any(rel == p or rel.startswith(p) for p in prefixes)


def _rng_finding(name: str, call: ast.Call) -> str | None:
    """Reason string when dotted call ``name`` is a global-RNG draw."""
    parts = name.split(".")
    if len(parts) < 2:
        return None
    if parts[0] == "jax":
        return None  # jax.random requires an explicit key: deterministic
    if parts[0] == "torch" and len(parts) == 2 \
            and parts[1] in _TORCH_DRAWS:
        if any(kw.arg == "generator" for kw in call.keywords):
            return None
        return (f"{name} draws from torch's global generator — pass a "
                "seeded torch.Generator (generator=) to keep f32 streams "
                "byte-identical")
    # stdlib: random.<fn>() on the module's hidden global instance
    if parts[-2] == "random" and parts[-1] not in _SEEDED_OK:
        head = ".".join(parts[:-1])
        if head in ("random", "np.random", "numpy.random"):
            return (f"{name} draws from the unseeded global RNG — "
                    "sampling must ride explicit keys (or an explicitly "
                    "seeded Generator) to keep f32 streams byte-identical")
    return None


def check(sources: list[Source], config: AnalysisConfig) -> list[Finding]:
    out: list[Finding] = []
    for src in sources:
        det = _matches(src.rel, config.determinism_modules)
        clock = _matches(src.rel, config.wallclock_modules)
        if not (det or clock):
            continue
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            if not name:
                continue
            if det:
                why = _rng_finding(name, node)
                if why is not None:
                    out.append(Finding(RULE, src.rel, node.lineno, why))
                    continue
            if clock and name in _WALLCLOCK:
                out.append(Finding(
                    RULE, src.rel, node.lineno,
                    f"wall-clock read {name} on the decode/sampling "
                    "path — nothing here may depend on time (f32 "
                    "byte-identity contract)"))
    return out
