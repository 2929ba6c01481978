"""The invariant registry shared by the static checker and the runtime
sanitizer (the port's copy of ``aigw_tpu/analysis/registry.py``, its
tables pointed at the port's files).

One source of truth, two consumers:

- ``tools/torch_staticcheck.py`` (the AST passes under
  ``analysis/passes/``) reads the declarations here to know WHICH fields
  are engine-thread-only, WHICH CUDA graph captures happen outside the
  engine's program pool, and WHICH modules carry the determinism
  contract.
- ``@engine_thread_only`` is the runtime half of the thread-discipline
  rule: a no-op by default, and with ``AIGW_TSAN=1`` in the environment
  (the test suite sets it) every decorated method asserts it is running
  on the owning engine thread whenever that thread is live. The
  decorator itself is the static annotation — the ``engine-thread`` pass
  flags any guarded-field mutation in an undecorated method, so the two
  layers cannot drift apart.

This module must stay import-light (stdlib only): the engine imports
the decorator on its hot construction path.
"""

from __future__ import annotations

import functools
import os
import threading
from dataclasses import dataclass, field

#: Runtime sanitizer switch, read once at import. Tests set it in
#: tests/conftest.py before the package is imported; production leaves it
#: off and every decorated method is returned UNWRAPPED (zero cost).
TSAN = os.environ.get("AIGW_TSAN", "").lower() not in ("", "0", "false")


class EngineThreadViolation(AssertionError):
    """A method declared engine-thread-only ran on a foreign thread
    while the engine thread was live (the warm-up race class: a
    server-thread write published through state the engine loop was
    concurrently nulling)."""


def engine_thread_only(fn):
    """Declare a method engine-thread-only.

    Static contract: the ``engine-thread`` lint pass requires this
    decorator on every method that mutates a guarded field of a
    registered thread domain (see ``THREAD_DOMAINS``).

    Runtime contract (``AIGW_TSAN=1`` only): the call must run on the
    thread stored at ``self._thread`` whenever that thread is live.
    Calls before ``start()`` or after ``stop()``'s join (e.g.
    ``Engine.__init__`` → ``_refresh_stats``, ``stop()`` →
    ``_abort_all``) are allowed — the owning thread is dead, so there
    is nothing to race.
    """
    fn.__engine_thread_only__ = True
    if not TSAN:
        return fn

    @functools.wraps(fn)
    def guard(self, *args, **kwargs):
        t = getattr(self, "_thread", None)
        if (t is not None and t.is_alive()
                and threading.current_thread() is not t):
            raise EngineThreadViolation(
                f"{type(self).__name__}.{fn.__name__} called from thread "
                f"{threading.current_thread().name!r} while the engine "
                f"thread {t.name!r} is live")
        return fn(self, *args, **kwargs)

    guard.__engine_thread_only__ = True
    return guard


@dataclass(frozen=True)
class ThreadDomain:
    """One single-writer-thread class: which fields only its loop thread
    may mutate, and which methods ARE that loop."""

    path: str                       # repo-relative module path
    cls: str                        # class name inside that module
    thread_attr: str                # attribute holding the owning Thread
    #: the loop body itself (implicitly engine-thread, never decorated —
    #: decorating the target of threading.Thread would be circular)
    entry_methods: tuple[str, ...]
    #: methods allowed to mutate guarded fields WITHOUT the decorator
    #: (construction — the thread does not exist yet)
    allowed_methods: tuple[str, ...]
    guarded_fields: tuple[str, ...]


#: The serving stack's thread domains: the port's Engine, with the
#: reference's guarded set — the device-state swap (the warm-up race),
#: the slot table / window membership (stale membership after a drain),
#: the dirty-row ledgers that feed the on-device row scatters, and the
#: lock-free KV digest swap read by /state and the fleet fetch probe.
THREAD_DOMAINS: tuple[ThreadDomain, ...] = (
    ThreadDomain(
        path="aigw_tpu_torch/tpuserve/engine.py",
        cls="Engine",
        thread_attr="_thread",
        entry_methods=("_run",),
        allowed_methods=("__init__",),
        guarded_fields=(
            "_device_state",
            "_slots",
            "_reserved_slots",
            "_inflight",
            "_pending_frees",
            "_dirty_rows",
            "_spec_dirty",
            "_cn_dirty",
            "_need_rebuild",
            "_state_bucket",
            "_cur_window",
            "_steady_ticks",
            "_kv_digest",
            "_kv_digest_next",
            # parked batch sessions: preempted offline streams stashed
            # host-side between park and resume — both ends of that
            # lifecycle run on the engine loop
            "_parked_batch",
            # MoE routing accumulators: [E] / [L] arrays _fold_moe grows
            # from the programs' routing counts — folded at drain and
            # prefill settle, both engine-thread-only
            "_moe_expert_tokens",
            "_moe_layer_drops",
        ),
    ),
)


#: capture registry (rule ``capture-registry``, the counterpart of the
#: reference's jit surface): every CUDA graph capture inside the serving
#: modules must sit in a function that reports it to the engine's
#: ``CompileTracker`` (``note_compile``: the captures ``/state`` counts
#: as ``warm_programs`` and ``xla_compiles``) — today only the program
#: pool, ``tpuserve/programs.py``'s ``CapturedProgram._capture`` — OR be
#: declared here with the reason it is accounted for anyway. Keys are
#: ``<repo-relative path>::<qualified name>`` of the enclosing function;
#: stale keys are themselves lint errors, so a renamed function cannot
#: leave a dangling exemption behind.
CAPTURE_SURFACE: dict[str, str] = {}

#: module path prefixes the ``capture-registry`` pass scans — the
#: serving path; benchmarks and tools stay out of scope.
CAPTURE_SCOPE: tuple[str, ...] = (
    "aigw_tpu_torch/tpuserve/",
    "aigw_tpu_torch/ops/",
    "aigw_tpu_torch/models/",
    "aigw_tpu_torch/parallel/",
)

#: modules under the byte-identical f32-stream contract (rule
#: ``determinism``): no unseeded stdlib/numpy/torch global RNG here.
DETERMINISM_MODULES: tuple[str, ...] = (
    "aigw_tpu_torch/tpuserve/sampling.py",
    "aigw_tpu_torch/tpuserve/speculation.py",
    "aigw_tpu_torch/tpuserve/constrain.py",
    "aigw_tpu_torch/tpuserve/engine.py",
    "aigw_tpu_torch/ops/",
    "aigw_tpu_torch/models/",
)

#: the subset of DETERMINISM_MODULES where a wall-clock read is ALSO a
#: finding — pure decode/sampling math has no business reading time.
#: engine.py is excluded: its time reads feed stats/throttles, never
#: sampled values.
WALLCLOCK_MODULES: tuple[str, ...] = (
    "aigw_tpu_torch/tpuserve/sampling.py",
    "aigw_tpu_torch/tpuserve/speculation.py",
    "aigw_tpu_torch/tpuserve/constrain.py",
    "aigw_tpu_torch/ops/",
    "aigw_tpu_torch/models/",
)


@dataclass(frozen=True)
class AnalysisConfig:
    """Everything the passes need to know about the tree under check —
    the default instance describes the port; tests swap in fixture
    configs to seed violations."""

    thread_domains: tuple[ThreadDomain, ...] = THREAD_DOMAINS
    capture_scope: tuple[str, ...] = CAPTURE_SCOPE
    capture_surface: dict[str, str] = field(
        default_factory=lambda: dict(CAPTURE_SURFACE))
    determinism_modules: tuple[str, ...] = DETERMINISM_MODULES
    wallclock_modules: tuple[str, ...] = WALLCLOCK_MODULES
    #: module holding the /state payload + the method that builds it
    #: (the port's server answers /state from ``TPUServeServer.state``)
    state_server: str = "aigw_tpu_torch/tpuserve/server.py"
    state_handler: str = "state"
    #: module holding FleetState.rollup (FLEET_GAUGES twin)
    fleetstate_module: str = "aigw_tpu_torch/gateway/fleetstate.py"
    #: module holding UsageLedger.snapshot (USAGE_GAUGES twin)
    usage_module: str = "aigw_tpu_torch/gateway/usage.py"


DEFAULT_CONFIG = AnalysisConfig()
