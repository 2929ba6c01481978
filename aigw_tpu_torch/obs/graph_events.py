"""Captured-program accounting (counterpart of
``aigw_tpu/obs/xla_events.py``'s ``CompileTracker``).

The reference counts its compiled XLA programs: each registered jitted
callable's cache size is a family's program count, and the process-wide
compile events give ``xla_compiles`` / ``xla_compile_ms``. The port's
counterpart of a compiled program is a captured CUDA graph
(``tpuserve/programs.py``): one per program key, captured the first
time the key is seen. A family registers its key → program map here,
and every new program reports its build (``note_compile``): on CUDA the
capture and its wall ms; on the CPU, where a program runs its body
eagerly and captures nothing, the first call of the key with 0 ms.

The tracker is per engine, not process-wide: two engines in one
process never see each other's counts, so ``compiles_since`` is exact
for the engine it is asked about.
"""

from __future__ import annotations

import threading
from collections.abc import Sized
from typing import Any


class CompileTracker:
    """Per-engine program accounting over registered program families,
    with the reference's method names."""

    def __init__(self) -> None:
        self._fns: dict[str, Sized] = {}
        self._lock = threading.Lock()
        self._compiles = 0
        self._compile_ms = 0.0

    # -- registration -----------------------------------------------------
    def register(self, name: str, programs: Sized) -> Sized:
        """Track ``programs`` (a family's key → program map) under
        ``name``; returns it so registration composes at the creation
        site."""
        self._fns[name] = programs
        return programs

    def note_compile(self, ms: float) -> None:
        """One program built (a capture, or a CPU program's first
        call), taking ``ms`` of wall time."""
        with self._lock:
            self._compiles += 1
            self._compile_ms += ms

    # -- per-engine program view (the tripwire surface) -------------------
    def programs(self) -> dict[str, int]:
        """Registered program family → program count."""
        return {name: len(p) for name, p in list(self._fns.items())}

    def program_count(self) -> int:
        return sum(self.programs().values())

    # -- build events -----------------------------------------------------
    def compiles(self) -> int:
        """Programs built since this tracker was constructed."""
        return self._compiles

    def compiles_total_ms(self) -> float:
        return self._compile_ms

    # -- checkpoint/delta (warmup tripwires) ------------------------------
    def checkpoint(self) -> tuple[int, int]:
        return (self.program_count(), self._compiles)

    def compiles_since(self, cp: tuple[int, int]) -> int:
        """New programs across this engine's registered families since
        ``cp``: the zero-compile-after-warmup assertion."""
        return self.program_count() - cp[0]

    def snapshot(self) -> dict[str, Any]:
        return {
            "xla_compiles": self.compiles(),
            "xla_compile_ms": round(self.compiles_total_ms(), 3),
            "programs": self.programs(),
        }
