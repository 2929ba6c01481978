"""Per-backend circuit breaker (Envoy outlier-detection parity; the
port's copy of ``aigw_tpu/gateway/circuit.py`` with an injectable clock).

The reference data plane gets passive health checking from Envoy (outlier
ejection on consecutive 5xx, reference cluster config); natively: after
``threshold`` consecutive failures a backend's circuit opens for
``cooldown`` seconds and the selector skips it, except when every
candidate is open (fail-static: better to try a suspect backend than to
reject outright). Any success closes the circuit.

Unified with the fleet health machine: the gateway keys the
same breaker by replica address for picked endpoints, installs an
``on_transition`` hook that lands every open/close in the fleet event
ring, and the endpoint picker consults ``is_open`` through its merged
routability view — a breaker-open replica can no longer be scored
healthy just because its /state polls still answer.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable


@dataclass
class _State:
    consecutive_failures: int = 0
    open_until: float = 0.0
    #: whether the last recorded transition was an open (so close events
    #: fire once, not on every success)
    open_recorded: bool = False


#: transition hook signature: (key, opened, consecutive_failures)
TransitionHook = Callable[[str, bool, int], None]


class CircuitBreaker:
    def __init__(self, threshold: int = 5, cooldown: float = 15.0,
                 on_transition: TransitionHook | None = None,
                 clock: Callable[[], float] = time.monotonic):
        """``clock``: the monotonic clock the cooldown runs on (a test
        steps its own)."""
        self.threshold = threshold
        self.clock = clock
        self.cooldown = cooldown
        #: called on every open/close transition — the gateway wires it
        #: into the fleet event rings; exceptions are the caller's bug
        #: (the hook must be non-raising bookkeeping)
        self.on_transition = on_transition
        self._states: dict[str, _State] = {}

    def _state(self, backend: str) -> _State:
        st = self._states.get(backend)
        if st is None:
            st = _State()
            self._states[backend] = st
        return st

    def record_success(self, backend: str) -> None:
        st = self._state(backend)
        st.consecutive_failures = 0
        st.open_until = 0.0
        if st.open_recorded:
            st.open_recorded = False
            if self.on_transition is not None:
                self.on_transition(backend, False, 0)

    def record_failure(self, backend: str, now: float | None = None) -> None:
        now = self.clock() if now is None else now
        st = self._state(backend)
        st.consecutive_failures += 1
        if st.consecutive_failures >= self.threshold:
            st.open_until = now + self.cooldown
            if not st.open_recorded:
                st.open_recorded = True
                if self.on_transition is not None:
                    self.on_transition(backend, True,
                                       st.consecutive_failures)

    def is_open(self, backend: str, now: float | None = None) -> bool:
        now = self.clock() if now is None else now
        st = self._states.get(backend)
        return st is not None and now < st.open_until

    def snapshot(self) -> dict[str, dict]:
        now = self.clock()
        return {
            name: {
                "consecutive_failures": st.consecutive_failures,
                "open_for_s": max(0.0, round(st.open_until - now, 1)),
            }
            for name, st in self._states.items()
            if st.consecutive_failures or st.open_until > now
        }
