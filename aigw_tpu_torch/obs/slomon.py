"""Live SLO burn-rate monitor — goodput accounting in the gateway.

The port's copy of ``aigw_tpu/obs/slomon.py``: goodput under the SLO
from cumulative server-side TTFT histogram bucket deltas, as a LIVE
monitor the gateway runs
against the histogram snapshots the endpoint picker already polls from
every replica's ``/state`` (``ttft_hist_buckets``):

- per sliding window of ``window_s`` seconds, the delta of the
  cumulative TTFT buckets gives ``served`` (requests finishing their
  TTFT in the window) and ``under`` (those landing in a bucket ≤ the
  SLO);
- ``goodput = under / served`` and the **error-budget burn rate**
  ``burn = (1 - goodput) / (1 - objective)`` — burn 1.0 means the
  replica consumes its error budget exactly as fast as the objective
  allows; burn > 1.0 means the budget is burning down;
- a **sustained-overshoot flag**: ``k_windows`` consecutive closed
  windows with burn > 1.0, the predicate an autoscaler consumes —
  computed from measured TTFTs, not predictions, so a
  mispredicting model can't silently scale the fleet.

Server-side by construction: requests the gateway shed with 429 never
reach a replica histogram, so a fully-shedding pool shows *empty*
windows (no served traffic), which clear the overshoot streak — the
shed volume itself is visible on ``aigw_slo_sheds_total``.

Counter resets (replica restart) make bucket deltas negative; the
monitor detects that, re-anchors, and skips the torn window instead of
reporting nonsense. Windows with no observations are skipped too (an
idle replica is not overshooting). Pure bookkeeping, no I/O.
"""

from __future__ import annotations

import collections
import re
import time
from typing import Any, Iterable

#: default TTFT SLO when the backend configures none (slo_ttft_ms = 0):
#: the monitor still reports goodput against something sane rather than
#: staying dark until an operator sets a budget
DEFAULT_SLO_MS = 500.0


def parse_hist_buckets(text: str, name: str) -> dict[str, int]:
    """Cumulative bucket counts of one Prometheus histogram family from
    /metrics exposition text: ``{le: cumulative_count}``. Tolerates the
    OpenMetrics exemplar suffix tpuserve renders on bucket lines AND
    extra labels (the fleet federation endpoint adds ``replica=...``):
    counts from multiple label sets sum per ``le`` — for a replica-
    labeled fleet scrape that sum IS the fleet histogram."""
    out: dict[str, int] = {}
    for m in re.finditer(
            rf'^{re.escape(name)}_bucket{{([^}}]*)}}\s+(\d+)',
            text, re.M):
        le = re.search(r'le="([^"]+)"', m.group(1))
        if le is None:
            continue
        out[le.group(1)] = out.get(le.group(1), 0) + int(m.group(2))
    return out


def under_slo_count(buckets: dict[str, int], slo_ms: float) -> int:
    """Cumulative count of observations in the largest bucket whose
    upper bound is ≤ the SLO — the ``under`` side of goodput."""
    best = -1.0
    val = 0
    for le, c in buckets.items():
        if le == "+Inf":
            continue
        f = float(le)
        if f <= slo_ms and f >= best:
            best, val = f, int(c)
    return val


def total_count(buckets: dict[str, int]) -> int:
    return int(buckets.get("+Inf", 0))


def sum_buckets(many: Iterable[dict]) -> dict[str, int]:
    """Per-le sum of several cumulative bucket dicts (fleet roll-up of
    per-replica histograms; valid because every replica renders the
    same PHASE_BUCKETS_MS ladder)."""
    out: dict[str, int] = {}
    for h in many:
        for le, c in (h or {}).items():
            out[le] = out.get(le, 0) + int(c)
    return out


class _KeyState:
    __slots__ = ("anchor_ts", "anchor", "windows", "over_streak")

    def __init__(self) -> None:
        self.anchor_ts: float | None = None
        self.anchor: dict[str, int] = {}
        # closed windows, oldest→newest, bounded
        self.windows: collections.deque = collections.deque(maxlen=16)
        self.over_streak = 0


class SLOMonitor:
    """Sliding-window goodput + burn rate per key (one key per replica,
    plus the caller's synthetic fleet key). Fed by the picker's poll
    loop via :meth:`observe`; read by ``/fleet/state`` and the fleet
    gauges via :meth:`snapshot`."""

    #: synthetic key the fleet-wide sum is observed under
    FLEET_KEY = "~fleet"

    def __init__(self, slo_ms: float = 0.0, objective: float = 0.95,
                 window_s: float = 30.0, k_windows: int = 3):
        if not 0.0 < objective < 1.0:
            raise ValueError(
                f"slo objective must be in (0, 1) (got {objective})")
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0 (got {window_s})")
        self.slo_ms = float(slo_ms) if slo_ms > 0 else DEFAULT_SLO_MS
        self.objective = objective
        self.window_s = float(window_s)
        self.k_windows = max(1, int(k_windows))
        self._keys: dict[str, _KeyState] = {}

    # -- write side -------------------------------------------------------
    def observe(self, key: str, cum_buckets: dict[str, int],
                ts: float | None = None) -> None:
        """One polled cumulative-bucket snapshot for ``key``. Closes the
        current window when it has aged past ``window_s``."""
        now = time.monotonic() if ts is None else ts
        st = self._keys.setdefault(key, _KeyState())
        if st.anchor_ts is None:
            st.anchor_ts, st.anchor = now, dict(cum_buckets)
            return
        if now - st.anchor_ts < self.window_s:
            return
        served = total_count(cum_buckets) - total_count(st.anchor)
        under = (under_slo_count(cum_buckets, self.slo_ms)
                 - under_slo_count(st.anchor, self.slo_ms))
        if served < 0 or under < 0 or under > served:
            # counter reset (replica restart) tore the delta: re-anchor
            # and skip the window rather than report garbage
            st.anchor_ts, st.anchor = now, dict(cum_buckets)
            return
        if served == 0:
            # idle window: no traffic is not an overshoot — clear the
            # streak (a sustained flag must mean sustained BAD service,
            # not stale history) and slide the anchor
            st.over_streak = 0
            st.anchor_ts, st.anchor = now, dict(cum_buckets)
            return
        goodput = under / served
        burn = (1.0 - goodput) / max(1e-9, 1.0 - self.objective)
        st.windows.append({
            "t0": round(st.anchor_ts, 3),
            "t1": round(now, 3),
            "served": served,
            "under_slo": under,
            "goodput": round(goodput, 4),
            "burn_rate": round(burn, 4),
        })
        st.over_streak = st.over_streak + 1 if burn > 1.0 else 0
        st.anchor_ts, st.anchor = now, dict(cum_buckets)

    def forget(self, key: str) -> None:
        """Drop a dead replica's window state (its counters restart from
        zero when it comes back)."""
        self._keys.pop(key, None)

    # -- read side --------------------------------------------------------
    def sustained(self, key: str) -> bool:
        """True when the last ``k_windows`` closed windows ALL burned
        error budget faster than the objective allows — the autoscale /
        health-degrade predicate."""
        st = self._keys.get(key)
        return st is not None and st.over_streak >= self.k_windows

    def snapshot(self, key: str) -> dict[str, Any]:
        """Current monitor view for one key: the latest closed window's
        goodput/burn (-1.0 = no closed window yet), recent windows, and
        the sustained flag."""
        st = self._keys.get(key)
        last = st.windows[-1] if st is not None and st.windows else None
        return {
            "slo_ms": self.slo_ms,
            "objective": self.objective,
            "window_s": self.window_s,
            "k_windows": self.k_windows,
            "goodput": last["goodput"] if last else -1.0,
            "burn_rate": last["burn_rate"] if last else -1.0,
            "over_budget_streak": st.over_streak if st is not None else 0,
            "sustained_overshoot": self.sustained(key),
            "windows": list(st.windows) if st is not None else [],
        }

    def keys(self) -> list[str]:
        return [k for k in self._keys if k != self.FLEET_KEY]
