"""Gateway-side fleet observability plane.

PRs 8–11 made the system a *fleet* — SLO routing, mid-stream migration,
cross-replica KV fetch — whose behavior was still only visible one
replica ``/state`` at a time. This module is the one-pane-of-glass
aggregation layer, fed by the endpoint picker's existing ``_poll_one``
loop (no new polling traffic):

- :class:`ReplicaHealth` — a per-replica health state machine
  (``up / degraded / draining / down``) with hysteresis over consecutive
  poll failures and sustained SLO overshoot, every transition recorded
  with its timestamp in a bounded event ring;
- :class:`FleetState` — per-backend aggregation: health map, last-good
  replica telemetry, fleet rollups (slots, worst/mean KV occupancy,
  worst device-memory fraction, spill/fetch/migration totals, resident
  adapter union) and the :class:`~aigw_tpu_torch.obs.slomon.SLOMonitor` feed;
- :class:`DecisionRing` — the routing-decision audit ring behind
  ``GET /debug/decisions``: every ``pick(explain=)`` dict in full
  (candidates, scores, predicted-TTFT map, affinity terms, shed events
  with Retry-After, migration triggers), keyed by the replica's
  ``x-aigw-request-id`` so a gateway decision joins the tpuserve
  flight-recorder timeline;
- :func:`relabel_exposition` — the Prometheus federation rewriter
  behind ``GET /fleet/metrics``: every replica's ``tpuserve_*`` samples
  re-exported with a ``replica`` label (the DEVICE_GAUGES labeled-render
  pattern, applied fleet-wide) so ONE scrape covers the
  whole fleet.

Pure bookkeeping — no I/O, event-loop-confined like the picker state it
aggregates (DecisionRing appends are GIL-atomic deque ops).
"""

from __future__ import annotations

import collections
import re
import time
from typing import Any

from aigw_tpu_torch.obs.slomon import SLOMonitor, sum_buckets

#: health states, in degradation order
UP = "up"
DEGRADED = "degraded"
DRAINING = "draining"
DOWN = "down"
UNKNOWN = "unknown"


class ReplicaHealth:
    """Health state machine for one replica, driven by poll outcomes.

    Hysteresis, both directions: the FIRST failed poll only degrades
    (one dropped packet must not fail a replica out of the pool),
    ``FAILURES_DOWN`` consecutive failures mark it down, and a down
    replica needs ``RECOVERY_POLLS`` consecutive good polls before it
    is trusted up again (a replica flapping through restart must not
    oscillate the fleet view every poll). ``draining`` is an operator /
    control-plane overlay for a lossless drain: polls
    still succeed, the state machine reports DRAINING until released.
    Sustained SLO overshoot (the slomon predicate) degrades a replica
    that answers every poll but is burning its error budget.
    """

    FAILURES_DOWN = 3
    RECOVERY_POLLS = 2
    EVENTS_MAX = 32

    __slots__ = ("state", "since", "failures", "successes", "draining",
                 "replica_id", "events", "breaker_open")

    def __init__(self) -> None:
        self.state = UNKNOWN
        self.since = time.time()
        self.failures = 0    # consecutive failed polls
        self.successes = 0   # consecutive good polls
        self.draining = False
        self.replica_id = ""  # identity from /state; change = restart
        # circuit-breaker overlay: the gateway's per-replica
        # breaker feeds its open/close transitions here so the fleet
        # view and the breaker can never disagree about a replica that
        # answers /state polls but fails every request
        self.breaker_open = False
        self.events: collections.deque = collections.deque(
            maxlen=self.EVENTS_MAX)

    def _to(self, new: str, reason: str) -> None:
        if new == self.state:
            return
        self.events.append({
            "ts": round(time.time(), 3),
            "from": self.state,
            "to": new,
            "reason": reason,
        })
        self.state = new
        self.since = time.time()

    def note_success(self, replica_id: str = "",
                     slo_overshoot: bool = False) -> None:
        self.failures = 0
        self.successes += 1
        if replica_id and self.replica_id and replica_id != self.replica_id:
            # same address, new process: record the restart in the ring
            # (counters reset; the slomon anchor guard handles deltas)
            self.events.append({
                "ts": round(time.time(), 3),
                "event": "restart",
                "old_replica_id": self.replica_id,
                "new_replica_id": replica_id,
            })
        if replica_id:
            self.replica_id = replica_id
        if self.state == DOWN and self.successes < self.RECOVERY_POLLS:
            return  # one good poll doesn't resurrect a down replica
        if self.draining:
            self._to(DRAINING, "drain_requested")
        elif slo_overshoot:
            self._to(DEGRADED, "slo_overshoot_sustained")
        else:
            self._to(UP, "poll_ok")

    def note_failure(self) -> None:
        self.successes = 0
        self.failures += 1
        if self.failures >= self.FAILURES_DOWN:
            self._to(DOWN, f"poll_failures={self.failures}")
        elif self.state != DOWN:
            self._to(DEGRADED, f"poll_failures={self.failures}")

    def set_draining(self, on: bool = True) -> None:
        self.draining = on
        if on and self.state not in (DOWN,):
            self._to(DRAINING, "drain_requested")
        # released: the next successful poll restores up/degraded

    def note_breaker(self, opened: bool, failures: int = 0) -> None:
        """Circuit-breaker transition for this replica: the open/close
        lands in the same event ring as health transitions, and the
        ``breaker_open`` flag joins the picker's merged routability
        view (a breaker-open replica is never scored healthy)."""
        if opened == self.breaker_open:
            return
        self.breaker_open = opened
        self.events.append({
            "ts": round(time.time(), 3),
            "event": "breaker_open" if opened else "breaker_closed",
            "consecutive_failures": failures,
        })

    def to_dict(self) -> dict[str, Any]:
        return {
            "state": self.state,
            "since": round(self.since, 3),
            "consecutive_failures": self.failures,
            "draining": self.draining,
            "breaker_open": self.breaker_open,
            "replica_id": self.replica_id,
            "events": list(self.events),
        }


class FleetState:
    """Per-backend fleet aggregation, fed by the picker's poll loop."""

    def __init__(self, slomon: SLOMonitor | None = None):
        self.slomon = slomon
        self.health: dict[str, ReplicaHealth] = {}
        # last successfully polled /state payload per replica — the
        # rollup's counter source (kept across failures so a flapping
        # replica's totals don't flicker to zero)
        self.last_state: dict[str, dict] = {}
        # latest cumulative TTFT buckets per live replica (fleet sum)
        self._cum: dict[str, dict] = {}

    # -- write side (the picker's _poll_one) ------------------------------
    def note_poll(self, addr: str, ok: bool,
                  data: dict | None = None,
                  ts: float | None = None) -> None:
        h = self.health.setdefault(addr, ReplicaHealth())
        if not ok:
            h.note_failure()
            if h.state == DOWN:
                # its cumulative counters will restart from zero; drop
                # the fleet-sum contribution and the window anchors
                self._cum.pop(addr, None)
                if self.slomon is not None:
                    self.slomon.forget(addr)
            return
        data = data or {}
        overshoot = False
        if self.slomon is not None:
            buckets = data.get("ttft_hist_buckets") or {}
            if isinstance(buckets, dict) and buckets:
                self.slomon.observe(addr, buckets, ts)
                self._cum[addr] = dict(buckets)
                self.slomon.observe(SLOMonitor.FLEET_KEY,
                                    sum_buckets(self._cum.values()), ts)
            overshoot = self.slomon.sustained(addr)
        h.note_success(replica_id=str(data.get("replica_id", "") or ""),
                       slo_overshoot=overshoot)
        if bool(data.get("draining", False)) != h.draining:
            # a replica may announce its own drain on /state (the
            # control-plane overlay)
            h.set_draining(bool(data.get("draining", False)))
        if data:
            self.last_state[addr] = data

    def mark_draining(self, addr: str, on: bool = True) -> None:
        self.health.setdefault(addr, ReplicaHealth()).set_draining(on)

    def mark_breaker(self, addr: str, opened: bool,
                     failures: int = 0) -> None:
        """Circuit-breaker transition feed (unification)."""
        self.health.setdefault(addr, ReplicaHealth()).note_breaker(
            opened, failures)

    def forget(self, addr: str) -> None:
        """Drop a retired replica entirely (controller scale-in): its
        health machine, cached telemetry, and SLO windows — the replica
        is gone on purpose, not flapping."""
        self.health.pop(addr, None)
        self.last_state.pop(addr, None)
        self._cum.pop(addr, None)
        if self.slomon is not None:
            self.slomon.forget(addr)

    # -- read side --------------------------------------------------------
    def health_of(self, addr: str) -> str:
        h = self.health.get(addr)
        return h.state if h is not None else UNKNOWN

    def rollup(self, picker_state: dict[str, Any]) -> dict[str, Any]:
        """Fleet rollups over the replicas this aggregator has seen.
        Keys track ``FLEET_GAUGES`` (obs/metrics.py) — the drift smoke
        asserts the two sides agree, and the ``gauge-drift`` lint pass
        checks every FLEET_GAUGES key against this dict's literal keys
        at analysis time (make lint), so keep the return a literal."""
        counts = {UP: 0, DEGRADED: 0, DRAINING: 0, DOWN: 0, UNKNOWN: 0}
        for addr in picker_state:
            counts[self.health_of(addr)] += 1
        serving = [addr for addr in picker_state
                   if self.health_of(addr) in (UP, DEGRADED, DRAINING)]
        occs = []
        slots_total = slots_free = queued = 0
        hbm_worst = 0.0
        for addr in serving:
            st = picker_state[addr]
            occs.append(float(st.worst_kv_occupancy()
                              if hasattr(st, "worst_kv_occupancy")
                              else getattr(st, "kv_occupancy", 0.0)))
            slots_total += int(getattr(st, "max_slots", 0))
            slots_free += max(0, int(getattr(st, "max_slots", 0))
                              - int(getattr(st, "active_slots", 0)))
            queued += int(getattr(st, "queued", 0))
            hbm_worst = max(hbm_worst,
                            float(st.worst_hbm_frac()
                                  if hasattr(st, "worst_hbm_frac")
                                  else 0.0))

        def csum(key: str) -> int:
            return sum(int(d.get(key, 0) or 0)
                       for d in self.last_state.values())

        adapters: set[str] = set()
        for d in self.last_state.values():
            adapters.update(str(a) for a in
                            (d.get("adapters_resident") or ()))
        slo = (self.slomon.snapshot(SLOMonitor.FLEET_KEY)
               if self.slomon is not None else {})
        return {
            "replicas_total": len(picker_state),
            "replicas_up": counts[UP],
            "replicas_degraded": counts[DEGRADED],
            "replicas_draining": counts[DRAINING],
            "replicas_down": counts[DOWN],
            "slots_total": slots_total,
            "slots_free": slots_free,
            "queued_total": queued,
            "kv_occupancy_worst": round(max(occs, default=0.0), 4),
            "kv_occupancy_mean": round(
                sum(occs) / len(occs), 4) if occs else 0.0,
            "device_memory_frac_worst": round(hbm_worst, 4),
            "kv_spills_total": csum("kv_spills"),
            "kv_revives_total": csum("kv_revives"),
            "kv_fetch_pages_in_total": csum("kv_fetch_pages_in"),
            "kv_fetch_pages_out_total": csum("kv_fetch_pages_out"),
            "migrations_in_total": csum("migrations_in"),
            "migrations_out_total": csum("migrations_out"),
            "adapters_resident": len(adapters),
            "slo_goodput": slo.get("goodput", -1.0),
            "slo_burn_rate": slo.get("burn_rate", -1.0),
            "slo_overshoot_sustained": int(
                bool(slo.get("sustained_overshoot", False))),
        }

    def snapshot(self, picker_state: dict[str, Any]) -> dict[str, Any]:
        """The per-backend half of ``GET /fleet/state``: every replica
        with its health, staleness stamps, key gauges, and burn-rate
        view, plus the fleet rollup and the fleet-wide SLO window."""
        now = time.monotonic()
        replicas: dict[str, Any] = {}
        for addr, st in picker_state.items():
            h = self.health.setdefault(addr, ReplicaHealth())
            last = self.last_state.get(addr, {})
            ok_ts = float(getattr(st, "last_poll_ok_ts", 0.0) or 0.0)
            entry = {
                "health": h.to_dict(),
                "healthy": bool(getattr(st, "healthy", False)),
                # staleness stamp: seconds since the last GOOD poll
                # (-1 = never polled successfully) — consumers must
                # treat stale numbers as history, not current truth
                "staleness_s": (round(max(0.0, now - ok_ts), 3)
                                if ok_ts else -1.0),
                "poll_failures": int(
                    getattr(st, "poll_failures", 0) or 0),
                "replica_id": str(getattr(st, "replica_id", "") or ""),
                "uptime_s": float(getattr(st, "uptime_s", 0.0) or 0.0),
                "model": str(getattr(st, "model", "") or ""),
                "queued": int(getattr(st, "queued", 0)),
                "active_slots": int(getattr(st, "active_slots", 0)),
                "max_slots": int(getattr(st, "max_slots", 0)),
                "queue_wait_ms": float(
                    getattr(st, "queue_wait_ms", 0.0)),
                "kv_occupancy": float(
                    st.worst_kv_occupancy()
                    if hasattr(st, "worst_kv_occupancy")
                    else getattr(st, "kv_occupancy", 0.0)),
                "device_memory_frac_worst": float(
                    st.worst_hbm_frac()
                    if hasattr(st, "worst_hbm_frac") else 0.0),
                "migratable_slots": int(
                    getattr(st, "migratable_slots", 0)),
                # priority-tiered serving: the offline
                # class's per-replica footprint — fleetwatch's batch
                # columns and the controller's retire-drain read these
                "batch_queued": int(getattr(st, "batch_queued", 0)),
                "batch_active": int(getattr(st, "batch_active", 0)),
                "batch_preemptions": int(
                    getattr(st, "batch_preemptions", 0)),
                "adapters_resident": sorted(
                    getattr(st, "adapters_resident", ()) or ()),
                "kv_spills": int(last.get("kv_spills", 0) or 0),
                "kv_fetch_pages_in": int(
                    last.get("kv_fetch_pages_in", 0) or 0),
                "kv_fetch_pages_out": int(
                    last.get("kv_fetch_pages_out", 0) or 0),
                "migrations_in": int(last.get("migrations_in", 0) or 0),
                "migrations_out": int(
                    last.get("migrations_out", 0) or 0),
            }
            if self.slomon is not None:
                entry["slo"] = self.slomon.snapshot(addr)
            replicas[addr] = entry
        out: dict[str, Any] = {
            "replicas": replicas,
            "rollup": self.rollup(picker_state),
        }
        if self.slomon is not None:
            out["slo"] = self.slomon.snapshot(SLOMonitor.FLEET_KEY)
        return out


def merge_rollups(rollups: list[dict]) -> dict[str, Any]:
    """Cross-backend fleet rollup for the top-level ``fleet`` block:
    counters and counts sum, ``*_worst`` take the max, means weight by
    replica count, the SLO fields follow the worst-burning backend."""
    if not rollups:
        return {}
    if len(rollups) == 1:
        return dict(rollups[0])
    out: dict[str, Any] = {}
    n_total = sum(r.get("replicas_total", 0) for r in rollups) or 1
    for key in rollups[0]:
        vals = [r.get(key, 0) for r in rollups]
        if key.endswith("_worst"):
            out[key] = max(vals)
        elif key == "kv_occupancy_mean":
            out[key] = round(sum(
                r.get(key, 0.0) * r.get("replicas_total", 0)
                for r in rollups) / n_total, 4)
        elif key in ("slo_goodput", "slo_burn_rate"):
            # the fleet is as healthy as its worst-burning backend
            burns = [(r.get("slo_burn_rate", -1.0), r) for r in rollups]
            worst = max(burns, key=lambda t: t[0])[1]
            out[key] = worst.get(key, -1.0)
        elif key == "slo_overshoot_sustained":
            out[key] = int(any(r.get(key, 0) for r in rollups))
        else:
            out[key] = sum(vals)
    return out


class DecisionRing:
    """Bounded ring of routing decisions — the gateway's answer to the
    tpuserve flight recorder. One entry per pick (routed OR shed),
    carrying the full ``pick(explain=)`` dict; the upstream request id
    (``x-aigw-request-id``) is attached once the replica responds, and
    a migration stamps the entry mid-stream — entries are mutable dicts
    precisely so the decision's afterlife lands on the decision."""

    def __init__(self, capacity: int = 512):
        self.capacity = max(1, capacity)
        self._ring: collections.deque = collections.deque(
            maxlen=self.capacity)
        self._recorded = 0

    def record(self, **fields: Any) -> dict[str, Any]:
        entry = {"ts": round(time.time(), 3), **fields}
        self._ring.append(entry)
        self._recorded += 1
        return entry

    def snapshot(self, rid: str = "", limit: int = 100) -> list[dict]:
        """Newest-first decisions; ``rid`` filters by the upstream
        request id (the flight-recorder join key) or the client's
        x-request-id."""
        out = []
        for e in reversed(self._ring):
            if rid and rid not in (e.get("upstream_request_id", ""),
                                   e.get("request_id", "")):
                continue
            out.append(e)
            if len(out) >= limit:
                break
        return out

    @property
    def recorded(self) -> int:
        return self._recorded

    def __len__(self) -> int:
        return len(self._ring)


#: sample-line shape: name, optional {labels}, rest (value + optional
#: OpenMetrics exemplar suffix — preserved verbatim)
_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{([^}]*)\})?( .*)$')


def relabel_exposition(text: str, replica: str,
                       seen_families: set | None = None,
                       keep_prefixes: tuple = ("tpuserve_",)) -> str:
    """Rewrite one replica's /metrics exposition for fleet federation:
    keep only families matching ``keep_prefixes`` and inject a
    ``replica="addr"`` label into every sample (first position, ahead
    of existing labels like ``device=`` or ``le=``). ``seen_families``
    dedupes ``# TYPE``/``# HELP`` header lines across replicas so the
    concatenated scrape stays a valid exposition."""
    out: list[str] = []
    esc = replica.replace("\\", r"\\").replace('"', r'\"')
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 3 and parts[1] in ("TYPE", "HELP"):
                fam = parts[2]
                if not fam.startswith(keep_prefixes):
                    continue
                if seen_families is not None:
                    if fam in seen_families:
                        continue
                    seen_families.add(fam)
                out.append(line)
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        name, labels, rest = m.groups()
        if not name.startswith(keep_prefixes):
            continue
        merged = f'replica="{esc}"' + (f",{labels}" if labels else "")
        out.append(f"{name}{{{merged}}}{rest}")
    return "\n".join(out) + ("\n" if out else "")
