"""Engine-truth usage metering ledger.

The gateway folds every finished request's
``MeterRecord`` (the engine-emitted truth riding ``usage.aigw_meter``)
into windowed per-tenant/per-model ledgers, with

- **crash-safe JSONL journaling**: one flushed line per record; replay
  reconstructs the exact totals and tolerates a torn final line (the
  only thing a crash mid-append can produce);
- **exact reconciliation by construction**: token counts are ints, and
  the page·byte·second residency floats are accumulated in integer
  MICRO units (the MeterRecord rounds them to 6 decimals, so micros
  are exact) — sums are associative/commutative and the ledger's
  totals equal the engine's ``meter_*`` /state counters token for
  token regardless of arrival order;
- **slomon-style budget burn**: per tenant, ``burn = window_cost /
  budget`` over the ledger's closed windows, with a K-consecutive-
  windows sustained flag (idle gaps clear the streak, exactly like the
  SLO monitor — sustained must mean sustained SPEND, not stale
  history).

The ``snapshot()`` literal dict is the ``USAGE_GAUGES`` twin
(obs/metrics.py).

Pure bookkeeping plus an append-only file handle; no event-loop I/O
(callers journal from the request path — a single ``write`` + ``flush``
of one short line).
"""

from __future__ import annotations

import collections
import json
import time
from typing import Any, TextIO

from aigw_tpu_torch.gateway.costs import TokenUsage

#: integer fields of one ledger window / journal line (summed exactly)
INT_FIELDS: tuple[str, ...] = (
    "records",
    "prefill_tokens",
    "prefill_padded_tokens",
    "prefix_reused_tokens",
    "decode_tokens",
    "spec_drafted",
    "spec_accepted",
    "cost",
)

#: residency fields: journal lines carry the 6-decimal floats the
#: MeterRecord rounds to; windows accumulate them as exact micro ints
#: (``*_u`` keys) so merge order can never change a total
FLOAT_FIELDS: tuple[str, ...] = ("hbm_page_byte_s", "host_page_byte_s")

_MICRO = 1_000_000


def _micros(v: Any) -> int:
    try:
        return int(round(float(v) * _MICRO))
    except (TypeError, ValueError):
        return 0


def _unmicros(u: int) -> float:
    return round(u / _MICRO, 6)


def zero_window(t0: float = 0.0, t1: float = 0.0) -> dict:
    """An empty ledger window — the merge identity."""
    w: dict[str, Any] = {"t0": round(t0, 3), "t1": round(t1, 3)}
    for f in INT_FIELDS:
        w[f] = 0
    for f in FLOAT_FIELDS:
        w[f + "_u"] = 0
    return w


def merge_windows(a: dict, b: dict) -> dict:
    """Field-wise sum of two windows; the time span is the union.

    Associative AND commutative (the property test asserts both): every
    summed field is an int — token counts natively, residency in micro
    page·byte·seconds — so float rounding can never make grouping
    matter."""
    t0s = [t for t in (a.get("t0", 0.0), b.get("t0", 0.0)) if t]
    out: dict[str, Any] = {
        "t0": min(t0s) if t0s else 0.0,
        "t1": max(a.get("t1", 0.0), b.get("t1", 0.0)),
    }
    for f in INT_FIELDS:
        out[f] = int(a.get(f, 0)) + int(b.get(f, 0))
    for f in FLOAT_FIELDS:
        k = f + "_u"
        out[k] = int(a.get(k, 0)) + int(b.get(k, 0))
    return out


def window_view(w: dict) -> dict:
    """External view of a window: micro ints rendered back to the
    6-decimal floats the MeterRecord speaks."""
    out = {k: v for k, v in w.items() if not k.endswith("_u")}
    for f in FLOAT_FIELDS:
        out[f] = _unmicros(int(w.get(f + "_u", 0)))
    return out


def line_from(tenant: str, model: str, usage: TokenUsage, cost: int = 0,
              ts: float | None = None) -> dict:
    """One journal line from a finished request.

    With an engine MeterRecord on the usage, every field is engine
    truth; provider backends (no meter) degrade to the mined token
    counts so external traffic still lands in the ledger."""
    m = dict(usage.meter)
    if m:
        prefill = int(m.get("prefill_real", 0) or 0)
        decode = int(m.get("decode_tokens", 0) or 0)
    else:
        prefill = usage.input_tokens
        decode = usage.output_tokens
    return {
        "ts": round(time.time() if ts is None else ts, 3),
        "tenant": tenant,
        "model": model,
        "records": 1,
        "prefill_tokens": prefill,
        "prefill_padded_tokens": int(m.get("prefill_padded", 0) or 0),
        "prefix_reused_tokens": int(m.get("prefix_reused", 0) or 0),
        "decode_tokens": decode,
        "spec_drafted": int(m.get("spec_drafted", 0) or 0),
        "spec_accepted": int(m.get("spec_accepted", 0) or 0),
        "hbm_page_byte_s": round(float(m.get("hbm_page_byte_s", 0.0) or 0.0), 6),
        "host_page_byte_s": round(float(m.get("host_page_byte_s", 0.0) or 0.0), 6),
        "cost": int(cost),
    }


def reconciles(usage: TokenUsage) -> bool:
    """Meter ↔ mined-usage agreement for one response.

    The engine's ``decode_tokens`` counts every token it GENERATED,
    including a consumed stop token the stream never emitted — so the
    mined ``output_tokens`` must sit within one stop token per stream
    segment of the engine count. Responses without a meter (provider
    backends) vacuously reconcile."""
    m = dict(usage.meter)
    if not m:
        return True
    decode = int(m.get("decode_tokens", 0) or 0)
    slack = max(1, int(m.get("segments", 1) or 1))
    return usage.output_tokens <= decode <= usage.output_tokens + slack


class _BurnState:
    __slots__ = ("streak", "burn", "over")

    def __init__(self) -> None:
        self.streak = 0
        self.burn = 0.0
        self.over = False


class UsageLedger:
    """Windowed per-tenant/per-model usage + cost ledger.

    Records fold into the open window of their ``(tenant, model)`` key
    (window index = ``ts // window_s``); a record landing in a later
    window closes the stale one into a bounded ring. A parallel
    per-tenant window stream drives the budget burn machine."""

    def __init__(self, path: str | None = None, *,
                 window_s: float = 60.0, retain_windows: int = 64,
                 budgets: dict[str, float] | None = None,
                 burn_windows: int = 3):
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0 (got {window_s})")
        self.window_s = float(window_s)
        self.burn_windows = max(1, int(burn_windows))
        self.budgets: dict[str, float] = {
            str(k): float(v) for k, v in (budgets or {}).items()}
        self.path = path or None
        self._fh: TextIO | None = None
        #: (tenant, model) → (window index, open window)
        self._open: dict[tuple[str, str], tuple[int, dict]] = {}
        #: closed windows, oldest → newest, each stamped tenant/model
        self._closed: collections.deque = collections.deque(
            maxlen=max(1, int(retain_windows)))
        #: per-tenant cross-model window stream for the burn machine
        self._tenant_open: dict[str, tuple[int, dict]] = {}
        self._burn: dict[str, _BurnState] = {}
        self._totals = zero_window()
        self._tenants: set[str] = set()
        self.windows_closed = 0
        self.journal_lines = 0
        self.reconcile_mismatches = 0

    # -- journal ----------------------------------------------------------
    @classmethod
    def replay(cls, path: str, **kwargs: Any) -> "UsageLedger":
        """Rebuild a ledger from its JSONL journal, then keep appending
        to the same file. A torn final line (crash mid-append) stops the
        replay at the last complete record — exactly what was durable."""
        led = cls(path=None, **kwargs)
        try:
            with open(path, "r", encoding="utf-8") as fh:
                for raw in fh:
                    raw = raw.strip()
                    if not raw:
                        continue
                    try:
                        line = json.loads(raw)
                    except ValueError:
                        break  # torn tail — everything before it counted
                    led._fold(line)
                    led.journal_lines += 1
        except OSError:
            pass  # no journal yet — fresh ledger
        led.path = path
        return led

    def _append(self, line: dict) -> None:
        if self.path is None:
            return
        if self._fh is None:
            self._fh = open(self.path, "a", encoding="utf-8")
        self._fh.write(json.dumps(line, sort_keys=True) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    # -- write side -------------------------------------------------------
    def record(self, tenant: str, model: str, usage: TokenUsage,
               cost: int = 0, ts: float | None = None) -> dict:
        """Journal + fold one finished request. Returns the line."""
        line = line_from(tenant, model, usage, cost, ts)
        self._append(line)
        self.journal_lines += 1
        if not reconciles(usage):
            self.reconcile_mismatches += 1
        self._fold(line)
        return line

    def _fold(self, line: dict) -> None:
        ts = float(line.get("ts", 0.0))
        tenant = str(line.get("tenant", ""))
        model = str(line.get("model", ""))
        wi = int(ts // self.window_s)
        w = zero_window(ts, ts)
        for f in INT_FIELDS:
            w[f] = int(line.get(f, 0) or 0)
        for f in FLOAT_FIELDS:
            w[f + "_u"] = _micros(line.get(f, 0.0))
        self._tenants.add(tenant)
        self._totals = merge_windows(self._totals, w)

        key = (tenant, model)
        cur = self._open.get(key)
        if cur is not None and cur[0] != wi:
            closed = dict(cur[1])
            closed.update(tenant=tenant, model=model)
            self._closed.append(closed)
            self.windows_closed += 1
            cur = None
        self._open[key] = (
            wi, w if cur is None else merge_windows(cur[1], w))

        tcur = self._tenant_open.get(tenant)
        if tcur is not None and tcur[0] != wi:
            self._close_tenant_window(tenant, tcur[1], wi - tcur[0])
            tcur = None
        self._tenant_open[tenant] = (
            wi, w if tcur is None else merge_windows(tcur[1], w))

    def _close_tenant_window(self, tenant: str, w: dict,
                             gap: int) -> None:
        budget = self.budgets.get(tenant, 0.0)
        if budget <= 0:
            return
        st = self._burn.setdefault(tenant, _BurnState())
        if gap > 1:
            # idle windows between the closed one and now: no spend is
            # not an overshoot — the streak restarts from this window
            st.streak = 0
        burn = w["cost"] / budget
        st.burn = round(burn, 4)
        st.over = burn > 1.0
        st.streak = st.streak + 1 if st.over else 0

    # -- read side --------------------------------------------------------
    def sustained(self, tenant: str) -> bool:
        """K consecutive closed windows over budget — the alert flag."""
        st = self._burn.get(tenant)
        return st is not None and st.streak >= self.burn_windows

    def burn(self, tenant: str) -> dict:
        st = self._burn.get(tenant)
        return {
            "budget": self.budgets.get(tenant, 0.0),
            "burn_rate": st.burn if st is not None else -1.0,
            "over_budget": st.over if st is not None else False,
            "over_streak": st.streak if st is not None else 0,
            "sustained": self.sustained(tenant),
        }

    def totals(self) -> dict:
        """Cumulative ledger totals (the engine-counter reconciliation
        surface: these equal the replica ``meter_*`` /state counters
        summed over the fleet, token for token)."""
        return window_view(self._totals)

    def query(self, since: float = 0.0, tenant: str = "",
              model: str = "") -> dict:
        """The ``GET /usage`` payload: filtered windows (closed ring +
        open), per-tenant aggregates with budget burn, and the grand
        totals."""
        windows: list[dict] = []
        for w in self._closed:
            if tenant and w.get("tenant") != tenant:
                continue
            if model and w.get("model") != model:
                continue
            if w.get("t1", 0.0) < since:
                continue
            windows.append(window_view(w))
        for (t, mdl), (_wi, w) in sorted(self._open.items()):
            if tenant and t != tenant:
                continue
            if model and mdl != model:
                continue
            if w.get("t1", 0.0) < since:
                continue
            v = window_view(w)
            v.update(tenant=t, model=mdl, open=True)
            windows.append(v)

        tenants: dict[str, dict] = {}
        for (t, mdl), (_wi, w) in self._open.items():
            agg = tenants.setdefault(t, zero_window())
            tenants[t] = merge_windows(agg, w)
        for w in self._closed:
            t = str(w.get("tenant", ""))
            agg = tenants.setdefault(t, zero_window())
            tenants[t] = merge_windows(agg, w)
        per_tenant = {}
        for t in sorted(tenants):
            if tenant and t != tenant:
                continue
            v = window_view(tenants[t])
            v["budget"] = self.burn(t)
            per_tenant[t] = v

        return {
            "window_s": self.window_s,
            "retained_windows": len(self._closed),
            "windows": windows,
            "tenants": per_tenant,
            "totals": self.totals(),
        }

    def snapshot(self) -> dict:
        """The ``USAGE_GAUGES`` twin — literal keys, drift-checked by
        the ``gauge-drift`` lint pass against obs/metrics.py."""
        t = self._totals
        return {
            "records_total": t["records"],
            "prefill_tokens_total": t["prefill_tokens"],
            "prefill_padded_tokens_total": t["prefill_padded_tokens"],
            "prefix_reused_tokens_total": t["prefix_reused_tokens"],
            "decode_tokens_total": t["decode_tokens"],
            "spec_drafted_total": t["spec_drafted"],
            "spec_accepted_total": t["spec_accepted"],
            "hbm_page_byte_s_total": _unmicros(t["hbm_page_byte_s_u"]),
            "host_page_byte_s_total": _unmicros(t["host_page_byte_s_u"]),
            "cost_total": t["cost"],
            "tenants": len(self._tenants),
            "windows_closed_total": self.windows_closed,
            "journal_lines_total": self.journal_lines,
            "reconcile_mismatches_total": self.reconcile_mismatches,
            "over_budget_tenants": sum(
                1 for st in self._burn.values() if st.over),
            "burn_sustained_tenants": sum(
                1 for t_ in self._burn if self.sustained(t_)),
        }
