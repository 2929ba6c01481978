"""Engine flight recorder — per-request lifecycle timelines, no backend
(the port's own copy of ``aigw_tpu/obs/flight.py``; standard library
only).

A tracing pipeline answers "why was this request slow" only when a
collector was already attached and sampling. Production incidents rarely
oblige, so the replica also keeps a bounded in-process ring of compact
per-request timelines (one :class:`FlightEntry` each) that a replica can
serve AFTER the fact:

- ``GET /debug/requests``        — recent + slow-request summaries
- ``GET /debug/requests/{id}``   — one request's full phase timeline

The same per-request sink (:class:`RequestTrace`) fans events out to the
request's OTel span tree when tracing IS enabled, so the flight recorder
and the exported spans can never disagree about what happened — they are
fed by the identical engine-side calls.

Threading: entries are written by the engine thread and the server's
handler threads and read by debug endpoints. Every mutation is a dict/list
append or scalar store (GIL-atomic); the ring itself takes a small lock
only on begin/finish, never per token or per event.
"""

from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass, field
from typing import Any

#: per-entry cap on recorded events — a long generation must not grow an
#: unbounded timeline; past the cap only counters advance
MAX_EVENTS = 48

#: decode windows individually recorded per request (the rest aggregate)
MAX_WINDOW_EVENTS = 8


@dataclass
class FlightEntry:
    """One request's compact timeline. Times are milliseconds relative
    to ``t0`` (request arrival at the server); -1.0 = not reached."""

    rid: str
    model: str = ""
    trace_id: str = ""
    span_id: str = ""
    ts: float = field(default_factory=time.time)  # wall clock at arrival
    t0: float = field(default_factory=time.monotonic)
    prompt_tokens: int = 0
    max_tokens: int = 0
    stream: bool = False
    # phase timings (ms)
    queue_wait_ms: float = -1.0
    prefill_ms: float = -1.0
    ttft_ms: float = -1.0  # arrival → first engine token emit
    total_ms: float = -1.0
    tokens_out: int = 0
    decode_windows: int = 0
    spec_accepted: int = 0
    # grammar-constrained decoding: windows cut at a mask boundary for
    # this request (each ≈ two windows of slot time — the per-request
    # view of tpuserve_constraint_rollbacks_total)
    constraint_rollbacks: int = 0
    transfer_ms: float = 0.0
    finish: str = ""  # "" = in flight
    admission: dict[str, Any] = field(default_factory=dict)
    events: list[tuple[str, float, dict]] = field(default_factory=list)
    events_dropped: int = 0

    def rel_ms(self) -> float:
        return (time.monotonic() - self.t0) * 1e3

    def event(self, name: str, **attrs: Any) -> None:
        if len(self.events) >= MAX_EVENTS:
            self.events_dropped += 1
            return
        self.events.append((name, round(self.rel_ms(), 3), attrs))

    def summary(self) -> dict[str, Any]:
        return {
            "id": self.rid,
            "model": self.model,
            "trace_id": self.trace_id,
            "ts": self.ts,
            "prompt_tokens": self.prompt_tokens,
            "tokens_out": self.tokens_out,
            "queue_wait_ms": round(self.queue_wait_ms, 3),
            "prefill_ms": round(self.prefill_ms, 3),
            "ttft_ms": round(self.ttft_ms, 3),
            "total_ms": round(self.total_ms, 3),
            "finish": self.finish or "in_flight",
        }

    def detail(self) -> dict[str, Any]:
        out = self.summary()
        out.update(
            span_id=self.span_id,
            max_tokens=self.max_tokens,
            stream=self.stream,
            decode_windows=self.decode_windows,
            spec_accepted=self.spec_accepted,
            constraint_rollbacks=self.constraint_rollbacks,
            transfer_ms=round(self.transfer_ms, 3),
            admission=self.admission,
            events=[
                {"name": n, "t_ms": t, **({"attrs": a} if a else {})}
                for n, t, a in self.events
            ],
            events_dropped=self.events_dropped,
        )
        return out


class FlightRecorder:
    """Bounded ring of :class:`FlightEntry` plus a rolling slow-request
    log. The ring evicts oldest-first; eviction SPARES entries currently
    held by the slow log (worst-N by TTFT and by queue wait), so "the
    slowest request of the last hour" survives an hour of fast traffic."""

    def __init__(self, capacity: int = 256, slow_n: int = 16):
        self.capacity = max(1, capacity)
        self.slow_n = max(1, slow_n)
        self._ring: "collections.OrderedDict[str, FlightEntry]" = (
            collections.OrderedDict()
        )
        # separate retention for the worst finished requests
        self._slow_ttft: list[FlightEntry] = []
        self._slow_queue: list[FlightEntry] = []
        self._lock = threading.Lock()

    # -- write side -------------------------------------------------------
    def begin(self, rid: str, **fields: Any) -> FlightEntry:
        entry = FlightEntry(rid=rid, **fields)
        with self._lock:
            self._ring[rid] = entry
            while len(self._ring) > self.capacity:
                self._ring.popitem(last=False)
        return entry

    def finish(self, entry: FlightEntry, finish: str,
               tokens_out: int | None = None) -> None:
        entry.finish = finish or "stop"
        if tokens_out is not None:
            entry.tokens_out = tokens_out
        entry.total_ms = entry.rel_ms()
        with self._lock:
            self._note_slow(self._slow_ttft, entry,
                            lambda e: e.ttft_ms)
            self._note_slow(self._slow_queue, entry,
                            lambda e: e.queue_wait_ms)

    def _note_slow(self, worst: list[FlightEntry], entry: FlightEntry,
                   key) -> None:
        if key(entry) < 0:
            return  # phase never reached (errored before it)
        worst.append(entry)
        worst.sort(key=key, reverse=True)
        del worst[self.slow_n:]

    # -- read side --------------------------------------------------------
    def get(self, rid: str) -> FlightEntry | None:
        with self._lock:
            e = self._ring.get(rid)
            if e is not None:
                return e
            for worst in (self._slow_ttft, self._slow_queue):
                for cand in worst:
                    if cand.rid == rid:
                        return cand
        return None

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            recent = [e.summary() for e in
                      reversed(list(self._ring.values()))]
            slow_ttft = [e.summary() for e in self._slow_ttft]
            slow_queue = [e.summary() for e in self._slow_queue]
        return {
            "capacity": self.capacity,
            "recent": recent,
            "slow_by_ttft": slow_ttft,
            "slow_by_queue_wait": slow_queue,
        }

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


class RequestTrace:
    """Per-request lifecycle sink handed to the engine via
    ``GenRequest.trace``: every call lands in the flight-recorder entry
    and, when tracing is enabled, in the request's span tree (child
    spans for queue-wait / prefill / decode, events for the rest).

    Called from the engine thread — methods must be cheap and must never
    raise into the engine loop (a telemetry bug aborting every in-flight
    request would be worse than no telemetry). Phase HISTOGRAMS are
    observed by the engine itself (they cover untraced requests too);
    this sink only records timelines and spans."""

    __slots__ = ("entry", "tracer", "span", "_decode_span")

    def __init__(self, entry: FlightEntry, tracer: Any = None,
                 span: Any = None):
        self.entry = entry
        self.tracer = tracer
        self.span = span
        self._decode_span = None

    @property
    def trace_id(self) -> str:
        return self.entry.trace_id

    def _child(self, name: str, start_ns: int | None = None):
        if self.span is None or self.tracer is None:
            return None
        child = self.tracer.start_span(name, self.span.context)
        if start_ns is not None:
            child.start_ns = start_ns
        return child

    def _backdated_child(self, name: str, dur_ms: float,
                         attrs: dict) -> None:
        """Emit a completed child span covering the last ``dur_ms``."""
        child = self._child(
            name, start_ns=time.time_ns() - int(dur_ms * 1e6))
        if child is None:
            return
        child.attributes.update(attrs)
        child.end()

    # -- engine-side lifecycle calls --------------------------------------
    def queue_wait(self, ms: float) -> None:
        try:
            self.entry.queue_wait_ms = ms
            self._backdated_child("engine.queue_wait", ms,
                                  {"tpuserve.queue_wait_ms": round(ms, 3)})
        except Exception:  # noqa: BLE001 — never into the engine loop
            pass

    def admission(self, **attrs: Any) -> None:
        try:
            self.entry.admission.update(attrs)
            self.entry.event("admission", **attrs)
            if self.span is not None:
                self.span.add_event("admission", attrs)
        except Exception:  # noqa: BLE001
            pass

    def event(self, name: str, **attrs: Any) -> None:
        try:
            self.entry.event(name, **attrs)
            if self.span is not None:
                self.span.add_event(name, attrs)
        except Exception:  # noqa: BLE001
            pass

    def prefill(self, ms: float, **attrs: Any) -> None:
        try:
            self.entry.prefill_ms = ms
            self.entry.admission.update(attrs)
            self._backdated_child(
                "engine.prefill", ms,
                {"tpuserve.prefill_ms": round(ms, 3),
                 **{f"tpuserve.{k}": v for k, v in attrs.items()}})
        except Exception:  # noqa: BLE001
            pass

    def first_token(self) -> None:
        try:
            self.entry.ttft_ms = self.entry.rel_ms()
            self.entry.event("first_token")
            if self.span is not None:
                self.span.add_event("first_token")
        except Exception:  # noqa: BLE001
            pass

    def decode_window(self, k: int, lean: bool, draft: int) -> None:
        try:
            e = self.entry
            e.decode_windows += 1
            if e.decode_windows <= MAX_WINDOW_EVENTS:
                attrs = {"k": k, "program": "lean" if lean else "full",
                         "spec_rung": draft}
                e.event("decode_window", **attrs)
                if self._decode_span is None and self.span is not None:
                    self._decode_span = self._child("engine.decode")
                if self._decode_span is not None:
                    self._decode_span.add_event("decode_window", attrs)
        except Exception:  # noqa: BLE001
            pass

    def spec_window(self, proposed: int, accepted: int) -> None:
        try:
            self.entry.spec_accepted += accepted
            if self.entry.decode_windows <= MAX_WINDOW_EVENTS:
                self.event("spec_accept", proposed=proposed,
                           accepted=accepted)
        except Exception:  # noqa: BLE001
            pass

    def constraint_rollback(self) -> None:
        """One decode window cut at a grammar mask boundary — the slot
        rolled back to its last accepted token."""
        try:
            self.entry.constraint_rollbacks += 1
            if self.entry.constraint_rollbacks <= MAX_WINDOW_EVENTS:
                self.event("constraint_rollback")
        except Exception:  # noqa: BLE001
            pass

    def transfer(self, ms: float) -> None:
        try:
            self.entry.transfer_ms += ms
        except Exception:  # noqa: BLE001
            pass

    def tokens(self, n: int) -> None:
        try:
            self.entry.tokens_out += n
        except Exception:  # noqa: BLE001
            pass

    def engine_finish(self, reason: str) -> None:
        """EOS / length / cancel seen by the engine (the server still
        owns the entry's finalization — its view includes stop-string
        trims and client disconnects the engine never sees)."""
        try:
            self.event("engine_finish", reason=reason)
            if self._decode_span is not None:
                self._decode_span.set(
                    "tpuserve.decode_windows", self.entry.decode_windows)
                self._decode_span.set(
                    "tpuserve.spec_accepted", self.entry.spec_accepted)
                self._decode_span.end()
                self._decode_span = None
        except Exception:  # noqa: BLE001
            pass


def trace_id_of(req: Any) -> str:
    """A request's trace id (a phase histogram's exemplar), "" when it
    carries no trace."""
    return req.trace.trace_id if req.trace is not None else ""
