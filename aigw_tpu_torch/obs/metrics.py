"""The engine's serving-phase latency histograms (the port's copy of
``PhaseHistogram``, ``EnginePhases``, ``ENGINE_HISTOGRAMS`` and
``PHASE_BUCKETS_MS`` from ``aigw_tpu/obs/metrics.py``; standard library
only).

``/state`` exports ``EnginePhases.percentiles()`` as
``phase_percentiles``, the key the gateway's picker prices a replica's
TTFT from, and the TTFT histogram's ``cumulative()`` buckets as
``ttft_hist_buckets``, which the gateway's SLO burn-rate monitor reads
off the same poll. The reference also renders the histograms on ``/metrics``
with trace-id exemplars; the port serves neither ``/metrics`` nor traces
yet, so this copy keeps the counts and the percentiles.
"""

from __future__ import annotations

import bisect

#: (phase key, metric family name), in the reference's order
ENGINE_HISTOGRAMS: tuple[tuple[str, str], ...] = (
    ("queue_wait", "tpuserve_queue_wait_hist_ms"),
    ("prefill", "tpuserve_prefill_hist_ms"),
    ("ttft", "tpuserve_ttft_hist_ms"),
    ("first_emit", "tpuserve_first_emit_hist_ms"),
    ("decode_per_token", "tpuserve_decode_per_token_hist_ms"),
    ("transfer", "tpuserve_transfer_hist_ms"),
)

#: histogram bucket upper bounds in milliseconds (+Inf implicit)
PHASE_BUCKETS_MS: tuple[float, ...] = (
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0, 30000.0,
)


class PhaseHistogram:
    """Fixed-bucket latency histogram. The engine thread writes
    (``observe`` is a few list and scalar operations, no lock); readers
    tolerate a count torn by one observation."""

    __slots__ = ("name", "buckets", "counts", "total", "count")

    def __init__(self, name: str,
                 buckets: tuple[float, ...] = PHASE_BUCKETS_MS):
        self.name = name
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)  # last = +Inf
        self.total = 0.0
        self.count = 0

    def observe(self, ms: float) -> None:
        self.counts[bisect.bisect_left(self.buckets, ms)] += 1
        self.total += ms
        self.count += 1

    def percentile(self, q: float) -> float:
        """q in (0, 1] -> linear interpolation inside the target bucket;
        -1.0 when empty (distinguishable from a real 0 ms)."""
        counts = list(self.counts)
        n = sum(counts)
        if n == 0:
            return -1.0
        target = q * n
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            if cum >= target:
                hi = (self.buckets[i] if i < len(self.buckets)
                      else self.buckets[-1] * 2)
                lo = self.buckets[i - 1] if i > 0 else 0.0
                if c == 0:
                    return hi
                frac = (target - (cum - c)) / c
                return lo + (hi - lo) * frac
        return self.buckets[-1] * 2

    def percentiles(self) -> dict[str, float]:
        return {
            "p50": round(self.percentile(0.50), 3),
            "p95": round(self.percentile(0.95), 3),
            "p99": round(self.percentile(0.99), 3),
        }

    def cumulative(self) -> dict[str, int]:
        """Cumulative bucket counts ``{le: count}``, ``+Inf`` last (the
        reference's ``/state`` ``ttft_hist_buckets``)."""
        out: dict[str, int] = {}
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            le = (f"{self.buckets[i]:g}" if i < len(self.buckets)
                  else "+Inf")
            out[le] = cum
        return out


class EnginePhases:
    """One PhaseHistogram per ENGINE_HISTOGRAMS phase, owned by the
    engine and summarized as p50/p95/p99 on ``/state``."""

    def __init__(self) -> None:
        self.hists: dict[str, PhaseHistogram] = {
            key: PhaseHistogram(name) for key, name in ENGINE_HISTOGRAMS
        }

    def observe(self, phase: str, ms: float) -> None:
        h = self.hists.get(phase)
        if h is not None:
            h.observe(ms)

    def percentiles(self) -> dict[str, dict[str, float]]:
        return {key: h.percentiles() for key, h in self.hists.items()}
