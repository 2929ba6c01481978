"""queue_wait_ms: engine admission (``tpuserve/engine.py``): the mean
wait of a request in the engine's queue over the counters' span, from
``tpuserve_queue_wait_hist_ms``'s ``_sum`` and ``_count`` deltas.
Moves ``ttft_slo_pct``."""

from readers import hist_mean


def read(ctx):
    return hist_mean(ctx, "queue_wait")
