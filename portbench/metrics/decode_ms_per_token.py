"""decode_ms_per_token: the engine's decode loop (``tpuserve/engine.py``,
``tpuserve/programs.py``): the mean time a decoded token took over the
counters' span, from ``tpuserve_decode_per_token_hist_ms``'s ``_sum`` and
``_count`` deltas. Moves ``tpot_p95_ms``."""

from readers import hist_mean


def read(ctx):
    return hist_mean(ctx, "decode_per_token")
