"""k1_roofline_pct: kernel K1 (``ops/paged_attention.py``
``ragged_prefill_attention``): the least time the card could take for
the prompt rows that the traced slice prefilled and the cached context
they attend (the larger of operations over 989 TFLOP/s and bytes over
3.35 TB/s, request by request, ``flops.k1_work``) over K1's summed
device time in the slice. Moves ``ttft_slo_pct``."""

import flops
from readers import K1_TAG, prefills, trace_kernels, trace_slice


def read(ctx):
    secs, _n = trace_kernels(ctx, K1_TAG)
    t0, t1 = trace_slice(ctx)
    least = 0.0
    for c, p in prefills(ctx, t0, t1):
        ops, nbytes = flops.k1_work(ctx.cfg, c, p)
        least += max(ops / flops.PEAK_BF16_FLOPS,
                     nbytes / flops.PEAK_HBM_BYTES)
    if secs <= 0 or least <= 0:
        return None
    return 100.0 * least / secs
