"""k2_roofline_pct.serve: kernel K2 (``ops/decode_fused.py``
``fused_paged_decode``): the bytes the traced slice's decode rows need
(each row's cached K/V read once a layer, its q, new K/V row and output,
``flops.k2_bytes``) over 3.35 TB/s, over K2's summed device time in the
slice. Moves ``tpot_p95_ms``."""

import flops
from readers import K2_TAG, decode_rows, trace_kernels, trace_slice


def read(ctx):
    secs, _n = trace_kernels(ctx, K2_TAG)
    t0, t1 = trace_slice(ctx)
    nbytes = sum(flops.k2_bytes(ctx.cfg, pos)
                 for pos in decode_rows(ctx, t0, t1))
    if secs <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / flops.PEAK_HBM_BYTES / secs
