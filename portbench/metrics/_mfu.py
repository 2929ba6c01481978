"""The model step's share of the chip's peak, shared by the ``mfu_pct``
metrics: the model operations of the rows the traced slice served (its
prefills and its decode rows, as ``flops.py`` counts them from the
configuration and the requests' lengths) over the device's busy
seconds in the slice times 989 TFLOP/s."""

import flops
from readers import decode_rows, prefills, trace_slice


def read(ctx):
    busy = ctx.trace["busy_s"]
    t0, t1 = trace_slice(ctx)
    work = sum(flops.prefill_flops(ctx.cfg, c, p)
               for c, p in prefills(ctx, t0, t1))
    work += sum(flops.decode_flops(ctx.cfg, pos)
                for pos in decode_rows(ctx, t0, t1))
    if busy <= 0 or work <= 0:
        return None
    return 100.0 * work / (busy * flops.PEAK_BF16_FLOPS)
