"""The device's idle share, shared by the ``device_idle_pct`` metrics:
the part of the traced slice in which no activity ran on the card
(one less the union of the kernels' and copies' intervals over the
slice's length)."""


def read(ctx):
    w = ctx.trace["window_s"]
    if w <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / w)
