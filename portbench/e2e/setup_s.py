"""setup_s: from the start of the run's process to the window's
opening: drawing the weights, building the kernels where the checkout
has none, the replica's warm-up (its CUDA graph captures), the
gateway's start, and the ramp the traffic needs."""


def read(ctx):
    return ctx.setup_s
