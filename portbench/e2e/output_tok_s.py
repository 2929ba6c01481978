"""output_tok_s: output tokens streamed to the clients inside the
window, over the window's seconds."""


def read(ctx):
    n = sum(1 for r in ctx.records for t in r["times"]
            if ctx.t_open <= t < ctx.t_close)
    return n / ctx.seconds
