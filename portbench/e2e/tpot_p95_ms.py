"""tpot_p95_ms: the 95th percentile over every request due in the
window that finished of its time per output token after the first:
(last token's arrival - first's) / (tokens - 1), on the client's
clock."""

from stats import quantile


def read(ctx):
    xs = [1e3 * (r["times"][-1] - r["times"][0]) / (len(r["times"]) - 1)
          for r in ctx.records
          if r["segment"] == "window" and r["ok"] and len(r["times"]) > 1]
    return quantile(xs, 0.95) if xs else None
