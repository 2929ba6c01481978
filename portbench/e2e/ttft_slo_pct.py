"""ttft_slo_pct: the share of the requests due in the window whose
first token reached the client within the mix's ``ttft_slo_ms`` of its
due time on the arrival schedule; a request that failed or was refused
missed it."""


def read(ctx):
    limit = ctx.traffic["ttft_slo_ms"]
    win = [r for r in ctx.records if r["segment"] == "window"]
    met = sum(1 for r in win if r["ok"] and r["times"]
              and 1e3 * (r["times"][0] - r["due"]) <= limit)
    return 100.0 * met / len(win) if win else None
