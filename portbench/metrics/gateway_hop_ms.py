"""gateway_hop_ms: the gateway's hop (``gateway/server.py`` over
``gateway/http.py``) and the replica's HTTP front (``tpuserve/server.py``):
the client's mean time from sending a request to its first token, less
the replica's own mean TTFT (``tpuserve_ttft_hist_ms`` ``_sum`` and
``_count`` deltas), both over the counters' span. Moves
``ttft_slo_pct``."""

from readers import hist_mean


def read(ctx):
    rep = hist_mean(ctx, "ttft")
    xs = [r["times"][0] - r["sent"] for r in ctx.records
          if r["times"] and ctx.t_open <= r["times"][0] < ctx.t_span_end]
    if rep is None or not xs:
        return None
    return 1e3 * sum(xs) / len(xs) - rep
