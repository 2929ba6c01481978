"""prefix_reuse_pct: the prefix cache (``tpuserve/kvcache.py``): the
prompt tokens whose K/V the cache held (the ``prefix_tokens_reused``
delta on ``/state``) per hundred prompt tokens the load generator sent,
both over the counters' span. Moves ``ttft_slo_pct``."""

from readers import state_delta


def read(ctx):
    sent = sum(r["prompt_tokens"] for r in ctx.records
               if r.get("sent") is not None
               and ctx.t_open <= r["sent"] < ctx.t_span_end)
    if not sent:
        return None
    return 100.0 * state_delta(ctx, "prefix_tokens_reused") / sent
