"""tokens_per_step.batch: engine batching (``tpuserve/engine.py``):
tokens generated per decode step over the counters' span (``tokens_generated``
and ``decode_steps`` deltas on ``/state``). Moves ``output_tok_s``."""

from readers import state_delta


def read(ctx):
    steps = state_delta(ctx, "decode_steps")
    return state_delta(ctx, "tokens_generated") / steps if steps else None
