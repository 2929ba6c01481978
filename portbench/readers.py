"""What the per-layer metrics of ``portbench/metrics/`` read, shared.

A reader is ``metrics/<metric name>.py`` with ``read(ctx) -> float |
None``; it returns None where its run has nothing to read. ``ctx``
holds the configuration (``cfg``), the load generator's records
(``records``), the window (``t_open``, ``t_close``), the replica's
counters at its opening and close and at the traced slice's start and
end (``snaps``), the span the counter metrics read (``span``, two keys
of ``snaps``, ending at ``t_span_end``: the window, or in a traced run
the window up to the slice, which sits at the window's end), and the
reduced device trace (``trace``, with the slice's host times
``trace_t0`` and ``trace_t1``).
"""

from __future__ import annotations

from devtrace import kernel_time

#: kernel-name substrings of the port's kernels on the served path
K1_TAG = "ragged_prefill"
K2_TAG = "fused_decode_kernel"


def hist_mean(ctx, phase: str) -> float | None:
    """Mean of the engine's ``tpuserve_<phase>_hist_ms`` over the
    observations in the counters' span (``_sum`` and ``_count``
    deltas)."""
    a, b = ctx.span
    s0, c0 = ctx.snaps[a]["hist"][phase]
    s1, c1 = ctx.snaps[b]["hist"][phase]
    return (s1 - s0) / (c1 - c0) if c1 > c0 else None


def state_delta(ctx, key: str) -> float:
    """The change of a ``/state`` counter over the counters' span."""
    a, b = ctx.span
    return ctx.snaps[b]["state"][key] - ctx.snaps[a]["state"][key]


def decode_rows(ctx, t0: float, t1: float) -> list[int]:
    """Positions of the decode rows whose tokens reached the client in
    ``[t0, t1)``: every token after a request's first, at the prompt's
    length plus its index."""
    out = []
    for r in ctx.records:
        p = r["prompt_tokens"]
        for j, t in enumerate(r["times"]):
            if j and t0 <= t < t1:
                out.append(p + j - 1)
    return out


def prefills(ctx, t0: float, t1: float) -> list[tuple[int, int]]:
    """``(cached, prompt)`` token counts of the requests whose first
    token reached the client in ``[t0, t1)``: their prefill ran just
    before it. ``cached`` is the prefix the replica's cache held, as its
    reply's usage reports it."""
    out = []
    for r in ctx.records:
        if r["times"] and t0 <= r["times"][0] < t1:
            out.append((cached_tokens(r), r["prompt_tokens"]))
    return out


def cached_tokens(r: dict) -> int:
    usage = r.get("usage") or {}
    details = usage.get("prompt_tokens_details") or {}
    return int(details.get("cached_tokens") or 0)


def trace_kernels(ctx, tag: str) -> tuple[float, int]:
    """(device seconds, launches) of a kernel in the traced slice."""
    return kernel_time(ctx.trace, tag)


def trace_slice(ctx) -> tuple[float, float]:
    return ctx.trace_t0, ctx.trace_t1
