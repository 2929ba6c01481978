"""Open-loop Poisson arrivals of single-turn chats.

The mix gives ``rate`` (requests a second), ``ramp_s`` (arrivals before
the window opens, so the queue is at steady state when it does),
``tail_s`` (arrivals after it closes, sent only while a request due in
the window is still streaming, so those finish under the same load) and
the lognormal ``prompt_tokens`` and ``output_tokens``. Each of the three
segments has a fixed set of gaps and lengths that the seed only orders.
Requests are timed from their due time, so a stall counts against every
request it delays.
"""

from __future__ import annotations

import time

from loadgen import TEMPLATE_ONE_TURN, gap_set, quantile_set, text


def run(plan: dict, client, rng, announce) -> None:
    tr = plan["traffic"]
    rate = tr["rate"]
    reqs: list[dict] = []
    offset = 0.0
    for name, span in (("ramp", tr["ramp_s"]), ("window", plan["seconds"]),
                       ("tail", tr["tail_s"])):
        n = max(1, round(rate * span))
        due = gap_set(n, span, rng)
        prompts = quantile_set(n, tr["prompt_tokens"], rng)
        outs = quantile_set(n, tr["output_tokens"], rng)
        for d, p, o in zip(due, prompts, outs):
            reqs.append({
                "id": len(reqs), "segment": name, "max_tokens": o,
                "offset": offset + d, "prompt_tokens": p,
                "messages": [{"role": "user", "content": text(
                    p - TEMPLATE_ONE_TURN, rng)}]})
        offset += span
    t0 = time.monotonic() + 0.5
    t_close = t0 + tr["ramp_s"] + plan["seconds"]
    announce(f"WINDOW {t0 + tr['ramp_s']!r}")
    in_window = []
    for rec in reqs:
        rec["due"] = t0 + rec["offset"]
        while True:
            if rec["segment"] == "tail" and not any(
                    th.is_alive() for th in in_window):
                return
            wait = rec["due"] - time.monotonic()
            if wait <= 0:
                break
            time.sleep(min(wait, 0.05))
        th = client.spawn(rec)
        if rec["segment"] == "window":
            in_window.append(th)
    deadline = t_close + tr["grace_s"]
    for th in in_window:
        th.join(timeout=max(0.0, deadline - time.monotonic()))
