"""A closed loop of ``clients`` callers, each sending its next request
when the last one has finished (offline batch jobs).

The pool of requests (``clients`` x ``requests_per_client``) has a fixed
set of lognormal prompt and output lengths that the seed only orders;
the clients take them in turn. Each client's first request stops at a
share of its drawn length, the shares spread evenly over (0, 1), so
that completions and refills are spread over the window from its start.
The window opens once every client has its first token (the first
prefills are set-up the traffic needs) and lasts ``seconds``; the
streams still open at its close are cut.
"""

from __future__ import annotations

import threading
import time

from loadgen import TEMPLATE_ONE_TURN, quantile_set, text


def run(plan: dict, client, rng, announce) -> None:
    tr = plan["traffic"]
    C = tr["clients"]
    n = C * tr["requests_per_client"]
    prompts = quantile_set(n, tr["prompt_tokens"], rng)
    outs = quantile_set(n, tr["output_tokens"], rng)
    shares = [(j + 0.5) / C for j in range(C)]
    rng.shuffle(shares)
    reqs = []
    for i, (p, o) in enumerate(zip(prompts, outs)):
        if i < C:
            o = max(1, int(o * shares[i]))
        reqs.append({"id": i, "segment": "window", "max_tokens": o,
                     "prompt_tokens": p, "messages": [{
                         "role": "user",
                         "content": text(p - TEMPLATE_ONE_TURN, rng)}]})
    lock = threading.Lock()
    nxt = iter(reqs)
    started = set()
    all_started = threading.Event()

    def first(rec):
        with lock:
            started.add(rec["client"])
            if len(started) == C:
                all_started.set()

    client.on_first = first

    def loop(c: int) -> None:
        while not client.stop.is_set():
            with lock:
                rec = next(nxt, None)
            if rec is None:
                return
            rec["client"] = c
            rec["due"] = time.monotonic()
            client.chat(rec)

    threads = [threading.Thread(target=loop, args=(c,), daemon=True)
               for c in range(C)]
    client.threads += threads
    for th in threads:
        th.start()
    if not all_started.wait(timeout=tr["ramp_timeout_s"]):
        raise RuntimeError(f"only {len(started)} of {C} clients had a "
                           f"first token after {tr['ramp_timeout_s']} s")
    t_open = time.monotonic()
    announce(f"WINDOW {t_open!r}")
    time.sleep(max(0.0, t_open + plan["seconds"] - time.monotonic()))
