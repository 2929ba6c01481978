"""How ``correct`` is decided: the served tokens against the plain
reference.

After the window has closed and the program's state is freed, a sample
of the requests the run finished, drawn from the seed with the longest
among them, is run once through ``reference.Model`` over its prompt and
the tokens served to it (teacher-forced). At each served position the
gap is how far the served token's reference logit lies below the best
of the pinned tokens' (the letters ``logit_bias`` lifts by the same
amount, so greedy decoding picks among them by the model's logits). The
widest or the mean gap over the sample, as the cell's limits file
(``portbench/limits/<cell>.json``) names them, is held to its limit; so
is the count of requests whose prompt or served tokens differ from what
their usage reports (limit 0).

The control puts the reference computed in a lower precision in the
program's place: its best pinned token at each position stands for the
served one, and its gaps go through the same limits.
"""

from __future__ import annotations

import random

import torch

from reference import Model


def prompt_ids(messages: list[dict]) -> list[int]:
    """The byte chat template's tokens (the replica's byte tokenizer
    renders ``<role>: content`` lines and an ``<assistant>: `` cue)."""
    s = "".join(f"<{m['role']}>: {m['content']}\n" for m in messages)
    return list((s + "<assistant>: ").encode())


def sample(records: list[dict], seed: int, tokens: int,
           most: int) -> list[dict]:
    """The finished request with the most served tokens, then others in
    an order drawn from ``seed``, until ``tokens`` served tokens or
    ``most`` requests."""
    done = [r for r in records if r["ok"] and r["text"]]
    if not done:
        return []
    done.sort(key=lambda r: (-len(r["text"]), r["id"]))
    out, rest = [done[0]], done[1:]
    random.Random(seed).shuffle(rest)
    n = len(done[0]["text"])
    for r in rest:
        if n >= tokens or len(out) >= most:
            break
        out.append(r)
        n += len(r["text"])
    return out


def compare(cfg: dict, params: dict, records: list[dict], seed: int,
            limits: dict, pin: str, lowp: tuple[str, ...] = ()) -> dict:
    """The numbers ``correct`` compares, each with its limit: the
    program's under ``numbers``, and under ``controls`` those of each
    lower precision in ``lowp`` put in the program's place."""
    ref = Model(cfg, params)
    ctrl = {name: Model(cfg, params, lowp=name) for name in lowp}
    pins = torch.tensor([ord(c) for c in pin])
    positions = mismatched = 0
    every: dict[str, list] = {"program": [], **{n: [] for n in lowp}}
    margins: list = []
    picked = sample(records, seed, limits["sample_tokens"],
                    limits["sample_requests"])
    for r in picked:
        prompt = prompt_ids(r["messages"])
        served = list(r["text"].encode())
        usage = r["usage"] or {}
        if (len(prompt) != usage.get("prompt_tokens")
                or len(served) != usage.get("completion_tokens")
                or any(t not in pins for t in served)):
            mismatched += 1
            continue
        n = len(served)
        logits = ref.logits(prompt + served[:-1], n)
        dev = logits.device
        lp = logits[:, pins.to(dev)]
        best = lp.max(-1).values
        got = logits[torch.arange(n, device=dev),
                     torch.tensor(served, device=dev)]
        every["program"].append((best - got).cpu())
        if ref.router_margin is not None:
            margins.append(ref.router_margin[-n:].cpu())
        positions += n
        for name, m in ctrl.items():
            cl = m.logits(prompt + served[:-1], n)[:, pins.to(dev)]
            pick = cl.argmax(-1)
            g = best - lp[torch.arange(n, device=dev), pick]
            every[name].append(g.cpu())
        del logits
    if not picked:
        mismatched += 1
    info = {"requests": len(picked), "positions": positions,
            "gaps": {k: spread(v) for k, v in every.items() if v}}
    if margins:
        info["router_margin"] = near_ties(torch.cat(every["program"]),
                                          torch.cat(margins))
    return {"numbers": numbers(every["program"], mismatched, limits),
            "controls": {n: numbers(every[n], mismatched, limits)
                         for n in lowp},
            "info": info}


def numbers(gaps: list, mismatched: int, limits: dict) -> dict:
    """The gap statistics that the cell's limits file names, and the
    token-count mismatches, each beside its limit."""
    g = torch.cat(gaps) if gaps else torch.zeros(1)
    found = {"widest_gap": float(g.max()), "mean_gap": float(g.mean())}
    out = {k: {"value": v, "limit": limits[k]} for k, v in found.items()
           if k in limits}
    out["token_count_mismatches"] = {"value": mismatched, "limit": 0}
    return out


def near_ties(gap: torch.Tensor, margin: torch.Tensor) -> dict:
    """The router's least margin at the positions of the five widest
    gaps against its median over every position (MoE only): where the
    widest gaps sit on near ties, the served token moved because a
    rounding picked another expert."""
    top = torch.topk(gap, min(5, gap.numel())).indices
    return {"at_widest_gaps": [round(float(m), 5) for m in margin[top]],
            "widest_gaps": [round(float(g), 4) for g in gap[top]],
            "median": float(margin.median())}


def spread(gaps: list) -> dict:
    """The gaps' mean, 99th percentile, share of positions above zero
    (where the served or control token is not the reference's best) and
    the largest of the requests' mean gaps, for the log."""
    g = torch.cat(gaps).float()
    return {"widest": float(g.max()), "mean": float(g.mean()),
            "p99": float(torch.quantile(g, 0.99)),
            "nonzero_frac": float((g > 0).float().mean()),
            "worst_request_mean": max(float(x.float().mean())
                                      for x in gaps)}


def passed(numbers: dict) -> bool:
    return all(v["value"] <= v["limit"] for v in numbers.values())
