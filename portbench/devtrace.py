"""The device trace of a traced run: ``torch.profiler`` recording the
card only (CUPTI), over a slice of the measured window, reduced to what
the per-layer metrics and the result's ``breakdown`` read.

Recording host operations as well cost seconds a slice on the card's
engine loop, so only device activity is kept. A CUDA graph's replay
shows each of its kernels as its own event.
"""

from __future__ import annotations

import time


class DeviceTrace:
    def __init__(self):
        self._prof = None
        self._results = None
        self.t0 = self.t1 = 0.0

    @staticmethod
    def warm() -> None:
        """Start and stop the profiler once: its first start initialises
        CUPTI, which took seconds on the card; a run does that in its
        set-up, before the window."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.t0 = time.monotonic()

    def stop(self) -> None:
        """Stop recording and keep the raw results: the profiler's own
        exit turns every event into a Python object while holding the
        interpreter, which stalled the replica in this process for
        seconds; that waits for ``events``, after the window."""
        import torch

        torch.cuda.synchronize()
        self.t1 = time.monotonic()
        self._results = torch.autograd.profiler._disable_profiler()

    def events(self) -> list[tuple[str, int, int]]:
        """Every device activity: (name, start ns, end ns), by start."""
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        out = []
        for ev in self._results.events():
            if ev.device_type() != cuda:
                continue
            start = ev.start_ns()
            out.append((ev.name(), start, start + ev.duration_ns()))
        out.sort(key=lambda e: e[1])
        return out


def reduce(events: list[tuple[str, int, int]], window_s: float) -> dict:
    """Busy seconds (the union of the activities' intervals), time and
    launches by name, and the idle gaps between busy stretches, each
    labelled by the activities on either side."""
    by_name: dict[str, list] = {}
    busy = 0
    gaps: list[tuple[int, str]] = []
    cur_s = cur_e = None
    last_name = ""
    for name, s, e in events:
        acc = by_name.setdefault(name, [0, 0])
        acc[0] += e - s
        acc[1] += 1
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((s - cur_e, f"after {last_name[:70]} | before "
                                    f"{name[:70]}"))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
        if e >= cur_e:
            last_name = name
    if cur_e is not None:
        busy += cur_e - cur_s
    gaps.sort(key=lambda g: -g[0])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {
        "busy_s": busy / 1e9,
        "window_s": window_s,
        "by_name": {k: (v[0] / 1e9, v[1]) for k, v in by_name.items()},
        "breakdown": {
            "device_ops": [[k[:120], v[0] / 1e9] for k, v in ops[:10]],
            "idle_gaps": [[label, ns / 1e9] for ns, label in gaps[:10]]},
    }


def kernel_time(red: dict, tag: str) -> tuple[float, int]:
    """(seconds, launches) of the activities whose name holds ``tag``."""
    s = n = 0
    for name, (t, c) in red["by_name"].items():
        if tag in name:
            s += t
            n += c
    return s, n
