"""The load generator: one process of its own, the standard library only.

    python3 portbench/loadgen.py <plan.json> <records.jsonl>

The plan names the replica's (or the gateway's) address, the model, the
seed, the window's length and the traffic mix (a file of
``portbench/traffic/``). The mix's ``arrival`` names a module of
``portbench/arrivals/`` that drives the requests; every module sends
OpenAI streamed chat completions through ``Client`` below and records,
for each request, when it was due, sent, and when each token arrived on
this process's clock (``time.monotonic``, which every process of the
machine shares).

Standard output carries two lines for the harness: ``WINDOW <t>`` when
the measured window's opening time is known, and ``DONE`` once every
record is written. Tokens are pinned by ``logit_bias`` to one-byte
tokens (the mix's ``pin`` letters), greedy, so that each token streams
as its own event and the served ids can be read back from the text.
"""

from __future__ import annotations

import http.client
import importlib
import json
import math
import os
import random
import socket
import statistics
import sys
import threading
import time

#: the byte chat template's tokens around one user message:
#: "<user>: " and "\n<assistant>: "
TEMPLATE_ONE_TURN = len("<user>: ") + len("\n<assistant>: ")
ALPHABET = "abcdefghijklmnopqrstuvwxyz     "


def quantile_set(n: int, dist: dict, rng: random.Random) -> list[int]:
    """``n`` lengths at the lognormal's quantiles ``(i + 0.5) / n``
    (``median``, ``sigma``), clipped to ``[min, max]``, in an order drawn
    from ``rng``: every seed gets the same lengths."""
    nd = statistics.NormalDist()
    out = []
    for i in range(n):
        z = nd.inv_cdf((i + 0.5) / n)
        v = math.exp(math.log(dist["median"]) + dist["sigma"] * z)
        out.append(int(min(dist["max"], max(dist["min"], round(v)))))
    rng.shuffle(out)
    return out


def gap_set(n: int, span_s: float, rng: random.Random) -> list[float]:
    """Offsets of ``n`` arrivals over ``span_s`` seconds: exponential
    gaps at their quantiles, scaled to fill the span, in an order drawn
    from ``rng`` (Poisson arrivals with the same gaps for every seed)."""
    gaps = [-math.log(1.0 - (i + 0.5) / n) for i in range(n)]
    rng.shuffle(gaps)
    scale = span_s / sum(gaps)
    t, out = 0.0, []
    for g in gaps:
        out.append(t)
        t += g * scale
    return out


def text(n: int, rng: random.Random) -> str:
    """``n`` bytes of letters and spaces (``n`` byte tokens)."""
    return "".join(rng.choices(ALPHABET, k=n))


class Client:
    """Streamed chat completions to one address; every connection in
    flight is registered so that ``abort`` can cut them all."""

    def __init__(self, plan: dict):
        host, port = plan["address"].rsplit(":", 1)
        self.host, self.port = host, int(port)
        self.model = plan["model"]
        pin = plan["traffic"].get("pin", "abcdefghijklmnopqrstuvwxyz")
        self.bias = {str(ord(c)): 100.0 for c in pin}
        self.stop = threading.Event()
        self._lock = threading.Lock()
        self._live: set = set()
        self.records: list[dict] = []
        self.threads: list[threading.Thread] = []
        #: called once with a record when its first token arrives
        self.on_first = None

    def body(self, messages: list[dict], max_tokens: int) -> dict:
        return {"model": self.model, "messages": messages, "stream": True,
                "stream_options": {"include_usage": True},
                "max_tokens": max_tokens, "temperature": 0,
                "logit_bias": self.bias}

    def chat(self, rec: dict) -> dict:
        """Send ``rec``'s messages, stream the answer, fill in the
        record (``sent``, ``times``, ``text``, ``ok``) and keep it."""
        conn = http.client.HTTPConnection(self.host, self.port, timeout=900)
        times: list[float] = []
        pieces: list[str] = []
        usage = None
        rec["ok"] = False
        with self._lock:
            self._live.add(conn)
        try:
            if self.stop.is_set():
                rec["err"] = "not sent: the run was over"
                return rec
            payload = json.dumps(self.body(rec["messages"],
                                           rec["max_tokens"])).encode()
            rec["sent"] = time.monotonic()
            conn.request("POST", "/v1/chat/completions", body=payload,
                         headers={"content-type": "application/json"})
            r = conn.getresponse()
            if r.status != 200:
                rec["err"] = f"HTTP {r.status}: {r.read()[:300]!r}"
                return rec
            done = False
            while True:
                line = r.readline()
                if not line:
                    break
                now = time.monotonic()
                if line.startswith(b"data: [DONE]"):
                    done = True
                    break
                if not line.startswith(b"data: {"):
                    continue
                frame = json.loads(line[6:])
                for c in frame.get("choices") or ():
                    piece = (c.get("delta") or {}).get("content") or ""
                    if piece:
                        if not pieces and self.on_first is not None:
                            self.on_first(rec)
                        pieces.append(piece)
                        times.extend([now] * len(piece))
                usage = frame.get("usage") or usage
            rec["ok"] = done and usage is not None
            if not rec["ok"]:
                rec["err"] = "stream ended without [DONE] and usage"
                rec["cut"] = self.stop.is_set()
        except (OSError, http.client.HTTPException, ValueError) as e:
            rec["err"] = f"{type(e).__name__}: {e}"
            rec["cut"] = self.stop.is_set()
        finally:
            with self._lock:
                self._live.discard(conn)
            conn.close()
            rec["times"] = times
            rec["text"] = "".join(pieces)
            rec["usage"] = usage
            with self._lock:
                self.records.append(rec)
        return rec

    def spawn(self, rec: dict) -> threading.Thread:
        """``chat(rec)`` on a thread of its own."""
        th = threading.Thread(target=self.chat, args=(rec,), daemon=True)
        th.start()
        self.threads.append(th)
        return th

    def abort(self) -> None:
        """Stop sending and cut every stream in flight."""
        self.stop.set()
        with self._lock:
            live = list(self._live)
        for conn in live:
            sock = conn.sock
            if sock is not None:
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass


def announce(line: str) -> None:
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def main(argv: list[str]) -> int:
    plan_path, out_path = argv[1], argv[2]
    with open(plan_path) as f:
        plan = json.load(f)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    arrival = importlib.import_module(
        "arrivals." + plan["traffic"]["arrival"])
    client = Client(plan)
    try:
        arrival.run(plan, client, random.Random(plan["seed"]), announce)
    finally:
        client.abort()
        # one bound for all the threads together: a stream that the
        # abort could not cut is left behind, unrecorded, with the
        # daemon thread that reads it
        end = time.monotonic() + 30
        for th in client.threads:
            th.join(timeout=max(0.0, end - time.monotonic()))
    with client._lock:
        records = list(client.records)
    with open(out_path, "w") as f:
        for rec in sorted(records, key=lambda r: r["id"]):
            f.write(json.dumps(rec) + "\n")
    announce("DONE")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
