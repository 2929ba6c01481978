"""The port's offline batch tier against the JAX package's.

Engines (the reference's ``Engine`` and the port's on the reference's
``init_params(PRNGKey(0), TINY, float32)`` weights, a float32 pool, 4
slots, ``batch_slot_frac`` 0.5) run the same scripts:

- the ceiling: four batch requests never hold more than two slots, and
  fill both;
- park and resume: two live batch streams, then an interactive burst
  of four on the full table; the burst parks both batch sessions through
  the export and the tier resumes them once the burst is done. The
  preemption and resume counts, every stream (each equal to its solo
  run) and each batch request's MeterRecord (two segments, the whole
  session's tokens) equal the reference's;
- never shed: batch requests queue past ``max_queued_requests``, where
  interactive ones are refused;
- the cancel finish: a batch request cancelled while live, while queued
  behind the ceiling, and while parked each finishes ``cancelled``.

The server (the reference's ``TPUServeServer`` and the port's, the same
float32 weights): ``/v1/files`` and ``/v1/batches`` answer as the
reference's do (the error matrix word for word, a batch run to
``completed`` with its output lines equal, a cancel), the
``x-aigw-priority: batch`` header is honoured, and ``/metrics`` renders
the batch, migration and KV gauges with ``/state``'s values.
"""

import asyncio
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aigw_tpu.models import llama as jllama
from aigw_tpu.tpuserve import engine as jengine
from aigw_tpu.tpuserve import server as jserver
from aigw_tpu.tpuserve.sampling import SamplingParams as JSampling
from aigw_tpu_torch.models import convert
from aigw_tpu_torch.models import llama as tllama
from aigw_tpu_torch.obs import metrics as tmetrics
from aigw_tpu_torch.tpuserve import engine as tengine
from aigw_tpu_torch.tpuserve import server as tserver
from aigw_tpu_torch.tpuserve.sampling import SamplingParams as TSampling

EOS = (257,)
CFG = dict(max_batch_size=4, max_seq_len=256, page_size=16,
           decode_steps_per_tick=4, attention_backend="pallas-ragged",
           decode_backend="fused", kv_cache_dtype="float32",
           batch_slot_frac=0.5)


def _seq(a, b, n=40, mod=400):
    return [(a * i + b) % mod + 1 for i in range(n)]


@pytest.fixture(scope="module")
def weights():
    p = jllama.init_params(jax.random.PRNGKey(0), jllama.TINY,
                           dtype=jnp.float32)
    return p, convert.params_from_numpy(
        {k: np.asarray(v) for k, v in p.items()}, device="cpu")


class _Side:
    """One package's engine, started, with a submit helper."""

    def __init__(self, weights, mod, **over):
        self.mod = mod
        cfg = mod.EngineConfig(**{**CFG, **over})
        if mod is jengine:
            self.eng = mod.Engine(weights[0], jllama.TINY, cfg,
                                  eos_token_ids=EOS)
        else:
            self.eng = mod.Engine(weights[1], tllama.TINY, cfg,
                                  eos_token_ids=EOS, device="cpu")
        self.eng.start()

    def submit(self, prompt, n, priority="interactive"):
        """(tokens, finish list, done, first-token event, meter box,
        request)."""
        toks: list[int] = []
        fins: list = []
        done, first = threading.Event(), threading.Event()
        box: dict = {}

        def emit(tok, fin):
            if tok >= 0:
                toks.append(tok)
                first.set()
            if fin is not None:
                fins.append(fin)
                done.set()

        sp = (JSampling if self.mod is jengine else TSampling)(
            temperature=0.0)
        req = self.mod.GenRequest(prompt=list(prompt), max_tokens=n,
                                  sampling=sp, emit=emit,
                                  priority=priority, meter_sink=box.update)
        self.eng.submit(req)
        return toks, fins, done, first, box, req


@pytest.fixture(scope="module")
def sides(weights):
    out = {"reference": _Side(weights, jengine),
           "port": _Side(weights, tengine)}
    yield out
    for s in out.values():
        s.eng.stop()


def _wait(pred, what, timeout=300.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.005)


def _ceiling(side) -> int:
    runs = [side.submit(_seq(3, k, 30), 12, "batch") for k in range(4)]
    peak = 0
    while not all(r[2].is_set() for r in runs):
        peak = max(peak, side.eng.stats.batch_active)
        time.sleep(0.002)
    assert all(len(r[0]) == 12 for r in runs)
    return peak


def test_batch_ceiling_bounds_active_slots(sides):
    assert _ceiling(sides["port"]) == _ceiling(sides["reference"]) == 2


BATCH = [_seq(11, 5), _seq(13, 7)]
BURST = [_seq(3, 100 + k, 30, 300) for k in range(4)]


def _park_script(side) -> dict:
    """Two live batch streams, then an interactive burst of four."""
    st = side.eng.stats
    pre0, res0 = st.batch_preemptions, st.batch_resumed
    batch = [side.submit(p, 40, "batch") for p in BATCH]
    for r in batch:
        assert r[3].wait(300)  # a park needs a generated token
    burst = [side.submit(p, 8) for p in BURST]
    for r in burst + batch:
        assert r[2].wait(300)
    _wait(lambda: side.eng.stats.batch_active == 0, "batch still live")
    meters = [{k: r[4][k] for k in ("finish", "decode_tokens", "segments",
                                    "priority")} for r in batch]
    return {"batch": [r[0] for r in batch], "burst": [r[0] for r in burst],
            "fins": [r[1] for r in batch + burst],
            "preempted": st.batch_preemptions - pre0,
            "resumed": st.batch_resumed - res0, "meters": meters}


@pytest.fixture(scope="module")
def parked(sides):
    return {name: _park_script(s) for name, s in sides.items()}


def test_parked_batch_streams_match_reference(parked):
    got, want = parked["port"], parked["reference"]
    assert got == want
    assert got["preempted"] == got["resumed"] == 2
    assert all(f == ["length"] for f in got["fins"])
    assert [m["segments"] for m in got["meters"]] == [2, 2]
    assert [m["decode_tokens"] for m in got["meters"]] == [40, 40]


def test_parked_streams_equal_solo_runs(sides, parked):
    side = sides["port"]
    for prompt, toks in zip(BATCH, parked["port"]["batch"]):
        r = side.submit(prompt, 40)
        assert r[2].wait(300) and r[0] == toks
    for prompt, toks in zip(BURST, parked["port"]["burst"]):
        r = side.submit(prompt, 8)
        assert r[2].wait(300) and r[0] == toks


@pytest.mark.parametrize("name", ["reference", "port"])
def test_batch_never_sheds(weights, name):
    mod = jengine if name == "reference" else tengine
    side = _Side(weights, mod, max_queued_requests=2)
    try:
        runs = [side.submit(_seq(7, k, 20), 4, "batch") for k in range(6)]
        with pytest.raises(mod.EngineOverloadedError):
            for k in range(8):  # interactive past the queue bound
                side.submit(_seq(5, k, 20), 200)
        assert all(r[2].wait(300) for r in runs)
        assert all(r[1] == ["length"] for r in runs)
    finally:
        side.eng.stop()


def _cancel_script(side) -> list:
    """Cancel a live batch request, a queued one (behind the ceiling) and
    a parked one: their finishes."""
    out = []
    live = side.submit(_seq(17, 1), 200, "batch")
    live2 = side.submit(_seq(17, 2), 200, "batch")
    queued = side.submit(_seq(17, 3), 200, "batch")
    assert live[3].wait(300) and live2[3].wait(300)
    queued[5].cancelled.set()
    live[5].cancelled.set()
    assert live[2].wait(60)
    out += [live[1], queued[1] if queued[2].wait(60) else None]
    # park live2 (the table filled by interactive work), then cancel it
    burst = [side.submit(p, 30) for p in BURST]
    _wait(lambda: side.eng.stats.batch_active == 0 or live2[2].is_set(),
          "never parked")
    live2[5].cancelled.set()
    for r in burst:
        assert r[2].wait(300)
    assert live2[2].wait(60)
    out.append(live2[1])
    _wait(lambda: side.eng.stats.batch_queued == 0
          and side.eng.stats.batch_active == 0, "batch work left")
    return out


def test_cancelled_batch_requests_finish(sides):
    got = _cancel_script(sides["port"])
    assert got == _cancel_script(sides["reference"])
    assert got == [["cancelled"]] * 3


# -- the server ---------------------------------------------------------------
MODEL = "tiny-random"
SERVER_CFG = dict(max_batch_size=2, max_seq_len=256, page_size=16,
                  kv_cache_dtype="float32")


def _http(port, path, body=None, raw=None, headers=None, method=None):
    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, method=method,
        headers={"content-type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.fixture(scope="module")
def servers(weights):
    """(reference port, port replica)."""
    from aiohttp import web

    class F32Server(jserver.TPUServeServer):
        def _load_params(self, spec):
            return weights[0]

    holder = {}
    started = threading.Event()

    def run():
        async def main():
            server = F32Server(MODEL, jengine.EngineConfig(
                attention_backend="pallas-ragged", **SERVER_CFG))
            holder["server"] = server
            runner = web.AppRunner(server.app)
            await runner.setup()
            site = web.TCPSite(runner, "127.0.0.1", 0)
            await site.start()
            holder["port"] = site._server.sockets[0].getsockname()[1]
            holder["loop"] = asyncio.get_running_loop()
            holder["stop"] = asyncio.Event()
            started.set()
            await holder["stop"].wait()
            await runner.cleanup()

        asyncio.run(main())

    t = threading.Thread(target=run, daemon=True)
    t.start()
    assert started.wait(timeout=300)
    srv = tserver.TPUServeServer(MODEL, tengine.EngineConfig(**SERVER_CFG),
                                 device="cpu", port=0, params=weights[1])
    srv.start()
    yield holder, srv
    srv.stop()
    holder["loop"].call_soon_threadsafe(holder["stop"].set)
    t.join(timeout=60)


def _line(cid, **body):
    return {"custom_id": cid, "method": "POST",
            "url": "/v1/chat/completions",
            "body": {"model": MODEL, "max_tokens": 6, "temperature": 0,
                     **body}}


def _chat_body(text):
    return {"messages": [{"role": "user", "content": text}]}


def _jsonl(lines) -> bytes:
    return b"\n".join(json.dumps(x).encode() if not isinstance(x, bytes)
                      else x for x in lines)


BAD_INPUTS = [
    [b"{not json"],
    [b"[1, 2]"],
    [{"method": "POST", "body": {}}],
    [_line("a", **_chat_body("x")), _line("a", **_chat_body("y"))],
    [dict(_line("a", **_chat_body("x")), method="GET")],
    [dict(_line("a", **_chat_body("x")), url="/v1/completions")],
    [{"custom_id": "a", "body": "text"}],
    [_line("a", stream=True, **_chat_body("x"))],
    [b"", b"   "],
]


def _matrix(port) -> list:
    """Every refusal of the batch routes: (status, body) each."""
    out = [_http(port, "/v1/files", raw=b"  \n")]
    for lines in BAD_INPUTS:
        _s, raw = _http(port, "/v1/files", raw=_jsonl(lines) or b"\n\n ")
        if _s != 200:
            out.append((_s, raw))
            continue
        fid = json.loads(raw)["id"]
        out.append(_http(port, "/v1/batches", {
            "input_file_id": fid, "endpoint": "/v1/chat/completions"}))
    out += [
        _http(port, "/v1/batches", {"input_file_id": "file-nope",
                                    "endpoint": "/v1/chat/completions"}),
        _http(port, "/v1/batches", {"input_file_id": "x",
                                    "endpoint": "/v1/embeddings"}),
        _http(port, "/v1/batches", raw=b"{bad"),
        _http(port, "/v1/batches/batch_nope"),
        _http(port, "/v1/batches/batch_nope/cancel", {}),
        _http(port, "/v1/files/file-nope/content"),
    ]
    return [(s, json.loads(b)) for s, b in out]


def test_batch_route_refusals_match_reference(servers):
    holder, srv = servers
    got, want = _matrix(srv.port), _matrix(holder["port"])
    assert got == want
    assert [s for s, _b in got].count(400) >= 9


def _run_batch(port, lines) -> tuple[dict, list]:
    status, raw = _http(port, "/v1/files", raw=_jsonl(lines))
    assert status == 200
    f = json.loads(raw)
    assert (f["object"], f["purpose"], f["bytes"]) == (
        "file", "batch", len(_jsonl(lines)))
    assert _http(port, f"/v1/files/{f['id']}/content")[1] == _jsonl(lines)
    status, raw = _http(port, "/v1/batches", {
        "input_file_id": f["id"], "endpoint": "/v1/chat/completions"})
    assert status == 200
    b = json.loads(raw)
    assert b["status"] == "in_progress"
    _wait(lambda: json.loads(_http(port, f"/v1/batches/{b['id']}")[1])[
        "status"] == "completed", "the batch never completed")
    b = json.loads(_http(port, f"/v1/batches/{b['id']}")[1])
    listed = json.loads(_http(port, "/v1/batches")[1])
    assert listed["object"] == "list" and b in listed["data"]
    out = _http(port, f"/v1/files/{b['output_file_id']}/content")[1]
    return b, [json.loads(ln) for ln in out.splitlines() if ln.strip()]


def _summary(batch, out) -> tuple:
    lines = sorted(((o["custom_id"], o["response"]["status_code"],
                     o["error"], o["response"]["body"]) for o in out),
                   key=lambda x: x[0])
    norm = []
    for cid, status, err, body in lines:
        if status == 200:
            ch = body["choices"][0]
            u = body["usage"]
            body = (body["object"], ch["message"]["content"],
                    ch["finish_reason"], u["prompt_tokens"],
                    u["completion_tokens"], u["aigw_meter"]["priority"])
        norm.append((cid, status, err, body))
    return (batch["status"], batch["request_counts"],
            batch["endpoint"], norm)


LINES = [_line(f"req-{k}", **_chat_body(f"batch line number {k}"))
         for k in range(3)] + [_line("bad-model", model="tiny-random:nope",
                                     **_chat_body("x"))]


def test_batch_run_matches_reference(servers):
    holder, srv = servers
    got = _summary(*_run_batch(srv.port, LINES))
    assert got == _summary(*_run_batch(holder["port"], LINES))
    assert got[1] == {"total": 4, "completed": 3, "failed": 1}
    assert all(line[3][5] == "batch" for line in got[3] if line[1] == 200)


def test_batch_cancel_finalizes(servers):
    holder, srv = servers
    lines = [_line(f"c{k}", **dict(_chat_body(f"cancel me {k}"),
                                   max_tokens=200)) for k in range(6)]
    finals = []
    for port in (srv.port, holder["port"]):
        fid = json.loads(_http(port, "/v1/files", raw=_jsonl(lines))[1])["id"]
        b = json.loads(_http(port, "/v1/batches", {
            "input_file_id": fid, "endpoint": "/v1/chat/completions"})[1])
        status, raw = _http(port, f"/v1/batches/{b['id']}/cancel", {})
        assert status == 200 and json.loads(raw)["status"] == "cancelling"
        _wait(lambda: json.loads(_http(port, f"/v1/batches/{b['id']}")[1])[
            "status"] == "cancelled", "the batch never finalized")
        b = json.loads(_http(port, f"/v1/batches/{b['id']}")[1])
        assert b["output_file_id"]
        finals.append(b["status"])
    assert finals == ["cancelled", "cancelled"]


def test_priority_header_and_metrics(servers):
    _holder, srv = servers
    before = json.loads(_http(srv.port, "/state")[1])["batch_tokens"]
    status, raw = _http(srv.port, "/v1/chat/completions",
                        {"model": MODEL, "max_tokens": 5, "temperature": 0,
                         **_chat_body("offline please")},
                        headers={"x-aigw-priority": "batch"})
    assert status == 200
    usage = json.loads(raw)["usage"]
    assert usage["aigw_meter"]["priority"] == "batch"
    st = json.loads(_http(srv.port, "/state")[1])
    assert st["batch_tokens"] - before == usage["completion_tokens"]
    assert st["batch_slot_frac"] == 0.5 and st["migration"] is True
    text = _http(srv.port, "/metrics")[1].decode()
    fams = tmetrics.parse_exposition(text)
    assert set(fams) == tmetrics.metric_families()
    st = json.loads(_http(srv.port, "/state")[1])
    values = {ln.split()[0]: float(ln.split()[1])
              for ln in text.splitlines() if ln and ln[0] != "#"}
    names = dict(tmetrics.ENGINE_GAUGES)
    for attr in ("batch_tokens", "batch_preemptions", "batch_resumed",
                 "migrations_out", "migrations_in", "kv_spills",
                 "kv_fetches_in", "migratable_slots"):
        assert values[names[attr]] == st[attr], attr
