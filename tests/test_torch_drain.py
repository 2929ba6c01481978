"""Draining a port replica: ``POST /drain``, ``drain()``, the reference
gateway's retire protocol and the CLI's signal handling.

- ``POST /drain``: every new generation (chat, completions, ``n > 1``,
  streamed or not) gets 503 with ``retry-after: 2`` and
  ``x-aigw-draining: 1`` and the reference's message, while requests
  already live finish with 200 and every token; ``/state`` says
  ``draining: true`` and the engine empties; ``{"on": false}`` lets the
  next request through. ``/tokenize`` stays open.
- ``drain(timeout_s)``: True once empty, False when the budget runs out
  with a request still live.
- The reference controller's ``drain_and_retire`` (its picker polling
  the port replica's ``/state``) retires a port replica that is serving
  a burst: every request completes, the drain reports empty, and the
  replica leaves the pool.
- ``python -m aigw_tpu_torch tpuserve`` on the CPU: SIGTERM while a
  request streams lets the stream end with ``[DONE]``, refuses new work
  meanwhile, and exits 0; a second signal stops it at once, exit 0.
"""

import asyncio
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = "tiny-random"
DRAIN_MSG = ("replica is draining (shutting down or being retired); "
             "retry against another replica")


def _http(port, path, body=None, headers=None, timeout=120):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"content-type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read().decode(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), dict(e.headers)


def _replica(**cfg):
    from aigw_tpu_torch.tpuserve.engine import EngineConfig
    from aigw_tpu_torch.tpuserve.server import TPUServeServer

    srv = TPUServeServer(MODEL, EngineConfig(max_seq_len=512, page_size=16,
                                             **cfg),
                         device="cpu", port=0)
    srv.start()
    return srv


def _chat(n_tokens, **kw):
    return {"model": MODEL, "messages": [{"role": "user",
                                          "content": "drain me"}],
            "max_tokens": n_tokens, "temperature": 0.0, **kw}


def _text(n_tokens, **kw):
    return {"model": MODEL, "prompt": "drain me", "max_tokens": n_tokens,
            "temperature": 0.0, **kw}


def _tokens(raw, stream):
    """Completion tokens of a reply (a stream's from its usage frame)."""
    if not stream:
        return json.loads(raw)["usage"]["completion_tokens"]
    frames = [ln[6:] for ln in raw.split("\n") if ln.startswith("data: ")]
    assert frames[-1] == "[DONE]"
    return [json.loads(f) for f in frames[:-1]][-1]["usage"][
        "completion_tokens"]


def _wait(pred, timeout=60.0, what=""):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


REFUSED = [
    ("/v1/chat/completions", _chat(4)),
    ("/v1/chat/completions", _chat(4, stream=True)),
    ("/v1/completions", _text(4)),
    ("/v1/completions", _text(4, n=2, temperature=0.7)),
    ("/v1/chat/completions", _chat(4, n=3, temperature=0.7, stream=True)),
]


def test_drain_refuses_new_work_and_lets_live_requests_finish():
    srv = _replica(max_batch_size=2)
    usage = {"stream_options": {"include_usage": True}}
    live = [("/v1/completions", _text(48, stream=True, **usage)),
            ("/v1/chat/completions", _chat(40)),
            ("/v1/completions", _text(30))]  # queued behind the two
    results: list = [None] * len(live)

    def one(i):
        path, body = live[i]
        results[i] = _http(srv.port, path, body)

    try:
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(live))]
        for t in threads:
            t.start()
        _wait(lambda: srv.engine.stats.tokens_generated >= 4,
              what="the burst to decode")
        status, body, _h = _http(srv.port, "/drain", {})
        reply = json.loads(body)
        assert status == 200 and reply["draining"] is True
        assert set(reply) == {"draining", "active_slots", "queued",
                              "live_streams"}
        assert reply["active_slots"] + reply["queued"] >= 1
        for path, body in REFUSED:
            status, raw, headers = _http(srv.port, path, body)
            assert status == 503, (path, body)
            assert headers["retry-after"] == "2"
            assert headers["x-aigw-draining"] == "1"
            assert json.loads(raw)["error"] == {
                "message": DRAIN_MSG, "type": "server_error", "code": None}
        assert _http(srv.port, "/tokenize", {"prompt": "x"})[0] == 200
        st = json.loads(_http(srv.port, "/state")[1])
        assert st["draining"] is True
        assert srv.drain(timeout_s=120)
        for t in threads:
            t.join(timeout=120)
        for (path, body), (status, raw, _h) in zip(live, results):
            assert status == 200
            assert _tokens(raw, body.get("stream", False)) \
                == body["max_tokens"]
        st = json.loads(_http(srv.port, "/state")[1])
        assert (st["active_slots"], st["queued"]) == (0, 0)
        reply = json.loads(_http(srv.port, "/drain", {"on": False})[1])
        assert reply == {"draining": False, "active_slots": 0,
                         "queued": 0, "live_streams": 0}
        assert _http(srv.port, "/v1/completions", _text(3))[0] == 200
        assert json.loads(_http(srv.port, "/state")[1])["draining"] is False
        empty = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/drain", data=b"", method="POST")
        with urllib.request.urlopen(empty, timeout=60) as r:
            assert r.status == 200  # no body: on
        assert srv.draining
        status, raw, _h = _http(srv.port, "/drain", {"on": False},
                                {"content-type": "text/plain"})
        assert status == 200 and not srv.draining
        assert _http(srv.port, "/drain", [1])[0] == 400
    finally:
        srv.stop()


def test_drain_times_out_with_a_live_request():
    srv = _replica(max_batch_size=1)
    try:
        out = {}
        t = threading.Thread(target=lambda: out.update(r=_http(
            srv.port, "/v1/completions", _text(200))))
        t.start()
        _wait(lambda: srv.engine.stats.active_slots == 1,
              what="the request to start")
        t0 = time.monotonic()
        assert srv.drain(timeout_s=0.2) is False
        assert time.monotonic() - t0 < 5
        stop = threading.Event()
        stop.set()
        assert srv.drain(timeout_s=60, stop=stop) is False  # cut at once
        t.join(timeout=300)
        assert out["r"][0] == 200
        assert srv.drain(timeout_s=60)
    finally:
        srv.stop()


def test_reference_controller_retires_a_port_replica():
    from aigw_tpu.gateway.controller import ControllerConfig, FleetController
    from aigw_tpu.gateway.picker import Endpoint, EndpointPicker

    srv = _replica(max_batch_size=2)
    addr = f"127.0.0.1:{srv.port}"
    burst = [("/v1/completions", _text(24)),
             ("/v1/chat/completions", _chat(
                 20, stream=True,
                 stream_options={"include_usage": True})),
             ("/v1/completions", _text(16))]
    results: list = [None] * len(burst)

    async def main():
        picker = EndpointPicker([Endpoint(addr)], poll_interval=0.05,
                                fleet_obs=True)
        ctl = FleetController(picker, ControllerConfig.parse({
            "min_replicas": 0, "max_replicas": 1, "drain_timeout_s": 120.0,
            "idle_ticks": 10 ** 6}))
        await picker.start()
        try:
            for _ in range(400):
                st = picker.state.get(addr)
                if st is not None and st.healthy:
                    break
                await asyncio.sleep(0.05)
            threads = [threading.Thread(target=lambda i=i: results.__setitem__(
                i, _http(srv.port, *burst[i]))) for i in range(len(burst))]
            for t in threads:
                t.start()
            await asyncio.to_thread(
                _wait, lambda: srv.engine.stats.tokens_generated >= 2,
                60.0, "the burst")
            drained = await ctl.drain_and_retire(addr, reason="test")
            late = await asyncio.to_thread(_http, srv.port,
                                           "/v1/completions", _text(2))
            for t in threads:
                await asyncio.to_thread(t.join, 120)
            return drained, late, [e.address for e in picker.endpoints], \
                [ev["action"] for ev in ctl.events]
        finally:
            await ctl.stop()
            await picker.stop()

    try:
        drained, late, endpoints, events = asyncio.run(main())
    finally:
        srv.stop()
    assert drained and endpoints == []
    assert events.count("drain_start") == 1 and "drain_complete" in events
    assert late[0] == 503 and late[2]["x-aigw-draining"] == "1"
    for (path, body), (status, raw, _h) in zip(burst, results):
        assert status == 200
        assert _tokens(raw, body.get("stream", False)) == body["max_tokens"]


def _spawn(log, *extra):
    proc = subprocess.Popen(
        [sys.executable, "-m", "aigw_tpu_torch", "tpuserve", "--model",
         MODEL, "--device", "cpu", "--port", "0", "--max-seq-len", "1024",
         "--page-size", "16", *extra],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=log, text=True,
        env={**os.environ, "PYTHONUNBUFFERED": "1"})
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if line.startswith("listening on http://"):
            return proc, int(line.rsplit(":", 1)[1])
        if proc.poll() is not None:
            break
    proc.kill()
    raise AssertionError(f"replica did not start: {log.read_text()}")


def _stream_until_first_frame(port, body, out):
    """POST a streamed completion; returns once its first frame arrives,
    the rest read by a thread into ``out``."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps(body).encode(),
        headers={"content-type": "application/json"})
    r = urllib.request.urlopen(req, timeout=300)
    first = r.readline() + r.readline()

    def rest():
        try:
            out["raw"] = (first + r.read()).decode()
        except Exception as e:  # noqa: BLE001 — a cut stream: reported
            out["raw"] = first.decode()
            out["error"] = repr(e)

    t = threading.Thread(target=rest)
    t.start()
    return t


@pytest.mark.parametrize("signals", [1, 2], ids=["drain", "insist"])
def test_cli_drains_on_sigterm_and_exits_zero(signals, tmp_path):
    log = tmp_path / "replica.log"
    with open(log, "w") as fh:
        proc, port = _spawn(fh, "--drain-grace", "120")
    try:
        out: dict = {}
        n = 160 if signals == 1 else 1000
        t = _stream_until_first_frame(port, _text(
            n, stream=True, stream_options={"include_usage": True}), out)
        proc.send_signal(signal.SIGTERM)
        if signals == 2:
            time.sleep(0.3)
            proc.send_signal(signal.SIGINT)
        else:
            _wait(lambda: _http(port, "/state")[1].find(
                '"draining": true') >= 0, what="the drain flag")
            status, _raw, headers = _http(port, "/v1/completions",
                                          _text(2))
            assert status == 503 and headers["retry-after"] == "2"
        rc = proc.wait(timeout=120)
        t.join(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert rc == 0, log.read_text()
    assert "signal received: draining" in log.read_text()
    if signals == 1:
        assert "error" not in out
        assert _tokens(out["raw"], True) == n
    else:
        assert '"finish_reason": "length"' not in out["raw"]
