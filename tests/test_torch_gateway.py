"""The port's gateway and the reference's (aiohttp) in front of the same
tiny-random CPU port replicas, with the same config and request script:
responses equal with ids, timestamps and the residency meter masked,
SSE frames equal in order, ``/usage``, ``/v1/models``, ``/health`` and
the ``/metrics`` family names equal; over two replicas a drained one
receives nothing on either gateway; a closed port and an always-503
upstream give equal retries and ``aigw_retries_total``. Then
``python -m aigw_tpu_torch run`` in front of a replica, and its
refusal of an unported field."""

import asyncio
import json
import os
import re
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from aigw_tpu.config import model as jmodel
from aigw_tpu.config import runtime as jruntime
from aigw_tpu.gateway import server as jserver
from aigw_tpu.obs import slomon as jslomon
from aigw_tpu_torch.config import model as tmodel
from aigw_tpu_torch.config import runtime as truntime
from aigw_tpu_torch.gateway import server as tserver
from aigw_tpu_torch.obs import slomon as tslomon

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = "tiny-random"
CHAT = "/v1/chat/completions"
TEXT = "/v1/completions"
EMBED = "/v1/embeddings"


def _replica():
    from aigw_tpu_torch.tpuserve.engine import EngineConfig
    from aigw_tpu_torch.tpuserve.server import TPUServeServer

    srv = TPUServeServer(
        MODEL, EngineConfig(max_batch_size=4, max_seq_len=256, page_size=16, logprobs_topk=4,
                            enable_prefix_cache=False),
        device="cpu", port=0, param_dtype="float32")
    srv.start()
    return srv


@pytest.fixture(scope="module")
def replicas():
    a, b = _replica(), _replica()
    yield a, b
    a.stop()
    b.stop()


@pytest.fixture(scope="module")
def loop():
    lp = asyncio.new_event_loop()
    t = threading.Thread(target=lp.run_forever, daemon=True)
    t.start()
    yield lp
    lp.call_soon_threadsafe(lp.stop)
    t.join(timeout=10)


def _on(loop, coro, timeout=60):
    return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout)


class _Gateways:
    """Both gateways on one config, in the test's event loop thread."""

    def __init__(self, loop, raw):
        self.loop = loop

        async def start():
            jsrv, runner = await jserver.run_gateway(
                jruntime.RuntimeConfig.build(jmodel.Config.parse(raw)),
                port=0)
            tsrv = await tserver.run_gateway(
                truntime.RuntimeConfig.build(tmodel.Config.parse(raw)),
                port=0)
            return jsrv, runner, tsrv

        self.jsrv, self.runner, self.tsrv = _on(loop, start())
        self.ports = {"ref": self.runner.addresses[0][1],
                      "port": self.tsrv.port}

    def close(self):
        async def stop():
            await self.runner.cleanup()
            await self.tsrv.stop()

        _on(self.loop, stop())


def _http(port, path, body=None, headers=None, method=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"content-type": "application/json", **(headers or {})},
        method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


_MASKED = ("id", "created", "hbm_page_byte_s", "host_page_byte_s", "t0",
           "t1", "ts")


def _mask(obj):
    if isinstance(obj, dict):
        return {k: "*" if k in _MASKED else _mask(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_mask(v) for v in obj]
    return obj


def _frames(raw):
    frames = [f for f in raw.decode().split("\n\n") if f.strip()]
    return [f if f == "data: [DONE]" else
            _mask(json.loads(f[len("data: "):])) for f in frames]


def _merged(frames):
    """A stream with its token frames merged per choice: how many tokens
    a replica frame carries, and whether the last one shares the finish
    frame, follow its emit timing, not the request; so a live replica's
    streams are compared merged (text, logprobs, finish reason, role and
    the frames' object and model per choice, the frames without choices
    in order) and the frames themselves on a replayed upstream
    (``test_sse_frames_relay_alike``)."""
    out, acc = [], {}
    for f in frames:
        choices = f.get("choices") if isinstance(f, dict) else None
        if not choices:
            out.append(f)
            continue
        for c in choices:
            a = acc.setdefault(c.get("index", 0), {
                "text": "", "lp": [], "finish": None, "role": None,
                "shape": {(f.get("object"), f.get("model"))}})
            a["shape"].add((f.get("object"), f.get("model")))
            delta = c.get("delta") or {}
            a["text"] += delta.get("content") or c.get("text") or ""
            lp = c.get("logprobs") or {}
            a["lp"] += lp.get("content") or lp.get("tokens") or []
            a["finish"] = c.get("finish_reason") or a["finish"]
            a["role"] = a["role"] or delta.get("role")
    return sorted(acc.items()), out


def _reply(status, headers, raw):
    ctype = {k.lower(): v for k, v in headers.items()}.get("content-type",
                                                            "")
    if "text/event-stream" in ctype:
        return status, "sse", _merged(_frames(raw))
    try:
        return status, "json", _mask(json.loads(raw))
    except ValueError:
        return status, "raw", raw


def _chat(**kw):
    return {"model": MODEL, "messages": [
        {"role": "system", "content": "be brief"},
        {"role": "user", "content": "hello there"}],
        "max_tokens": 6, "temperature": 0, **kw}


def _text(**kw):
    return {"model": MODEL, "prompt": "the quick brown fox",
            "max_tokens": 5, "seed": 7, "temperature": 0.8, **kw}


SCRIPT = [
    (CHAT, _chat(), {}),
    (CHAT, _chat(stream=True, stream_options={"include_usage": True}), {}),
    (TEXT, _text(), {"x-aigw-tenant": "acme"}),
    (TEXT, _text(stream=True, n=2,
                 stream_options={"include_usage": True}), {}),
    (CHAT, _chat(n=2, seed=3, temperature=0.7), {}),
    (CHAT, _chat(stream=True, logprobs=True, top_logprobs=2), {}),
    (TEXT, _text(model=f"{MODEL}:nope"), {}),
    (EMBED, {"model": MODEL, "input": ["hello", [1, 2, 3]]}, {}),
    (CHAT, _chat(temperature=5), {}),
    (CHAT, _chat(model="gpt-nope"), {}),
    (TEXT, {"model": MODEL}, {}),
]


def _pool_config(addrs, **backend):
    return {
        "version": "v1",
        "backends": [{"name": "pool", "schema": "TPUServe",
                      "endpoints": [{"address": a, "slice": "s0"}
                                    for a in addrs],
                      "picker_poll_interval": 0.1,
                      "picker_content_affinity": True, **backend}],
        "routes": [{"name": "serving", "rules": [
            {"model_prefixes": ["tiny"], "backends": ["pool"]}]}],
        "models": [MODEL],
        # one ledger window: a minute boundary between the two gateways'
        # scripts would close a window on one of them only
        "usage": {"window_s": 1e9},
        "llm_request_costs": [
            {"metadata_key": "total_tokens", "type": "TotalToken"},
            {"metadata_key": "weighted", "type": "Expression",
             "expression": "input_tokens + 4 * output_tokens"}],
    }


def _families(text):
    return {m.group(1) for m in re.finditer(r"^# TYPE (\S+) ", text, re.M)}


def _samples(text, name):
    return sorted(line for line in text.splitlines()
                  if line.startswith(name + "{"))


def _wait(pred, what, timeout=20.0):
    import time

    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _fleet_ready(gw, n):
    def ok():
        for port in gw.ports.values():
            st = json.loads(_http(port, "/fleet/state")[2])
            reps = st["backends"]["pool"]["replicas"]
            if sum(r["health"]["state"] == "up" for r in reps.values()) < n:
                return False
        return True

    _wait(ok, f"{n} replicas up on both gateways")


def test_script_matches_reference_gateway(replicas, loop):
    a, _b = replicas
    gw = _Gateways(loop, _pool_config([f"127.0.0.1:{a.port}"]))
    try:
        _fleet_ready(gw, 1)
        got = {}
        for name, port in gw.ports.items():
            got[name] = [_reply(*_http(port, path, body, hdr))
                         for path, body, hdr in SCRIPT]
        for i, (want, have) in enumerate(zip(got["ref"], got["port"])):
            assert have == want, (i, SCRIPT[i][:2])
        statuses = [s for s, _k, _b in got["port"]]
        assert statuses == [200] * 6 + [404, 200, 400, 404, 400]
        assert [k for _s, k, _b in got["port"]][:2] == ["json", "sse"]
        ends = {}
        for name, port in gw.ports.items():
            ends[name] = {p: _http(port, p)
                          for p in ("/usage", "/v1/models", "/health",
                                    "/metrics", "/debug/decisions",
                                    "/fleet/state")}
        for p in ("/usage", "/v1/models", "/health"):
            assert _reply(*ends["port"][p]) == _reply(*ends["ref"][p]), p
        usage = json.loads(ends["port"]["/usage"][2])
        assert usage["totals"]["records"] == 7
        assert usage["totals"]["cost"] > 0
        mt = {n: ends[n]["/metrics"][2].decode() for n in ends}
        assert _families(mt["port"]) == _families(mt["ref"])
        for fam in ("aigw_requests_total", "aigw_usage_records_total"):
            assert _samples(mt["port"], fam) == _samples(mt["ref"], fam)
        dec = {n: json.loads(ends[n]["/debug/decisions"][2])
               for n in ends}
        assert dec["port"]["recorded"] == dec["ref"]["recorded"] == 8
        keys = [sorted(d) for d in dec["ref"]["decisions"]]
        assert [sorted(d) for d in dec["port"]["decisions"]] == keys
        costs = [d.get("costs") for d in dec["ref"]["decisions"]]
        assert [d.get("costs") for d in dec["port"]["decisions"]] == costs
        assert sum(c is not None for c in costs) == 7
        fs = {n: json.loads(ends[n]["/fleet/state"][2]) for n in ends}
        assert sorted(fs["port"]) == sorted(fs["ref"])
        assert fs["port"]["fleet"].keys() == fs["ref"]["fleet"].keys()
    finally:
        gw.close()


def test_replica_metrics_histograms_parse_alike(replicas):
    a, _b = replicas
    assert _http(a.port, TEXT, _text(max_tokens=2))[0] == 200
    text = _http(a.port, "/metrics")[2].decode()
    for fam in ("tpuserve_ttft_hist_ms", "tpuserve_prefill_hist_ms",
                "gen_ai_server_request_duration_seconds"):
        got = tslomon.parse_hist_buckets(text, fam)
        assert got == jslomon.parse_hist_buckets(text, fam)
        assert got and got["+Inf"] >= 1, fam


def test_drained_replica_receives_nothing(replicas, loop):
    a, b = replicas
    addrs = [f"127.0.0.1:{r.port}" for r in (a, b)]
    gw = _Gateways(loop, _pool_config(addrs))
    served = lambda r: json.loads(_http(r.port, "/state")[2])[  # noqa: E731
        "meter_records"]
    try:
        _fleet_ready(gw, 2)
        assert _http(b.port, "/drain", {})[0] == 200

        def drained():
            for port in gw.ports.values():
                st = json.loads(_http(port, "/fleet/state")[2])
                h = st["backends"]["pool"]["replicas"][addrs[1]]
                if h["health"]["state"] != "draining":
                    return False
            return True

        _wait(drained, "the drained replica on both gateways")
        before = served(b), served(a)
        for port in gw.ports.values():
            for i in range(4):
                body = _chat(messages=[{"role": "user",
                                        "content": f"q{i}"}])
                assert _http(port, CHAT, body)[0] == 200
        assert served(b) == before[0]
        assert served(a) == before[1] + 8
        for port in gw.ports.values():
            dec = json.loads(_http(port, "/debug/decisions")[2])
            assert {d["chosen"] for d in dec["decisions"]} == {addrs[0]}
    finally:
        _http(b.port, "/drain", {"on": False})
        gw.close()


class _Always503(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def do_POST(self):
        self.rfile.read(int(self.headers.get("content-length", 0)))
        body = b'{"error": "overloaded"}'
        self.send_response(503)
        self.send_header("content-type", "application/json")
        self.send_header("content-length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


def test_retries_over_priorities_match_reference(replicas, loop):
    """A closed port (priority 0), an always-503 upstream (priority 1),
    then the replica (priority 2): equal statuses, bodies, retry and
    request counters, and breaker state; a rule with only the dead
    backends answers the last upstream error on both."""
    a, _b = replicas
    fake = ThreadingHTTPServer(("127.0.0.1", 0), _Always503)
    threading.Thread(target=fake.serve_forever, daemon=True).start()
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    closed = s.getsockname()[1]
    s.close()
    raw = {
        "version": "v1",
        "backends": [
            {"name": "dead", "schema": "OpenAI",
             "url": f"http://127.0.0.1:{closed}"},
            {"name": "busy", "schema": "OpenAI",
             "url": f"http://127.0.0.1:{fake.server_address[1]}"},
            {"name": "replica", "schema": "TPUServe",
             "url": f"http://127.0.0.1:{a.port}"}],
        "routes": [{"name": "r", "rules": [
            {"models": [MODEL], "backends": [
                {"backend": "dead", "priority": 0},
                {"backend": "busy", "priority": 1},
                {"backend": "replica", "priority": 2}]},
            {"models": ["only-dead"], "backends": [
                {"backend": "dead", "priority": 0},
                {"backend": "busy", "priority": 1}]}]}],
    }
    gw = _Gateways(loop, raw)
    try:
        got = {}
        for name, port in gw.ports.items():
            got[name] = [
                _reply(*_http(port, CHAT, _chat())),
                _reply(*_http(port, CHAT, _chat(stream=True))),
                _reply(*_http(port, CHAT, _chat(model="only-dead"))),
            ]
        assert [g[0] for g in got["port"]] == [200, 200, 503]
        assert got["port"][:2] == got["ref"][:2]
        # the last upstream's error, in the same envelope
        assert got["port"][2] == got["ref"][2]
        mt = {n: _http(p, "/metrics")[2].decode()
              for n, p in gw.ports.items()}
        for fam in ("aigw_retries_total", "aigw_requests_total"):
            assert _samples(mt["port"], fam) == _samples(mt["ref"], fam)
            assert _samples(mt["port"], fam), fam
        health = {n: json.loads(_http(p, "/health")[2])
                  for n, p in gw.ports.items()}
        assert _mask(health["port"]) == _mask(health["ref"])
    finally:
        gw.close()
        fake.shutdown()
        fake.server_close()


def test_cli_run_serves_and_refuses_unported_fields(replicas, tmp_path):
    a, _b = replicas
    cfg = tmp_path / "gw.json"
    cfg.write_text(json.dumps(_pool_config([f"127.0.0.1:{a.port}"])))
    env = dict(os.environ, AIGW_DRAIN_SECONDS="0")
    proc = subprocess.Popen(
        [sys.executable, "-m", "aigw_tpu_torch", "run", str(cfg),
         "--port", "0", "--watch-interval", "0.2"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        line = proc.stdout.readline()
        m = re.search(r"gateway listening on http://[\d.]+:(\d+)", line)
        assert m, (line, proc.stderr.read() if proc.poll() else "")
        port = int(m.group(1))
        _wait(lambda: json.loads(_http(port, "/fleet/state")[2])[
            "backends"]["pool"]["rollup"]["replicas_up"] == 1, "a poll")
        s, h, raw = _http(port, CHAT, _chat())
        assert s == 200 and json.loads(raw)["usage"]["completion_tokens"]
        s, h, raw = _http(port, TEXT, _text(stream=True))
        assert s == 200 and raw.rstrip().endswith(b"data: [DONE]")
        s, h, raw = _http(port, EMBED, {"model": MODEL, "input": "x"})
        assert s == 200 and json.loads(raw)["data"][0]["embedding"]
        # a hot reload drops the model's route
        raw_cfg = _pool_config([f"127.0.0.1:{a.port}"])
        raw_cfg["routes"][0]["rules"][0]["model_prefixes"] = ["other"]
        cfg.write_text(json.dumps(raw_cfg))
        _wait(lambda: _http(port, CHAT, _chat())[0] == 404, "the reload")
    finally:
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        proc.stdout.close()
        proc.stderr.close()
    # a live cluster outside a cluster ends as the reference's does (the
    # cluster source itself: tests/test_torch_kube.py)
    done = [subprocess.run(
        [sys.executable, "-m", pkg, "run", "kube:in-cluster", "--port", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=60,
        env={k: v for k, v in os.environ.items()
             if k != "KUBERNETES_SERVICE_HOST"})
        for pkg in ("aigw_tpu", "aigw_tpu_torch")]
    assert done[1].returncode == done[0].returncode == 1
    assert done[1].stderr.strip().splitlines()[-1] == \
        done[0].stderr.strip().splitlines()[-1] == (
            "ValueError: not running in-cluster "
            "(KUBERNETES_SERVICE_HOST unset)")


class _Replay(BaseHTTPRequestHandler):
    """An upstream that answers every POST with ``self.server.script``:
    (content type, the body's pieces, written with a flush between)."""

    protocol_version = "HTTP/1.1"

    def do_POST(self):
        self.rfile.read(int(self.headers.get("content-length", 0)))
        ctype, pieces = self.server.script
        self.send_response(200)
        self.send_header("content-type", ctype)
        self.send_header("connection", "close")
        self.end_headers()
        for p in pieces:
            self.wfile.write(p)
            self.wfile.flush()

    def log_message(self, *a):
        pass


def _cut(raw, n):
    return [raw[i:i + n] for i in range(0, len(raw), n)]


def test_sse_frames_relay_alike(replicas, loop):
    """A replica's recorded stream replayed in 37-byte pieces, the same
    with a malformed event spliced in, the same cut mid-frame, and a
    malformed non-streamed body: both gateways relay the same frames in
    the same order (the malformed event never, the stream ending with
    the error event), and both answer the bad body 502."""
    a, _b = replicas
    body = _chat(stream=True, max_tokens=8,
                 stream_options={"include_usage": True})
    s, h, recorded = _http(a.port, CHAT, body)
    assert s == 200 and recorded.endswith(b"data: [DONE]\n\n")
    frames = recorded.split(b"\n\n")
    bad = b'data: {"choices": "not-a-list"}'
    spliced = b"\n\n".join(frames[:2] + [bad] + frames[2:])
    cut = recorded[:len(recorded) // 2 + 5]
    cases = [
        ("text/event-stream", _cut(recorded, 37)),
        ("text/event-stream", _cut(spliced, 53)),
        ("text/event-stream", _cut(cut, 41)),
        ("application/json", [b'{"choices": 7}']),
    ]
    fake = ThreadingHTTPServer(("127.0.0.1", 0), _Replay)
    threading.Thread(target=fake.serve_forever, daemon=True).start()
    raw = {"version": "v1",
           "backends": [{"name": "up", "schema": "OpenAI",
                         "url": f"http://127.0.0.1:{fake.server_address[1]}"}],
           "routes": [{"name": "r", "rules": [{"backends": ["up"]}]}]}
    gw = _Gateways(loop, raw)
    try:
        for i, case in enumerate(cases):
            fake.script = case
            got = {n: _http(p, CHAT, body if i < 3 else _chat())
                   for n, p in gw.ports.items()}
            assert got["port"][0] == got["ref"][0], i
            assert got["port"][2] == got["ref"][2], i
            if i == 0:
                assert got["port"][2] == recorded
            elif i < 3:
                assert got["port"][2].count(b"upstream_error") == 1
                assert b"not-a-list" not in got["port"][2]
            else:
                assert got["port"][0] == 502
        mt = {n: _http(p, "/metrics")[2].decode()
              for n, p in gw.ports.items()}
        assert _samples(mt["port"], "aigw_requests_total") == \
            _samples(mt["ref"], "aigw_requests_total")
    finally:
        gw.close()
        fake.shutdown()
        fake.server_close()
