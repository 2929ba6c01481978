"""The replica's observability surface against the JAX package's: the
``/metrics`` exposition, trace propagation and export, the flight
recorder, the debug routes and the profile capture.

- ``obs/metrics.py``: ``render_engine_gauges`` on the same stats,
  ``PhaseHistogram.render`` with exemplars, ``render_device_gauges`` and
  ``render_moe_gauges`` give the reference's bytes (the engine gauges
  less ``GAUGES_NOT_PORTED``); the GenAI families equal
  ``prometheus_client``'s ``generate_latest`` of the reference's empty
  registry; a CPU port replica's ``/metrics`` family set equals a
  reference replica's less ``GAUGES_NOT_PORTED``, which is the
  constant ``metric_families()`` chip_smoke holds the card's scrapes
  to; the reference gateway's ``relabel_exposition`` federates it.
- ``obs/tracing.py`` and ``obs/otlp_proto.py``: ``Propagators`` on
  traceparent, B3 single and multi headers (valid and malformed);
  the OTLP protobuf and JSON bodies of one span with fixed ids and
  times; the ``OTEL_*`` environment contract, gRPC refused naming
  grpcio.
- ``obs/flight.py``: ``FlightRecorder`` eviction and the slow log on one
  scripted sequence, ``RequestTrace`` on one scripted lifecycle.
- A CPU replica: ``/debug/requests[/{rid}]`` with the caller's trace id
  (tracing off), and with tracing on the request's spans posted to a
  local OTLP sink (protobuf), children of the caller's span;
  ``/debug/profile`` 404 unless enabled, 409 during a capture, the
  30 s cap, a Chrome trace written, a profiler fault a 500.
"""

import asyncio
import json
import os
import threading
import time
import types
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from aigw_tpu.obs import flight as jflight
from aigw_tpu.obs import metrics as jmetrics
from aigw_tpu.obs import otlp_proto as jproto
from aigw_tpu.obs import tracing as jtracing
from aigw_tpu_torch.obs import flight as tflight
from aigw_tpu_torch.obs import metrics as tmetrics
from aigw_tpu_torch.obs import otlp_proto as tproto
from aigw_tpu_torch.obs import tracing as ttracing

MODEL = "tiny-random"


# -- /metrics ----------------------------------------------------------------
def _stats(seed):
    rng = np.random.default_rng(seed)
    names = [a for a, _n in jmetrics.ENGINE_GAUGES]
    return types.SimpleNamespace(**{
        a: (int(rng.integers(0, 10 ** 6)) if i % 3 else
            round(float(rng.random()), 4)) for i, a in enumerate(names)})


def test_engine_gauges_are_the_reference_minus_not_ported():
    want = [g for g in jmetrics.ENGINE_GAUGES
            if g[0] not in tmetrics.GAUGES_NOT_PORTED]
    assert list(tmetrics.ENGINE_GAUGES) == want
    ref = dict(jmetrics.ENGINE_GAUGES)
    for attr, (name, entry) in tmetrics.GAUGES_NOT_PORTED.items():
        assert ref[attr] == name and entry
    # only the multi-GPU gauges are left (the warm gauges are ported)
    assert set(tmetrics.GAUGES_NOT_PORTED) == {
        "sp_prefills", "sp_chunked_prefills", "sp_resume_prefills",
        "sp_interactive_admits", "ici_bytes_per_token", "ici_bytes_total"}
    assert {e for _n, e in tmetrics.GAUGES_NOT_PORTED.values()} == {
        "item 7, multi-GPU"}
    assert len(tmetrics.ENGINE_GAUGES) + len(tmetrics.GAUGES_NOT_PORTED) \
        == len(jmetrics.ENGINE_GAUGES) == 100
    import dataclasses

    from aigw_tpu_torch.tpuserve.engine import EngineStats

    have = {f.name for f in dataclasses.fields(EngineStats)}
    assert {a for a, _n in tmetrics.ENGINE_GAUGES} <= have
    assert not set(tmetrics.GAUGES_NOT_PORTED) & have


@pytest.mark.parametrize("seed", [0, 1])
def test_render_engine_gauges_matches_reference(seed):
    stats = _stats(seed)
    keep = {n for _a, n in tmetrics.ENGINE_GAUGES}
    want = [ln for ln in jmetrics.render_engine_gauges(stats).decode()
            .splitlines() if ln.split()[-2 if ln[0] == "#" else 0] in keep]
    assert tmetrics.render_engine_gauges(stats).decode().splitlines() \
        == want


@pytest.mark.parametrize("seed", [0, 1])
def test_phase_histograms_render_like_reference(seed):
    rng = np.random.default_rng(seed)
    jp, tp = jmetrics.EnginePhases(), tmetrics.EnginePhases()
    for i in range(300):
        phase = tmetrics.ENGINE_HISTOGRAMS[i % 6][0]
        ms = float(rng.exponential(60.0)) if i % 7 else 40000.0
        tid = f"{i:032x}" if rng.random() < 0.5 else ""
        jp.observe(phase, ms, tid)
        tp.observe(phase, ms, tid)
    assert tp.render() == jp.render()
    assert b'# {trace_id="' in tp.render()
    assert tp.percentiles() == jp.percentiles()


def test_device_and_moe_gauges_render_like_reference():
    devs = [{"id": 0, "platform": "gpu", "bytes_in_use": 123,
             "bytes_limit": 1000, "memory_frac": 0.123,
             "kv_pool_bytes": 77, "kv_bytes_in_use": 7,
             "kv_occupancy": 0.0909, "param_bytes": 55}]
    for d in (devs, [], devs * 2):
        assert tmetrics.render_device_gauges(d) \
            == jmetrics.render_device_gauges(d)
    assert tmetrics.DEVICE_GAUGES == jmetrics.DEVICE_GAUGES
    for load, drops in (([], []), ([3, 0, 9], [1, 0]), ([1], [])):
        assert tmetrics.render_moe_gauges(load, drops) \
            == jmetrics.render_moe_gauges(load, drops)


def test_genai_families_equal_generate_latest():
    assert tmetrics.render_genai_families() \
        == jmetrics.GenAIMetrics().export()


def _port_replica(**kw):
    from aigw_tpu_torch.tpuserve.engine import EngineConfig
    from aigw_tpu_torch.tpuserve.server import TPUServeServer

    return TPUServeServer(MODEL, EngineConfig(max_seq_len=256,
                                              page_size=16),
                          device="cpu", port=0, **kw)


@pytest.fixture(scope="module")
def replica():
    """A CPU port replica (tracing off) that served two requests, the
    second with a caller's traceparent."""
    srv = _port_replica(enable_profile_endpoint=True)
    srv.start()
    try:
        for body, headers in ((_body(4), {}),
                              (_body(6, stream=True), {"traceparent": TP})):
            assert _http(srv.port, "/v1/completions", body,
                         headers)[0] == 200
        yield srv
    finally:
        srv.stop()


TRACE_ID = "4bf92f3577b34da6a3ce929d0e0e4736"
TP = f"00-{TRACE_ID}-00f067aa0ba902b7-01"


def _body(n, stream=False):
    return {"model": MODEL, "prompt": "hello replica", "max_tokens": n,
            "temperature": 0.0, "stream": stream}


def _http(port, path, body=None, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"content-type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read().decode(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), dict(e.headers)


def test_metrics_families_are_the_reference_replicas_less_not_ported(
        replica):
    """A reference replica's /metrics and the port replica's: the port's
    family set is the reference's less the map, and it is the constant
    chip_smoke checks the card against."""
    from aigw_tpu.tpuserve import engine as jengine
    from aigw_tpu.tpuserve import server as jserver

    jsrv = jserver.TPUServeServer(MODEL, jengine.EngineConfig(
        max_seq_len=256, page_size=16))
    ref = asyncio.run(jsrv._metrics(None)).body.decode()
    ref_fams = set(tmetrics.parse_exposition(ref))
    not_ported = {n for n, _e in tmetrics.GAUGES_NOT_PORTED.values()}
    assert not_ported <= ref_fams
    status, text, headers = _http(replica.port, "/metrics")
    assert status == 200 and headers["content-type"].startswith(
        "text/plain")
    fams = tmetrics.parse_exposition(text)
    assert set(fams) == ref_fams - not_ported \
        == tmetrics.metric_families()
    assert tmetrics.metric_families(moe=True) - tmetrics.metric_families() \
        == set(tmetrics.MOE_FAMILIES)
    lines = text.splitlines()
    assert "tpuserve_meter_records_total 2" in lines
    # the replica runs the defaults: the gather rung, as the reference's
    assert 'tpuserve_decode_attn_impl{impl="gather-torch"} 1' in lines
    assert any(ln.startswith('tpuserve_device_param_bytes{device="0"} ')
               and int(ln.split()[-1]) > 0 for ln in lines)
    assert any(f'trace_id="{TRACE_ID}"' in ln for ln in lines
               if ln.startswith("tpuserve_ttft_hist_ms_bucket"))


def test_parse_exposition_refuses_malformed_lines():
    with pytest.raises(ValueError):
        tmetrics.parse_exposition("tpuserve_x 1\n")  # undeclared
    with pytest.raises(ValueError):
        tmetrics.parse_exposition("# TYPE a gauge\na one\n")
    assert tmetrics.parse_exposition(
        "# TYPE h histogram\nh_bucket{le=\"1\"} 2 # {trace_id=\"ab\"} 0.5\n"
        "h_sum 1\nh_count 2\n") == {"h": "histogram"}


def test_relabel_exposition_federates_a_port_replica(replica):
    from aigw_tpu.gateway.fleetstate import relabel_exposition

    text = _http(replica.port, "/metrics")[1]
    seen: set = set()
    out = relabel_exposition(text, "127.0.0.1:1", seen)
    kept = tmetrics.parse_exposition(out)
    assert set(kept) == {f for f in tmetrics.metric_families()
                         if f.startswith("tpuserve_")} == seen
    samples = [ln for ln in out.splitlines() if not ln.startswith("#")]
    assert samples and all('{replica="127.0.0.1:1"' in ln
                           for ln in samples)
    assert any("# {trace_id=" in ln for ln in samples)  # kept verbatim


# -- tracing -----------------------------------------------------------------
HEADERS = [
    {"traceparent": TP},
    {"traceparent": f"00-{TRACE_ID}-00f067aa0ba902b7-00"},
    {"traceparent": "00-" + "0" * 32 + "-00f067aa0ba902b7-01"},
    {"traceparent": "garbage"},
    {"b3": f"{TRACE_ID}-00f067aa0ba902b7-1"},
    {"b3": "a3ce929d0e0e4736-00f067aa0ba902b7-0"},  # a 64-bit trace id
    {"b3": "zz-00f067aa0ba902b7"},
    {"x-b3-traceid": TRACE_ID, "x-b3-spanid": "00f067aa0ba902b7",
     "x-b3-sampled": "0"},
    {},
]


@pytest.mark.parametrize("spec", ["", "tracecontext,baggage", "b3",
                                  "b3multi,tracecontext"])
def test_propagators_match_reference(spec):
    jp, tp = jtracing.Propagators(spec), ttracing.Propagators(spec)
    assert tp.names == jp.names
    for h in HEADERS:
        want, got = jp.extract(h), tp.extract(h)
        assert (got is None) == (want is None), h
        if want is not None:
            assert (got.trace_id, got.span_id, got.sampled) \
                == (want.trace_id, want.span_id, want.sampled)
            jh: dict = {}
            th: dict = {}
            jp.inject(want, jh)
            tp.inject(got, th)
            assert th == jh


def _span(mod):
    ctx = mod.SpanContext(trace_id=TRACE_ID, span_id="00f067aa0ba902b7")
    s = mod.Span(name="tpuserve.chat m", context=ctx,
                 parent_span_id="a3ce929d0e0e4736", start_ns=10 ** 18,
                 end_ns=10 ** 18 + 5_000_000)
    s.attributes.update(mod.genai_attributes(
        operation="chat", request_model="m", response_model="m",
        backend="tpuserve", input_tokens=3, output_tokens=4,
        streaming=True))
    s.set("tpuserve.ratio", 0.25)
    s.events.append(("first_token", 10 ** 18 + 1000, {}))
    s.events.append(("admission", 10 ** 18 + 500, {"path": "single",
                                                   "burst_id": -2}))
    return s


@pytest.mark.parametrize("error", ["", "engine failure"])
def test_otlp_bodies_of_one_span_match_reference(error):
    js, ts = _span(jtracing), _span(ttracing)
    js.status_error = ts.status_error = error
    assert tproto.encode_traces([ts], "tpuserve") \
        == jproto.encode_traces([js], "tpuserve")
    jt = jtracing.Tracer(exporter="none", service_name="tpuserve")
    tt = ttracing.Tracer(exporter="none", service_name="tpuserve")
    assert tt._otlp_payload([ts]) == jt._otlp_payload([js])
    assert tt._to_dict(ts) == jt._to_dict(js)
    body = tproto.decode_message(tproto.encode_traces([ts], "tpuserve"))
    assert tproto.decode_message(body[1][0])[2]  # scope spans


def test_tracer_environment_contract(monkeypatch):
    for k in ("OTEL_SDK_DISABLED", "OTEL_TRACES_EXPORTER",
              "OTEL_EXPORTER_OTLP_PROTOCOL",
              "OTEL_EXPORTER_OTLP_TRACES_PROTOCOL",
              "OTEL_EXPORTER_OTLP_ENDPOINT", "OTEL_SERVICE_NAME"):
        monkeypatch.delenv(k, raising=False)
    t = ttracing.Tracer()
    assert (t.exporter, t.enabled, t.protocol, t.endpoint,
            t.service_name) == ("none", False, "http/protobuf",
                                "http://127.0.0.1:4318", "aigw-tpu")
    monkeypatch.setenv("OTEL_TRACES_EXPORTER", "console")
    monkeypatch.setenv("OTEL_SERVICE_NAME", "svc")
    t = ttracing.Tracer()
    assert t.enabled and t.service_name == "svc"
    monkeypatch.setenv("OTEL_SDK_DISABLED", "true")
    assert not ttracing.Tracer().enabled
    monkeypatch.delenv("OTEL_SDK_DISABLED")
    monkeypatch.setenv("OTEL_TRACES_EXPORTER", "otlp")
    monkeypatch.setenv("OTEL_EXPORTER_OTLP_PROTOCOL", "grpc")
    with pytest.raises(NotImplementedError, match="grpcio"):
        ttracing.Tracer()
    monkeypatch.setenv("OTEL_EXPORTER_OTLP_TRACES_PROTOCOL", "http/json")
    assert ttracing.Tracer(exporter="none").protocol == "http/json"
    ctx = ttracing.SpanContext(TRACE_ID, "00f067aa0ba902b7", sampled=False)
    assert ttracing.Tracer(exporter="console").start_span(
        "x", ctx)._tracer is None  # the caller's opt-out is honored


# -- the flight recorder -------------------------------------------------------
def _flight_script(mod, monkeypatch):
    """One scripted sequence: 12 requests through a ring of 5 with a slow
    log of 2; a slow TTFT and a slow queue wait early on, one request
    errored before its first token, one still in flight."""
    clock = [100.0]
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(
        monotonic=lambda: clock[0]))
    rec = mod.FlightRecorder(capacity=5, slow_n=2)
    ttft = [30, 900, 20, 25, -1, 40, 10, 5, 700, 15, 12, 11]
    qw = [1, 2, 800, 3, -1, 4, 5, 6, 7, 600, 8, 9]
    for i in range(12):
        e = rec.begin(f"r{i}", model="m", trace_id=f"{i:032x}",
                      prompt_tokens=i, max_tokens=8, ts=1.7e9 + clock[0],
                      t0=clock[0])
        clock[0] += 0.5
        if ttft[i] >= 0:
            e.ttft_ms = float(ttft[i])
            e.queue_wait_ms = float(qw[i])
            e.prefill_ms = 1.5
        if i != 11:
            rec.finish(e, "stop" if i % 3 else "length", tokens_out=i + 1)
        clock[0] += 0.25
    return rec


def test_flight_recorder_evicts_like_reference(monkeypatch):
    j = _flight_script(jflight, monkeypatch)
    t = _flight_script(tflight, monkeypatch)
    assert t.snapshot() == j.snapshot()
    assert len(t) == len(j) == 5
    for i in range(12):
        got, want = t.get(f"r{i}"), j.get(f"r{i}")
        assert (got is None) == (want is None), i
        if want is not None:
            assert got.detail() == want.detail(), i
    snap = t.snapshot()
    assert [e["id"] for e in snap["slow_by_ttft"]] == ["r1", "r8"]
    assert [e["id"] for e in snap["slow_by_queue_wait"]] == ["r2", "r9"]
    assert t.get("r1") is not None and t.get("r3") is None  # spared


def test_request_trace_records_like_reference(monkeypatch):
    out = []
    for mod in (jflight, tflight):
        clock = [5.0]
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            monotonic=lambda: clock[0], time_ns=time.time_ns))
        entry = mod.FlightEntry(rid="x", t0=5.0, ts=1.0)
        tr = mod.RequestTrace(entry)
        tr.queue_wait(3.5)
        tr.admission(path="single", prefix="miss")
        tr.prefill(12.25, bucket=64, chunks=0)
        clock[0] = 5.02
        tr.first_token()
        for k in range(mod.MAX_WINDOW_EVENTS + 3):
            tr.decode_window(8, True, 0)
            tr.spec_window(4, 2)
        tr.constraint_rollback()
        tr.transfer(0.5)
        tr.tokens(9)
        tr.engine_finish("length")
        out.append(entry.detail())
    assert out[0] == out[1]
    assert out[1]["ttft_ms"] == pytest.approx(20.0)
    assert tflight.MAX_EVENTS == jflight.MAX_EVENTS


# -- a replica's debug routes ------------------------------------------------
def test_debug_requests_carry_the_callers_trace(replica):
    snap = json.loads(_http(replica.port, "/debug/requests")[1])
    assert snap["capacity"] == 256
    traced, plain = snap["recent"][0], snap["recent"][1]
    assert traced["trace_id"] == TRACE_ID and plain["trace_id"] == ""
    assert (traced["tokens_out"], plain["tokens_out"]) == (6, 4)
    assert set(traced) == set(jflight.FlightEntry(rid="r").summary())
    detail = json.loads(_http(replica.port,
                              f"/debug/requests/{traced['id']}")[1])
    names = [e["name"] for e in detail["events"]]
    assert names[0] == "admission" and "first_token" in names
    assert names[-1] == "engine_finish" and "decode_window" in names
    assert detail["prefill_ms"] >= 0 and detail["queue_wait_ms"] >= 0
    assert detail["admission"]["path"] == "single"
    assert detail["stream"] is True and detail["finish"] == "length"
    assert set(detail) == set(jflight.FlightEntry(rid="r").detail())
    status, body, _h = _http(replica.port, "/debug/requests/nope")
    assert status == 404 and "unknown request id" in body


class _Sink(BaseHTTPRequestHandler):
    posts: list = []

    def do_POST(self):  # noqa: N802
        n = int(self.headers["content-length"])
        self.posts.append((self.path, self.headers["content-type"],
                           self.rfile.read(n)))
        self.send_response(200)
        self.send_header("content-length", "0")
        self.end_headers()

    def log_message(self, *a):
        pass


def _spans(payloads):
    """(name, trace id, span id, parent id, attribute keys) per span in
    the posted ExportTraceServiceRequest bodies."""
    out = []
    for _p, _c, raw in payloads:
        for rs in tproto.decode_message(raw)[1]:
            for ss in tproto.decode_message(rs)[2]:
                for sp in tproto.decode_message(ss).get(2, []):
                    f = tproto.decode_message(sp)
                    keys = {tproto.decode_message(kv)[1][0].decode()
                            for kv in f.get(9, [])}
                    out.append((f[5][0].decode(), f[1][0].hex(),
                                f[2][0].hex(), f.get(4, [b""])[0].hex(),
                                keys))
    return out


def test_traced_replica_exports_request_spans(monkeypatch):
    sink = ThreadingHTTPServer(("127.0.0.1", 0), _Sink)
    threading.Thread(target=sink.serve_forever, daemon=True).start()
    monkeypatch.setenv("OTEL_TRACES_EXPORTER", "otlp")
    monkeypatch.setenv("OTEL_EXPORTER_OTLP_ENDPOINT",
                       f"http://127.0.0.1:{sink.server_address[1]}")
    monkeypatch.delenv("OTEL_EXPORTER_OTLP_PROTOCOL", raising=False)
    _Sink.posts.clear()
    srv = _port_replica()
    srv.start()
    try:
        assert _http(srv.port, "/v1/chat/completions", {
            "model": MODEL, "messages": [{"role": "user", "content": "hi"}],
            "max_tokens": 5}, {"traceparent": TP})[0] == 200
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            spans = _spans(_Sink.posts)
            if any(s[0].startswith("tpuserve.chat") for s in spans):
                break
            time.sleep(0.05)
    finally:
        srv.stop()
        sink.shutdown()
    assert all(p == "/v1/traces" and c == "application/x-protobuf"
               for p, c, _r in _Sink.posts)
    root = [s for s in spans if s[0] == f"tpuserve.chat {MODEL}"]
    assert len(root) == 1
    name, tid, sid, parent, keys = root[0]
    assert (tid, parent) == (TRACE_ID, "00f067aa0ba902b7")
    assert {"gen_ai.operation.name", "gen_ai.request.model",
            "gen_ai.response.model", "gen_ai.usage.input_tokens",
            "gen_ai.usage.output_tokens", "tpuserve.finish_reason"} <= keys
    children = {s[0] for s in spans if s[3] == sid}
    assert {"engine.queue_wait", "engine.prefill",
            "engine.decode"} <= children
    entry = srv.flight.snapshot()["recent"][0]
    assert entry["trace_id"] == TRACE_ID


def test_profile_endpoint(replica, monkeypatch):
    off = _port_replica()
    try:
        status, body = off.profile("seconds=1")
        assert status == 404 and b"--enable-profile-endpoint" in body
    finally:
        off.httpd.server_close()
    status, body, _h = _http(replica.port, "/debug/profile?seconds=0.2")
    out = json.loads(body)
    assert status == 200 and out["seconds"] == 0.2
    assert os.path.exists(os.path.join(out["profile_dir"], "trace.json"))
    assert json.loads(open(os.path.join(out["profile_dir"],
                                        "trace.json")).read())
    assert _http(replica.port, "/debug/profile?seconds=x")[0] == 400
    # a second capture while one runs
    replica._profile_lock.acquire()
    try:
        assert _http(replica.port, "/debug/profile?seconds=1")[0] == 409
    finally:
        replica._profile_lock.release()


def test_profile_window_is_capped_and_faults_are_500(replica, monkeypatch):
    import torch.profiler

    from aigw_tpu_torch.tpuserve import server as tserver

    slept = []
    monkeypatch.setattr(tserver, "time", types.SimpleNamespace(
        sleep=slept.append, monotonic=time.monotonic, time=time.time))
    status, body = replica.profile("seconds=1000")
    assert status == 200 and json.loads(body)["seconds"] == 30.0
    assert slept == [30.0] == [tserver.PROFILE_MAX_SECONDS]

    def broken(*a, **k):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    status, body = replica.profile("seconds=0.1")
    assert status == 500
    assert json.loads(body)["error"]["message"] == (
        "profiler capture failed: no profiler here")
    assert not replica._profile_lock.locked()
    assert replica.engine.healthy
