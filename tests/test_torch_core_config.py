"""``core-config`` and the core's span tailer, held against the reference:
``config/nativecore.py``'s JSON and skip reasons equal
``aigw_tpu.config.nativecore``'s over the reference's compiler cases
(``tests/test_native_core.py:645-795``), the port's ``core-config``
prints and writes what ``python -m aigw_tpu core-config`` does byte for
byte, ``obs/native_spans.py``'s spans and costs equal the reference's
over one access log; and the core in front of the port's own gateway on
the CPU (``python -m aigw_tpu_torch run`` on the fallback port with
``AIGW_CORE_ACCESS_LOG``): native and fallback requests counted, one
span per native request carrying the client's trace id, the startup
lines."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from aigw_tpu.cli import main as jmain
from aigw_tpu.config.model import Config as JConfig
from aigw_tpu.config.nativecore import compile_core_config as jcompile
from aigw_tpu.config.runtime import RuntimeConfig as JRuntime
from aigw_tpu.obs import native_spans as jspans
from aigw_tpu.obs.tracing import Tracer as JTracer
from aigw_tpu_torch import native as nbuild
from aigw_tpu_torch.cli import main as tmain
from aigw_tpu_torch.config.model import Config
from aigw_tpu_torch.config.nativecore import compile_core_config
from aigw_tpu_torch.config.runtime import RuntimeConfig
from aigw_tpu_torch.obs import native_spans as tspans
from aigw_tpu_torch.obs.tracing import Tracer

ROOT = Path(__file__).resolve().parents[1]

_BASE = {
    "backends": [
        {"name": "one", "schema": {"name": "OpenAI"},
         "url": "http://127.0.0.1:9001",
         "auth": {"kind": "APIKey", "api_key": "file:/tmp/k"}},
        {"name": "two", "schema": {"name": "OpenAI"},
         "url": "http://127.0.0.1:9002"},
        {"name": "tls", "schema": {"name": "OpenAI"},
         "url": "https://api.example.com"},
        {"name": "anthropic", "schema": {"name": "Anthropic"},
         "url": "http://127.0.0.1:9003"},
    ],
    "routes": [{"name": "r1", "rules": [
        {"models": ["m1", "m2"],
         "backends": [{"backend": "one", "weight": 3},
                      {"backend": "two", "priority": 1}]}]}],
}


def _one(url: str = "http://127.0.0.1:9001", **backend) -> list:
    return [{"name": "one", "schema": {"name": "OpenAI"}, "url": url,
             **backend}]


#: the reference's compiler cases, as config dicts
CASES = {
    "eligible": _BASE,
    "tls": {
        "backends": [
            {"name": "tls", "schema": {"name": "OpenAI"},
             "url": "https://api.example.com"},
            {"name": "ok", "schema": {"name": "OpenAI"},
             "url": "http://127.0.0.1:9002"}],
        "routes": [{"name": "r", "rules": [
            {"models": ["secure"], "backends": ["tls"]},
            {"models": ["plain"], "backends": ["ok"]}]}]},
    "translation": {
        "backends": [{"name": "a", "schema": {"name": "Anthropic"},
                      "url": "http://127.0.0.1:9003"}],
        "routes": [{"name": "r", "rules": [
            {"models": ["m"], "backends": ["a"]}]}]},
    "costs": {
        "backends": _one(),
        "routes": [{"name": "r", "rules": [
            {"models": ["m"], "backends": ["one"]}]}],
        "llm_request_costs": [{"metadata_key": "t",
                               "type": "OutputToken"}]},
    "catch_all": {
        "backends": _one(),
        "routes": [{"name": "r", "rules": [
            {"backends": ["one"]},
            {"models": ["m"], "backends": ["one"]}]}]},
    "path_prefix": {
        "backends": _one("http://127.0.0.1:9001/openai"),
        "routes": [{"name": "r", "rules": [
            {"models": ["m"], "backends": ["one"]}]}]},
    "drained": {
        "backends": [
            {"name": "a", "schema": {"name": "OpenAI"},
             "url": "http://127.0.0.1:9001"},
            {"name": "b", "schema": {"name": "OpenAI"},
             "url": "http://127.0.0.1:9002"}],
        "routes": [{"name": "r", "rules": [
            {"models": ["m"], "backends": [{"backend": "a", "weight": 0},
                                           {"backend": "b",
                                            "weight": 2}]}]}]},
    "hostnames": {
        "backends": _one(),
        "routes": [{"name": "r", "hostnames": ["api.acme.io"], "rules": [
            {"model_prefixes": ["gpt-"], "backends": ["one"]}]}]},
    "auth_kinds": {
        "backends": [
            {"name": "az", "schema": {"name": "OpenAI"},
             "url": "http://127.0.0.1:9004",
             "auth": {"kind": "AzureAPIKey", "azure_api_key": "file:/k"}},
            {"name": "an", "schema": {"name": "OpenAI"},
             "url": "http://127.0.0.1:9005",
             "auth": {"kind": "AnthropicAPIKey", "api_key": "sk-x"},
             "header_mutation": {"set": [{"name": "x-a", "value": "1"}],
                                 "remove": ["x-b"]}}],
        "routes": [{"name": "r", "rules": [
            {"models": ["m"], "backends": ["az", "an"]}]}]},
    "mutation_stops": {
        "backends": [
            *_one(),
            {"name": "mut", "schema": {"name": "OpenAI"},
             "url": "http://127.0.0.1:9002",
             "body_mutation": {"set": [{"name": "temperature",
                                        "value": 0}]}}],
        "routes": [{"name": "r", "rules": [
            {"models": ["a"], "backends": ["one"]},
            {"models": ["b"], "backends": ["mut"]},
            {"models": ["c"], "backends": ["one"]}]}]},
    "quotas": {
        "backends": _one(),
        "routes": [{"name": "r", "rules": [
            {"models": ["m"], "backends": ["one"]}]}],
        "llm_request_costs": [{"metadata_key": "t",
                               "type": "TotalToken"}],
        "quotas": [{"name": "q", "cost_key": "t", "limit": 10,
                    "window_s": 60}]},
}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("access_log", ["", "/tmp/core.log"])
def test_compiler_equals_the_reference(name, access_log):
    got = compile_core_config(Config.parse(CASES[name]), listen_port=2001,
                              access_log_path=access_log)
    want = jcompile(JConfig.parse(CASES[name]), listen_port=2001,
                    access_log_path=access_log)
    assert got == want


def test_compiles_eligible_rules():
    core, skipped = compile_core_config(Config.parse(CASES["eligible"]))
    assert skipped == []
    assert [r["model_exact"] for r in core["rules"]] == ["m1", "m2"]
    b0 = core["rules"][0]["backends"][0]
    assert (b0["host"], b0["port"], b0["weight"]) == ("127.0.0.1", 9001, 3)
    assert b0["auth_headers"][0]["value_file"] == "/tmp/k"
    assert core["rules"][0]["backends"][1]["priority"] == 1


def test_tls_backend_compiles_native():
    core, _ = compile_core_config(Config.parse(CASES["tls"]))
    tls_be = core["rules"][0]["backends"][0]
    assert (tls_be["tls"], tls_be["sni"], tls_be["port"]) == (
        True, "api.example.com", 443)
    assert "tls" not in core["rules"][1]["backends"][0]


def test_ineligible_rules_stop_compilation():
    core, skipped = compile_core_config(Config.parse(CASES["translation"]))
    assert core["rules"] == [] and any("translation" in s for s in skipped)
    core, skipped = compile_core_config(Config.parse(CASES["costs"]))
    assert core["rules"] == []
    assert any("llm_request_costs" in s for s in skipped)
    core, _ = compile_core_config(Config.parse(CASES["costs"]),
                                  access_log_path="/tmp/core.log")
    assert len(core["rules"]) == 1
    assert compile_core_config(
        Config.parse(CASES["catch_all"]))[0]["rules"] == []
    core, skipped = compile_core_config(Config.parse(CASES["path_prefix"]))
    assert core["rules"] == [] and any("path prefix" in s for s in skipped)
    core, skipped = compile_core_config(
        Config.parse(CASES["mutation_stops"]))
    assert [r["model_exact"] for r in core["rules"]] == ["a"]
    assert any("body mutation" in s for s in skipped)


def test_drained_backends_hostnames_and_prefixes():
    core, _ = compile_core_config(Config.parse(CASES["drained"]))
    assert [b["name"] for b in core["rules"][0]["backends"]] == ["b"]
    core, _ = compile_core_config(Config.parse(CASES["hostnames"]))
    assert core["rules"][0]["model_prefix"] == "gpt-"
    assert core["rules"][0]["hostnames"] == ["api.acme.io"]


def _cli(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("name", sorted(CASES))
def test_core_config_cli_prints_and_writes_what_the_reference_does(
        name, tmp_path, capsys, monkeypatch):
    cfg = tmp_path / "gw.json"
    cfg.write_text(json.dumps(CASES[name]))
    outs = {}
    # both print the path they were given: the same name each
    monkeypatch.chdir(tmp_path.parent)
    for pkg, main in (("ref", jmain), ("port", tmain)):
        target = tmp_path / f"{pkg}.json"
        argv = ["core-config", str(cfg), "-o", f"{tmp_path.name}/core.json",
                "--listen-host", "127.0.0.1", "--listen-port", "2001",
                "--fallback-port", "2002", "--access-log", "/tmp/c.log"]
        rc, out, err = _cli(main, argv, capsys)
        os.replace(tmp_path / "core.json", target)
        outs[pkg] = (rc, out, err, target.read_bytes())
    assert outs["port"] == outs["ref"]
    assert outs["port"][0] == 0


def test_core_config_cli_refuses_an_invalid_config(tmp_path, capsys):
    cfg = tmp_path / "bad.json"
    cfg.write_text(json.dumps({"backends": [{"name": "x"}]}))
    rc, out, err = _cli(tmain, ["core-config", str(cfg), "-o",
                                str(tmp_path / "o.json")], capsys)
    rc2, out2, err2 = _cli(jmain, ["core-config", str(cfg), "-o",
                                   str(tmp_path / "o.json")], capsys)
    assert rc == rc2 == 1 and err.startswith("INVALID: ")
    assert not (tmp_path / "o.json").exists()


def test_core_config_as_a_command(tmp_path):
    """``python -m aigw_tpu_torch core-config`` against ``python -m
    aigw_tpu core-config``: the same lines, the same file."""
    cfg = tmp_path / "gw.json"
    cfg.write_text(json.dumps(CASES["costs"]))
    got = {}
    for pkg in ("aigw_tpu", "aigw_tpu_torch"):
        proc = subprocess.run(
            [sys.executable, "-m", pkg, "core-config", str(cfg), "-o",
             "core.json", "--access-log", "c.log"],
            cwd=tmp_path, capture_output=True, text=True, timeout=120,
            env={**os.environ, "PYTHONPATH": str(ROOT)})
        got[pkg] = (proc.returncode, proc.stdout,
                    (tmp_path / "core.json").read_text())
    assert got["aigw_tpu_torch"] == got["aigw_tpu"]
    assert "REMINDER: run the gateway with AIGW_CORE_ACCESS_LOG=c.log" in \
        got["aigw_tpu_torch"][1]
    assert "Not ported" not in (ROOT / "aigw_tpu_torch" / "cli.py").read_text()


# -- the tailer -----------------------------------------------------------

_COSTS = {
    "backends": [{"name": "a", "schema": {"name": "OpenAI"},
                  "url": "http://127.0.0.1:9001"}],
    "routes": [{"name": "r", "rules": [
        {"models": ["m-a"], "backends": ["a"]}]}],
    "llm_request_costs": [
        {"metadata_key": "total", "type": "TotalToken"},
        {"metadata_key": "double_out", "type": "Expression",
         "expression": "output_tokens * 2"}],
}


def _entry(i: int, **kw) -> dict:
    e = {"ts": "2026-07-29T00:00:00Z", "native": True,
         "path": "/v1/chat/completions", "model": "m-a", "backend": "a",
         "status": 200, "duration_ms": 12 + i, "result": "complete",
         "trace_id": f"{i:02x}" * 16, "span_id": f"{i + 1:02x}" * 8,
         "parent_span_id": "34" * 8,
         "start_unix_ns": 1785300000000000000 + i,
         "usage": {"prompt_tokens": 3 + i, "completion_tokens": 4,
                   "total_tokens": 7 + i}}
    e.update(kw)
    return e


#: one access log: spans with and without usage, embeddings, a 5xx, a
#: torn relay, an unsampled request, short ids, non-native and bad lines
LOG_LINES = [
    json.dumps(_entry(1)),
    json.dumps(_entry(2, path="/v1/embeddings", usage={})),
    json.dumps(_entry(3, status=502, result="upstream_error")),
    json.dumps(_entry(4, result="upstream_broken")),
    json.dumps(_entry(5, sampled=False)),
    json.dumps(_entry(6, trace_id="ab")),
    json.dumps(_entry(7, native=False)),
    "not json",
    json.dumps([1, 2]),
    json.dumps(_entry(8, path="/v1/completions", model="m-é",
                      usage={"completion_tokens": 9})),
]


def _tail(mod, tracer_cls, runtime, log: Path) -> tuple[list, list]:
    spans, sunk = [], []
    tracer = tracer_cls(exporter="console")
    tracer._export = spans.append
    tailer = mod.NativeLogTailer(
        str(log), tracer, poll_interval=0.02,
        cost_fn=mod.make_cost_fn(lambda: runtime,
                                 lambda c, m: sunk.append((c, m))))
    tailer.start()
    try:
        time.sleep(0.2)  # lines written before start() are history
        with open(log, "a") as f:
            for ln in LOG_LINES:
                f.write(ln + "\n")
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and len(spans) < 5:
            time.sleep(0.02)
        time.sleep(0.2)
    finally:
        tailer.stop()
    return ([(s.name, s.context.trace_id, s.context.span_id,
              s.parent_span_id, s.start_ns, s.end_ns, s.attributes,
              s.status_error) for s in spans], sunk)


def test_tailer_spans_and_costs_equal_the_reference(tmp_path):
    (tmp_path / "j.log").write_text(json.dumps(_entry(0)) + "\n")
    (tmp_path / "t.log").write_text(json.dumps(_entry(0)) + "\n")
    want = _tail(jspans, JTracer, JRuntime.build(JConfig.parse(_COSTS)),
                 tmp_path / "j.log")
    got = _tail(tspans, Tracer, RuntimeConfig.build(Config.parse(_COSTS)),
                tmp_path / "t.log")
    assert got == want
    spans, sunk = got
    # lines 1-4 and 8 make spans; 5 is unsampled, 6's ids are short
    assert [s[1] for s in spans] == [f"{i:02x}" * 16 for i in (1, 2, 3, 4, 8)]
    assert spans[0][6]["gen_ai.usage.input_tokens"] == 4
    assert spans[0][6]["aigw.native"] is True
    assert spans[0][5] - spans[0][4] == 13_000_000
    assert [s[7] for s in spans] == ["", "", "upstream status 502",
                                     "upstream status 200", ""]
    assert spans[1][0] == "embeddings m-a"
    # costs for every native line with usage, sampled or not
    assert [c["total"] for c, _m in sunk] == [8, 10, 11, 12, 13, 0]
    assert sunk[0] == ({"total": 8, "double_out": 8},
                       {"model": "m-a", "backend": "a", "route": "",
                        "native": "true"})


def test_tailer_reads_a_log_made_after_it_started(tmp_path):
    """No log yet at ``start()``: its first lines, written before the
    tailer's next poll, are new requests and make spans (the reference
    seeks to the end of a log that appears and loses them)."""
    log = tmp_path / "core.log"
    got = {}
    for name, mod, tracer_cls in (("port", tspans, Tracer),
                                  ("ref", jspans, JTracer)):
        spans: list = []
        tracer = tracer_cls(exporter="console")
        tracer._export = spans.append
        log.unlink(missing_ok=True)
        tailer = mod.NativeLogTailer(str(log), tracer, poll_interval=0.5)
        tailer.start()
        try:
            time.sleep(0.1)
            log.write_text(json.dumps(_entry(1)) + "\n")
            time.sleep(1.2)
            with open(log, "a") as f:
                f.write(json.dumps(_entry(2)) + "\n")
            time.sleep(1.2)
        finally:
            tailer.stop()
        got[name] = [s.context.trace_id for s in spans]
    assert got["port"] == ["01" * 16, "02" * 16]
    assert got["ref"] == ["02" * 16]


def test_tailer_follows_rotation(tmp_path):
    log = tmp_path / "core.log"
    log.write_text("")
    spans: list = []
    tracer = Tracer(exporter="console")
    tracer._export = spans.append
    tailer = tspans.NativeLogTailer(str(log), tracer, poll_interval=0.02)
    tailer.start()
    try:
        time.sleep(0.1)
        with open(log, "a") as f:
            f.write(json.dumps(_entry(1)))  # torn: no newline yet
        time.sleep(0.15)
        assert spans == []
        with open(log, "a") as f:
            f.write("\n")
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and not spans:
            time.sleep(0.02)
        assert len(spans) == 1
        log.rename(tmp_path / "core.log.1")  # rotated: a new file
        log.write_text(json.dumps(_entry(2)) + "\n")
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and len(spans) < 2:
            time.sleep(0.02)
    finally:
        tailer.stop()
    assert [s.context.trace_id for s in spans] == ["01" * 16, "02" * 16]


def _openai_chat(h, body):
    """An OpenAI chat upstream: a completion, or three chunks and
    ``[DONE]`` flushed one by one."""
    req = json.loads(body)
    usage = {"prompt_tokens": 3, "completion_tokens": 4,
             "total_tokens": 7}
    if not req.get("stream"):
        h._json(200, {
            "id": "c1", "object": "chat.completion", "created": 1,
            "model": req["model"], "marker": "UP", "usage": usage,
            "choices": [{"index": 0, "finish_reason": "stop",
                         "message": {"role": "assistant",
                                     "content": "hello"}}]})
        return
    h.send_response(200)
    h.send_header("content-type", "text/event-stream")
    h.send_header("transfer-encoding", "chunked")
    h.end_headers()
    for i, piece in enumerate(("he", "llo", "")):
        frame = {"id": "c1", "object": "chat.completion.chunk",
                 "created": 1, "model": req["model"],
                 "choices": [{"index": 0, "delta": {"content": piece},
                              "finish_reason": "stop" if i == 2
                              else None}]}
        if i == 2:
            frame["usage"] = usage
        h._chunk(f"data: {json.dumps(frame)}\n\n".encode())
        time.sleep(0.01)
    h._chunk(b"data: [DONE]\n\n")
    h.wfile.write(b"0\r\n\r\n")
    h.wfile.flush()


def test_gateway_cost_sink_takes_python_path_costs():
    """``GatewayServer(cost_sink=...)``, as the reference's: every
    finished request's costs with its model, backend and route (the
    tailer feeds native requests' through the same sink)."""
    import asyncio

    from aigw_tpu_torch.gateway.http import HTTPClient
    from aigw_tpu_torch.gateway.server import run_gateway
    from test_torch_native_core import Upstream, free_port

    up = Upstream("UP", free_port(), handler=_openai_chat)
    sunk: list = []

    async def main():
        cfg = Config.parse({
            "version": "v1",
            "backends": [{"name": "up", "schema": "OpenAI",
                          "url": f"http://127.0.0.1:{up.server_address[1]}"}],
            "routes": [{"name": "r", "rules": [
                {"models": ["m"], "backends": ["up"]}]}],
            "llm_request_costs": [
                {"metadata_key": "total", "type": "TotalToken"},
                {"metadata_key": "weighted", "type": "Expression",
                 "expression": "input_tokens + 3 * output_tokens"}]})
        gw = await run_gateway(RuntimeConfig.build(cfg), port=0,
                               cost_sink=lambda c, m: sunk.append((c, m)))
        client = HTTPClient()
        try:
            r = await client.post(
                f"http://127.0.0.1:{gw.port}/v1/chat/completions",
                data=json.dumps({"model": "m", "messages": [
                    {"role": "user", "content": "hi"}]}).encode(),
                headers={"content-type": "application/json"})
            assert r.status == 200
            await r.read()
            r.release()
        finally:
            client.close()
            await gw.stop()

    try:
        asyncio.run(main())
    finally:
        up.close()
    assert sunk == [({"total": 7, "weighted": 15},
                     {"model": "m", "backend": "up", "route": "r"})]


# -- the core in front of the port's gateway on the CPU ---------------------


def test_core_in_front_of_the_port_gateway(tmp_path):
    """``core-config`` compiles rule one (OpenAI, plain http) native and
    stops at rule two (a body mutation); ``aigw-core`` listens in front,
    ``python -m aigw_tpu_torch run`` on the fallback port tails the
    core's access log. Native requests reach the upstream straight,
    fallback ones through the gateway (its SSE parse on the scanner);
    ``/aigw-core/stats`` counts each; the gateway exports one span per
    native request under the client's trace id."""
    from test_torch_native_core import Upstream, free_port, request

    up = Upstream("UP", free_port(), handler=_openai_chat)
    core_port, fb_port = free_port(), free_port()
    log = tmp_path / "core-access.log"
    cfg = {
        "version": "v1",
        "backends": [
            {"name": "up", "schema": "OpenAI",
             "url": f"http://127.0.0.1:{up.server_address[1]}"},
            {"name": "mut", "schema": "OpenAI",
             "url": f"http://127.0.0.1:{up.server_address[1]}",
             "body_mutation": {"set": [{"name": "user", "value": "gw"}]}}],
        "routes": [{"name": "r", "rules": [
            {"models": ["m"], "backends": ["up"]},
            {"models": ["m-mut"], "backends": ["mut"]}]}],
        "llm_request_costs": [{"metadata_key": "total",
                               "type": "TotalToken"}]}
    (tmp_path / "gw.json").write_text(json.dumps(cfg))
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    cc = subprocess.run(
        [sys.executable, "-m", "aigw_tpu_torch", "core-config", "gw.json",
         "-o", "core.json", "--listen-host", "127.0.0.1", "--listen-port",
         str(core_port), "--fallback-port", str(fb_port), "--access-log",
         str(log)], cwd=tmp_path, capture_output=True, text=True,
        timeout=60, env=env)
    assert cc.returncode == 0, cc.stderr
    assert cc.stdout.splitlines()[0] == (
        f"core.json: 1 native rules, fallback 127.0.0.1:{fb_port}")
    assert "rule 'r': backend 'mut': body mutation" in cc.stdout
    spans_err = open(tmp_path / "gw.err", "w")
    gw = subprocess.Popen(
        [sys.executable, "-m", "aigw_tpu_torch", "run", "gw.json", "--port",
         str(fb_port), "--watch-interval", "3600"], cwd=tmp_path,
        stdout=subprocess.PIPE, stderr=spans_err, text=True,
        env={**env, "AIGW_CORE_ACCESS_LOG": str(log),
             "OTEL_TRACES_EXPORTER": "console", "AIGW_DRAIN_SECONDS": "0"})
    core = subprocess.Popen([str(nbuild.core_binary()), "core.json"],
                            cwd=tmp_path, stderr=subprocess.PIPE, text=True)
    lines: list = []
    try:
        assert "listening" in core.stderr.readline()
        for _ in range(3):
            lines.append(gw.stdout.readline().strip())
        assert lines[0] == f"native-core telemetry: tailing {log}"
        assert lines[1] == f"gateway listening on http://127.0.0.1:{fb_port}"
        assert lines[2].startswith("native scanners: SSE and event-stream "
                                   "parsing in C++ (libaigw_native-")
        traces = [f"{i + 1:032x}" for i in range(4)]
        for t in traces:
            status, _h, body = request(
                core_port, "POST", "/v1/chat/completions",
                {"model": "m", "messages": [{"role": "user",
                                             "content": "hi"}]},
                headers={"traceparent": f"00-{t}-{'1' * 16}-01"})
            assert status == 200 and json.loads(body)["marker"] == "UP"
        for stream in (False, True):
            status, _h, body = request(
                core_port, "POST", "/v1/chat/completions",
                {"model": "m-mut", "stream": stream,
                 "messages": [{"role": "user", "content": "hi"}]})
            assert status == 200, body
            if stream:  # parsed and re-framed by the gateway's SSE relay
                events = [e for e in body.decode().split("\n\n") if e]
                assert events[-1] == "data: [DONE]"
                text = "".join(
                    c["delta"].get("content") or ""
                    for e in events[:-1]
                    for c in json.loads(e[len("data: "):])["choices"])
                assert text == "hello"
            else:
                assert json.loads(body)["choices"][0]["message"][
                    "content"] == "hello"
        st = json.loads(request(core_port, "GET", "/aigw-core/stats")[2])
        assert (st["native_requests"], st["fallback_requests"]) == (4, 2)
        assert st["retries"] == 0 and st["upstream_errors"] == 0
        # the fallback's requests reached the upstream mutated
        muts = [json.loads(s["body"]) for s in up.seen
                if json.loads(s["body"])["model"] == "m-mut"]
        assert len(muts) == 2 and all(m["user"] == "gw" for m in muts)
        deadline = time.monotonic() + 15
        native = []
        while time.monotonic() < deadline:
            spans_err.flush()
            native = [s for s in _console_spans(tmp_path / "gw.err")
                      if s["attributes"].get("aigw.native")]
            if len(native) >= 4:
                break
            time.sleep(0.1)
        assert sorted(s["traceId"] for s in native) == traces
        assert all(s["parentSpanId"] == "1" * 16 for s in native)
    finally:
        core.kill()
        gw.terminate()
        try:
            gw.wait(timeout=30)
        finally:
            spans_err.close()
            up.close()


def _console_spans(path: Path) -> list:
    out = []
    for ln in path.read_text().splitlines():
        if ln.startswith("{"):
            try:
                obj = json.loads(ln)
            except ValueError:
                continue
            if isinstance(obj, dict) and "traceId" in obj:
                out.append(obj)
    return out

