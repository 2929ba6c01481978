"""The port's fleet operations held against the reference's on the CPU,
without replicas: the config's ``controller``, ``migration`` and
``quotas`` fields; ``ControllerConfig``; the rate limiter on one script
of check, consume, remaining, reload and sweep under one stepped clock;
the flock'd file store shared by both (one budget, the legacy file name,
a corrupt file); each quota service answering the other's client, and
both clients failing open; two gateways, one of each, sharing one quota
directory in front of a fake upstream; and both ``FleetController``s on
one script (scale-out at exactly K windows, a failed launch, idle
hysteresis then drain and retire, failover after the grace, a flapping
replica), their event rings, decision rings, gauges and snapshots
equal with the timestamps masked."""

import asyncio
import dataclasses
import json
import threading
import types
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from aigw_tpu.config import model as jmodel
from aigw_tpu.config import runtime as jruntime
from aigw_tpu.gateway import controller as jctl
from aigw_tpu.gateway import fleetstate as jfleet
from aigw_tpu.gateway import picker as jpicker
from aigw_tpu.gateway import ratelimit as jrl
from aigw_tpu.gateway import server as jserver
from aigw_tpu.obs import metrics as jmetrics
from aigw_tpu.obs import slomon as jslomon
from aigw_tpu_torch.config import model as tmodel
from aigw_tpu_torch.config import runtime as truntime
from aigw_tpu_torch.gateway import controller as tctl
from aigw_tpu_torch.gateway import fleetstate as tfleet
from aigw_tpu_torch.gateway import picker as tpicker
from aigw_tpu_torch.gateway import ratelimit as trl
from aigw_tpu_torch.gateway import server as tserver
from aigw_tpu_torch.obs import metrics as tmetrics
from aigw_tpu_torch.obs import slomon as tslomon

ROOT = __import__("pathlib").Path(__file__).resolve().parent.parent
SIDES = {
    "ref": types.SimpleNamespace(
        model=jmodel, runtime=jruntime, ctl=jctl, fleet=jfleet,
        picker=jpicker, rl=jrl, slomon=jslomon),
    "port": types.SimpleNamespace(
        model=tmodel, runtime=truntime, ctl=tctl, fleet=tfleet,
        picker=tpicker, rl=trl, slomon=tslomon),
}


# -- config ---------------------------------------------------------------------
POOL = {"name": "pool", "schema": "TPUServe",
        "endpoints": ["127.0.0.1:8011", "127.0.0.1:8012"]}
LAUNCHER = {"kind": "local", "env": {"A": "1"}, "term_grace_s": 5,
            "spec": {"model": "m", "cfg": {"dim": 64}, "batch": 2,
                     "page": 16, "k": 2, "device": "cpu"}}
CONFIGS = {
    "controller_defaults": {"backends": [dict(POOL, controller={})]},
    "controller_knobs": {"backends": [dict(POOL, controller={
        "min_replicas": 0, "max_replicas": 3, "tick_s": 0.5,
        "scale_cooldown_s": 2, "idle_ticks": 4, "idle_slots_frac": 0.5,
        "down_grace_s": 1.5, "drain_timeout_s": 9, "enabled": True,
        "launcher": LAUNCHER})]},
    "controller_disabled": {"backends": [dict(POOL, controller={
        "enabled": False})]},
    "migration": {"backends": [dict(POOL, migration=True,
                                    migration_queue_depth=1,
                                    migration_young_tokens=8)]},
    "migration_defaults": {"backends": [dict(POOL, migration=True)]},
    "quotas": {"backends": [POOL], "quotas": [
        {"name": "a b", "metadata_key": "t", "limit": 9,
         "window_seconds": 5, "model": "m", "backend": "pool",
         "client_key_header": "X-User", "shared_group": "g"},
        {"name": "b", "metadata_key": "t", "limit": 1}]},
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_new_fields_parse_like_reference(name):
    raw = {"version": "v1", **CONFIGS[name],
           "routes": [{"name": "r", "rules": [{"backends": ["pool"]}]}]}
    want = jmodel.Config.parse(raw)
    got = tmodel.Config.parse(raw)
    assert got.to_dict() == want.to_dict()
    assert got.checksum() == want.checksum()
    assert got == tmodel.Config.parse(got.to_dict())
    jr = jruntime.RuntimeConfig.build(want)
    tr = truntime.RuntimeConfig.build(got)
    assert [dataclasses.asdict(r) for r in tr.rate_limiter.rules] == \
        [dataclasses.asdict(r) for r in jr.rate_limiter.rules]


def test_token_ratelimit_example_loads_like_reference(tmp_path):
    path = ROOT / "examples" / "token-ratelimit" / "config.yaml"
    want = jmodel.load_config(str(path))
    twin = tmp_path / "config.json"
    twin.write_text(json.dumps(want.to_dict()))
    for src in (path, twin):
        got = tmodel.load_config(str(src))
        assert got.to_dict() == want.to_dict()
        assert got.checksum() == want.checksum()
    rules = truntime.RuntimeConfig.build(got).rate_limiter.rules
    assert [r.name for r in rules] == ["per-user-hourly", "tpu-global"]


BAD = {
    "controller_no_pool": {"backends": [
        {"name": "pool", "schema": "OpenAI", "url": "http://x",
         "controller": {}}]},
    "controller_bounds": {"backends": [dict(POOL, controller={
        "min_replicas": 3, "max_replicas": 2})]},
    "controller_tick": {"backends": [dict(POOL, controller={
        "tick_s": 0})]},
    "controller_idle_frac": {"backends": [dict(POOL, controller={
        "idle_slots_frac": 1.5})]},
    "controller_launcher": {"backends": [dict(POOL, controller={
        "launcher": {"kind": "k8s"}})]},
    "controller_not_a_mapping": {"backends": [dict(POOL,
                                                   controller=[1])]},
}


@pytest.mark.parametrize("name", sorted(BAD))
def test_bad_controller_blocks_raise_like_reference(name):
    raw = {"version": "v1", **BAD[name]}
    with pytest.raises(jmodel.ConfigError) as want:
        jmodel.Config.parse(raw)
    with pytest.raises(tmodel.ConfigError) as got:
        tmodel.Config.parse(raw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("rule", [
    {"name": "x", "metadata_key": "t", "limit": 0},
    {"name": "x", "metadata_key": "t", "limit": 3, "window_seconds": -1},
    {"name": "x"}])
def test_bad_quota_rules_raise_like_reference(rule):
    raw = {"version": "v1", "backends": [POOL], "quotas": [rule]}
    with pytest.raises(jmodel.ConfigError) as want:
        jruntime.RuntimeConfig.build(jmodel.Config.parse(raw))
    with pytest.raises(tmodel.ConfigError) as got:
        truntime.RuntimeConfig.build(tmodel.Config.parse(raw))
    assert str(got.value) == str(want.value)


def test_controller_config_parses_like_reference():
    for raw in ({}, {"max_replicas": 2, "tick_s": 0.1},
                CONFIGS["controller_knobs"]["backends"][0]["controller"]):
        assert dataclasses.asdict(tctl.ControllerConfig.parse(raw)) == \
            dataclasses.asdict(jctl.ControllerConfig.parse(raw))
    launcher = tctl.build_launcher(LAUNCHER)
    assert isinstance(launcher, tctl.LocalProcessLauncher)
    assert launcher.command()[1:3] == ["-m", tctl.DEFAULT_CHILD]
    assert (launcher.spec, launcher.env, launcher.term_grace_s) == (
        LAUNCHER["spec"], {"A": "1"}, 5.0)
    assert tctl.build_launcher(None) is None
    assert tctl.COUNTERS == jctl.COUNTERS
    assert tmetrics.CONTROLLER_GAUGES == jmetrics.CONTROLLER_GAUGES
    values = {k: i for i, (k, _n) in enumerate(tmetrics.CONTROLLER_GAUGES)}
    for backend in ("", "pool"):
        assert tmetrics.render_controller_gauges(values, backend) == \
            jmetrics.render_controller_gauges(values, backend)


# -- the rate limiter -----------------------------------------------------------
RULES = [
    {"name": "global", "metadata_key": "total", "limit": 100,
     "window_seconds": 60},
    {"name": "per-user", "metadata_key": "total", "limit": 10,
     "window_seconds": 60, "client_key_header": "X-User-Id"},
    {"name": "gpt4-only", "metadata_key": "out", "limit": 5,
     "window_seconds": 60, "model": "gpt-4o"},
    {"name": "be-only", "metadata_key": "total", "limit": 40,
     "window_seconds": 30, "backend": "b2"},
    {"name": "shared-a", "metadata_key": "in", "limit": 3,
     "window_seconds": 60, "shared_group": "g"},
    {"name": "shared-b", "metadata_key": "in", "limit": 6,
     "window_seconds": 60, "shared_group": "g"},
]


def _name(x):
    return None if x is None else x.name


def _limiter_script(side, monkeypatch):
    """One script of checks, draws, remainders, reloads and a sweep;
    every result in order."""
    m = SIDES[side]
    monkeypatch.delenv("AIGW_QUOTA_URL", raising=False)
    monkeypatch.delenv("AIGW_QUOTA_DIR", raising=False)
    raw = {"version": "v1", "backends": [
        {"name": "b", "schema": "OpenAI", "url": "http://x"},
        {"name": "b2", "schema": "OpenAI", "url": "http://y"}],
        "quotas": RULES}
    rc = m.runtime.RuntimeConfig.build(m.model.Config.parse(raw))
    rl = rc.rate_limiter
    out = []

    def check(model, backend, headers, now):
        ok, rule = rl.check(model, backend, headers, now=now)
        out.append(("check", ok, _name(rule)))

    alice, bob = {"x-user-id": "alice"}, {"x-user-id": "bob"}
    check("m", "b", alice, 0)
    rl.consume({"total": 10}, "m", "b", alice, now=1)
    check("m", "b", alice, 2)
    check("m", "b", bob, 2)
    check("m", "b", alice, 61)  # the next window
    rl.consume({"out": 5}, "gpt-4o", "b", {}, now=62)
    check("gpt-4o", "b", {}, 63)
    check("other", "b", {}, 63)
    rl.consume({"total": 41, "in": 4}, "m", "b2", {}, now=64)
    check("m", "b2", {}, 65)  # be-only spent, shared-b has headroom
    check("m", "b", {}, 65)
    rl.consume({"in": 3}, "m", "b", {}, now=66)
    check("m", "b", {}, 67)  # both of group g spent
    for name, key in (("global", ""), ("per-user", "alice"),
                      ("gpt4-only", ""), ("be-only", ""), ("nope", "")):
        out.append(("remaining", name, rl.remaining(name, key, now=68)))
    # a reload that changes nothing keeps the spent windows; one that
    # changes a rule starts it fresh
    raw2 = dict(raw, models=["m"])
    rc2 = m.runtime.RuntimeConfig.build(m.model.Config.parse(raw2),
                                        previous=rc)
    out.append(("reload", rc2.rate_limiter.check("m", "b", alice,
                                                 now=69)[0],
                rc2.rate_limiter.remaining("global", now=69)))
    raw3 = dict(raw, quotas=[dict(RULES[0], limit=200)] + RULES[1:])
    rc3 = m.runtime.RuntimeConfig.build(m.model.Config.parse(raw3),
                                        previous=rc2)
    out.append(("changed", rc3.rate_limiter.remaining("global", now=70),
                rc3.rate_limiter.remaining("per-user", "alice", now=70)))
    sweep = m.rl.RateLimiter([m.rl.QuotaRule(
        name="r", metadata_key="t", limit=5, window_seconds=1)])
    sweep._SWEEP_EVERY = 10
    for i in range(25):
        sweep.consume({"t": 1}, "m", "b", {"x": str(i)}, now=float(i * 10))
    out.append(("swept", sorted(sweep._windows)))
    return out


def test_rate_limiter_script_matches_reference(monkeypatch):
    want = _limiter_script("ref", monkeypatch)
    got = _limiter_script("port", monkeypatch)
    assert got == want
    assert ("check", False, "per-user") in got  # the script bites


@pytest.mark.parametrize("env,kind", [
    ({}, None), ({"AIGW_QUOTA_DIR": "{d}"}, "FileQuotaBackend"),
    ({"AIGW_QUOTA_URL": "http://127.0.0.1:9"}, "HTTPQuotaBackend"),
    ({"AIGW_QUOTA_URL": "http://127.0.0.1:9", "AIGW_QUOTA_DIR": "{d}"},
     "HTTPQuotaBackend")])
def test_shared_store_precedence_like_reference(env, kind, monkeypatch,
                                                tmp_path):
    for k in ("AIGW_QUOTA_URL", "AIGW_QUOTA_DIR"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v.format(d=tmp_path))
    for rules, want in (([RULES[0]], kind or "NoneType"),
                        ([], "NoneType")):
        for m in SIDES.values():
            backend = m.rl.RateLimiter.from_config_value(rules).backend
            assert type(backend).__name__ == want


def test_file_store_is_shared_with_reference(tmp_path):
    """Both stores on one directory: one file per rule under the same
    name, each seeing the other's draws; a legacy (unhashed) file is
    renamed on first touch by either; a torn or wrong-shaped file reads
    as an empty window and heals on the next write."""
    d = str(tmp_path)
    j, t = jrl.FileQuotaBackend(d), trl.FileQuotaBackend(d)
    for name in ("cap", "a b", "a_b", "ünï"):
        assert t._path(name) == j._path(name)
    assert t._path("a b") != t._path("a_b")
    assert t.add("cap", "k", 60.0, 7) == 7
    assert j.add("cap", "k", 60.0, 4) == 11
    assert t.get("cap", "k", 60.0) == j.get("cap", "k", 60.0) == 11
    assert t.get("cap", "k", 120.0) == 0 == t.get("cap", "k2", 60.0)
    assert j.add("cap", "k", 120.0, 1) == 1  # a new window resets
    assert t.get("cap", "k", 60.0) == 0
    for first, second, rule in ((t, j, "rule-a"), (j, t, "rule-b")):
        legacy = tmp_path / f"quota_{rule}.json"
        legacy.write_text(json.dumps({"start": 1e12,
                                      "used": {"client": 7}}))
        path = first._path(rule)
        assert not legacy.exists()
        assert second.get(rule, "client", 1e12) == 7
        assert path == second._path(rule)
    for torn in ("{torn", json.dumps([1, 2]), json.dumps({"used": 3})):
        for store in (t, j):
            with open(store._path("cap"), "w") as f:
                f.write(torn)
            assert (t.get("cap", "k", 0.0), j.get("cap", "k", 0.0)) \
                == (0, 0)
            assert store.add("cap", "k", 0.0, 2) == 2
    a = trl.RateLimiter([trl.QuotaRule(
        name="cap", metadata_key="total", limit=10, window_seconds=60,
        client_key_header="x-user-id")], trl.FileQuotaBackend(d))
    b = jrl.RateLimiter([jrl.QuotaRule(
        name="cap", metadata_key="total", limit=10, window_seconds=60,
        client_key_header="x-user-id")], jrl.FileQuotaBackend(d))
    h = {"x-user-id": "alice"}
    a.consume({"total": 7}, "m", "be", h, now=1000)
    assert b.remaining("cap", "alice", now=1001) == 3
    assert b.check("m", "be", h, now=1001)[0]
    b.consume({"total": 4}, "m", "be", h, now=1001)
    assert not a.check("m", "be", h, now=1002)[0]
    assert not b.check("m", "be", h, now=1002)[0]
    assert a.check("m", "be", {"x-user-id": "bob"}, now=1002)[0]


# -- the quota services ---------------------------------------------------------
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


@pytest.fixture(scope="module")
def services(loop, tmp_path_factory):
    """The port's quota service and the reference's, each on its own
    directory."""
    from aiohttp import web

    async def start():
        tsrv = trl.quota_service(str(tmp_path_factory.mktemp("tq")))
        tport = await tsrv.start("127.0.0.1", 0)
        runner = web.AppRunner(jrl.quota_service_app(
            str(tmp_path_factory.mktemp("jq"))))
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        return tsrv, tport, runner, site._server.sockets[0].getsockname()[1]

    tsrv, tport, runner, jport = _on(loop, start())
    yield {"port": tport, "ref": jport}

    async def stop():
        await tsrv.stop()
        await runner.cleanup()

    _on(loop, stop())


def _raw(port, path, body=None, method=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=None if body is None else body)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.mark.parametrize("client,service", [("ref", "port"),
                                            ("port", "ref")])
def test_quota_service_answers_the_other_client(client, service,
                                                services):
    be = SIDES[client].rl.HTTPQuotaBackend(
        f"http://127.0.0.1:{services[service]}")
    rule = f"r/{client} x"  # a slash and a space, quoted in the path
    assert be.get(rule, "k", 0.0) == 0
    assert be.add(rule, "k", 0.0, 7) == 7
    assert be.add(rule, "k", 0.0, 4) == 11
    assert be.get(rule, "k", 0.0) == 11
    assert be.get(rule, "k", 60.0) == 0 == be.get(rule, "k2", 0.0)
    limiter = SIDES[client].rl.RateLimiter(
        [SIDES[client].rl.QuotaRule(name=rule, metadata_key="t",
                                    limit=12, window_seconds=60)], be)
    assert limiter.check("m", "b", {}, now=1)[0]
    limiter.consume({"t": 12}, "m", "b", {}, now=1)
    assert not limiter.check("m", "b", {}, now=2)[0]


def test_quota_services_answer_alike(services):
    """The same requests, good and bad, to both services: the same
    statuses and bodies."""
    calls = [
        ("/health", None, None),
        ("/v1/quota/q?key=a&start=0", None, None),
        ("/v1/quota/q?key=a&start=zz", None, None),
        ("/v1/quota/q", b'{"key": "a", "start": 0, "amount": 3}', "POST"),
        ("/v1/quota/q", b'{"key": "a", "start": 0}', "POST"),
        ("/v1/quota/q", b"[1]", "POST"),
        ("/v1/quota/q", b"{nope", "POST"),
        ("/v1/quota/q?key=a&start=0", None, None),
        ("/v1/quota/q?start=0", None, None),
    ]
    for path, body, method in calls:
        got = _raw(services["port"], path, body, method)
        want = _raw(services["ref"], path, body, method)
        assert got == want, path
    assert _raw(services["port"], "/v1/quota/q?key=a&start=0") == \
        (200, {"used": 3})
    assert _raw(services["port"], "/v1/quota", None)[0] == 404
    assert _raw(services["port"], "/health", b"{}", "POST")[0] == 405


@pytest.mark.parametrize("side", ["ref", "port"])
def test_quota_service_down_fails_open(side):
    m = SIDES[side].rl
    be = m.HTTPQuotaBackend("http://127.0.0.1:9", timeout=0.3)
    limiter = m.RateLimiter([m.QuotaRule(name="cap", metadata_key="total",
                                         limit=10, window_seconds=60)],
                            backend=be)
    assert limiter.check("m", "be", {}, now=1)[0]
    limiter.consume({"total": 99}, "m", "be", {}, now=1)
    assert limiter.check("m", "be", {}, now=2)[0]


# -- one budget across a reference and a port gateway ---------------------------
class _Upstream(BaseHTTPRequestHandler):
    """An OpenAI upstream whose every chat costs 50 tokens."""

    protocol_version = "HTTP/1.1"

    def do_POST(self):
        self.rfile.read(int(self.headers.get("content-length", 0)))
        body = json.dumps({
            "id": "chatcmpl-fake", "object": "chat.completion",
            "created": 1700000000, "model": "m1",
            "choices": [{"index": 0, "finish_reason": "stop",
                         "message": {"role": "assistant",
                                     "content": "hello"}}],
            "usage": {"prompt_tokens": 5, "completion_tokens": 45,
                      "total_tokens": 50}}).encode()
        self.send_response(200)
        self.send_header("content-type", "application/json")
        self.send_header("content-length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


def _post(port, body, headers):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/chat/completions",
        data=json.dumps(body).encode(),
        headers={"content-type": "application/json", **headers})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, _lower(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, _lower(e.headers), json.loads(e.read())


def _lower(headers):
    return {k.lower(): v for k, v in headers.items()}


def test_two_gateways_share_one_quota_directory(loop, tmp_path,
                                                monkeypatch):
    """A reference gateway and a port gateway on one AIGW_QUOTA_DIR: a
    60-token budget per user admits two 50-token requests in all, the
    third 429s on either with the same body; another user is served."""
    up = ThreadingHTTPServer(("127.0.0.1", 0), _Upstream)
    threading.Thread(target=up.serve_forever, daemon=True).start()
    raw = {"version": "v1",
           "backends": [{"name": "a", "schema": "OpenAI",
                         "url": f"http://127.0.0.1:{up.server_address[1]}"}],
           "routes": [{"name": "r", "rules": [
               {"models": ["m1"], "backends": ["a"]}]}],
           "llm_request_costs": [{"metadata_key": "total",
                                  "type": "TotalToken"}],
           "quotas": [{"name": "cap", "metadata_key": "total", "limit": 60,
                       "window_seconds": 3600,
                       "client_key_header": "x-user-id"}]}
    monkeypatch.delenv("AIGW_QUOTA_URL", raising=False)
    monkeypatch.setenv("AIGW_QUOTA_DIR", str(tmp_path))

    async def start():
        jsrv, runner = await jserver.run_gateway(
            jruntime.RuntimeConfig.build(jmodel.Config.parse(raw)), port=0)
        tsrv = await tserver.run_gateway(
            truntime.RuntimeConfig.build(tmodel.Config.parse(raw)), port=0)
        return runner, tsrv

    runner, tsrv = _on(loop, start())
    ports = {"ref": runner.addresses[0][1], "port": tsrv.port}
    body = {"model": "m1", "messages": [{"role": "user", "content": "hi"}]}
    try:
        u1 = {"x-user-id": "u1"}
        assert _post(ports["port"], body, u1)[0] == 200
        assert _post(ports["ref"], body, u1)[0] == 200
        got = [_post(ports[n], body, u1) for n in ("port", "ref")]
        assert [g[0] for g in got] == [429, 429]
        assert got[0][2] == got[1][2]
        assert got[0][2]["error"]["type"] == "rate_limit_error"
        assert got[0][1]["retry-after"] == got[1][1]["retry-after"] == "1"
        assert _post(ports["port"], body, {"x-user-id": "u2"})[0] == 200
        assert trl.FileQuotaBackend(str(tmp_path)).get(
            "cap", "u1", 0.0) == 0  # another window: nothing there
    finally:
        async def stop():
            await runner.cleanup()
            await tsrv.stop()

        _on(loop, stop())
        up.shutdown()
        up.server_close()


# -- the controller -------------------------------------------------------------
def _fake_launcher(m, fail=False):
    class FakeLauncher(m.ctl.ReplicaLauncher):
        """Instant launches of synthetic addresses, recorded."""

        def __init__(self):
            self.launched, self.terminated, self.n = [], [], 0

        async def launch(self):
            if fail:
                raise RuntimeError("injected launch failure")
            self.n += 1
            addr = f"10.99.0.{self.n}:8000"
            self.launched.append(addr)
            return addr

        def owns(self, address):
            return address in self.launched

        async def terminate(self, address):
            self.terminated.append(address)

        async def close(self):
            pass

    return FakeLauncher()


def _picker(m, addrs, **kw):
    return m.picker.EndpointPicker([m.picker.Endpoint(a) for a in addrs],
                                   fleet_obs=True, **kw)


def _ctl(m, picker, launcher, **cfg):
    return m.ctl.FleetController(
        picker, m.ctl.ControllerConfig.parse(cfg), launcher=launcher,
        decisions=m.fleet.DecisionRing(), backend="pool")


async def _settle(n=4):
    for _ in range(n):
        await asyncio.sleep(0)


async def _scale_out(m):
    picker = _picker(m, ["127.0.0.1:9"], slo_ttft_ms=100.0,
                     slo_window_s=1.0, slo_burn_windows=3)
    mon = picker.fleet.slomon
    launcher = _fake_launcher(m)
    ctl = _ctl(m, picker, launcher, min_replicas=1, max_replicas=3,
               scale_cooldown_s=5.0, idle_ticks=10 ** 6)
    picker.observe("127.0.0.1:9", max_slots=2)
    key = m.slomon.SLOMonitor.FLEET_KEY
    mon.observe(key, {"100": 0, "+Inf": 0}, ts=0.0)
    served, steps = 0, []
    for ts in (1.01, 2.02, 3.03, 4.04, 9.1, 20.0):
        served += 5
        mon.observe(key, {"100": 0, "+Inf": served}, ts=ts)
        await ctl.tick(now=ts)
        await _settle()
        steps.append((len(launcher.launched), mon.sustained(key)))
    await ctl.stop()
    return ctl, {"steps": steps, "launched": launcher.launched}


async def _launch_failure(m):
    picker = _picker(m, ["127.0.0.1:9"], slo_ttft_ms=100.0,
                     slo_window_s=1.0, slo_burn_windows=1)
    mon = picker.fleet.slomon
    ctl = _ctl(m, picker, _fake_launcher(m, fail=True), max_replicas=2,
               scale_cooldown_s=0.0, idle_ticks=10 ** 6)
    key = m.slomon.SLOMonitor.FLEET_KEY
    mon.observe(key, {"100": 0, "+Inf": 0}, ts=0.0)
    mon.observe(key, {"100": 0, "+Inf": 4}, ts=1.1)
    for now in (1.1, 2.2):
        await ctl.tick(now=now)
        await _settle()
    await ctl.stop()
    return ctl, {}


async def _idle_drain(m):
    a, b = "127.0.0.1:11", "127.0.0.1:12"
    picker = _picker(m, [a, b])
    launcher = _fake_launcher(m)
    launcher.launched.append(b)
    ctl = _ctl(m, picker, launcher, min_replicas=1, max_replicas=2,
               idle_ticks=3, idle_slots_frac=0.75, scale_cooldown_s=0.0,
               drain_timeout_s=5.0)
    for addr in (a, b):
        picker.observe(addr, max_slots=2, active_slots=0, queued=0)
    streaks = []
    await ctl.tick(now=100.0)
    streaks.append(ctl.idle_streak)
    picker.observe(a, max_slots=2, active_slots=2, queued=1)
    await ctl.tick(now=101.0)
    streaks.append(ctl.idle_streak)
    picker.observe(a, max_slots=2, active_slots=0, queued=0)
    mid = None
    for now in (102.0, 103.0, 104.0):
        await ctl.tick(now=now)
        streaks.append((ctl.idle_streak, sorted(ctl._drains)))
        if mid is None and ctl._drains:
            mid = (ctl.gauge_values(), _masked(ctl.snapshot()))
    for _ in range(200):
        if not ctl._drains:
            break
        picker.observe(b, max_slots=2, active_slots=0, queued=0)
        await asyncio.sleep(0.02)
    for now in range(110, 130):
        await ctl.tick(now=float(now))
    await ctl.stop()
    return ctl, {"streaks": streaks, "mid": mid,
                 "terminated": launcher.terminated,
                 "pool": [e.address for e in picker.endpoints]}


async def _failover(m):
    a, b = "127.0.0.1:31", "127.0.0.1:32"
    picker = _picker(m, [a, b])
    launcher = _fake_launcher(m)
    ctl = _ctl(m, picker, launcher, min_replicas=2, max_replicas=3,
               down_grace_s=5.0, scale_cooldown_s=0.0, idle_ticks=10 ** 6)
    picker.observe(a, max_slots=2)
    picker.observe(b, max_slots=2)
    picker._affinity["sess-1"] = a
    for _ in range(3):
        picker.fleet.note_poll(a, False)
    seen = []
    for now in (50.0, 56.0, 57.0):
        await ctl.tick(now=now)
        await _settle()
        seen.append((ctl.counters["failovers"], list(launcher.launched),
                     "sess-1" in picker._affinity))
    await ctl.stop()
    return ctl, {"seen": seen}


async def _flapping(m):
    a, b = "127.0.0.1:41", "127.0.0.1:42"
    picker = _picker(m, [a, b])
    launcher = _fake_launcher(m)
    ctl = _ctl(m, picker, launcher, min_replicas=2, max_replicas=3,
               down_grace_s=5.0, scale_cooldown_s=0.0, idle_ticks=10 ** 6)
    picker.observe(b, max_slots=2)
    health = []
    for flap in range(3):
        now = 100.0 + flap * 10
        for _ in range(3):
            picker.fleet.note_poll(a, False)
        await ctl.tick(now=now)
        await ctl.tick(now=now + 2.0)
        picker.fleet.note_poll(a, True, {"replica_id": "r-a"})
        picker.fleet.note_poll(a, True, {"replica_id": "r-a"})
        health.append(picker.fleet.health_of(a))
        await ctl.tick(now=now + 4.0)
    await ctl.stop()
    return ctl, {"health": health, "launched": launcher.launched,
                 "terminated": launcher.terminated}


def _masked(obj):
    if isinstance(obj, dict):
        return {k: "*" if k == "ts" else _masked(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_masked(v) for v in obj]
    return obj


SCENARIOS = {"scale_out": _scale_out, "launch_failure": _launch_failure,
             "idle_drain": _idle_drain, "failover": _failover,
             "flapping": _flapping}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_controllers_act_alike(name):
    """One script, both controllers: the same actions in the same order
    (event ring and decision ring), counters, gauges and snapshots."""
    out = {}
    for side, m in SIDES.items():
        ctl, extra = asyncio.run(SCENARIOS[name](m))
        out[side] = {
            "events": [(e["action"], e.get("replica", ""),
                        e.get("reason", "")) for e in ctl.events],
            "decisions": _masked(ctl.decisions.snapshot(limit=1000)),
            "gauges": ctl.gauge_values(),
            "snapshot": _masked(ctl.snapshot()),
            **extra}
    assert out["port"] == out["ref"]
    got = out["port"]
    actions = [e[0] for e in got["events"]]
    if name == "scale_out":
        # the launch at the third window exactly, one more past the
        # cooldown, then the cap
        assert got["steps"] == [(0, False), (0, False), (1, True),
                                (1, True), (2, True), (2, True)]
        assert actions.count("scale_out") == 2
    elif name == "launch_failure":
        assert got["gauges"]["launch_failures"] == 2
    elif name == "idle_drain":
        assert got["terminated"] == ["127.0.0.1:12"]
        assert got["pool"] == ["127.0.0.1:11"]
        assert {"drain_start", "drain_complete", "retire"} <= set(actions)
        assert got["mid"][0]["drains_in_progress"] == 1
    elif name == "failover":
        assert got["seen"] == [(0, [], False), (1, ["10.99.0.1:8000"],
                                                False),
                               (1, ["10.99.0.1:8000"], False)]
        assert actions[:2] == ["reroute", "failover"]
    else:
        assert got["health"] == ["up"] * 3
        assert got["launched"] == got["terminated"] == []
        assert got["gauges"]["failovers"] == 0
