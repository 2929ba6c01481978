"""The port's fleet operations against the reference's with replicas on
the CPU.

- Quotas: the reference's gateway and the port's in front of the same
  port replica, one quota script: the same 429s after the same requests,
  the consumed budget the sum of the replies' token usage; a
  backend-scoped budget fails over to the next backend on both, without
  a breaker mark.
- Migration: both gateways over the same two port replicas, the
  queue-depth trigger: a stream pinned to the one-slot replica whose
  queue then deepens is moved to its idle sibling, its text equal to the
  same request served whole, each gateway's migration counter and the
  replicas' ``migrations_out`` / ``migrations_in`` one up; a replica
  with its prefix cache off (``migration: false``) is never exported
  from.
- The port's launcher and child (``tpuserve/child.py``, ``device:
  cpu``) behind the port's gateway with a ``controller`` block: a
  lossless drain (a stream on the launched replica moved off it byte for
  byte as its solo run, the replica retired and exited 0), and a kill -9
  mid-decode (a typed error event, the failover, and a replacement the
  controller's launcher starts after the grace).
"""

import asyncio
import json
import os
import signal
import threading
import time
import urllib.error
import urllib.request

import pytest

from aigw_tpu.config import model as jmodel
from aigw_tpu.config import runtime as jruntime
from aigw_tpu.gateway import server as jserver
from aigw_tpu_torch.config import model as tmodel
from aigw_tpu_torch.config import runtime as truntime
from aigw_tpu_torch.gateway import server as tserver
from aigw_tpu_torch.gateway.controller import LocalProcessLauncher

MODEL = "tiny-random"
PS = 16


def _replica(batch=2, max_seq_len=512, ticks=1, prefix_cache=True):
    from aigw_tpu_torch.tpuserve.engine import EngineConfig
    from aigw_tpu_torch.tpuserve.server import TPUServeServer

    srv = TPUServeServer(
        MODEL, EngineConfig(max_batch_size=batch, max_seq_len=max_seq_len,
                            page_size=PS, decode_steps_per_tick=ticks,
                            enable_prefix_cache=prefix_cache),
        device="cpu", port=0)
    srv.start()
    return srv


@pytest.fixture(scope="module")
def loop():
    lp = asyncio.new_event_loop()
    t = threading.Thread(target=lp.run_forever, daemon=True)
    t.start()
    yield lp
    lp.call_soon_threadsafe(lp.stop)
    t.join(timeout=10)


def _on(loop, coro, timeout=120):
    return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout)


def _start(loop, side, raw):
    """A gateway of ``side`` on ``raw``: (its port, a stop coroutine
    factory, the server)."""
    async def start():
        if side == "ref":
            srv, runner = await jserver.run_gateway(
                jruntime.RuntimeConfig.build(jmodel.Config.parse(raw)),
                port=0)
            return runner.addresses[0][1], runner.cleanup, srv
        srv = await tserver.run_gateway(
            truntime.RuntimeConfig.build(tmodel.Config.parse(raw)), port=0)
        return srv.port, srv.stop, srv

    return _on(loop, start())


def _http(port, path, body=None, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"content-type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, {k.lower(): v for k, v in r.headers.items()}, \
                r.read()
    except urllib.error.HTTPError as e:
        return e.code, {k.lower(): v for k, v in e.headers.items()}, \
            e.read()


def _state(port):
    return json.loads(_http(port, "/state")[2])


def _stream(port, path, body, headers=None, on_frame=None):
    """One streamed request: the text of its token frames, whether it
    ended with ``[DONE]``, whether an error event came, the finish
    reason. ``on_frame(n)`` runs after the n-th data frame."""
    out = {"pieces": [], "done": False, "error_event": False,
           "finish": None}
    frames = 0
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"content-type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=300) as r:
        out["status"] = r.status
        for line in r:
            line = line.strip()
            if not line.startswith(b"data: "):
                continue
            if line[6:] == b"[DONE]":
                out["done"] = True
                break
            ev = json.loads(line[6:])
            if "error" in ev:
                out["error_event"] = True
                continue
            for c in ev.get("choices") or []:
                piece = (c.get("delta") or {}).get("content") \
                    or c.get("text") or ""
                if piece:
                    out["pieces"].append(piece)
                out["finish"] = c.get("finish_reason") or out["finish"]
            frames += 1
            if on_frame is not None:
                on_frame(frames)
    return out


def _wait(pred, what, timeout=60.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _routes(*backends):
    return [{"name": "serving", "rules": [
        {"model_prefixes": ["tiny"], "backends": list(backends)}]}]


# -- quotas -----------------------------------------------------------------------
@pytest.fixture(scope="module")
def replica():
    srv = _replica(batch=4, max_seq_len=256, ticks=2)
    yield srv
    srv.stop()


def test_quotas_through_both_gateways(replica, loop, monkeypatch):
    """A TotalToken budget keyed by a header: the same requests are
    admitted on both gateways, the next answers the same 429; the
    consumed budget equals the replies' token usage; another key is
    served. Then a backend-scoped budget: once spent, both fail over to
    the second backend with no breaker failure and equal counters."""
    for k in ("AIGW_QUOTA_URL", "AIGW_QUOTA_DIR"):
        monkeypatch.delenv(k, raising=False)
    url = f"http://127.0.0.1:{replica.port}"
    raw = {"version": "v1",
           "backends": [{"name": n, "schema": "TPUServe", "url": url}
                        for n in ("main", "first", "second")],
           "routes": [{"name": "r", "rules": [
               {"headers": [{"name": "x-scope", "value": "1"}],
                "backends": [{"backend": "first", "priority": 0},
                             {"backend": "second", "priority": 1}]},
               {"models": [MODEL], "backends": ["main"]}]}],
           "llm_request_costs": [{"metadata_key": "total",
                                  "type": "TotalToken"}],
           "quotas": [{"name": "per-user", "metadata_key": "total",
                       "limit": 100, "window_seconds": 3600,
                       "client_key_header": "x-user-id"},
                      {"name": "first-only", "metadata_key": "total",
                       "limit": 30, "window_seconds": 3600,
                       "model": MODEL, "backend": "first"}]}
    got = {}
    for side in ("ref", "port"):
        port, stop, srv = _start(loop, side, raw)
        try:
            seen, used = [], 0
            for i in range(12):
                body = {"model": MODEL, "prompt": f"quota request {i}",
                        "max_tokens": 8, "temperature": 0}
                s, h, b = _http(port, "/v1/completions", body,
                                {"x-user-id": "u1"})
                seen.append(s)
                if s != 200:
                    break
                used += json.loads(b)["usage"]["total_tokens"]
            limited = (s, h.get("retry-after"), json.loads(b))
            other = _http(port, "/v1/completions", dict(body, max_tokens=2),
                          {"x-user-id": "u2"})[0]
            spent = srv.runtime.rate_limiter._windows[
                ("per-user", "u1")].used
            # the backend-scoped budget: first, first, then second
            scoped = []
            for i in range(3):
                body = {"model": MODEL, "prompt": f"scoped {i}",
                        "max_tokens": 8, "temperature": 0}
                s2, _h, b2 = _http(port, "/v1/completions", body,
                                   {"x-scope": "1"})
                scoped.append(s2)
            health = json.loads(_http(port, "/health")[2])
            metrics = _http(port, "/metrics")[2].decode()
            got[side] = {
                "statuses": seen, "limited": limited, "other": other,
                "used": used, "spent": spent, "scoped": scoped,
                "circuit": health["circuit"],
                "retries": sorted(ln for ln in metrics.splitlines()
                                  if ln.startswith(("aigw_retries_total{",
                                                    "aigw_requests_total{")))}
        finally:
            _on(loop, stop())
    assert got["port"] == got["ref"]
    g = got["port"]
    assert g["statuses"][-1] == 429 and len(g["statuses"]) > 1
    assert g["limited"][1] == "1"
    assert g["limited"][2]["error"]["type"] == "rate_limit_error"
    assert g["used"] == g["spent"] >= 100 and g["other"] == 200
    assert g["scoped"] == [200, 200, 200]
    assert not g["circuit"].get("first", {}).get("failures")
    assert any('backend="second"' in ln for ln in g["retries"])


# -- migration ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def pair():
    """A: one slot; B: two; C: one slot with the prefix cache off."""
    a, b = _replica(batch=1), _replica(batch=2)
    c = _replica(batch=1, prefix_cache=False)
    yield a, b, c
    for r in (a, b, c):
        r.stop()


N_TOK = 240
PAYLOAD = {"model": MODEL, "max_tokens": N_TOK, "temperature": 0,
           "stream": True,
           "messages": [{"role": "user", "content": "migrate me " * 8}]}


def _migrate_through(port, src, flood_port):
    """The payload pinned to ``src``; once its first token arrives,
    three requests sent straight to ``flood_port`` deepen its queue."""
    floods = []

    def flood(n):
        if n == 1:
            for i in range(3):
                t = threading.Thread(target=_http, args=(
                    flood_port, "/v1/completions",
                    {"model": MODEL, "max_tokens": 48, "temperature": 0,
                     "prompt": f"flood {i} " * 8}))
                t.start()
                floods.append(t)

    out = _stream(port, "/v1/chat/completions", PAYLOAD,
                  {"x-gateway-destination-endpoint": src}, on_frame=flood)
    for t in floods:
        t.join(timeout=120)
    return out


def test_migration_through_both_gateways(pair, loop):
    a, b, c = pair
    addrs = [f"127.0.0.1:{r.port}" for r in (a, b, c)]
    raw = {"version": "v1",
           "backends": [{"name": "pool", "schema": "OpenAI",
                         "endpoints": addrs[:2],
                         "picker_poll_interval": 0.1, "migration": True,
                         "migration_queue_depth": 1,
                         "migration_young_tokens": N_TOK},
                        {"name": "nocache", "schema": "OpenAI",
                         "endpoints": [addrs[2], addrs[1]],
                         "picker_poll_interval": 0.1, "migration": True,
                         "migration_queue_depth": 1,
                         "migration_young_tokens": N_TOK}],
           "routes": _routes("pool"), "models": [MODEL]}
    solo = json.loads(_http(b.port, "/v1/chat/completions",
                            dict(PAYLOAD, stream=False))[2])
    want = solo["choices"][0]["message"]["content"]
    got = {}
    for side in ("ref", "port"):
        port, stop, srv = _start(loop, side, raw)
        try:
            picker = srv._pickers["pool"]
            _wait(lambda: len(picker.state) == 2 and all(
                st.healthy and st.migration_capable
                for st in picker.state.values()), "the pool polled")
            before = [_state(r.port) for r in (a, b)]
            res = _migrate_through(port, addrs[0], a.port)
            after = [_state(r.port) for r in (a, b)]
            metrics = _http(port, "/metrics")[2].decode()
            got[side] = {
                "text": "".join(res["pieces"]), "done": res["done"],
                "error": res["error_event"], "finish": res["finish"],
                "out": after[0]["migrations_out"]
                - before[0]["migrations_out"],
                "in": after[1]["migrations_in"] - before[1]["migrations_in"],
                "counter": [ln for ln in metrics.splitlines()
                            if ln.startswith("aigw_migrations_total{")]}
        finally:
            _on(loop, stop())
    assert got["port"] == got["ref"]
    g = got["port"]
    assert g["text"] == want and g["done"] and not g["error"]
    assert g["finish"] == "length"
    assert (g["out"], g["in"]) == (1, 1)
    assert g["counter"] == [
        'aigw_migrations_total{backend="pool",route="serving"} 1.0']
    # the replica without a prefix cache reports migration: false and
    # its stream is never exported, on either gateway
    raw["routes"] = _routes("nocache")
    for side in ("ref", "port"):
        port, stop, srv = _start(loop, side, raw)
        try:
            picker = srv._pickers["nocache"]
            _wait(lambda: len(picker.state) == 2 and all(
                st.healthy for st in picker.state.values()),
                "the pool polled")
            assert not picker.state[addrs[2]].migration_capable
            before = _state(c.port)["migrations_out"]
            res = _migrate_through(port, addrs[2], c.port)
            assert res["done"] and "".join(res["pieces"]) == want
            assert _state(c.port)["migrations_out"] == before == 0
            metrics = _http(port, "/metrics")[2].decode()
            assert "aigw_migrations_total{" not in metrics, side
        finally:
            _on(loop, stop())


# -- the launcher, the child and the controller ---------------------------------
TINY = {"vocab_size": 512, "dim": 64, "n_layers": 2, "n_heads": 4,
        "n_kv_heads": 2, "ffn_dim": 128, "max_seq_len": 1024,
        "rope_theta": 10000.0}
CHILD = {"model": "tiny-fleet", "cfg": TINY, "batch": 2, "page": 16,
         "k": 2, "quantize": "", "param_dtype": "float32", "tp": 1,
         "engine": {"min_prefill_bucket": 16, "num_pages": 160,
                    "kv_cache_dtype": "float32"},
         "seed": 3, "device": "cpu"}


def _fleet_config(endpoints, **controller):
    return {"version": "v1",
            "backends": [{"name": "pool", "schema": "OpenAI",
                          "endpoints": endpoints,
                          "picker_poll_interval": 0.1, "migration": True,
                          # no stream matures past a drain's reach
                          "migration_young_tokens": 10 ** 6,
                          "controller": {
                              "min_replicas": 1, "max_replicas": 3,
                              "tick_s": 0.1, "idle_ticks": 10 ** 6,
                              "scale_cooldown_s": 0.0,
                              "launcher": {"kind": "local", "spec": CHILD,
                                           "term_grace_s": 60},
                              **controller}}],
            "routes": _routes("pool"), "models": ["tiny-fleet"]}


def _actions(srv):
    return [e["action"] for e in srv._controllers["pool"].events]


def test_lossless_drain_of_a_launched_replica(loop):
    """Replica B from a launcher of the test, replica A from the
    gateway's controller's launcher (one spec, one seed, so one set of
    weights); the solo run on B; the same request through the gateway
    pinned to A, and after a few tokens ``drain_and_retire(A)``: one
    complete stream whose text equals the solo run's, A out of the pool
    and exited 0, the drain in both rings, the migration counted."""
    side = LocalProcessLauncher(CHILD, term_grace_s=60)
    addr_b = _on(loop, side.launch())
    port, stop, srv = _start(loop, "port", _fleet_config([addr_b]))
    try:
        ctl = srv._controllers["pool"]
        addr_a = _on(loop, ctl.launcher.launch())
        ctl.picker.add_endpoint(addr_a)
        _wait(lambda: all(st.healthy and st.migration_capable
                          for st in ctl.picker.state.values())
              and len(ctl.picker.state) == 2, "both replicas polled")
        # long enough that the drain lands while it decodes on A; a chat,
        # since the gateway counts streamed tokens by their content
        # deltas, as the reference's does (a stream with none yet is not
        # exported)
        payload = {"model": "tiny-fleet", "max_tokens": 600,
                   "temperature": 0, "stream": True,
                   "messages": [{"role": "user", "content": "drain me"}]}
        solo = _stream(int(addr_b.split(":")[1]), "/v1/chat/completions",
                       payload)
        assert solo["done"] and solo["finish"] == "length"
        drained = {}

        def drain(n):
            if n == 4:
                drained["f"] = asyncio.run_coroutine_threadsafe(
                    ctl.drain_and_retire(addr_a, reason="test"), loop)

        res = _stream(port, "/v1/chat/completions", payload,
                      {"x-gateway-destination-endpoint": addr_a},
                      on_frame=drain)
        assert drained["f"].result(120) is True
        assert res["done"] and not res["error_event"]
        assert "".join(res["pieces"]) == "".join(solo["pieces"])
        assert addr_a not in ctl.picker.state
        assert ctl.launcher.returncode(addr_a) == 0
        acts = _actions(srv)
        assert acts.count("drain_start") == 1
        assert {"drain_complete", "retire"} <= set(acts)
        lifecycles = [d.get("lifecycle")
                      for d in srv.decisions.snapshot(limit=200)]
        assert {"drain_start", "drain_complete", "retire"} <= set(lifecycles)
        st_b = _state(int(addr_b.split(":")[1]))
        assert st_b["migrations_in"] == 1
        mets = _http(port, "/metrics")[2].decode()
        assert 'aigw_migrations_total{backend="pool",route="serving"} 1.0' \
            in mets
        fs = json.loads(_http(port, "/fleet/state")[2])
        snap = fs["backends"]["pool"]["controller"]
        assert snap["counters"]["retires"] == 1
        assert snap["replicas_live"] == [addr_b]
        fm = _http(port, "/fleet/metrics")[2].decode()
        assert "aigw_ctl_retires_total 1" in fm
    finally:
        _on(loop, stop())
        _on(loop, side.close())
    assert side.returncode(addr_b) == 0


def test_kill9_mid_decode_fails_over_and_replaces(loop):
    """Two launched replicas behind the port's gateway, its controller
    keeping two live: kill -9 of the one a stream is pinned to ends the
    stream with a typed error event; the replica goes down, the
    controller records the reroute and the failover and its launcher
    starts a replacement that joins the pool; new traffic completes; the
    gateway's shutdown stops the replacement."""
    side = LocalProcessLauncher(CHILD, term_grace_s=60)

    async def two():
        return await asyncio.gather(side.launch(), side.launch())

    addr_a, addr_b = _on(loop, two())
    port, stop, srv = _start(loop, "port", _fleet_config(
        [addr_a, addr_b], min_replicas=2, down_grace_s=0.3))
    stopped = False
    try:
        ctl = srv._controllers["pool"]
        _wait(lambda: all(st.healthy for st in ctl.picker.state.values()),
              "both replicas polled")
        payload = {"model": "tiny-fleet", "prompt": "k " * 20,
                   "max_tokens": 900, "temperature": 0, "stream": True}

        def kill(n):
            if n == 3:
                os.kill(side.pid(addr_a), signal.SIGKILL)

        res = _stream(port, "/v1/completions", payload,
                      {"x-gateway-destination-endpoint": addr_a},
                      on_frame=kill)
        assert res["error_event"] and not res["done"], res
        _wait(lambda: ctl.picker.fleet.health_of(addr_a) == "down",
              "A down")
        _wait(lambda: ctl.counters["failovers"] >= 1, "the failover")
        _wait(lambda: len(ctl.picker.endpoints) == 3, "the replacement",
              timeout=120)
        new = [e.address for e in ctl.picker.endpoints
               if e.address not in (addr_a, addr_b)]
        assert ctl.launcher.owns(new[0])
        acts = _actions(srv)
        assert {"reroute", "failover", "launch"} <= set(acts)
        lifecycles = [d.get("lifecycle")
                      for d in srv.decisions.snapshot(limit=200)]
        assert "failover" in lifecycles
        res2 = _stream(port, "/v1/completions",
                       dict(payload, max_tokens=8, prompt="post " * 10))
        assert res2["done"], res2
        pid = ctl.launcher.pid(new[0])
        _on(loop, stop())
        stopped = True
        assert ctl.launcher.returncode(new[0]) == 0  # not orphaned
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
    finally:
        if not stopped:
            _on(loop, stop())
        _on(loop, side.close())
