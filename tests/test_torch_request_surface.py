"""The replica's request surface: logprobs and ``n`` at the server,
tenant-fair admission, ``/state``'s tenant keys and
``ttft_hist_buckets``, against the JAX package.

- Intake: ``check_logprobs`` on the bodies of ROADMAP §3's table, an
  over-cap ``top_logprobs`` and ``top_logprobs`` without ``logprobs``,
  with the knob off and at caps 3 and 25 (the 20 ceiling): status and
  message equal to the reference's ``_check_logprobs``.
- Servers: the reference server (its weights in float32) and the
  port's, ``logprobs_topk=5``, serve the same bodies one at a time:
  chat and legacy logprobs buffered and streamed, ``n`` choices
  buffered and streamed with and without logprobs; texts, indexes,
  finish reasons, usage and every logprobs entry (values within 2e-4)
  equal per choice; the refusals (``n`` above the batch, tools with
  ``n``, logprobs with ``response_format`` or tools, the intake's bad
  bodies) return the reference's status and message.
- Fairness: ``_fair_admission`` on the reference tests' cases and, over
  random mixes, equal to the reference's and to the quadratic scan its
  heap replaced. Whole engines (the reference's and the port's): a
  multi-adapter burst at cap 0 and header tenants at cap 1 are admitted
  in the reference's order, with its deferral counts and its tenant
  counts at every first token.
- ``/state``: the five tenant keys equal the reference server's for the
  same slots; ``ttft_hist_buckets`` equals the reference's
  ``cumulative()``; a reference ``FleetState`` fed a port replica's
  polls closes a goodput window (and marks the replica degraded when
  the window overshoots its SLO).
- The reference gateway in front of a port replica relays
  ``x-aigw-tenant`` and passes logprobs and ``n: 2`` through.
"""

import asyncio
import json
import random
import threading
import types
import urllib.error
import urllib.request

import aiohttp
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aigw_tpu.models import llama as jllama
from aigw_tpu.obs import metrics as jmetrics
from aigw_tpu.tpuserve import adapters as jadapters
from aigw_tpu.tpuserve import engine as jengine
from aigw_tpu.tpuserve.sampling import SamplingParams as JSampling
from aigw_tpu_torch.models import convert
from aigw_tpu_torch.models import llama as tllama
from aigw_tpu_torch.obs import metrics as tmetrics
from aigw_tpu_torch.schemas import openai as toai
from aigw_tpu_torch.tpuserve import adapters as tadapters
from aigw_tpu_torch.tpuserve import engine as tengine
from aigw_tpu_torch.tpuserve.sampling import SamplingParams as TSampling

MODEL = "tiny-random"
EOS = (257,)
TOL = 2e-4
TENANT_KEYS = ("tenant_slots", "tenants_active", "tenant_max_slots",
               "tenant_deferrals", "tenant_slot_cap")


@pytest.fixture(scope="module")
def weights():
    p = jllama.init_params(jax.random.PRNGKey(0), jllama.TINY,
                           dtype=jnp.float32)
    return p, convert.params_from_numpy(
        {k: np.asarray(v) for k, v in p.items()}, device="cpu")


# -- intake ------------------------------------------------------------------
INTAKE = [
    {"logprobs": 0},  # the legacy integer form: chosen-token logprobs
    {"logprobs": False, "top_logprobs": 0},
    {"logprobs": True},
    {"top_logprobs": 2},  # the reference's quirk: the type message
    {"logprobs": True, "top_logprobs": 3},
    {"logprobs": True, "top_logprobs": 6},  # over cap 3
    {"logprobs": True, "top_logprobs": 21},  # over the 20 ceiling
    {"logprobs": 20},
    {"logprobs": -1},
    {"logprobs": "x"},
    {"logprobs": True, "top_logprobs": "x"},
    {},
]


def _intake(fn, body, cap):
    me = types.SimpleNamespace(
        engine=types.SimpleNamespace(cfg=types.SimpleNamespace(
            logprobs_topk=cap)))
    try:
        return 200, fn(me, body)
    except ValueError as e:  # SchemaError: the handler's 400
        return 400, str(e)


@pytest.mark.parametrize("cap", [0, 3, 25])
@pytest.mark.parametrize("body", INTAKE, ids=[json.dumps(b) for b in INTAKE])
def test_check_logprobs_matches_reference(body, cap):
    from aigw_tpu.tpuserve import server as jserver
    from aigw_tpu_torch.tpuserve.server import TPUServeServer

    want = _intake(jserver.TPUServeServer._check_logprobs, body, cap)
    got = _intake(TPUServeServer.check_logprobs, body, cap)
    assert got == want
    if body == {"top_logprobs": 2}:
        assert got[1].startswith("logprobs must be a boolean")


# -- the servers ----------------------------------------------------------------
SERVER_CFG = dict(max_batch_size=4, max_seq_len=256, page_size=16,
                  decode_steps_per_tick=4, kv_cache_dtype="float32",
                  attention_backend="pallas-ragged", logprobs_topk=5)
MSGS = [{"role": "user", "content": "hello there"}]


def _chat(**kw):
    return {"model": MODEL, "messages": MSGS, "max_tokens": 6,
            "temperature": 0.0, **kw}


def _text(**kw):
    return {"model": MODEL, "prompt": "once upon", "max_tokens": 5,
            "temperature": 0.0, **kw}


USAGE = {"stream_options": {"include_usage": True}}
CHAT, TEXT = "/v1/chat/completions", "/v1/completions"
CALLS = [
    (CHAT, _chat(logprobs=True, top_logprobs=2)),
    (CHAT, _chat(logprobs=True, top_logprobs=5, stream=True, **USAGE)),
    (TEXT, _text(logprobs=3)),
    (TEXT, _text(logprobs=0, stream=True)),
    (TEXT, _text(logprobs=False, top_logprobs=0)),
    (CHAT, _chat(n=3, temperature=0.8, seed=11)),
    (CHAT, _chat(n=2, logprobs=True, top_logprobs=1, stream=True, **USAGE)),
    (TEXT, _text(n=2, temperature=0.9, seed=5, stream=True, **USAGE)),
    (TEXT, _text(n=2, logprobs=2)),
    (CHAT, _chat(n=4, temperature=0.7, seed=3, stream=True)),
    # refusals
    (CHAT, _chat(n=99)),
    (CHAT, _chat(n=2, tools=[{"type": "function",
                              "function": {"name": "f"}}],
                 tool_choice="required")),
    (CHAT, _chat(logprobs=True, response_format={"type": "json_object"})),
    (CHAT, _chat(logprobs=True, tools=[{"type": "function",
                                        "function": {"name": "f"}}],
                 tool_choice="required")),
    (CHAT, _chat(logprobs=True, top_logprobs=6)),
    (CHAT, _chat(top_logprobs=2)),
    (TEXT, _text(logprobs=-2)),
]


def _http(port, path, body=None, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"content-type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _usage(u):
    # the reference's usage also carries its meter record (usage
    # metering is not ported)
    return None if u is None else {k: v for k, v in u.items()
                                   if k != "aigw_meter"}


def _reply(status, raw, stream):
    """A reply without its id and ``created``: per choice index its
    text, finish and logprobs (a stream's reassembled: the chat entries
    concatenated, the legacy lists extended), the usage, and a stream's
    frame counts."""
    if status != 200:
        return {"status": status, "error": json.loads(raw)["error"]}
    if not stream:
        body = json.loads(raw)
        return {"object": body["object"], "usage": _usage(body["usage"]),
                "choices": [{k: v for k, v in c.items()}
                            for c in body["choices"]]}
    frames = [ln[6:] for ln in raw.split("\n") if ln.startswith("data: ")]
    assert frames[-1] == "[DONE]" and frames.count("[DONE]") == 1
    choices: dict = {}
    usage = None
    for f in frames[:-1]:
        ev = json.loads(f)
        usage = _usage(ev.get("usage")) or usage
        for ch in ev["choices"]:
            c = choices.setdefault(ch["index"], {
                "text": "", "finishes": [], "logprobs": None, "roles": 0})
            if "delta" in ch:
                c["text"] += ch["delta"].get("content") or ""
                c["roles"] += "role" in ch["delta"]
            else:
                c["text"] += ch["text"]
            if ch["finish_reason"] is not None:
                c["finishes"].append(ch["finish_reason"])
            lp = ch.get("logprobs")
            if lp is None:
                continue
            if "content" in lp:
                c["logprobs"] = (c["logprobs"] or []) + lp["content"]
            else:
                acc = c["logprobs"] or {"tokens": [], "token_logprobs": [],
                                        "top_logprobs": []}
                for k in acc:
                    acc[k] = acc[k] + lp[k]
                c["logprobs"] = acc
    return {"object": json.loads(frames[0])["object"], "usage": usage,
            "choices": [choices[i] for i in sorted(choices)]}


def _drive(port) -> list:
    return [_reply(*_http(port, path, body), body.get("stream", False))
            for path, body in CALLS]


def _approx(got, want, where=""):
    """Equal structures; floats within TOL."""
    if isinstance(want, float) and isinstance(got, (int, float)):
        assert abs(got - want) <= TOL, (where, got, want)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (
            where, sorted(got), sorted(want))
        for k in want:
            _approx(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _approx(g, w, f"{where}[{i}]")
    else:
        assert got == want, (where, got, want)


@pytest.fixture(scope="module")
def reference_run():
    """The reference server in a thread, on its tiny-random weights in
    float32, driven with CALLS one at a time."""
    from aiohttp import web

    from aigw_tpu.tpuserve import server as jserver

    class F32Server(jserver.TPUServeServer):
        def _load_params(self, spec):
            return jllama.init_params(jax.random.PRNGKey(0), self.model_cfg,
                                      jnp.float32)

    holder = {}
    started = threading.Event()

    def run():
        async def main():
            server = F32Server(MODEL, jengine.EngineConfig(**SERVER_CFG))
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
    try:
        return _drive(holder["port"])
    finally:
        holder["loop"].call_soon_threadsafe(holder["stop"].set)
        t.join(timeout=60)


def _port_server(weights, **over):
    from aigw_tpu_torch.tpuserve.server import TPUServeServer

    srv = TPUServeServer(MODEL, tengine.EngineConfig(**{**SERVER_CFG,
                                                         **over}),
                         device="cpu", port=0, param_dtype="float32")
    srv.engine = tengine.Engine(weights[1], tllama.TINY, srv.engine.cfg,
                                eos_token_ids=EOS, fns=srv.fns, device="cpu")
    return srv


@pytest.fixture(scope="module")
def port_run(weights):
    srv = _port_server(weights)
    srv.start()
    try:
        return _drive(srv.port)
    finally:
        srv.stop()


@pytest.mark.parametrize("i", range(len(CALLS)))
def test_server_reply_matches_reference(port_run, reference_run, i):
    _approx(port_run[i], reference_run[i], f"call {i}")


def test_server_replies_hold_their_shapes(port_run):
    """Beyond parity: one entry per completion token, ``bytes`` the
    piece's UTF-8, k alternates, one finish (and one role frame) per
    streamed index, the prompt counted once."""
    got = port_run
    c0 = got[0]["choices"][0]
    assert len(c0["logprobs"]["content"]) == got[0]["usage"][
        "completion_tokens"]
    for e in c0["logprobs"]["content"]:
        assert e["bytes"] == list(e["token"].encode())
        assert len(e["top_logprobs"]) == 2 and e["logprob"] <= 0.0
    s1 = got[1]["choices"][0]
    assert len(s1["logprobs"]) == got[1]["usage"]["completion_tokens"]
    assert s1["finishes"] == ["length"] and s1["roles"] == 1
    legacy = got[2]["choices"][0]["logprobs"]
    assert len(legacy["tokens"]) == len(legacy["token_logprobs"]) == 5
    assert all(len(t) <= 3 for t in legacy["top_logprobs"])
    assert got[3]["choices"][0]["logprobs"]["top_logprobs"] == [{}] * 5
    assert "logprobs" not in got[4]["choices"][0]
    n3 = got[5]
    assert [c["index"] for c in n3["choices"]] == [0, 1, 2]
    assert len({c["message"]["content"] for c in n3["choices"]}) > 1
    assert n3["usage"]["completion_tokens"] == 18
    assert n3["usage"]["prompt_tokens"] == got[0]["usage"]["prompt_tokens"]
    for r in (got[6], got[7], got[9]):
        assert all(c["finishes"] == ["length"] for c in r["choices"])
    assert got[6]["choices"][0]["text"] == got[6]["choices"][1]["text"]
    assert got[6]["usage"]["completion_tokens"] == 12
    assert len(got[9]["choices"]) == 4
    assert [r["status"] for r in got[10:]] == [400] * 7
    assert got[10]["error"]["message"] == "n=99 exceeds max_batch_size 4"


@pytest.mark.parametrize("argv,want", [
    ([], (0, 0)), (["--logprobs", "20", "--tenant-slot-cap", "4"], (20, 4))])
def test_cli_logprobs_and_tenant_cap(argv, want):
    from aigw_tpu_torch.cli import build_parser, engine_config

    args = build_parser().parse_args(
        ["tpuserve", "--model", MODEL, "--device", "cpu", *argv])
    cfg = engine_config(args)
    assert (cfg.logprobs_topk, cfg.tenant_slot_cap) == want


# -- fairness: the function ------------------------------------------------
def _fake_engine(cap, live):
    return types.SimpleNamespace(
        cfg=types.SimpleNamespace(tenant_slot_cap=cap),
        _tenant_slots=lambda: dict(live))


def _req(mod, tenant):
    sp = JSampling() if mod is jengine else TSampling()
    return mod.GenRequest(prompt=[1], max_tokens=1, sampling=sp,
                          tenant=tenant)


@pytest.mark.parametrize("case", ["cap_unit", "deficit_without_cap"])
def test_fair_admission_reference_cases(case):
    """``tests/test_adapters.py``'s two cases, on both engines."""
    if case == "cap_unit":
        cap, live, tenants, free = 2, {"A": 2}, ["A", "A", "B", "C"], 2
        want = (["B", "C"], ["A", "A"], 2)
    else:
        cap, live, tenants, free = 0, {"A": 1}, ["A", "A", "B"], 3
        want = (["B", "A", "A"], [], 0)
    for mod in (jengine, tengine):
        pending = [_req(mod, t) for t in tenants]
        admit, requeue, capped = mod.Engine._fair_admission(
            _fake_engine(cap, live), pending, free)
        assert ([r.tenant for r in admit], [r.tenant for r in requeue],
                capped) == want, mod.__name__


def _quadratic_order(cap, live, pending, free):
    """The scan the heap replaced: each pick is the eligible request
    whose tenant has the fewest live + taken slots, earliest first."""
    taken: dict = {}
    eligible, capped = [], []
    for req in pending:
        t = req.tenant
        if cap > 0 and live.get(t, 0) + taken.get(t, 0) >= cap:
            capped.append(req)
            continue
        taken[t] = taken.get(t, 0) + 1
        eligible.append(req)
    if cap <= 0 and len({r.tenant for r in pending} | set(live)) <= 1:
        return pending[:free], pending[free:], 0
    if len({r.tenant for r in eligible}) > 1:
        counts = dict(live)
        ordered, rest = [], list(eligible)
        while rest:
            i = min(range(len(rest)),
                    key=lambda j: (counts.get(rest[j].tenant, 0), j))
            req = rest.pop(i)
            counts[req.tenant] = counts.get(req.tenant, 0) + 1
            ordered.append(req)
        eligible = ordered
    left = set(map(id, capped)) | set(map(id, eligible[free:]))
    return (eligible[:free], [r for r in pending if id(r) in left],
            len(capped))


def test_fair_admission_heap_order_property():
    """Over random mixes (an anonymous tenant among them), live counts,
    caps and free counts: the port's admit order, requeue order and
    capped count equal the reference's heap and the quadratic scan."""
    rng = random.Random(1905)
    for case in range(300):
        tenants = [f"t{i}" for i in range(rng.randint(1, 6))]
        if rng.random() < 0.3:
            tenants.append("")
        live = {t: rng.randint(0, 3) for t in tenants if rng.random() < 0.6}
        cap = rng.choice((0, 0, 1, 2, 3))
        names = [rng.choice(tenants) for _ in range(rng.randint(0, 30))]
        free = rng.randint(0, len(names) + 2)
        pending = [_req(tengine, t) for t in names]
        got = tengine.Engine._fair_admission(_fake_engine(cap, live),
                                             list(pending), free)
        oracle = _quadratic_order(cap, live, list(pending), free)
        jpending = [_req(jengine, t) for t in names]
        ref = jengine.Engine._fair_admission(_fake_engine(cap, live),
                                             list(jpending), free)
        pos = {id(r): i for i, r in enumerate(pending)}
        jpos = {id(r): i for i, r in enumerate(jpending)}
        for g, o, w in zip(got[:2], oracle[:2], ref[:2]):
            assert [pos[id(r)] for r in g] == [pos[id(r)] for r in o] \
                == [jpos[id(r)] for r in w], case
        assert got[2] == oracle[2] == ref[2], case


# -- fairness: whole engines ------------------------------------------------
ENGINE_CFG = dict(max_batch_size=4, max_seq_len=128, page_size=16,
                  decode_steps_per_tick=4, kv_cache_dtype="float32",
                  attention_backend="pallas-ragged", decode_backend="fused",
                  ragged_chunk_tokens=16, ragged_max_chunks=4)
#: (tenant or adapter, prompt, max_tokens)
BURSTS = {
    # a multi-adapter burst at cap 0: the tenant is the adapter
    "adapters_cap0": (0, True, [
        ("ad0", [10, 20, 30], 6), ("ad0", [11, 21], 9), ("ad0", [12], 5),
        ("ad1", [13, 23, 33], 7), ("", [14, 24], 8), ("ad1", [15], 6),
        ("ad0", [16, 26], 4), ("", [17], 5)]),
    # header tenants at cap 1
    "tenants_cap1": (1, False, [
        ("a", [10, 20, 30], 6), ("a", [11, 21], 9), ("a", [12], 5),
        ("b", [13, 23, 33], 7), ("b", [14, 24], 8), ("c", [15], 6),
        ("", [16, 26], 4), ("", [17], 5)]),
}


def _zoo():
    from aigw_tpu.models import lora as jlora

    j = jlora.init_lora_adapters(jax.random.PRNGKey(7), jllama.TINY,
                                 jlora.LoRAConfig(rank=4, alpha=8.0,
                                                  targets=("wq", "wv")),
                                 2, random_b=True)
    return {f"ad{i}": {k: np.asarray(v[i]) for k, v in j.items()}
            for i in range(2)}


def _admit_trace(eng, mod, sp_cls, burst, adapters):
    """Serve one burst; returns the admission order (each request's
    index in the order of its sequence id), the streams, and at every
    first token the tenant counts and the two tenant stats."""
    n = len(burst)
    streams = [[] for _ in range(n)]
    firsts: list = []
    done = [threading.Event() for _ in range(n)]
    reqs = []
    for i, (who, prompt, m) in enumerate(burst):
        def emit(t, f, i=i):
            if not streams[i]:
                eng._refresh_stats()
                firsts.append((i, dict(eng._tenant_slots()),
                               eng.stats.tenants_active,
                               eng.stats.tenant_max_slots))
            streams[i].append(t if f is None else (t, f))
            if f is not None:
                done[i].set()
        kw = dict(adapter=who, tenant=who) if adapters else dict(tenant=who)
        reqs.append(mod.GenRequest(prompt=list(prompt), max_tokens=m,
                                   sampling=sp_cls(temperature=0.0),
                                   emit=emit, **kw))
    eng.start()
    try:
        for r in reqs:
            eng.submit(r)
        assert all(d.wait(300) for d in done)
        assert eng.healthy, eng.last_error
    finally:
        eng.stop()
    order = sorted(range(n), key=lambda i: reqs[i].id)
    return order, streams, firsts, eng.stats.tenant_deferrals


@pytest.mark.parametrize("name", sorted(BURSTS))
def test_engine_admission_order_matches_reference(weights, name):
    cap, adapters, burst = BURSTS[name]
    cfg = {**ENGINE_CFG, "tenant_slot_cap": cap}
    out = {}
    zoo = _zoo() if adapters else None
    for mod, sp_cls, p, extra in (
            (jengine, JSampling, weights[0], {}),
            (tengine, TSampling, weights[1], {"device": "cpu"})):
        kw = {}
        if adapters:
            st = (jadapters.AdapterStore(n_slots=2) if mod is jengine
                  else tadapters.AdapterStore(n_slots=2, device="cpu"))
            for k, v in zoo.items():
                st.register(k, v)
            kw["adapter_store"] = st
        eng = mod.Engine(p, jllama.TINY if mod is jengine else tllama.TINY,
                         mod.EngineConfig(**cfg), eos_token_ids=EOS,
                         **extra, **kw)
        out[mod.__name__] = _admit_trace(eng, mod, sp_cls, burst, adapters)
    got, want = out[tengine.__name__], out[jengine.__name__]
    assert got[0] == want[0]  # admission order
    assert got[1] == want[1]  # streams
    assert got[2] == want[2]  # tenant counts at every first token
    assert got[3] == want[3]  # deferrals
    if cap == 0:
        assert got[0] != list(range(len(burst)))  # not arrival order
        assert got[3] == 0
    else:
        assert got[3] > 0
        assert all(max(s.values()) <= cap for _i, s, _a, _m in got[2])


# -- /state ---------------------------------------------------------------------
def test_state_tenant_keys_match_reference(weights):
    """The same live slots and deferrals on both servers' engines: the
    five keys equal (the anonymous tenant named as the reference names
    it), the cap carried through."""
    from aigw_tpu.tpuserve import server as jserver

    jsrv = jserver.TPUServeServer(
        MODEL, jengine.EngineConfig(**{**SERVER_CFG, "tenant_slot_cap": 3}))
    srv = _port_server(weights, tenant_slot_cap=3)
    try:
        for eng, mod in ((jsrv.engine, jengine), (srv.engine, tengine)):
            sp = JSampling() if mod is jengine else TSampling()
            for i, t in enumerate(["b", "", "b", "a"]):
                eng._slots[i] = types.SimpleNamespace(req=mod.GenRequest(
                    prompt=[1], max_tokens=1, sampling=sp, tenant=t),
                    adapter_row=eng._base_row, cn=None, generated=1)
            eng.stats.tenant_deferrals = 5
            eng._refresh_stats()
        want = json.loads(asyncio.run(jsrv._state(None)).body)
        got = srv.state()
        assert {k: got[k] for k in TENANT_KEYS} == \
            {k: want[k] for k in TENANT_KEYS} == {
                "tenant_slots": {"(anonymous)": 1, "a": 1, "b": 2},
                "tenants_active": 3, "tenant_max_slots": 2,
                "tenant_deferrals": 5, "tenant_slot_cap": 3}
        assert got["ttft_hist_buckets"] == want["ttft_hist_buckets"]
    finally:
        srv.httpd.server_close()


@pytest.mark.parametrize("seed", [0, 1])
def test_ttft_hist_buckets_match_reference_cumulative(seed):
    rng = np.random.default_rng(seed)
    ms = np.concatenate([rng.exponential(40.0, 200),
                         [0.0, 0.25, 1000.0, 30000.0, 1e6]])
    jh = jmetrics.PhaseHistogram("tpuserve_ttft_hist_ms",
                                 jmetrics.PHASE_BUCKETS_MS)
    th = tmetrics.EnginePhases()
    for v in ms:
        jh.observe(float(v))
        th.observe("ttft", float(v))
    got = th.hists["ttft"].cumulative()
    assert got == jh.cumulative()
    assert list(got)[-1] == "+Inf" and got["+Inf"] == len(ms)


def test_fleetstate_reads_a_port_replicas_polls(weights):
    """A reference FleetState with an SLO monitor polls a port replica's
    /state before and after two requests: the window closes with both
    requests served; at a 0.25 ms SLO it overshoots and the replica is
    marked degraded."""
    from aigw_tpu.gateway.fleetstate import DEGRADED, FleetState
    from aigw_tpu.obs.slomon import SLOMonitor

    srv = _port_server(weights)
    srv.start()
    try:
        fleets = {slo: FleetState(SLOMonitor(slo_ms=slo, window_s=10.0,
                                             k_windows=1))
                  for slo in (60000.0, 0.25)}

        def poll(ts):
            data = json.loads(_http(srv.port, "/state")[1])
            for f in fleets.values():
                f.note_poll("port", True, data, ts=ts)
            return data

        poll(0.0)
        for body in (_chat(max_tokens=3), _text(max_tokens=2)):
            path = CHAT if "messages" in body else TEXT
            assert _http(srv.port, path, body)[0] == 200
        data = poll(11.0)
    finally:
        srv.stop()
    assert data["ttft_hist_buckets"]["+Inf"] == 2
    ok = fleets[60000.0].slomon.snapshot("port")
    assert ok["windows"][-1]["served"] == 2 and ok["goodput"] == 1.0
    bad = fleets[0.25].slomon.snapshot("port")
    assert bad["goodput"] == 0.0 and bad["sustained_overshoot"]
    assert fleets[0.25].health_of("port") == DEGRADED


# -- the reference gateway in front of a port replica -------------------------
def test_gateway_relays_tenant_logprobs_and_n(weights):
    from aigw_tpu.config.model import Config
    from aigw_tpu.config.runtime import RuntimeConfig
    from aigw_tpu.gateway.server import run_gateway

    srv = _port_server(weights)
    tenants = []
    submit = srv.engine.submit

    def recording(req):
        tenants.append(req.tenant)
        submit(req)

    srv.engine.submit = recording
    srv.start()
    addr = f"127.0.0.1:{srv.port}"

    async def main():
        cfg = Config.parse({
            "version": "v1",
            "backends": [{"name": "pool", "schema": "TPUServe",
                          "endpoints": [addr]}],
            "routes": [{"name": "r", "rules": [
                {"models": [MODEL], "backends": ["pool"]}]}],
            "models": [MODEL],
        })
        server, runner = await run_gateway(RuntimeConfig.build(cfg), port=0)
        port = list(runner.sites)[0]._server.sockets[0].getsockname()[1]
        url = f"http://127.0.0.1:{port}/v1/chat/completions"
        try:
            async with aiohttp.ClientSession() as s:
                async with s.post(url, json=_chat(
                        logprobs=True, top_logprobs=2),
                        headers={"x-aigw-tenant": "acme"}) as r:
                    lp = (r.status, await r.json())
                async with s.post(url, json=_chat(n=2)) as r:
                    two = (r.status, await r.json())
            return lp, two
        finally:
            await runner.cleanup()

    try:
        (s1, lp), (s2, two) = asyncio.run(main())
    finally:
        srv.stop()
    assert s1 == 200 and s2 == 200, (lp, two)
    entries = lp["choices"][0]["logprobs"]["content"]
    assert len(entries) == lp["usage"]["completion_tokens"]
    assert all(len(e["top_logprobs"]) == 2 for e in entries)
    assert [c["index"] for c in two["choices"]] == [0, 1]
    assert tenants[0] == "acme" and tenants[1:] == ["", ""]


def test_schema_chunks_carry_index_and_logprobs():
    sse = toai.stream_chunk_sse(response_id="r", model="m", created=1,
                                delta={"content": "x"}, index=2,
                                logprobs={"content": []})
    ch = json.loads(sse.decode()[6:])["choices"][0]
    assert ch["index"] == 2 and ch["logprobs"] == {"content": []}
    ev = json.loads(toai.completion_chunk_sse(
        response_id="r", model="m", created=1, text=None,
        usage=toai.TokenUsage(1, 2, 3)).decode()[6:])
    assert ev["choices"] == [] and ev["usage"]["total_tokens"] == 3
