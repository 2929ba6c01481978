"""Grammar-constrained serving: the port's engine and server against the
JAX package's, and the reference gateway in front of a port replica.

- Engine: the reference ``Engine`` and the port's, on the reference's
  ``init_params(PRNGKey(0), TINY, float32)`` weights (carried across by
  ``models/convert.py``), float32 pools, serve one mixed batch (more
  requests than slots): ``json_object``, ``json_schema`` (one with
  ``logit_bias`` composed into the mask), required and named tool calls,
  and unconstrained requests, greedy and seeded. On the fused rung, on
  the chained rung speculating at width 4, and with the prefix cache
  resuming every request behind a warm-up's pages. Streams are
  identical, and so are the constraint and speculation counters; the
  unconstrained streams equal the same requests served alone.
- Server: the same bodies to the reference server (aiohttp, its weights
  in float32) and to the port's (the same weights), one at a time.
  Non-streamed replies are equal apart from ids and ``created``;
  streamed deltas reassemble to equal replies with tool-call deltas of
  the same shape (chunk boundaries follow the engine's timing in both);
  the reference's ``test_clear_400s`` cases and the knob-off replica's
  refusal give 400s with equal messages; ``/v1/models`` ``capabilities``
  and ``/state``'s constraint keys are equal.
- Gateway: the reference gateway relays a port replica's streamed tool
  call (the reference's ``tests/test_constrained_serving.py`` gateway
  case) and merges its polled capability flags into ``/v1/models``.
"""

import asyncio
import json
import threading
import time
import urllib.error
import urllib.request

import aiohttp
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aigw_tpu.models import llama as jllama
from aigw_tpu.tpuserve import constrain as jc
from aigw_tpu.tpuserve import engine as jengine
from aigw_tpu.tpuserve.sampling import SamplingParams as JSampling
from aigw_tpu.tpuserve.tokenizer import ByteTokenizer as JTok
from aigw_tpu_torch.models import convert
from aigw_tpu_torch.models import llama as tllama
from aigw_tpu_torch.tpuserve import constrain as tc
from aigw_tpu_torch.tpuserve import engine as tengine
from aigw_tpu_torch.tpuserve.sampling import SamplingParams as TSampling
from aigw_tpu_torch.tpuserve.tokenizer import ByteTokenizer as TTok

EOS = (257,)
V = jllama.TINY.vocab_size
MODEL = "tiny-random"
SCHEMA = {"type": "object", "properties": {
    "t": {"type": "string", "maxLength": 12},
    "n": {"type": "integer"},
    "k": {"enum": ["cat", "dog", "bird"]}},
    "required": ["t", "n", "k"], "additionalProperties": False}
TOOLS = [
    {"type": "function", "function": {
        "name": "get_weather", "parameters": {
            "type": "object", "properties": {
                "city": {"type": "string", "maxLength": 6}},
            "required": ["city"], "additionalProperties": False}}},
    {"type": "function", "function": {"name": "get_time"}},
]
CFG = dict(max_batch_size=4, max_seq_len=128, page_size=16,
           decode_steps_per_tick=4, kv_cache_dtype="float32",
           attention_backend="pallas-ragged", ragged_chunk_tokens=16,
           ragged_max_chunks=2)
RUNGS = {
    "fused": dict(decode_backend="fused", enable_prefix_cache=False),
    "chained_spec": dict(decode_backend="auto", pallas_attn=True,
                         spec_tokens=4, spec_adaptive=False,
                         enable_prefix_cache=False),
    "prefix_hit": dict(decode_backend="fused", enable_prefix_cache=True),
}
#: (constraint, max_tokens, sampling kwargs); constraint None = plain
BATCH = [
    ("json_object", 40, dict(temperature=0.0)),
    ("json_schema", 60, dict(temperature=0.0, logit_bias=((98, 4.0),))),
    ("required", 60, dict(temperature=0.8, seed=3)),
    (None, 30, dict(temperature=0.0)),
    ("named", 60, dict(temperature=0.0)),
    ("json_schema", 60, dict(temperature=0.7, seed=11)),
    (None, 30, dict(temperature=0.9, top_p=0.9, seed=5)),
    ("json_schema", 40, dict(temperature=0.0)),
]
#: the warm-up prompt of the prefix-hit rung (41 tokens): every batch
#: prompt starts with its first two 16-token pages
SHARED = np.random.default_rng(7).integers(0, 256, 40).tolist()


def _spec(mod, kind):
    if kind == "json_object":
        return mod.spec_for_response_format("json_object", None)
    if kind == "json_schema":
        return mod.spec_for_response_format("json_schema", SCHEMA)
    tools = mod.parse_tools(TOOLS)
    return mod.spec_for_tools(tools if kind == "required" else tools[1:])


def _prompts(shared: bool):
    """The batch's prompts; with ``shared``, each behind SHARED's first
    two pages, and the last one exactly those pages (a full hit: its
    last page copied on write, one row resumed)."""
    rng = np.random.default_rng(123)
    out = [(SHARED if shared else []) + rng.integers(0, 256, n).tolist()
           for n in (3, 17, 9, 30, 5, 12, 21, 8)]
    if shared:
        out[-1] = SHARED[:32]
    return out


def _serve(eng, req_cls, sp_cls, mod, tok, items, warm=None):
    """Serve ``items`` ((prompt, kind, max_tokens, sampling kwargs)) on
    ``eng``; with ``warm``, that prompt first, alone."""
    def run(batch):
        """Submit ``batch`` in one burst (built first, so the engine's
        admission coalescing sees all of it)."""
        out = [[] for _ in batch]
        done = [threading.Event() for _ in batch]
        reqs = []
        for i, (prompt, kind, max_tokens, kw) in enumerate(batch):
            def emit(t, f, i=i):
                if t >= 0:
                    out[i].append(t)
                if f is not None:
                    out[i].append(f)
                    done[i].set()
            cn = (mod.compile_constraint(tok, V, EOS, _spec(mod, kind))
                  if kind else None)
            reqs.append(req_cls(prompt=prompt, max_tokens=max_tokens,
                                sampling=sp_cls(**kw), emit=emit,
                                constraint=cn))
        for r in reqs:
            eng.submit(r)
        return out, done

    if warm is not None:
        eng.start()
        _, done = run([(warm, "json_schema", 8, dict(temperature=0.0))])
        assert done[0].wait(300)
        # the batch arrives at a quiesced engine, as it would before start
        deadline = time.monotonic() + 60
        while (eng._inflight is not None or eng._device_state is not None
               or not eng._queue.empty()) and time.monotonic() < deadline:
            time.sleep(0.01)
    try:
        out, done = run(items)
        if warm is None:
            eng.start()
        assert all(d.wait(300) for d in done), "a stream did not finish"
        assert eng.healthy, eng.last_error
    finally:
        eng.stop()
    return out


@pytest.fixture(scope="module")
def weights():
    p = jllama.init_params(jax.random.PRNGKey(0), jllama.TINY,
                           dtype=jnp.float32)
    return p, convert.params_from_numpy(
        {k: np.asarray(v) for k, v in p.items()}, device="cpu")


COUNTERS = ("constraint_requests", "constraint_rollbacks",
            "constraint_mask_updates", "spec_accepted", "spec_drafted",
            "prefix_cache_hits", "prefix_tokens_reused", "decode_steps")


def _both(weights, rung, items, warm=None):
    jp, tp = weights
    jeng = jengine.Engine(jp, jllama.TINY, jengine.EngineConfig(
        **CFG, **RUNGS[rung]), eos_token_ids=EOS)
    want = _serve(jeng, jengine.GenRequest, JSampling, jc, JTok(), items,
                  warm)
    teng = tengine.Engine(tp, tllama.TINY, tengine.EngineConfig(
        **CFG, **RUNGS[rung]), eos_token_ids=EOS, device="cpu")
    got = _serve(teng, tengine.GenRequest, TSampling, tc, TTok(), items,
                 warm)
    return got, want, teng.stats, jeng.stats


@pytest.mark.parametrize("rung", sorted(RUNGS))
def test_engine_streams_and_counters_match_reference(weights, rung):
    shared = rung == "prefix_hit"
    items = [(p, kind, n, kw)
             for p, (kind, n, kw) in zip(_prompts(shared), BATCH)]
    got, want, ts, js = _both(weights, rung, items,
                              SHARED + [1] if shared else None)
    assert got == want
    for key in COUNTERS:
        assert getattr(ts, key) == getattr(js, key), key
    assert ts.constraint_requests == 6 + shared
    assert ts.constraint_rollbacks > 0
    if rung == "chained_spec":
        assert ts.spec_accepted > 0
    if shared:
        assert ts.prefix_cache_hits == len(items)
        assert ts.prefix_full_hits == js.prefix_full_hits == 1
    # every constrained reply is valid JSON of its grammar, or its prefix
    for (_p, kind, n, _kw), s in zip(items, got):
        text = TTok().decode([t for t in s if isinstance(t, int)])
        if kind and s[-1] == "stop":
            obj = json.loads(text)
            if kind == "json_schema":
                assert tc.validate_instance(SCHEMA, obj), text
            elif kind in ("required", "named"):
                assert set(obj) == {"name", "arguments"}, text
    # unconstrained streams equal the same requests served alone
    plain = [it for it in items if it[1] is None]
    _, tp = weights
    alone = _serve(tengine.Engine(tp, tllama.TINY, tengine.EngineConfig(
        **CFG, **RUNGS[rung]), eos_token_ids=EOS, device="cpu"),
        tengine.GenRequest, TSampling, tc, TTok(), plain,
        SHARED + [1] if shared else None)
    assert alone == [s for it, s in zip(items, got) if it[1] is None]


# -- the servers ---------------------------------------------------------------
SERVER_CFG = dict(max_batch_size=4, max_seq_len=256, page_size=16,
                  decode_steps_per_tick=4, kv_cache_dtype="float32",
                  attention_backend="pallas-ragged")


def _base(**over):
    body = {"model": MODEL, "max_tokens": 60, "temperature": 0.0,
            "logit_bias": {"97": 100},
            "messages": [{"role": "user", "content": "hi"}]}
    body.update(over)
    return body


RF = {"type": "json_schema", "json_schema": {"name": "x", "schema": SCHEMA}}
BODIES = [
    _base(response_format=RF),
    _base(response_format=RF, stream=True),
    _base(response_format={"type": "json_object"},
          logit_bias={"125": 100}),
    _base(response_format=RF, temperature=0.8, seed=4, logit_bias={}),
    _base(tools=TOOLS, tool_choice="required"),
    _base(tools=TOOLS, tool_choice="required", stream=True),
    _base(tools=TOOLS, tool_choice={"type": "function",
                                    "function": {"name": "get_weather"}},
          stream=True),
    _base(tools=TOOLS, tool_choice="auto", stream=True),
    _base(tools=TOOLS, tool_choice="auto", max_tokens=12, logit_bias={}),
    _base(tools=TOOLS, tool_choice="none", max_tokens=8),
    _base(max_tokens=10, logit_bias={}),
]
#: the reference's test_clear_400s cases, and more of its refusals
BAD = [
    ("/v1/chat/completions",
     _base(response_format={"type": "json_schema",
                            "json_schema": {"name": "x"}})),
    ("/v1/chat/completions",
     _base(response_format={"type": "json_schema", "json_schema": {
         "name": "x", "schema": {"type": "string", "pattern": "a+"}}})),
    ("/v1/chat/completions",
     _base(tools=[{"type": "google_search"}], tool_choice="required")),
    ("/v1/chat/completions",
     _base(tools=TOOLS, tool_choice={"type": "function",
                                     "function": {"name": "nope"}})),
    ("/v1/chat/completions", _base(tools=TOOLS, tool_choice="required",
                                   n=2)),
    ("/v1/chat/completions",
     _base(tools=TOOLS, tool_choice="required",
           response_format={"type": "json_object"})),
    ("/v1/chat/completions", _base(response_format={"type": "xml"})),
    ("/v1/chat/completions",
     _base(response_format={"type": "json_schema", "json_schema": {
         "name": "x", "schema": {"type": "object", "properties": {
             "a": {"type": "string"}}, "required": ["zz"]}}})),
    ("/v1/completions", {"model": MODEL, "prompt": "x", "max_tokens": 4,
                         "response_format": {"type": "json_object"}}),
]
STATE_KEYS = ("constrained_decoding", "capabilities", "constrained_slots",
              "constraint_requests", "constraint_rollbacks",
              "constraint_mask_updates")


def _http(port, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"content-type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _reply(raw: str, stream: bool) -> dict:
    """A reply without its ids and ``created``: the message (tool call
    ids checked and dropped) and finish; for a stream, its deltas
    reassembled, plus the shape of its tool-call deltas."""
    if not stream:
        body = json.loads(raw)
        ch = body["choices"][0]
        msg = dict(ch["message"])
        for call in msg.get("tool_calls") or []:
            assert call.pop("id").startswith("call_")
        # the reference's usage also carries its meter record (usage
        # metering is not ported)
        usage = {k: v for k, v in body["usage"].items() if k != "aigw_meter"}
        return {"message": msg, "finish": ch["finish_reason"],
                "usage": usage}
    frames = [json.loads(ln[6:]) for ln in raw.split("\n")
              if ln.startswith("data: ") and ln[6:] != "[DONE]"]
    content, name, args, shape, fin = "", None, "", [], None
    for f in frames:
        for ch in f["choices"]:
            d = ch["delta"]
            content += d.get("content") or ""
            for t in d.get("tool_calls") or []:
                if "id" in t:
                    assert len(t["id"]) == 29 and t["type"] == "function"
                    name = t["function"]["name"]
                    kind = "name"
                else:
                    kind = "args"
                if not shape or shape[-1] != kind:
                    shape.append(kind)
                args += t["function"].get("arguments") or ""
            fin = ch["finish_reason"] or fin
    return {"content": content, "tool": name, "args": args,
            "tool_delta_shape": shape, "finish": fin}


def _drive(port) -> dict:
    out = {"replies": [_reply(_http(port, "/v1/chat/completions", b)[1],
                              b.get("stream", False)) for b in BODIES]}
    out["bad"] = []
    for path, body in BAD:
        status, raw = _http(port, path, body)
        out["bad"].append((status, json.loads(raw)["error"]["message"]))
    time.sleep(0.5)  # the last request's slot is freed after its reply
    state = json.loads(_http(port, "/state")[1])
    out["state"] = {k: state[k] for k in STATE_KEYS}
    out["grammars"] = state["constraint_grammars"]
    out["models"] = json.loads(_http(port, "/v1/models")[1])["data"][0][
        "capabilities"]
    return out


@pytest.fixture(scope="module")
def reference_server_run():
    """The reference server in a thread, on its tiny-random weights in
    float32, driven with BODIES and BAD one at a time; also its knob-off
    refusal text."""
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
    try:
        out = _drive(holder["port"])
        srv = holder["server"]
        srv.engine.cfg.constrained_decoding = False
        try:
            srv._check_constraints(BODIES[0], True, -1, 1)
        except Exception as e:  # noqa: BLE001 — its message is compared
            out["knob_off"] = str(e)
        return out
    finally:
        holder["loop"].call_soon_threadsafe(holder["stop"].set)
        t.join(timeout=60)


def _port_server(weights, **over):
    from aigw_tpu_torch.tpuserve.server import TPUServeServer

    srv = TPUServeServer(MODEL, tengine.EngineConfig(**SERVER_CFG, **over),
                         device="cpu", port=0, param_dtype="float32")
    srv.engine = tengine.Engine(weights[1], tllama.TINY, srv.engine.cfg,
                                eos_token_ids=EOS, fns=srv.fns, device="cpu")
    return srv


def test_server_replies_match_reference(weights, reference_server_run):
    srv = _port_server(weights)
    srv.start()
    try:
        got = _drive(srv.port)
    finally:
        srv.stop()
    want = reference_server_run
    for i, (g, w) in enumerate(zip(got["replies"], want["replies"])):
        assert g == w, (i, BODIES[i])
    assert got["bad"] == want["bad"]
    assert all(status == 400 for status, _ in got["bad"])
    assert got["state"] == want["state"]
    assert got["models"] == want["models"] == tc.CAPABILITIES
    assert got["grammars"] >= 3 and want["grammars"] >= 3
    replies = got["replies"]
    assert replies[4]["finish"] == "tool_calls"
    assert replies[5]["tool_delta_shape"] == ["name", "args"]
    assert replies[1]["content"] == replies[0]["message"]["content"]
    assert got["state"]["constraint_rollbacks"] > 0


def test_knob_off_replica_refuses_with_reference_text(weights,
                                                      reference_server_run):
    srv = _port_server(weights, constrained_decoding=False)
    srv.start()
    try:
        status, raw = _http(srv.port, "/v1/chat/completions", BODIES[0])
        state = json.loads(_http(srv.port, "/state")[1])
        models = json.loads(_http(srv.port, "/v1/models")[1])["data"][0]
    finally:
        srv.stop()
    assert status == 400
    assert json.loads(raw)["error"]["message"] == \
        reference_server_run["knob_off"]
    assert state["constrained_decoding"] is False
    assert state["capabilities"] == {} and "capabilities" not in models


@pytest.mark.parametrize("argv,want", [([], True),
                                       (["--no-constrained-decoding"],
                                        False)])
def test_cli_constrained_decoding_flag(argv, want):
    from aigw_tpu_torch.cli import build_parser, engine_config

    args = build_parser().parse_args(
        ["tpuserve", "--model", MODEL, "--device", "cpu", *argv])
    assert engine_config(args).constrained_decoding is want


# -- the reference gateway in front of a port replica --------------------------
async def _read_stream(resp):
    """→ (content, tool name, tool args, finish, events), as the
    reference's gateway test reads a stream."""
    content, name, args, fin, events = "", None, "", None, []
    async for line in resp.content:
        line = line.strip()
        if not line.startswith(b"data: "):
            continue
        d = line[6:]
        if d == b"[DONE]":
            break
        ev = json.loads(d)
        events.append(ev)
        for ch in ev.get("choices") or []:
            delta = ch.get("delta") or {}
            content += delta.get("content") or ""
            for t in delta.get("tool_calls") or []:
                fn = t.get("function") or {}
                if fn.get("name"):
                    name = fn["name"]
                args += fn.get("arguments") or ""
            if ch.get("finish_reason"):
                fin = ch["finish_reason"]
    return content, name, args, fin, events


def test_gateway_relays_port_tool_call_and_capabilities(weights):
    from aigw_tpu.config.model import Config
    from aigw_tpu.config.runtime import RuntimeConfig
    from aigw_tpu.gateway.server import run_gateway

    srv = _port_server(weights)
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
        url = f"http://127.0.0.1:{port}"
        try:
            picker = server._pickers["pool"]
            for _ in range(200):  # the picker's first /state poll
                st = picker.state.get(addr)
                if st is not None and st.capabilities:
                    break
                await asyncio.sleep(0.05)
            async with aiohttp.ClientSession() as s:
                async with s.post(url + "/v1/chat/completions", json=_base(
                        tools=TOOLS[:1], stream=True,
                        tool_choice={"type": "function",
                                     "function": {"name": "get_weather"}},
                )) as r:
                    assert r.status == 200, await r.text()
                    streamed = await _read_stream(r)
                async with s.get(url + "/v1/models") as r:
                    assert r.status == 200
                    models = await r.json()
            return streamed, models
        finally:
            await runner.cleanup()

    try:
        (content, name, args, fin, events), models = asyncio.run(main())
    finally:
        srv.stop()
    assert not any("error" in ev for ev in events), events
    assert name == "get_weather" and fin == "tool_calls"
    assert jc.validate_instance(TOOLS[0]["function"]["parameters"],
                                json.loads(args))
    entry = next(m for m in models["data"] if m["id"] == MODEL)
    assert entry.get("capabilities") == tc.CAPABILITIES
