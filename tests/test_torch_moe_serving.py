"""The mixtral family served: the port's engine and server against the
JAX package's on tiny-moe.

- Engine: the reference ``Engine`` and the port's, on the reference's
  ``init_params(PRNGKey(7), TINY_MOE, float32)`` weights (carried across
  by ``models/convert.py``), both on the ragged prefill backend, serve
  the reference's
  full-mix burst (``tests/test_moe_serving.py::_full_mix``: a speculating
  greedy slot, a penalized slot, a grammar-constrained slot and a
  page-aligned prompt resumed from the prefix cache as a full hit) behind
  a warm-up that caches the resumed prompt's pages. On the fused rung, on
  the chained rung, over an int8 pool, and with a capacity factor that
  drops assignments. Streams are identical, and so are the routing totals
  (per expert, per layer, and the four ``/state`` scalars) and the
  serving counters.

  The reference runs its Pallas kernels in interpret mode, as its own
  parity tests do (``AIGW_RAGGED_PREFILL_IMPL`` and
  ``AIGW_DECODE_FUSED_IMPL`` set to ``pallas``; the port's plain
  versions are those kernels'). Its CPU defaults, the windowed prefill
  and the XLA fused decode, give the rows that attend nothing (padding
  rows, idle slots) other attention outputs: no token sees them, but
  the router routes every row, and the counters count them.
- Server: the reference server (aiohttp, its weights in float32) and the
  port's replica serve the same requests one at a time; ``/state``'s
  ``moe_*`` keys are equal, on tiny-moe and (zero or ``[]``) on
  tiny-random. The reference picker polls a port replica's ``/state``
  and prices its expert imbalance. ``python -m aigw_tpu_torch tpuserve
  --model tiny-moe --device cpu`` serves.
"""

import asyncio
import dataclasses
import json
import subprocess
import sys
import threading
import time
import urllib.request

import aiohttp
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aigw_tpu.models import mixtral as jmixtral
from aigw_tpu.models.registry import family_fns as jfamily_fns
from aigw_tpu.tpuserve import constrain as jc
from aigw_tpu.tpuserve import engine as jengine
from aigw_tpu.tpuserve.sampling import SamplingParams as JSampling
from aigw_tpu.tpuserve.tokenizer import ByteTokenizer as JTok
from aigw_tpu_torch.models import convert
from aigw_tpu_torch.models import mixtral as tmixtral
from aigw_tpu_torch.models.registry import family_fns as tfamily_fns
from aigw_tpu_torch.tpuserve import constrain as tc
from aigw_tpu_torch.tpuserve import engine as tengine
from aigw_tpu_torch.tpuserve.sampling import SamplingParams as TSampling
from aigw_tpu_torch.tpuserve.tokenizer import ByteTokenizer as TTok

EOS = (257,)
CFG = dict(max_batch_size=4, max_seq_len=256, page_size=16,
           decode_steps_per_tick=4, kv_cache_dtype="float32",
           attention_backend="pallas-ragged", ragged_chunk_tokens=32,
           ragged_max_chunks=4, adaptive_decode_window=False,
           spec_tokens=3, spec_adaptive=False)
RUNGS = {
    "fused": dict(decode_backend="fused"),
    "chained": dict(decode_backend="auto", pallas_attn=True),
    "int8_pool": dict(decode_backend="fused", kv_cache_dtype="int8"),
    "binding": dict(decode_backend="fused"),
}
SCHEMA = {"type": "object", "properties": {
    "t": {"type": "string", "maxLength": 8},
}, "required": ["t"], "additionalProperties": False}
#: 64 tokens = 4 full pages: served alone first, then re-asked in the
#: burst (a full hit: the last page copied on write, one row resumed)
BASE = [5, 3, 8, 1, 9, 2, 4, 6] * 8
#: (prompt, sampling kwargs, constrained) of the reference's _full_mix
MIX = [
    ([5, 6, 7, 8] * 10, dict(temperature=0.0), False),
    ([2, 9, 4, 4, 1, 7, 3], dict(temperature=0.0, frequency_penalty=0.6,
                                 presence_penalty=0.2), False),
    (list(b"json now"), dict(temperature=0.0, logit_bias=((97, 100.0),)),
     True),
    (BASE, dict(temperature=0.0), False),
]
COUNTERS = ("decode_steps", "prefills", "spec_accepted", "spec_drafted",
            "prefix_cache_hits", "prefix_full_hits", "prefix_tokens_reused",
            "constraint_requests", "constraint_rollbacks",
            "prefill_tokens_padded", "tokens_generated", "state_rebuilds",
            "moe_tokens_routed", "moe_tokens_dropped", "moe_dropped_frac",
            "moe_expert_imbalance")


def _cfgs(rung):
    cf = 0.5 if rung == "binding" else 2.0
    j = dataclasses.replace(jmixtral.TINY_MOE, capacity_factor=cf)
    return j, tmixtral.MixtralConfig(**dataclasses.asdict(j))


@pytest.fixture(autouse=True)
def _reference_kernels(monkeypatch):
    monkeypatch.setenv("AIGW_RAGGED_PREFILL_IMPL", "pallas")
    monkeypatch.setenv("AIGW_DECODE_FUSED_IMPL", "pallas")


@pytest.fixture(scope="module")
def weights():
    p = jmixtral.init_params(jax.random.PRNGKey(7), jmixtral.TINY_MOE,
                             jnp.float32)
    return p, convert.params_from_numpy(
        {k: np.asarray(v) for k, v in p.items()}, device="cpu")


def _serve(eng, req_cls, sp_cls, mod, tok, vocab, n=10):
    """BASE alone (its pages cached), then MIX as one burst on the
    quiesced engine; returns the burst's streams (tokens, then the
    finish reason)."""
    def run(batch):
        out = [[] for _ in batch]
        done = [threading.Event() for _ in batch]
        reqs = []
        for i, (prompt, kw, constrained) in enumerate(batch):
            def emit(t, f, i=i):
                if t >= 0:
                    out[i].append(t)
                if f is not None:
                    out[i].append(f)
                    done[i].set()
            cn = (mod.compile_constraint(
                tok, vocab, EOS,
                mod.spec_for_response_format("json_schema", SCHEMA))
                if constrained else None)
            reqs.append(req_cls(prompt=list(prompt), max_tokens=n,
                                sampling=sp_cls(**kw), emit=emit,
                                constraint=cn))
        for r in reqs:
            eng.submit(r)
        assert all(d.wait(300) for d in done), "a stream did not finish"
        return out

    eng.start()
    try:
        run([(BASE, dict(temperature=0.0), False)])
        deadline = time.monotonic() + 60
        while (eng._inflight is not None or eng._device_state is not None
               or not eng._queue.empty()) and time.monotonic() < deadline:
            time.sleep(0.01)
        out = run(MIX)
        assert eng.healthy, eng.last_error
    finally:
        eng.stop()
    eng._refresh_stats()
    return out


@pytest.mark.parametrize("rung", sorted(RUNGS))
def test_full_mix_streams_and_routing_match_reference(weights, rung):
    jp, tp = weights
    jcfg, tcfg = _cfgs(rung)
    over = {**CFG, **RUNGS[rung]}
    jeng = jengine.Engine(jp, jcfg, jengine.EngineConfig(**over),
                          eos_token_ids=EOS, fns=jfamily_fns("mixtral"))
    want = _serve(jeng, jengine.GenRequest, JSampling, jc, JTok(),
                  jcfg.vocab_size)
    teng = tengine.Engine(tp, tcfg, tengine.EngineConfig(**over),
                          eos_token_ids=EOS, fns=tfamily_fns("mixtral"),
                          device="cpu")
    got = _serve(teng, tengine.GenRequest, TSampling, tc, TTok(),
                 tcfg.vocab_size)
    assert got == want
    assert teng.moe_expert_load() == jeng.moe_expert_load()
    assert teng.moe_layer_drops() == jeng.moe_layer_drops()
    for key in COUNTERS:
        assert getattr(teng.stats, key) == getattr(jeng.stats, key), key
    assert len(teng.moe_expert_load()) == tcfg.n_experts
    assert teng.stats.moe_tokens_routed > 0
    # every row of every call is counted: the totals are whole multiples
    # of layers x k
    total = teng.stats.moe_tokens_routed + teng.stats.moe_tokens_dropped
    assert total % (tcfg.n_layers * tcfg.experts_per_token) == 0
    assert teng.stats.prefix_full_hits == 1
    assert teng.stats.spec_accepted > 0
    assert teng.stats.constraint_requests == 1
    if rung == "binding":
        assert teng.stats.moe_tokens_dropped > 0
        assert teng.stats.moe_dropped_frac > 0
    elif rung == "int8_pool":
        assert teng.kv_cache["q"].dtype == torch.int8


def test_dense_engine_has_no_routing_stats():
    from aigw_tpu_torch.models import llama as tllama

    eng = tengine.Engine(tllama.init_params(0, tllama.TINY, device="cpu"),
                         tllama.TINY, tengine.EngineConfig(**CFG),
                         eos_token_ids=EOS, device="cpu")
    assert not eng._moe
    assert eng.moe_expert_load() == [] and eng.moe_layer_drops() == []
    eng._fold_moe(None)  # a dense call's leaf is None: a no-op


# -- the servers -------------------------------------------------------------
#: the fused rung on both sides: the reference's ``auto`` takes its gather
#: rung, which the port does not have
SERVER_CFG = dict(max_batch_size=4, max_seq_len=256, page_size=16,
                  decode_steps_per_tick=4, kv_cache_dtype="float32",
                  attention_backend="pallas-ragged", decode_backend="fused")
MOE_KEYS = ("moe_tokens_routed", "moe_tokens_dropped", "moe_dropped_frac",
            "moe_expert_imbalance", "moe_expert_load", "moe_layer_drops")
BODIES = [
    ("/v1/chat/completions", {"messages": [{"role": "user",
                                            "content": "hello there"}],
                              "max_tokens": 12, "temperature": 0.0}),
    ("/v1/completions", {"prompt": "abcabcabc", "max_tokens": 9,
                         "temperature": 0.0, "stream": True}),
    ("/v1/completions", {"prompt": "x" * 40, "max_tokens": 6,
                         "temperature": 0.7, "seed": 3}),
]


def _http(port, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, r.read().decode()


def _drive(port, model) -> dict:
    """BODIES one at a time, then /state's moe_* keys."""
    for path, body in BODIES:
        status, _ = _http(port, path, dict(body, model=model))
        assert status == 200
    time.sleep(0.5)  # the last request's window settles after its reply
    state = json.loads(_http(port, "/state")[1])
    return {k: state[k] for k in MOE_KEYS}


def _reference_run(model, params_fn):
    """The reference server on ``params_fn(cfg)`` weights, driven with
    BODIES."""
    from aiohttp import web

    from aigw_tpu.tpuserve import server as jserver

    class F32Server(jserver.TPUServeServer):
        def _load_params(self, spec):
            return params_fn(self.model_cfg)

    holder = {}
    started = threading.Event()

    def run():
        async def main():
            server = F32Server(model, jengine.EngineConfig(**SERVER_CFG))
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
        return _drive(holder["port"], model)
    finally:
        holder["loop"].call_soon_threadsafe(holder["stop"].set)
        t.join(timeout=60)


def _port_server(model, params=None, cfg=None):
    from aigw_tpu_torch.tpuserve.server import TPUServeServer

    srv = TPUServeServer(model, tengine.EngineConfig(**SERVER_CFG),
                         device="cpu", port=0, param_dtype="float32")
    if params is not None:
        srv.engine = tengine.Engine(params, cfg, srv.engine.cfg,
                                    eos_token_ids=EOS, fns=srv.fns,
                                    device="cpu")
    return srv


def test_server_moe_state_matches_reference(weights):
    want = _reference_run("tiny-moe", lambda cfg: jmixtral.init_params(
        jax.random.PRNGKey(7), cfg, jnp.float32))
    srv = _port_server("tiny-moe", weights[1], tmixtral.TINY_MOE)
    srv.start()
    try:
        got = _drive(srv.port, "tiny-moe")
    finally:
        srv.stop()
    assert got == want
    assert got["moe_tokens_routed"] > 0
    assert len(got["moe_expert_load"]) == tmixtral.TINY_MOE.n_experts
    assert len(got["moe_layer_drops"]) == tmixtral.TINY_MOE.n_layers


def test_dense_server_moe_state_is_zero_like_reference():
    from aigw_tpu.models import llama as jllama

    want = _reference_run("tiny-random", lambda cfg: jllama.init_params(
        jax.random.PRNGKey(0), cfg, jnp.float32))
    srv = _port_server("tiny-random")
    srv.start()
    try:
        got = _drive(srv.port, "tiny-random")
    finally:
        srv.stop()
    assert got == want == {
        "moe_tokens_routed": 0, "moe_tokens_dropped": 0,
        "moe_dropped_frac": 0.0, "moe_expert_imbalance": 0.0,
        "moe_expert_load": [], "moe_layer_drops": []}


def test_reference_picker_prices_a_port_moe_replica(weights):
    """The reference picker polls a port tiny-moe replica whose router
    is skewed and, at equal load, routes to a balanced replica."""
    from aigw_tpu.gateway.picker import Endpoint, EndpointPicker

    srv = _port_server("tiny-moe", weights[1], tmixtral.TINY_MOE)
    srv.start()
    try:
        state = _drive(srv.port, "tiny-moe")
        addr = f"127.0.0.1:{srv.port}"
        picker = EndpointPicker([Endpoint(addr), Endpoint("b:1")])

        async def poll():
            # polled until the replica reads healthy: on a loaded host
            # one poll can time out and leave the state stale
            deadline = time.monotonic() + 60
            async with aiohttp.ClientSession(
                    timeout=aiohttp.ClientTimeout(total=10.0)) as session:
                while True:
                    await picker._poll_one(session, picker.endpoints[0])
                    if picker.state[addr].healthy \
                            or time.monotonic() > deadline:
                        return
                    await asyncio.sleep(0.2)

        asyncio.run(poll())
    finally:
        srv.stop()
    st = picker.state[addr]
    assert st.healthy
    assert st.moe_expert_imbalance == state["moe_expert_imbalance"] > 1.0
    # b:1 carries the polled replica's own load (its queue wait, slots
    # and memory follow the host's timing), so only the router differs
    load = dict(queued=st.queued, active_slots=st.active_slots,
                max_slots=st.max_slots, queue_wait_ms=st.queue_wait_ms,
                hbm_frac=st.hbm_frac, hbm_frac_worst=st.hbm_frac_worst,
                devices=st.devices)
    picker.observe("b:1", kv_occupancy=st.kv_occupancy, **load)
    assert picker.pick() == "b:1"
    # the same replica with a balanced router wins the tie back
    st.moe_expert_imbalance = 1.0
    picker.observe("b:1", kv_occupancy=st.kv_occupancy + 0.01, **load)
    assert picker.pick() == addr


def test_cli_serves_tiny_moe_on_cpu():
    proc = subprocess.Popen(
        [sys.executable, "-m", "aigw_tpu_torch", "tpuserve", "--model",
         "tiny-moe", "--device", "cpu", "--port", "0", "--max-seq-len",
         "256", "--page-size", "16"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("listening on http://"), line
        port = int(line.rsplit(":", 1)[1])
        status, raw = _http(port, "/v1/completions", {
            "model": "tiny-moe", "prompt": "hi", "max_tokens": 4})
        assert status == 200
        assert json.loads(raw)["usage"]["completion_tokens"] >= 1
        time.sleep(0.3)
        state = json.loads(_http(port, "/state")[1])
        assert state["model"] == "tiny-moe"
        assert state["moe_tokens_routed"] > 0
        assert len(state["moe_expert_load"]) == 4
    finally:
        proc.terminate()
        proc.wait(timeout=30)
