"""Multi-LoRA served: the port's engine, server and CLI against the JAX
package's, and the reference gateway in front of a port replica.

- Engine: the reference ``Engine`` and the port's, each with an
  ``AdapterStore`` of 2 rows over a zoo of 3 adapters (the reference's
  ``init_lora_adapters(PRNGKey(7), TINY, rank 4, wq/wv/w_down,
  random_b=True)``, bf16), on the reference's ``init_params(PRNGKey(0),
  float32)`` weights over a float32 pool, serve the same phases one
  after the other, the cases of the reference's ``tests/test_lora.py``
  and ``tests/test_adapters.py``: solo runs, then a mixed burst of two
  adapters, a base slot and a penalized slot (each equal to its solo
  run); a base stream with both adapters resident (equal to an engine
  with no LoRA at all); an eviction and a reload; an unknown adapter
  (``error``); a capacity wait (three adapters over two rows); the
  prefix-cache case (a base prompt, then the same prompt through an
  adapter: the cache keys pages on tokens only, so the adapter adopts
  the base request's pages, and the stream differs from the cache-off
  one, as the reference's does). On the fused rung, and on the chained
  rung speculating at a fixed width of 3 (K5's path; a pinned adapter
  request accepts drafts). Streams, accepted and offered drafts and the
  adapter counters equal the reference's.
- A Mixtral engine with a zoo: adapters ignored, as in the reference.
- Server: ``<base>:<adapter>`` and bare names, the 404 on an unknown
  suffix on both routes streamed or not, ``/v1/models``' entries, and
  ``/state``'s six adapter keys equal to the reference server's with
  and without a zoo; the CLI's ``--lora`` and ``--lora-slots``.
- The reference gateway over a port replica: its merged ``/v1/models``
  lists the zoo, and its picker reads ``adapters_resident``.
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
import torch

from aigw_tpu.models import llama as jllama
from aigw_tpu.models import lora as jlora
from aigw_tpu.models import mixtral as jmixtral
from aigw_tpu.models.registry import family_fns as jfamily_fns
from aigw_tpu.tpuserve import adapters as jadapters
from aigw_tpu.tpuserve import engine as jengine
from aigw_tpu.tpuserve.sampling import SamplingParams as JSampling
from aigw_tpu_torch.models import convert
from aigw_tpu_torch.models import llama as tllama
from aigw_tpu_torch.models import mixtral as tmixtral
from aigw_tpu_torch.models.registry import family_fns as tfamily_fns
from aigw_tpu_torch.tpuserve import adapters as tadapters
from aigw_tpu_torch.tpuserve import engine as tengine
from aigw_tpu_torch.tpuserve.sampling import SamplingParams as TSampling

EOS = (257,)
CFG = dict(max_batch_size=4, max_seq_len=128, page_size=16,
           decode_steps_per_tick=4, kv_cache_dtype="float32",
           attention_backend="pallas-ragged", decode_backend="fused",
           ragged_chunk_tokens=16, ragged_max_chunks=4)
RUNGS = {
    "fused": dict(decode_backend="fused"),
    "chained_spec": dict(decode_backend="auto", pallas_attn=True,
                         spec_tokens=3, spec_adaptive=False),
}
LORA = jlora.LoRAConfig(rank=4, alpha=8.0, targets=("wq", "wv", "w_down"))
GREEDY = dict(temperature=0.0)
PEN = dict(temperature=0.0, frequency_penalty=0.8)
SHARED = list(range(1, 40)) + [7]  # 2 full pages of 16
#: phases served one after the other: (adapter, prompt, max_tokens,
#: sampling) requests submitted together
PHASES = [
    [("ad0", [10, 20, 30], 5, GREEDY)],
    [("ad1", [10, 20, 30], 5, GREEDY)],
    [("", [10, 20, 30], 5, GREEDY)],
    [("", [10, 20, 30], 5, PEN)],
    # the mixed burst: each member equals its solo run above
    [("ad0", [10, 20, 30], 5, GREEDY), ("ad1", [10, 20, 30], 5, GREEDY),
     ("", [10, 20, 30], 5, GREEDY), ("", [10, 20, 30], 5, PEN)],
    # base with both rows resident (= an engine without LoRA)
    [("", [3, 1, 4, 1, 5], 8, GREEDY)],
    # ad2 evicts the least recently parked row; ad0 then reloads
    [("ad2", [3, 1, 4, 1, 5], 5, GREEDY)],
    [("ad0", [10, 20, 30], 5, GREEDY)],
    [("nope", [1, 2], 2, GREEDY)],
    # three adapters over two rows: the third waits for a free row
    [("ad1", [7, 8, 9], 30, GREEDY), ("ad2", [6, 5], 12, GREEDY),
     ("ad0", [4, 5], 3, GREEDY)],
    # a pinned adapter stream: drafts accepted on the speculating rung
    [("ad1", [5, 6, 7, 5, 6], 10, dict(temperature=0.0,
                                        logit_bias=((7, 100.0),)))],
    # the prefix cache keys on tokens: the adapter adopts base pages
    [("", SHARED, 8, GREEDY)],
    [("ad0", SHARED, 8, GREEDY)],
]
COUNTERS = ("adapter_loads", "adapter_evictions", "adapter_resident",
            "adapter_slots", "prefills", "decode_steps", "tokens_generated",
            "spec_accepted", "spec_drafted", "prefix_cache_hits",
            "prefix_tokens_reused", "prefix_cache_misses")


@pytest.fixture(scope="module")
def weights():
    p = jllama.init_params(jax.random.PRNGKey(0), jllama.TINY,
                           dtype=jnp.float32)
    return p, convert.params_from_numpy(
        {k: np.asarray(v) for k, v in p.items()}, device="cpu")


@pytest.fixture(scope="module")
def zoo():
    """Three single adapters, numpy (bf16), the reference tests' form."""
    j = jlora.init_lora_adapters(jax.random.PRNGKey(7), jllama.TINY, LORA,
                                 3, random_b=True)
    return {f"ad{i}": {k: np.asarray(v[i]) for k, v in j.items()}
            for i in range(3)}


def _store(mod, zoo, n_slots=2, **kw):
    st = mod.AdapterStore(n_slots=n_slots, **kw)
    for name, ad in zoo.items():
        st.register(name, ad)
    return st


def _serve(eng, req_cls, sp_cls, phases):
    """Serve ``phases`` one after the other on a started engine; returns
    each phase's streams (tokens, then the finish reason)."""
    out = []
    eng.start()
    try:
        for phase in phases:
            streams = [[] for _ in phase]
            done = [threading.Event() for _ in phase]
            reqs = []
            for i, (adapter, prompt, n, kw) in enumerate(phase):
                def emit(t, f, i=i):
                    if t >= 0:
                        streams[i].append(t)
                    if f is not None:
                        streams[i].append(f)
                        done[i].set()
                reqs.append(req_cls(prompt=list(prompt), max_tokens=n,
                                    sampling=sp_cls(**kw), emit=emit,
                                    adapter=adapter))
            for r in reqs:
                eng.submit(r)
            assert all(d.wait(300) for d in done), "a stream did not finish"
            deadline = time.monotonic() + 60
            while (eng._inflight is not None
                   or eng._device_state is not None
                   or not eng._queue.empty()) \
                    and time.monotonic() < deadline:
                time.sleep(0.01)
            out.append(streams)
        assert eng.healthy, eng.last_error
    finally:
        eng.stop()
    eng._refresh_stats()
    return out


def _port_engine(tp, zoo, cfg_over, store=True, **over):
    return tengine.Engine(
        tp, tllama.TINY, tengine.EngineConfig(**{**CFG, **cfg_over, **over}),
        eos_token_ids=EOS, device="cpu",
        adapter_store=_store(tadapters, zoo, device="cpu") if store
        else None)


@pytest.fixture(scope="module", params=sorted(RUNGS))
def served(request, weights, zoo):
    jp, tp = weights
    over = RUNGS[request.param]
    jeng = jengine.Engine(jp, jllama.TINY,
                          jengine.EngineConfig(**{**CFG, **over}),
                          eos_token_ids=EOS,
                          adapter_store=_store(jadapters, zoo))
    want = _serve(jeng, jengine.GenRequest, JSampling, PHASES)
    teng = _port_engine(tp, zoo, over)
    got = _serve(teng, tengine.GenRequest, TSampling, PHASES)
    return request.param, want, got, jeng, teng


def test_engine_phases_match_reference(served):
    rung, want, got, jeng, teng = served
    assert got == want
    for key in COUNTERS:
        assert getattr(teng.stats, key) == getattr(jeng.stats, key), key
    store = teng._adapter_store
    store.check_invariants()
    assert store.resident_names() == jeng._adapter_store.resident_names()
    assert teng.stats.adapter_evictions >= 2 and teng.stats.adapter_slots == 0
    assert teng.stats.prefix_cache_hits >= 1
    if rung == "chained_spec":
        assert teng._verify_impl == "chained"
        assert teng.stats.spec_accepted > 0


def test_engine_phases_hold_the_reference_tests_expectations(served):
    """The reference tests' own expectations, on the port's streams."""
    _, _, got, _, teng = served
    solo = [got[i][0] for i in range(4)]
    assert got[4] == solo  # the mixed burst equals the solo runs
    assert solo[0] != solo[2] and solo[1] != solo[2]  # adapters visible
    assert got[7][0] == solo[0]  # reloaded after its eviction
    assert got[8] == [["error"]]  # the unknown adapter
    assert [s[-1] for s in got[9]] == ["length"] * 3  # the wait completed
    assert got[10][0] == [7] * 10 + ["length"]


def test_base_stream_and_prefix_cache_against_no_lora_engines(
        weights, zoo, served):
    """The base stream with adapters resident equals a no-LoRA engine's
    byte for byte; the adapter request behind a cached base prompt gives
    the cache-on stream, which differs from the cache-off one (the
    reference's adapter-blind prefix keys, kept for parity)."""
    rung, got = served[0], served[2]
    plain = _serve(_port_engine(weights[1], zoo, RUNGS[rung], store=False),
                   tengine.GenRequest, TSampling, [PHASES[5]])
    assert plain[0] == got[5]
    off = _serve(_port_engine(weights[1], zoo, RUNGS[rung],
                              enable_prefix_cache=False),
                 tengine.GenRequest, TSampling, PHASES[11:])
    assert off[0] == got[11]  # the base stream: no cached pages either way
    assert off[1] != got[12]  # the adapter adopted base-computed pages


# -- the mixtral family: adapters ignored -------------------------------------
MOE_PHASES = [
    [("ad0", [10, 20, 30, 40], 6, GREEDY), ("", [10, 20, 30, 40], 6, GREEDY)],
    [("ad1", [9, 8, 7], 5, GREEDY)],
]


def test_mixtral_engine_with_a_zoo_matches_reference(zoo, monkeypatch):
    """The reference's Mixtral entry points take the adapter rows and
    ignore them; so do the port's: a burst with an adapter and a base
    request of one prompt gives two equal streams, the reference's
    (its kernels in interpret mode, as ``tests/test_torch_moe_serving``
    runs them: padding rows route like the port's)."""
    monkeypatch.setenv("AIGW_RAGGED_PREFILL_IMPL", "pallas")
    monkeypatch.setenv("AIGW_DECODE_FUSED_IMPL", "pallas")
    p = jmixtral.init_params(jax.random.PRNGKey(7), jmixtral.TINY_MOE,
                             jnp.float32)
    tp = convert.params_from_numpy({k: np.asarray(v) for k, v in p.items()},
                                   device="cpu")
    jeng = jengine.Engine(p, jmixtral.TINY_MOE, jengine.EngineConfig(**CFG),
                          eos_token_ids=EOS, fns=jfamily_fns("mixtral"),
                          adapter_store=_store(jadapters, zoo))
    want = _serve(jeng, jengine.GenRequest, JSampling, MOE_PHASES)
    teng = tengine.Engine(tp, tmixtral.TINY_MOE, tengine.EngineConfig(**CFG),
                          eos_token_ids=EOS, fns=tfamily_fns("mixtral"),
                          device="cpu",
                          adapter_store=_store(tadapters, zoo, device="cpu"))
    got = _serve(teng, tengine.GenRequest, TSampling, MOE_PHASES)
    assert got == want
    assert got[0][0] == got[0][1]  # the adapter changed nothing
    assert teng.moe_expert_load() == jeng.moe_expert_load()
    for key in ("adapter_loads", "adapter_resident", "moe_tokens_routed"):
        assert getattr(teng.stats, key) == getattr(jeng.stats, key), key


# -- the servers ---------------------------------------------------------------
SERVER_CFG = dict(max_batch_size=2, max_seq_len=256, page_size=16,
                  decode_steps_per_tick=4, attention_backend="pallas-ragged",
                  decode_backend="fused")
MODEL = "tiny-random"
ADAPTER_KEYS = ("adapters_registered", "adapters_resident", "adapter_rows",
                "adapter_loads", "adapter_evictions", "adapter_slots")
CHAT = {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 4,
        "temperature": 0.0}
#: (path, model, stream, body): base, ad0 by suffix, ad1 by its bare
#: name (streamed), ad2 (evicts, 2 rows), unknown suffixes on both routes
CALLS = [
    ("/v1/completions", MODEL, False, {"prompt": "ab", "max_tokens": 4}),
    ("/v1/chat/completions", f"{MODEL}:ad0", False, CHAT),
    ("/v1/completions", "ad1", True, {"prompt": "xyz", "max_tokens": 3}),
    ("/v1/chat/completions", f"{MODEL}:ad2", True, CHAT),
    ("/v1/chat/completions", f"{MODEL}:nope", False, CHAT),
    ("/v1/chat/completions", f"{MODEL}:nope", True, CHAT),
    ("/v1/completions", f"{MODEL}:nope", False, {"prompt": "a"}),
    ("/v1/completions", f"{MODEL}:nope", True, {"prompt": "a"}),
]


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


def _drive(port) -> dict:
    """CALLS one at a time; then /v1/models and /state's adapter keys."""
    out = {"calls": []}
    for path, model, stream, body in CALLS:
        status, raw = _http(port, path, dict(body, model=model,
                                             stream=stream))
        err = json.loads(raw)["error"] if status != 200 else None
        out["calls"].append((status, err and (err["message"], err["type"])))
    time.sleep(0.5)  # the last window settles after its reply
    out["models"] = [(m["id"], m["owned_by"], m.get("capabilities"))
                     for m in json.loads(_http(port, "/v1/models")[1])["data"]]
    state = json.loads(_http(port, "/state")[1])
    out["state"] = {k: state[k] for k in ADAPTER_KEYS}
    return out


def _reference_server(**kw):
    from aigw_tpu.tpuserve import server as jserver

    return jserver.TPUServeServer(MODEL, jengine.EngineConfig(**SERVER_CFG),
                                  **kw)


def _reference_run(zoo) -> dict:
    from aiohttp import web

    holder = {}
    started = threading.Event()

    def run():
        async def main():
            server = _reference_server(lora_adapters=zoo, lora_slots=2)
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


def _port_server(zoo=None, slots=2):
    from aigw_tpu_torch.tpuserve.server import TPUServeServer

    return TPUServeServer(MODEL, tengine.EngineConfig(**SERVER_CFG),
                          device="cpu", port=0, lora_adapters=zoo,
                          lora_slots=slots)


def test_server_adapter_routing_and_state_match_reference(zoo):
    want = _reference_run(zoo)
    srv = _port_server(zoo)
    srv.start()
    try:
        got = _drive(srv.port)
    finally:
        srv.stop()
    assert got == want
    missing = ("unknown LoRA adapter 'nope'; loaded: ['ad0', 'ad1', 'ad2']",
               "model_not_found")
    assert got["calls"] == [(200, None)] * 4 + [(404, missing)] * 4
    assert [m[:2] for m in got["models"]] == [
        (MODEL, "tpuserve")] + [(f"{MODEL}:ad{i}", "tpuserve-lora")
                                for i in range(3)]
    assert got["state"] == {
        "adapters_registered": ["ad0", "ad1", "ad2"],
        "adapters_resident": ["ad1", "ad2"], "adapter_rows": 2,
        "adapter_loads": 3, "adapter_evictions": 1, "adapter_slots": 0}


def test_server_without_a_zoo_matches_reference():
    """No zoo: the six keys at the reference's values, every
    ``<base>:<x>`` a 404, bare names the base model."""
    jsrv = _reference_server()
    want = json.loads(asyncio.run(jsrv._state(None)).body)
    srv = _port_server()
    got = srv.state()
    assert {k: got[k] for k in ADAPTER_KEYS} == \
        {k: want[k] for k in ADAPTER_KEYS} == {
            "adapters_registered": [], "adapters_resident": [],
            "adapter_rows": 0, "adapter_loads": 0, "adapter_evictions": 0,
            "adapter_slots": 0}
    assert srv.adapter_store is None and srv.engine.lora_params is None
    assert srv._resolve_adapter("ad0") == "" == srv._resolve_adapter(MODEL)
    for fn in (jsrv._resolve_adapter, srv._resolve_adapter):
        with pytest.raises(ValueError, match=r"unknown LoRA adapter 'x'; "
                                             r"loaded: \[\]"):
            fn(f"{MODEL}:x")
    assert [m["id"] for m in srv.models()["data"]] == [MODEL]
    srv.httpd.server_close()
    with pytest.raises(ValueError, match="llama family"):
        from aigw_tpu_torch.tpuserve.server import TPUServeServer

        TPUServeServer("tiny-moe", tengine.EngineConfig(**SERVER_CFG),
                       device="cpu", port=0, lora_adapters=zoo_of(1))


def zoo_of(n):
    return {f"ad{i}": {"l0.wq.lora_a": np.zeros((4, 64), np.float32),
                       "l0.wq.lora_b": np.zeros((64, 4), np.float32)}
            for i in range(n)}


def test_engine_adapter_arguments_and_device_checks(weights):
    tp = weights[1]
    cfg = tengine.EngineConfig(**CFG)
    store = _store(tadapters, zoo_of(2), device="cpu")
    with pytest.raises(ValueError, match="not both"):
        tengine.Engine(tp, tllama.TINY, cfg, device="cpu",
                       adapter_store=store, adapter_names=("a",))
    # the fixed-stack form: rows by name, the last row the base row
    stacks = {k: torch.zeros((3, *v.shape)) for k, v in
              zoo_of(1)["ad0"].items()}
    eng = tengine.Engine(tp, tllama.TINY, cfg, device="cpu",
                         lora_params=stacks, adapter_names=("a", "b"))
    assert eng.lora_params is stacks and eng._base_row == 2
    assert eng._acquire_adapter("b") == 1
    with pytest.raises(tadapters.UnknownAdapterError):
        eng._acquire_adapter("c")
    eng._refresh_stats()
    assert eng.stats.adapter_resident == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tadapters.AdapterStore(n_slots=1)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tengine.Engine(tp, tllama.TINY, cfg, adapter_store=store)


def test_cli_lora_flags():
    from aigw_tpu_torch.cli import build_parser, lora_adapters, main

    args = build_parser().parse_args(
        ["tpuserve", "--model", MODEL, "--lora-slots", "3"])
    assert args.lora_slots == 3 and args.lora == []
    assert lora_adapters([]) == {}
    with pytest.raises(ValueError, match="NAME=ORBAX_DIR"):
        lora_adapters(["fr"])
    with pytest.raises(NotImplementedError, match="orbax"):
        main(["tpuserve", "--model", MODEL, "--device", "cpu", "--port",
              "0", "--lora", "fr=/ckpt/fr"])


# -- the reference gateway in front of a port replica -------------------------
def test_reference_gateway_lists_the_port_zoo_and_reads_residency(zoo):
    from aigw_tpu.config.model import Config
    from aigw_tpu.config.runtime import RuntimeConfig
    from aigw_tpu.gateway.server import run_gateway

    srv = _port_server(zoo)
    srv.start()
    addr = f"127.0.0.1:{srv.port}"
    assert _http(srv.port, "/v1/completions", {
        "model": f"{MODEL}:ad1", "prompt": "a", "max_tokens": 2})[0] == 200

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
        try:
            picker = server._pickers["pool"]
            for _ in range(200):  # the picker's first /state poll
                st = picker.state.get(addr)
                if st is not None and st.adapters_registered:
                    break
                await asyncio.sleep(0.05)
            async with aiohttp.ClientSession() as s:
                async with s.get(f"http://127.0.0.1:{port}/v1/models") as r:
                    assert r.status == 200
                    ids = [m["id"] for m in (await r.json())["data"]]
                async with s.post(
                        f"http://127.0.0.1:{port}/v1/completions",
                        json={"model": f"{MODEL}:ad0", "prompt": "b",
                              "max_tokens": 2}) as r:
                    relayed = r.status
            return ids, st, relayed
        finally:
            await runner.cleanup()

    try:
        ids, st, relayed = asyncio.run(main())
    finally:
        srv.stop()
    assert {MODEL, f"{MODEL}:ad0", f"{MODEL}:ad1", f"{MODEL}:ad2"} <= set(ids)
    assert st.adapters_resident == frozenset({"ad1"})
    assert st.adapters_registered == ("ad0", "ad1", "ad2")
    assert relayed == 200
