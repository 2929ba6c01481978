"""The port's page migration against the JAX package's.

Engines (the reference's ``Engine`` and the port's on the reference's
``init_params(PRNGKey(0), TINY, float32)`` weights with two LoRA
adapters, a float32 pool, speculation at 4 drafts; a session cut after a
few tokens at a token boundary, its complete pages exported, imported by
another engine and resumed at its offset):

- port to port: greedy with a pinned bias (a speculating slot), seeded
  with a frequency penalty, and a LoRA slot each continue to the solo
  stream, which equals the reference's solo stream; only complete pages
  travel, ``(m - 1) // page_size`` of them;
- across frameworks, both ways (over the wire codec, as replicas would
  exchange them): the reference exports and the port imports, and the
  port exports and the reference imports; each continuation equals the
  reference's solo stream;
- a failed export leaves the session serving, and every refusal (export
  and import) carries the reference's message;
- ``migratable_slots`` counts a young decoding slot.

HTTP (port replicas on the standard-library server): a stream cut by
``POST /migrate/export`` ends without terminal frames, ``POST
/migrate/import`` streams the continuation under the same response id
with the whole session's usage, and the two texts are the solo run's;
the routes' refusals equal the reference server's; a draining replica
refuses an import. The reference gateway's ``_Migrator`` moves a stream
pinned to a one-slot replica whose queue deepens to an idle sibling,
and the client sees one clean stream.
"""

import asyncio
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aigw_tpu.models import llama as jllama
from aigw_tpu.models import lora as jlora
from aigw_tpu.tpuserve import engine as jengine
from aigw_tpu.tpuserve import server as jserver
from aigw_tpu.tpuserve.sampling import SamplingParams as JSampling
from aigw_tpu_torch.models import convert
from aigw_tpu_torch.models import llama as tllama
from aigw_tpu_torch.tpuserve import engine as tengine
from aigw_tpu_torch.tpuserve import server as tserver
from aigw_tpu_torch.tpuserve.sampling import SamplingParams as TSampling

EOS = (257,)
PS = 16
CFG = dict(max_batch_size=2, max_seq_len=256, page_size=PS,
           decode_steps_per_tick=4, attention_backend="pallas-ragged",
           decode_backend="fused", ragged_chunk_tokens=24,
           ragged_max_chunks=1, kv_cache_dtype="float32", spec_tokens=4)
ADAPTERS = ("t0", "t1")


def _seq(a, b, n=50, mod=450):
    return [(a * i + b) % mod + 1 for i in range(n)]


@pytest.fixture(scope="module")
def rig():
    """(reference solo, reference R, port solo, port A, port B)."""
    jp = jllama.init_params(jax.random.PRNGKey(0), jllama.TINY,
                            dtype=jnp.float32)
    tp = convert.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                   device="cpu")
    stacks = jlora.init_lora_adapters(
        jax.random.PRNGKey(11), jllama.TINY,
        jlora.LoRAConfig(rank=4, alpha=8.0, targets=("wq", "wv")), 2,
        random_b=True)
    jst = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), stacks)
    tst = convert.adapters_from_numpy(
        {k: np.asarray(v, np.float32) for k, v in jst.items()},
        torch.float32, "cpu")
    engines = [jengine.Engine(jp, jllama.TINY, jengine.EngineConfig(**CFG),
                              eos_token_ids=EOS, lora_params=jst,
                              adapter_names=ADAPTERS) for _ in range(2)]
    engines += [tengine.Engine(tp, tllama.TINY, tengine.EngineConfig(**CFG),
                               eos_token_ids=EOS, device="cpu",
                               lora_params=tst, adapter_names=ADAPTERS)
                for _ in range(3)]
    for e in engines:
        e.start()
    yield engines
    for e in engines:
        e.stop()


def _sp(mod, kw):
    return (JSampling if mod is jengine else TSampling)(**kw)


def _mod(eng):
    return jengine if isinstance(eng, jengine.Engine) else tengine


def _generate(eng, prompt, n, sampling, adapter=""):
    mod = _mod(eng)
    done = threading.Event()
    toks: list[int] = []

    def emit(tok, fin):
        if tok >= 0:
            toks.append(tok)
        if fin is not None:
            done.set()

    eng.submit(mod.GenRequest(prompt=list(prompt), max_tokens=n,
                              sampling=_sp(mod, sampling), emit=emit,
                              adapter=adapter))
    assert done.wait(300)
    return toks


def _wire(page, src, dst):
    """A host page from ``src``'s package onto ``dst``'s, through the
    wire codec (as replicas exchange them)."""
    return dst.decode_wire_page(src.encode_wire_page(page))


def _migrate(eng_a, eng_b, prompt, n, sampling, adapter="", cut_after=3):
    """Serve on A, export after ``cut_after`` tokens, import and resume
    on B: (tokens before the cut, after it, the export). A stream that
    finishes before its export runs is retried (generation is
    deterministic, so the retry changes nothing)."""
    ma, mb = _mod(eng_a), _mod(eng_b)
    sa = ma if ma is jengine else tengine
    srv_a = jserver if ma is jengine else tserver
    srv_b = jserver if mb is jengine else tserver
    for _attempt in range(4):
        toks_a: list[int] = []
        cut = threading.Event()
        done = threading.Event()
        fin: list = [None]

        def emit(tok, f, toks_a=toks_a, cut=cut, done=done, fin=fin):
            if tok >= 0:
                toks_a.append(tok)
            if len(toks_a) >= cut_after:
                cut.set()
            if f is not None:
                fin[0] = f
                done.set()

        req = sa.GenRequest(prompt=list(prompt), max_tokens=n,
                            sampling=_sp(ma, sampling), emit=emit,
                            adapter=adapter)
        eng_a.submit(req)
        deadline = time.monotonic() + 300
        while not (cut.wait(0.05) or done.is_set()):
            assert time.monotonic() < deadline
        assert cut.is_set(), f"the stream ended after {len(toks_a)} tokens"
        try:
            out = eng_a.migrate_export(req)
        except ma.MigrationError as e:
            assert "finished" in str(e), e
            assert done.wait(300)
            continue
        break
    else:
        raise AssertionError("the export never won the race")
    assert done.wait(60) and fin[0] == "migrated"
    data = out["data"] if ma is mb else [_wire(d, srv_a, srv_b)
                                         for d in out["data"]]
    eng_b.migrate_import(out["blob"]["tokens"], data)
    toks_b: list[int] = []
    done_b = threading.Event()

    def emit_b(tok, f):
        if tok >= 0:
            toks_b.append(tok)
        if f is not None:
            done_b.set()

    eng_b.submit(mb.continuation_request(
        json.loads(json.dumps(out["blob"])), emit=emit_b))
    assert done_b.wait(300)
    return toks_a, toks_b, out


CASES = {
    # greedy pinned by a bias: drafts accept, so the slot speculates
    "greedy_speculating": (_seq(7, 3), 24,
                           dict(temperature=0.0, logit_bias=((7, 50.0),)),
                           ""),
    # seeded with a penalty: the key state and the penalty counts resume
    "sampled_penalized": (_seq(11, 5, 40, 400), 20,
                          dict(temperature=0.9, seed=42,
                               frequency_penalty=0.4), ""),
    # the continuation re-acquires the adapter's row on the target
    "lora": (_seq(5, 9), 16, dict(temperature=0.0), "t1"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_port_migration_matches_solo(rig, case):
    ref_solo, _ref_r, solo, eng_a, eng_b = rig
    prompt, n, sampling, adapter = CASES[case]
    want = _generate(ref_solo, prompt, n, sampling, adapter)
    assert len(want) == n
    assert _generate(solo, prompt, n, sampling, adapter) == want
    out_a, in_b = eng_a.stats.migrations_out, eng_b.stats.migrations_in
    toks_a, toks_b, out = _migrate(eng_a, eng_b, prompt, n, sampling,
                                   adapter)
    assert toks_a + toks_b == want
    assert eng_a.stats.migrations_out == out_a + 1
    assert eng_b.stats.migrations_in == in_b + 1
    m = len(out["blob"]["tokens"])
    assert len(out["data"]) == (m - 1) // PS == len(out["blob"]["chain"])
    assert out["blob"]["adapter"] == adapter
    assert out["blob"]["meter"]["decode_tokens"] == len(toks_a)


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
@pytest.mark.parametrize("sampled", [False, True])
def test_cross_framework_migration_matches_reference_solo(rig, direction,
                                                          sampled):
    ref_solo, ref_r, _solo, eng_a, eng_b = rig
    prompt = _seq(13 + 2 * sampled, 3 + (direction == "port_to_reference"))
    sampling = (dict(temperature=0.8, seed=7, presence_penalty=0.3)
                if sampled else dict(temperature=0.0))
    want = _generate(ref_solo, prompt, 20, sampling)
    assert len(want) == 20
    src, dst = ((ref_r, eng_b) if direction == "reference_to_port"
                else (eng_a, ref_r))
    toks_a, toks_b, _out = _migrate(src, dst, prompt, 20, sampling)
    assert toks_a + toks_b == want


@pytest.fixture(scope="module", params=["int8", "int4"])
def quant_pair(request):
    """A reference and a port engine over one quantized pool dtype."""
    jp = jllama.init_params(jax.random.PRNGKey(0), jllama.TINY,
                            dtype=jnp.float32)
    tp = convert.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                   device="cpu")
    cfg = dict(CFG, kv_cache_dtype=request.param, spec_tokens=0)
    pair = (jengine.Engine(jp, jllama.TINY, jengine.EngineConfig(**cfg),
                           eos_token_ids=EOS),
            tengine.Engine(tp, tllama.TINY, tengine.EngineConfig(**cfg),
                           eos_token_ids=EOS, device="cpu"))
    for e in pair:
        e.start()
    yield request.param, pair
    for e in pair:
        e.stop()


def test_quantized_pages_cross_frameworks_byte_for_byte(quant_pair):
    """Quantized pools compare page bytes, not streams (ROADMAP §3): a
    session exported by one framework and imported by the other is held
    there byte for byte: the importer serves the adopted chain back over
    the fleet fetch's export as the exporter's own wire dicts."""
    dtype, (ref, port) = quant_pair
    for k, (src, dst) in enumerate(((ref, port), (port, ref))):
        prompt = _seq(9 + k, 4, 60)
        sampling = dict(temperature=0.0)
        _toks_a, _toks_b, out = _migrate(src, dst, prompt, 12, sampling)
        assert out["blob"]["kv_dtype"] == dtype
        src_srv, dst_srv = ((jserver, tserver) if src is ref
                            else (tserver, jserver))
        want = [src_srv.encode_wire_page(d) for d in out["data"]]
        keys = [bytes.fromhex(h) for h in out["blob"]["chain"]]
        held = dst.kv_export_pages(keys)
        assert [kk for kk, _d in held] == keys
        assert [dst_srv.encode_wire_page(d) for _kk, d in held] == want
        assert all(w["dtype"] == dtype for w in want)


def _err(fn) -> str:
    try:
        fn()
    except (jengine.MigrationError, tengine.MigrationError) as e:
        return str(e)
    raise AssertionError("no MigrationError")


def test_export_refusals_match_reference_and_leave_sessions_serving(rig):
    _ref_solo, ref_r, _solo, eng_a, _eng_b = rig
    ghosts = [mod.GenRequest(prompt=[1, 2, 3], max_tokens=4,
                             sampling=_sp(mod, dict(temperature=0.0)))
              for mod in (jengine, tengine)]
    assert _err(lambda: eng_a.migrate_export(ghosts[1])) \
        == _err(lambda: ref_r.migrate_export(ghosts[0]))
    # a live session next to the failed export completes
    assert len(_generate(eng_a, _seq(3, 2, 30, 300), 8,
                         dict(temperature=0.0))) == 8


def test_import_refusals_match_reference(rig):
    _ref_solo, ref_r, _solo, _eng_a, eng_b = rig
    mc = jllama.TINY
    shape = (mc.n_layers, 2, PS, mc.n_kv_heads, mc.head_dim)
    good = np.zeros(shape, np.float32)
    q8 = np.zeros(shape, np.int8)
    cases = [
        ([1] * 40, [np.zeros((1, 2, 3), np.float32)]),  # wrong shape
        ([1] * 17, [good, good]),  # beyond the written coverage
        ([1] * 40, [{"q": q8, "scale": np.zeros(shape[:-1], np.float32)}]),
    ]
    for tokens, pages in cases:
        port_pages = [
            {"q": torch.from_numpy(p["q"]),
             "scale": torch.from_numpy(p["scale"]), "dtype": "int8"}
            if isinstance(p, dict) else torch.from_numpy(p) for p in pages]
        assert _err(lambda: eng_b.migrate_import(tokens, port_pages)) \
            == _err(lambda: ref_r.migrate_import(tokens, pages))
    nocache = tengine.Engine({}, tllama.TINY,
                             tengine.EngineConfig(enable_prefix_cache=False),
                             device="cpu")
    with pytest.raises(tengine.MigrationError, match="prefix cache"):
        nocache._do_import([1] * 40, [good])
    assert not nocache.migratable and eng_b.migratable


def test_migratable_slots_gauge(rig):
    eng = rig[3]
    seen = threading.Event()
    done = threading.Event()

    def emit(tok, fin):
        if tok >= 0:
            seen.set()
        if fin is not None:
            done.set()

    req = tengine.GenRequest(prompt=[5] * 20, max_tokens=200,
                             sampling=TSampling(temperature=0.0), emit=emit)
    eng.submit(req)
    assert seen.wait(300)
    deadline = time.monotonic() + 30
    while eng.stats.migratable_slots < 1:
        assert time.monotonic() < deadline and not done.is_set()
        time.sleep(0.01)
    req.cancelled.set()
    assert done.wait(60)


# -- HTTP ---------------------------------------------------------------------
MODEL = "tiny-random"


def _replica(batch: int, params=None, max_seq_len=256, ticks=2):
    srv = tserver.TPUServeServer(
        MODEL, tengine.EngineConfig(max_batch_size=batch,
                                    max_seq_len=max_seq_len, page_size=PS,
                                    decode_steps_per_tick=ticks),
        device="cpu", port=0, params=params)
    srv.start()
    return srv


@pytest.fixture(scope="module")
def replicas():
    a = _replica(2)
    b = _replica(2, params=a.engine.params)
    yield a, b
    a.stop()
    b.stop()


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"content-type": "application/json"})
    try:
        return urllib.request.urlopen(req, timeout=600)
    except urllib.error.HTTPError as e:
        return e


def _frames(resp):
    """Yield each SSE data payload (bytes) of a response."""
    for line in resp:
        line = line.strip()
        if line.startswith(b"data: "):
            yield line[6:]


def _consume(frames, first=()):
    """(text, finish, usage, saw [DONE]) of the rest of a stream."""
    text, finish, usage, done = "", None, None, False
    for raw in (*first, *frames):
        if raw == b"[DONE]":
            done = True
            break
        ev = json.loads(raw)
        usage = ev.get("usage") or usage
        for ch in ev.get("choices") or ():
            text += (ch.get("delta") or {}).get("content") or ""
            finish = ch.get("finish_reason") or finish
    return text, finish, usage, done


PAYLOAD = {"model": MODEL, "max_tokens": 60, "temperature": 0.8, "seed": 7,
           "frequency_penalty": 0.5, "stream": True,
           "stream_options": {"include_usage": True},
           "messages": [{"role": "user", "content": "hello migration " * 6}]}


def test_http_migrate_splice_matches_solo(replicas):
    a, b = replicas
    solo = _consume(_frames(_post(b.port, "/v1/chat/completions", PAYLOAD)))
    assert solo[1] == "length" and solo[3]
    for _attempt in range(4):
        resp = _post(a.port, "/v1/chat/completions", PAYLOAD)
        rid = resp.headers["x-aigw-request-id"]
        frames = _frames(resp)
        head = [next(frames), next(frames)]  # the role frame, a token
        exp = _post(a.port, "/migrate/export", {"request_id": rid})
        if exp.status == 200:
            export = json.loads(exp.read())
            break
        _consume(frames)  # raced to completion: a fresh stream
    else:
        raise AssertionError("the export never won the race")
    text_a, fin_a, _u, done_a = _consume(frames, head)
    assert fin_a is None and not done_a  # no terminal frames
    assert export["blob"]["meta"]["response_id"] == rid
    cont = _post(b.port, "/migrate/import", export)
    assert cont.status == 200 and cont.headers["x-aigw-request-id"] == rid
    text_b, fin_b, usage, done_b = _consume(_frames(cont))
    assert done_b and fin_b == "length"
    assert text_a + text_b == solo[0]
    assert usage["completion_tokens"] == PAYLOAD["max_tokens"] \
        == solo[2]["completion_tokens"]
    assert usage["prompt_tokens"] == solo[2]["prompt_tokens"]
    assert usage["aigw_meter"]["decode_tokens"] == PAYLOAD["max_tokens"]
    assert usage["aigw_meter"]["segments"] == 2
    sa = json.loads(urllib.request.urlopen(
        f"http://127.0.0.1:{a.port}/state").read())
    sb = json.loads(urllib.request.urlopen(
        f"http://127.0.0.1:{b.port}/state").read())
    assert sa["migrations_out"] >= 1 and sb["migrations_in"] >= 1
    assert sb["migration_pages_in"] == len(export["pages"]) >= 1
    assert sa["migration"] is sb["migration"] is True


@pytest.fixture(scope="module")
def reference_replica():
    from aiohttp import web

    holder = {}
    started = threading.Event()

    def run():
        async def main():
            server = jserver.TPUServeServer(MODEL, jengine.EngineConfig(
                max_batch_size=2, max_seq_len=256, page_size=PS))
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
    yield holder
    holder["loop"].call_soon_threadsafe(holder["stop"].set)
    t.join(timeout=60)


def test_http_refusals_match_reference(replicas, reference_replica):
    a, b = replicas
    ref = reference_replica["port"]
    good = {"b64": "", "shape": [0]}
    cases = [
        ("/migrate/export", {"request_id": "chatcmpl-nope"}),
        ("/migrate/export", {}),
        ("/migrate/import", {}),
        ("/migrate/import", {"blob": {"tokens": "x"}}),
        ("/migrate/import", {"blob": {"tokens": [1] * 40},
                             "pages": [dict(good, dtype="int2")]}),
        ("/migrate/import", {"blob": {"tokens": [1] * 40},
                             "pages": [good]}),
    ]
    for path, body in cases:
        g, w = _post(a.port, path, body), _post(ref, path, body)
        assert (g.status, json.loads(g.read())) \
            == (w.status, json.loads(w.read())), (path, body)
    # a draining replica adopts nothing: the drain's 503
    b.set_draining(True)
    try:
        g = _post(b.port, "/migrate/import", {})
        reference_replica["server"].draining = True
        w = _post(ref, "/migrate/import", {})
        assert (g.status, json.loads(g.read())) \
            == (w.status, json.loads(w.read())) == (g.status, json.loads(
                _post(b.port, "/v1/completions", {}).read()))
        assert g.status == 503 and g.headers["retry-after"] == "2"
    finally:
        b.set_draining(False)
        reference_replica["server"].draining = False


def test_gateway_migrator_moves_a_stream_between_port_replicas():
    """The reference gateway's ``_Migrator``: a stream pinned to the
    one-slot replica A, whose queue then deepens, is exported and spliced
    onto the idle sibling B; the client sees one stream with every token
    and the gateway counts the migration."""
    import aiohttp

    from aigw_tpu.config.model import Config
    from aigw_tpu.config.runtime import RuntimeConfig
    from aigw_tpu.gateway.server import run_gateway

    # a long stream, one decode step a tick, so that it is still young
    # when A's queue deepens and the picker's poll sees it
    geometry = dict(max_seq_len=512, ticks=1)
    a = _replica(1, **geometry)
    b = _replica(2, **geometry)
    addr_a, addr_b = f"127.0.0.1:{a.port}", f"127.0.0.1:{b.port}"
    n_tok = 240

    async def main():
        cfg = Config.parse({
            "version": "v1",
            "backends": [{
                "name": "pool", "schema": "OpenAI",
                "endpoints": [addr_a, addr_b],
                "picker_poll_interval": 0.1,
                "migration": True,
                "migration_queue_depth": 1,
                "migration_young_tokens": n_tok,
            }],
            "routes": [{"name": "serving", "rules": [
                {"model_prefixes": ["tiny"], "backends": ["pool"]}]}],
            "models": [MODEL],
        })
        server, runner = await run_gateway(RuntimeConfig.build(cfg), port=0)
        site = list(runner.sites)[0]
        gw = f"http://127.0.0.1:{site._server.sockets[0].getsockname()[1]}"
        picker = server._pickers["pool"]
        try:
            for _ in range(100):
                if len(picker.state) == 2 and all(
                        st.healthy and st.migration_capable
                        for st in picker.state.values()):
                    break
                await asyncio.sleep(0.1)
            payload = {"model": MODEL, "max_tokens": n_tok,
                       "temperature": 0, "stream": True,
                       "messages": [{"role": "user",
                                     "content": "migrate me " * 8}]}
            flood = {"model": MODEL, "max_tokens": 48, "temperature": 0,
                     "prompt": "flood " * 8}
            async with aiohttp.ClientSession() as s:
                pieces, done, fin = [], False, None
                async with s.post(
                        gw + "/v1/chat/completions", json=payload,
                        headers={"x-gateway-destination-endpoint":
                                 addr_a}) as resp:
                    assert resp.status == 200, await resp.text()
                    floods = None
                    async for line in resp.content:
                        line = line.strip()
                        if not line.startswith(b"data: "):
                            continue
                        if line[6:] == b"[DONE]":
                            done = True
                            break
                        ch = json.loads(line[6:]).get("choices") or []
                        if ch:
                            d = ch[0].get("delta") or {}
                            if d.get("content"):
                                pieces.append(d["content"])
                            fin = ch[0].get("finish_reason") or fin
                        if floods is None and pieces:
                            # the stream decodes on A: deepen A's queue
                            floods = [asyncio.ensure_future(s.post(
                                f"http://{addr_a}/v1/completions",
                                json=flood)) for _ in range(3)]
                for f in floods or ():
                    (await f).release()
                mets = (await (await s.get(gw + "/metrics")).read()
                        ).decode()
            return pieces, done, fin, mets
        finally:
            await runner.cleanup()

    try:
        pieces, done, fin, mets = asyncio.run(main())
        st_a = json.loads(urllib.request.urlopen(
            f"http://{addr_a}/state").read())
        st_b = json.loads(urllib.request.urlopen(
            f"http://{addr_b}/state").read())
    finally:
        a.stop()
        b.stop()
    assert done and fin == "length"
    # the same text as the same request served whole on B
    solo = _replica(2, **geometry)
    try:
        text = json.loads(_post(solo.port, "/v1/chat/completions", {
            "model": MODEL, "max_tokens": n_tok, "temperature": 0,
            "messages": [{"role": "user", "content": "migrate me " * 8}],
        }).read())["choices"][0]["message"]["content"]
    finally:
        solo.stop()
    assert "".join(pieces) == text
    assert st_a["migrations_out"] == 1 and st_b["migrations_in"] == 1
    assert 'aigw_migrations_total{backend="pool",route="serving"}' in mets
