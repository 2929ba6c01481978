"""The port's KV memory hierarchy against the JAX package's.

- ``HostKVTier``: a seeded schedule of put / contains / get / take /
  discard / keys over byte blobs, float32 arrays and int8 and int4
  quantized pages runs on the reference's tier and the port's; after
  every step the answers, the counters, the bytes and the LRU order are
  equal.
- The host-page helpers (``page_nbytes``, ``page_shape_ok``,
  ``page_matches_dtype``) and the wire codec: ``encode_wire_page`` gives
  the reference's dict, string for string, for float32, int8 and int4
  pages (int4 one element per byte, the ``ml_dtypes.int4`` bytes), and
  each side decodes the other's wire.
- Spill and revive on whole engines (the reference's ``Engine`` and the
  port's, on the reference's ``init_params(PRNGKey(0), TINY, float32)``
  weights, a 12-page pool): a wave of four prompts evicts the first
  ones' chains into the host tier, the first two are asked again and
  revived. The spill tier's counters, the prefix counters and the free
  pages equal the reference's; over a float32 pool the streams do too;
  the revived pages equal the spilled bytes exactly, and the spilled
  pages equal the reference's host pages (float32 within 1e-5; int8 and
  int4 byte for byte where the two sides' scales agree, ROADMAP §3).
- The fleet fetch over HTTP: a port replica fetches a prompt's pages
  from a reference replica over ``/kv/pages`` (``x-aigw-kv-peers``) and
  serves the reference's stream, and the reverse; a dead peer degrades
  to a cold prefill, counted; ``/kv/pages``' refusals and the
  ``x-aigw-kv-chain`` header equal the reference server's.
"""

import asyncio
import base64
import json
import random
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from aigw_tpu.models import kvq as jkvq
from aigw_tpu.models import llama as jllama
from aigw_tpu.tpuserve import engine as jengine
from aigw_tpu.tpuserve import kvhost as jkvhost
from aigw_tpu.tpuserve import server as jserver
from aigw_tpu.tpuserve.sampling import SamplingParams as JSampling
from aigw_tpu_torch.models import convert, kvq
from aigw_tpu_torch.models import llama as tllama
from aigw_tpu_torch.tpuserve import engine as tengine
from aigw_tpu_torch.tpuserve import kvhost as tkvhost
from aigw_tpu_torch.tpuserve import server as tserver
from aigw_tpu_torch.tpuserve.sampling import SamplingParams as TSampling

EOS = (257,)
PS = 16
#: a host page's geometry in these tests: [L, 2, page_size, Hkv, D]
PAGE = (2, 2, PS, 2, 8)


# -- the tier and the host pages ----------------------------------------------
def _pages(kind: str, shape: tuple, rng: np.random.Generator):
    """(reference page, port page) of one kind with the same content."""
    if kind == "bytes":
        b = bytes(rng.integers(0, 256, shape[0], dtype=np.uint8))
        return b, b
    if kind == "float32":
        a = rng.standard_normal(shape).astype(np.float32)
        return a, torch.from_numpy(a.copy())
    scale = rng.random(shape[:-1]).astype(np.float32)
    if kind == "int8":
        q = rng.integers(-127, 128, shape).astype(np.int8)
        return ({"q": q, "scale": scale},
                {"q": torch.from_numpy(q.copy()),
                 "scale": torch.from_numpy(scale.copy()), "dtype": "int8"})
    vals = rng.integers(-7, 8, shape)
    ref_q = vals.astype(ml_dtypes.int4)
    port_q = ref_q.view(np.uint8).copy()  # the low-nibble bytes
    return ({"q": ref_q, "scale": scale},
            {"q": torch.from_numpy(port_q),
             "scale": torch.from_numpy(scale.copy()), "dtype": "int4"})


def _tier_state(tier):
    return (tier.count, tier.bytes_used, tier.spills, tier.revives,
            tier.evictions, tier.keys())


@pytest.mark.parametrize("seed", range(8))
def test_host_tier_schedule_matches_reference(seed):
    rng = np.random.default_rng(seed)
    pick = random.Random(seed)
    kinds = [("bytes", (int(rng.integers(40, 400)),)),
             ("float32", (2, 2, 2, 2, int(rng.integers(2, 9)))),
             ("int8", (2, 2, 2, 2, 8)), ("int4", (2, 2, 4, 2, 8)),
             ("bytes", (5000,))]  # larger than any budget: refused
    pool = [_pages(*kinds[i % len(kinds)], rng) for i in range(12)]
    budget = int(rng.integers(600, 1600))
    ref, port = jkvhost.HostKVTier(budget), tkvhost.HostKVTier(budget)
    keys = [bytes([k]) * 4 for k in range(6)]
    for _ in range(160):
        op = pick.choice(["put", "put", "put", "contains", "get", "take",
                          "discard", "keys"])
        key = pick.choice(keys)
        if op == "put":
            j = pick.randrange(len(pool))
            assert port.put(key, pool[j][1]) == ref.put(key, pool[j][0])
        elif op in ("get", "take"):
            got, want = getattr(port, op)(key), getattr(ref, op)(key)
            # the same entry: its index in the pool on each side
            assert (next((j for j, p in enumerate(pool) if p[1] is got),
                         None)
                    == next((j for j, p in enumerate(pool) if p[0] is want),
                            None))
        elif op == "keys":
            assert port.keys() == ref.keys()
        else:
            assert getattr(port, op)(key) == getattr(ref, op)(key)
        assert _tier_state(port) == _tier_state(ref)
    with pytest.raises(ValueError):
        tkvhost.HostKVTier(0)


def test_host_tier_holds_its_books_under_threads():
    """Spills and revives (the engine thread) race fetches and the digest
    (server threads): more threads than cores, a short switch interval;
    afterwards the bytes and the count are those of the pages held,
    within the budget."""
    import sys

    tier = tkvhost.HostKVTier(4096)
    pages = [np.zeros(n, np.uint8) for n in (100, 300, 700, 1500)]
    errors: list = []

    def work(seed):
        pick = random.Random(seed)
        try:
            for _ in range(400):
                key = bytes([pick.randrange(16)])
                op = pick.randrange(5)
                if op < 2:
                    tier.put(key, pages[pick.randrange(len(pages))])
                elif op == 2:
                    tier.take(key)
                elif op == 3:
                    tier.get(key)
                else:
                    tier.discard(key)
                tier.keys()
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    held = dict(tier._pages)
    assert tier.count == len(held) == len(tier.keys())
    assert tier.bytes_used == sum(p.nbytes for p in held.values()) <= 4096


@pytest.mark.parametrize("kind", ["float32", "int8", "int4"])
def test_page_helpers_match_reference(kind):
    ref, port = _pages(kind, PAGE, np.random.default_rng(3))
    assert kvq.page_nbytes(port) == jkvq.page_nbytes(ref)
    for want in (PAGE, (2, 2, PS, 2, 16), (1, 2, PS, 2, 8)):
        assert kvq.page_shape_ok(port, want) == jkvq.page_shape_ok(ref, want)
    for dt in kvq.KV_DTYPES:
        assert kvq.page_matches_dtype(port, dt) \
            == jkvq.page_matches_dtype(ref, dt)


@pytest.mark.parametrize("kind", ["float32", "int8", "int4"])
def test_wire_codec_matches_reference(kind):
    ref, port = _pages(kind, PAGE, np.random.default_rng(4))
    wire = tserver.encode_wire_page(port)
    assert wire == jserver.encode_wire_page(ref)
    if kind == "int4":
        # one element per byte: the 4-bit value in the low nibble
        raw = np.frombuffer(base64.b64decode(wire["b64"]), np.uint8)
        assert raw.max() <= 15
    back = tserver.decode_wire_page(jserver.encode_wire_page(ref))
    assert tserver.encode_wire_page(back) == wire
    mine = jserver.decode_wire_page(wire)
    if kind == "float32":
        np.testing.assert_array_equal(mine, ref)
        assert back.dtype == torch.float32
    else:
        np.testing.assert_array_equal(np.asarray(mine["q"]).astype(np.int8),
                                      np.asarray(ref["q"]).astype(np.int8))
        np.testing.assert_array_equal(mine["scale"], ref["scale"])
        assert back["dtype"] == kind


def test_wire_decode_refusals_match_reference():
    good = tserver.encode_wire_page(_pages("int8", PAGE,
                                           np.random.default_rng(5))[1])
    for bad in (dict(good, dtype="int2"), dict(good, shape=[3, 3]),
                {"shape": [2]}, dict(good, b64="!!")):
        errs = []
        for mod in (jserver, tserver):
            with pytest.raises((KeyError, ValueError)) as e:
                mod.decode_wire_page(bad)
            errs.append((type(e.value), str(e.value)))
        assert errs[0] == errs[1], bad.keys()


# -- spill and revive on whole engines ----------------------------------------
CFG = dict(max_batch_size=2, max_seq_len=256, page_size=PS,
           decode_steps_per_tick=4, attention_backend="pallas-ragged",
           decode_backend="fused", ragged_chunk_tokens=24,
           ragged_max_chunks=1, enable_prefix_cache=True, num_pages=12,
           kv_host_bytes=1 << 24)
#: four prompts of 4 full pages each (distinct first pages), 5 pages
#: allocated each: the 12-page pool evicts the earlier chains as the wave
#: goes on, and again when its first two come back
WAVE = [[(7 * i + 3 * j + 1) % 450 + 1 for i in range(66)]
        for j in range(4)]
STATS = ("kv_spills", "kv_revives", "kv_spill_evictions", "kv_spilled_pages",
         "kv_spill_bytes", "kv_host_bytes", "prefix_cache_hits",
         "prefix_cache_misses", "prefix_cache_evictions",
         "prefix_tokens_reused", "prefills")


@pytest.fixture(scope="module")
def weights():
    p = jllama.init_params(jax.random.PRNGKey(0), jllama.TINY,
                           dtype=jnp.float32)
    return p, convert.params_from_numpy(
        {k: np.asarray(v) for k, v in p.items()}, device="cpu")


def _idle(eng, timeout=120.0):
    deadline = time.monotonic() + timeout
    while not (all(s is None for s in eng._slots) and eng._inflight is None
               and not eng._pending_frees and eng._queue.qsize() == 0):
        assert time.monotonic() < deadline, "engine did not go idle"
        time.sleep(0.01)
    time.sleep(0.05)


def _serve(eng, req_cls, sp_cls, prompts, max_tokens=6) -> list:
    """Serve ``prompts`` one at a time (greedy); their streams."""
    streams = []
    for prompt in prompts:
        out: list[int] = []
        done = threading.Event()

        def emit(tok, fin, out=out, done=done):
            if tok >= 0:
                out.append(tok)
            if fin is not None:
                done.set()

        eng.submit(req_cls(prompt=list(prompt), max_tokens=max_tokens,
                           sampling=sp_cls(temperature=0.0), emit=emit))
        assert done.wait(300)
        _idle(eng)
        streams.append(out)
    return streams


def _host_np(page) -> dict:
    """A host page (either side's) as numpy per leaf, q as int8 values."""
    if isinstance(page, dict):
        q = np.asarray(page["q"])
        q = (q.view(np.uint8).astype(np.int16) ^ 8) - 8 \
            if page.get("dtype") == "int4" or q.dtype.name == "int4" \
            else q.astype(np.int16)
        return {"q": q.astype(np.int8), "scale": np.asarray(page["scale"])}
    a = page.numpy() if isinstance(page, torch.Tensor) else np.asarray(page)
    return {"kv": a.astype(np.float32)}


def _assert_close_to_reference(got: dict, want: dict) -> None:
    """float32 within 1e-5; quantized q within ±1 only where the scale
    differs in its last place (the two sides' f32 K/V differ there,
    ROADMAP §3), else equal."""
    if "kv" in got:
        np.testing.assert_allclose(got["kv"], want["kv"], rtol=1e-5,
                                   atol=1e-5)
        return
    np.testing.assert_allclose(got["scale"], want["scale"], rtol=1e-5)
    dq = np.abs(got["q"].astype(np.int32) - want["q"].astype(np.int32))
    assert dq.max() <= 1
    same = got["scale"] == want["scale"]
    assert not dq[np.broadcast_to(same[..., None], dq.shape)].any()


def _run_spill(eng, req_cls, sp_cls):
    """The schedule: the wave, then its first two prompts again. Returns
    (streams, stats, every spill in order as (key, host page), [(revived
    page ids, the host pages revived into them)])."""
    revived: list = []
    spills: list = []
    port = isinstance(eng, tengine.Engine)
    put = eng.host_tier.put

    def recording_put(key, rows):
        spills.append((key, rows))
        return put(key, rows)

    eng.host_tier.put = recording_put
    if port:
        imp = eng._import_pages_dev

        def recording(page_ids, rows):
            revived.append((list(page_ids), list(rows)))
            imp(page_ids, rows)

        eng._import_pages_dev = recording
    eng.start()
    try:
        first = _serve(eng, req_cls, sp_cls, WAVE)
        again = _serve(eng, req_cls, sp_cls, WAVE[:2])
        if port:  # the reference refreshes on its engine thread
            eng.refresh_stats()
        stats = {k: getattr(eng.stats, k) for k in STATS}
        stats["kv_pages_free"] = eng.allocator.free_pages
    finally:
        eng.stop()
    return first + again, stats, spills, revived


@pytest.fixture(scope="module", params=["float32", "int8", "int4"])
def spilled(weights, request):
    jp, tp = weights
    cfg = dict(CFG, kv_cache_dtype=request.param)
    jeng = jengine.Engine(jp, jllama.TINY, jengine.EngineConfig(**cfg),
                          eos_token_ids=EOS)
    want = _run_spill(jeng, jengine.GenRequest, JSampling)
    teng = tengine.Engine(tp, tllama.TINY, tengine.EngineConfig(**cfg),
                          eos_token_ids=EOS, device="cpu")
    got = _run_spill(teng, tengine.GenRequest, TSampling)
    return request.param, want, got, teng


def test_spill_revive_counters_match_reference(spilled):
    dtype, want, got, _teng = spilled
    assert got[1] == want[1], dtype
    assert got[1]["kv_spills"] > 0 and got[1]["kv_revives"] > 0
    if dtype == "float32":  # quantized pools: pages, not streams (§3)
        assert got[0] == want[0]
        assert got[0][4:] == got[0][:2]  # the revived chains' streams


def test_revived_pages_equal_spilled_bytes(spilled):
    dtype, _want, got, teng = spilled
    _streams, _stats, spills, revived = got
    assert revived, "nothing was revived"
    for page_ids, rows in revived:
        for page_id, row in zip(page_ids, rows):
            # the row revived is a spilled page, byte for byte
            assert any(_pages_equal(row, h) for _k, h in spills)
            # and the pool holds those bytes at its page (unless the
            # page was reused since: then its key is gone)
            key = teng.prefix_cache.key_of_page(page_id)
            if key is not None:
                pool = teng._export_pages([page_id])[0]
                assert _pages_equal(pool, row), dtype


def _pages_equal(a, b) -> bool:
    if isinstance(a, dict):
        return (a["dtype"] == b["dtype"] and torch.equal(a["q"], b["q"])
                and torch.equal(a["scale"], b["scale"]))
    return torch.equal(a, b)


def test_spilled_pages_match_reference(spilled):
    dtype, want, got, _teng = spilled
    assert [k for k, _p in got[2]] == [k for k, _p in want[2]]
    for (_k, page), (_k2, ref) in zip(got[2], want[2]):
        _assert_close_to_reference(_host_np(page), _host_np(ref))
        if dtype == "int4":
            q = page["q"]
            assert q.dtype == torch.uint8 and int(q.max()) <= 15


# -- the fleet fetch over HTTP ------------------------------------------------
MODEL = "tiny-random"
SERVER_CFG = dict(max_batch_size=2, max_seq_len=256, page_size=PS,
                  kv_cache_dtype="float32", decode_steps_per_tick=4)
_SYSTEM = ("You are a careful assistant. Answer in one short sentence and "
           "never repeat the question back to the user.")


def _chat(user: str) -> dict:
    """A chat whose system message starts with the user turn's first
    word, so each test's prompt has its own first page."""
    return {"model": MODEL, "max_tokens": 8, "temperature": 0,
            "messages": [{"role": "system",
                          "content": f"{user.split()[0]} {_SYSTEM}"},
                         {"role": "user", "content": user}]}


def _http(port, path, body=None, headers=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        headers={"content-type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


@pytest.fixture(scope="module")
def reference_replica(weights):
    """The reference TPUServeServer (aiohttp, float32 weights) in a
    thread."""
    from aiohttp import web

    class F32Server(jserver.TPUServeServer):
        def _load_params(self, spec):
            return weights[0]

    holder = {}
    started = threading.Event()

    def run():
        async def main():
            server = F32Server(MODEL, jengine.EngineConfig(
                attention_backend="pallas-ragged", **SERVER_CFG))
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


@pytest.fixture(scope="module")
def port_replica(weights):
    srv = tserver.TPUServeServer(MODEL, tengine.EngineConfig(**SERVER_CFG),
                                 device="cpu", port=0, params=weights[1])
    srv.start()
    yield srv
    srv.stop()


def _state(port) -> dict:
    return json.loads(_http(port, "/state")[1])


def _chains(port, key: str, timeout: float = 10.0) -> list:
    """``/state``'s kv_chains once they hold ``key`` (the engine rebuilds
    the digest at most every 0.5 s)."""
    deadline = time.monotonic() + timeout
    while True:
        chains = _state(port)["kv_chains"]
        if key in chains or time.monotonic() > deadline:
            return chains
        time.sleep(0.1)


def _text(raw: bytes) -> str:
    return json.loads(raw)["choices"][0]["message"]["content"]


def _fetch_case(src_port, dst_port, user: str):
    """Warm the source with a chat, send the same prompt to the
    destination naming the source as a peer: (source reply, destination
    reply, source response headers, destination /state before/after)."""
    body = _chat(user)
    s_status, s_raw, s_hdr = _http(src_port, "/v1/chat/completions", body)
    assert s_status == 200
    before = _state(dst_port)
    d_status, d_raw, _ = _http(
        dst_port, "/v1/chat/completions", body,
        {"x-aigw-kv-peers": f"127.0.0.1:{src_port}"})
    assert d_status == 200
    return s_raw, d_raw, s_hdr, before, _state(dst_port)


def _prompt_len(port, user: str) -> int:
    return json.loads(_http(port, "/tokenize", _chat(user))[1])["count"]


def test_port_fetches_from_reference_replica(reference_replica,
                                             port_replica):
    ref = reference_replica["port"]
    user = "Which planet is the largest in the solar system, and why?"
    s_raw, d_raw, s_hdr, before, after = _fetch_case(
        ref, port_replica.port, user)
    n = _prompt_len(ref, user)
    assert _text(d_raw) == _text(s_raw)
    assert after["kv_fetches_in"] - before["kv_fetches_in"] == 1
    assert after["kv_fetch_pages_in"] - before["kv_fetch_pages_in"] \
        == (n - 1) // PS
    assert after["prefix_cache_hits"] - before["prefix_cache_hits"] == 1
    assert after["prefix_tokens_reused"] - before["prefix_tokens_reused"] \
        == (n - 1) // PS * PS
    assert s_hdr["x-aigw-kv-chain"] in _chains(port_replica.port,
                                                s_hdr["x-aigw-kv-chain"])
    assert _state(ref)["kv_fetches_out"] >= 1


def test_reference_fetches_from_port_replica(reference_replica,
                                             port_replica):
    ref = reference_replica["port"]
    user = "Name three rivers of South America, briefly please."
    s_raw, d_raw, s_hdr, before, after = _fetch_case(
        port_replica.port, ref, user)
    n = _prompt_len(ref, user)
    assert _text(d_raw) == _text(s_raw)
    assert after["kv_fetches_in"] - before["kv_fetches_in"] == 1
    assert after["kv_fetch_pages_in"] - before["kv_fetch_pages_in"] \
        == (n - 1) // PS
    assert _state(port_replica.port)["kv_fetches_out"] >= 1
    assert s_hdr["x-aigw-kv-chain"] in _chains(port_replica.port,
                                                s_hdr["x-aigw-kv-chain"])


def test_dead_peer_degrades_to_a_cold_prefill(reference_replica,
                                              port_replica):
    user = "What is the boiling point of water at sea level?"
    body = _chat(user)
    want = _text(_http(reference_replica["port"], "/v1/chat/completions",
                       body)[1])
    failures = port_replica.kv_fetch_failures
    before = _state(port_replica.port)
    status, raw, hdr = _http(port_replica.port, "/v1/chat/completions",
                             body, {"x-aigw-kv-peers": "127.0.0.1:1"})
    assert status == 200 and _text(raw) == want
    assert port_replica.kv_fetch_failures == failures + 1
    after = _state(port_replica.port)
    assert after["kv_fetches_in"] == before["kv_fetches_in"]
    assert after["prefix_cache_misses"] - before["prefix_cache_misses"] == 1


def test_kv_pages_route_matches_reference(reference_replica, port_replica):
    ref = reference_replica["port"]
    user = "Spell the word 'banana' backwards, one letter per line."
    _http(ref, "/v1/chat/completions", _chat(user))
    _status, _raw, hdr = _http(port_replica.port, "/v1/chat/completions",
                               _chat(user))
    keys = [hdr["x-aigw-kv-chain"], "00" * 16]
    got = json.loads(_http(port_replica.port, "/kv/pages",
                           {"keys": keys})[1])
    want = json.loads(_http(ref, "/kv/pages", {"keys": keys})[1])
    assert (got["model"], got["page_size"]) == (want["model"],
                                                want["page_size"])
    assert [p["key"] for p in got["pages"]] == [keys[0]] \
        == [p["key"] for p in want["pages"]]
    assert got["pages"][0]["shape"] == want["pages"][0]["shape"]
    np.testing.assert_allclose(
        tserver.decode_wire_page(got["pages"][0]).numpy(),
        jserver.decode_wire_page(want["pages"][0]), rtol=1e-5, atol=1e-5)
    for bad in ({}, {"keys": []}, {"keys": "ab"}, {"keys": ["zz"]},
                {"keys": ["abc"]}):
        g = _http(port_replica.port, "/kv/pages", bad)
        w = _http(ref, "/kv/pages", bad)
        assert (g[0], json.loads(g[1])) == (w[0], json.loads(w[1])), bad
