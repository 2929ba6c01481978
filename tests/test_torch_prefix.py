"""The port's prefix cache against the JAX package's.

- ``page_chain_hashes``: the port's keys equal the reference's byte for
  byte (a later cross-framework KV migration reuses them).
- A seeded admit / complete / dispatch / drain / copy-on-write /
  ``truncate_to`` schedule runs on both ``RefcountedAllocator`` +
  ``PrefixCache`` pairs (the reference's ``tests/
  test_kvcache_eviction.py`` discipline): after every step the page ids,
  refcounts, the evictable pool in LRU order, the free stack, the
  evictions, every probe and every continuation are equal.
- Whole engines: the reference ``Engine`` (``pallas-ragged``, the cache
  on; on the CPU its windowed XLA prefill) and the port's on the CPU,
  both on the reference's ``init_params(PRNGKey(0), TINY, float32)``
  weights, serve the reference's prefix-cache scenarios in turn on one
  engine each (``tests/test_tpuserve.py`` partial hit, full-hit CoW
  isolation over three identical requests, no false hits, a shared
  prefix within one burst; ``tests/test_ragged_prefill.py`` partial and
  full resume; ``tests/test_chunked_prefill.py`` cache reuse, a resume
  whose budget boundaries are not page multiples, the miss path), so the
  pool fills and evicts. After each scenario the streams are identical
  and every prefix counter and ``kv_pages_free`` are equal; over int8
  and int4 pools the copy-on-write'd page equals its source byte for
  byte (q and scales) and the pools equal the reference's under the
  scale note of ROADMAP §3.
- Speculation with the cache on: lookahead-seeded slots, drafted and
  accepted counts equal the reference's.
- The server: ``/state``'s prefix keys and the usage's ``cached_tokens``
  (streamed and not) equal the reference server's for the same requests.
"""

import asyncio
import json
import random
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aigw_tpu.models import llama as jllama
from aigw_tpu.tpuserve import engine as jengine
from aigw_tpu.tpuserve import kvcache as jkv
from aigw_tpu.tpuserve.sampling import SamplingParams as JSampling
from aigw_tpu_torch.models import convert, kvq
from aigw_tpu_torch.models import llama as tllama
from aigw_tpu_torch.tpuserve import engine as tengine
from aigw_tpu_torch.tpuserve import kvcache as tkv
from aigw_tpu_torch.tpuserve.sampling import SamplingParams as TSampling


# -- chain hashes -------------------------------------------------------------
@pytest.mark.parametrize("page_size", [1, 4, 16, 128])
def test_page_chain_hashes_match_reference(page_size):
    rng = np.random.default_rng(page_size)
    for _ in range(20):
        n = int(rng.integers(0, 5 * page_size + 3))
        prompt = rng.integers(0, 128256, n).tolist()
        want = jkv.page_chain_hashes(prompt, page_size)
        assert tkv.page_chain_hashes(prompt, page_size) == want
        assert len(want) == n // page_size
        # resumed from an already hashed prefix
        if want:
            cut = len(want) // 2 * page_size
            prev = want[cut // page_size - 1] if cut else b""
            assert tkv.page_chain_hashes(prompt[cut:], page_size, prev) \
                == jkv.page_chain_hashes(prompt[cut:], page_size, prev) \
                == want[cut // page_size:]


# -- the allocator and cache under a randomized schedule ----------------------
PS = 4


def _prompt_pool(rng: random.Random) -> list[list[int]]:
    """Prompts sharing page-aligned heads (adoption, full hits) and
    unique ones (insertion, eviction)."""
    heads = [[rng.randrange(1, 50) for _ in range(PS * 2)]
             for _ in range(3)]
    pool = []
    for h in heads:
        pool.append(list(h))  # page-aligned: a full hit once cached
        for _ in range(3):
            tail_len = rng.choice([3, PS, PS * 2 + 1])
            pool.append(h + [rng.randrange(50, 99)
                             for _ in range(tail_len)])
    for _ in range(4):
        pool.append([rng.randrange(100, 199)
                     for _ in range(rng.randrange(PS, PS * 4))])
    return pool


def _snapshot(alloc, cache, pool, live):
    return dict(
        pages={sid: list(alloc.pages(sid)) for sid in live},
        refs=dict(sorted(alloc._refs.items())),
        evictable=list(alloc._evictable.items()),
        free=list(alloc._free),
        telemetry=(alloc.free_pages, alloc.used_pages, alloc.occupancy,
                   alloc.available_pages, alloc.pinned_cached_pages),
        cache=(cache.evictions, cache.resident_entries),
        probes=[cache.probe(cache.chain_keys(p)) for p in pool],
        conts=[cache.continuation(cache.chain_keys(p)) for p in pool],
        keys=[cache.key_of_page(p) for p in range(alloc.num_pages)])


class _Side:
    """One package's allocator + cache, driven by the schedule."""

    def __init__(self, mod):
        self.mod = mod
        self.alloc = mod.RefcountedAllocator(num_pages=20, page_size=PS)
        self.cache = mod.PrefixCache(self.alloc, PS)

    def admit(self, sid, prompt, total):
        """The engine's adoption: returns (pages, cow pairs) or "oop"."""
        alloc, cache = self.alloc, self.cache
        chain = cache.chain_keys(prompt)
        hit = cache.probe(chain)
        hits = min(len(hit), len(prompt) // PS)
        full = hits > 0 and hits * PS == len(prompt)
        cached = hit[:hits]
        cows = []
        try:
            if cached:
                alloc.adopt(sid, cached)
                extra = alloc.pages_for(total) - len(cached)
                if extra > 0:
                    alloc.allocate_extra(sid, extra)
                if full:
                    cows.append((cached[-1],
                                 alloc.cow_page(sid, cached[-1])))
            else:
                alloc.allocate(sid, total)
        except self.mod.OutOfPagesError:
            alloc.free(sid)
            return "oop"
        cache.insert(chain, alloc.pages(sid), tokens=prompt)
        return list(alloc.pages(sid)), cows

    def truncate(self, sid, n):
        try:
            return self.alloc.truncate_to(sid, n)
        except self.mod.OutOfPagesError:
            return "oop"


@pytest.mark.parametrize("trial", range(6))
def test_randomized_schedule_matches_reference(trial):
    rng = random.Random(2000 + trial)
    pool = _prompt_pool(rng)
    ref, port = _Side(jkv), _Side(tkv)
    seq_ids = iter(range(10_000))
    live: dict[int, list[int]] = {}
    pending_frees: list[int] = []
    inflight: list[int] | None = None
    swapped = 0
    for step in range(400):
        op = rng.random()
        if op < 0.45:  # admit
            prompt = rng.choice(pool)
            sid = next(seq_ids)
            total = len(prompt) + rng.randrange(1, 6)
            got = port.admit(sid, prompt, total)
            assert got == ref.admit(sid, prompt, total), step
            if got != "oop":
                live[sid] = prompt
        elif op < 0.60 and live:  # complete: the free is deferred
            sid = rng.choice(list(live))
            del live[sid]
            pending_frees.append(sid)
        elif op < 0.70 and live:  # the speculative write invariant
            sid = rng.choice(list(live))
            n = rng.randrange(0, len(live[sid]) + 1)
            swaps = port.truncate(sid, n)
            assert swaps == ref.truncate(sid, n), step
            swapped += swaps not in ([], "oop")
        elif op < 0.85:  # dispatch a window: it captures the frees
            if inflight is None:
                inflight, pending_frees = pending_frees, []
        elif inflight is not None:  # drain the window: apply its frees
            for sid in inflight:
                port.alloc.free(sid)
                ref.alloc.free(sid)
            inflight = None
        assert _snapshot(port.alloc, port.cache, pool, live) == _snapshot(
            ref.alloc, ref.cache, pool, live), step
    for sid in list(live) + pending_frees + (inflight or []):
        port.alloc.free(sid)
        ref.alloc.free(sid)
    assert _snapshot(port.alloc, port.cache, pool, {}) == _snapshot(
        ref.alloc, ref.cache, pool, {})
    assert port.alloc.available_pages == port.alloc.num_pages
    # the schedule reclaimed parked pages and swapped shared tail pages
    assert port.cache.evictions > 0 and swapped > 0


def test_without_a_cache_pages_return_to_the_free_stack():
    a = tkv.RefcountedAllocator(num_pages=4, page_size=8)
    a.allocate(0, 16)
    a.adopt(1, a.pages(0))
    assert a.truncate_to(1, 8) == [(a.pages(0)[1], a.pages(1)[1], False)]
    a.free(0)
    a.free(1)
    assert a.free_pages == 4 and not a._evictable
    assert a.pinned_cached_pages == 0


# -- whole engines ------------------------------------------------------------
EOS = (257,)
CFG = dict(max_batch_size=2, max_seq_len=256, page_size=16,
           decode_steps_per_tick=4, attention_backend="pallas-ragged",
           decode_backend="fused", ragged_chunk_tokens=24,
           ragged_max_chunks=1, enable_prefix_cache=True)
COUNTERS = ("prefix_cache_hits", "prefix_cache_misses", "prefix_full_hits",
            "prefix_cow_copies", "prefix_tokens_reused",
            "prefix_cache_evictions", "prefills")


def _seq(a, b, n, mod=450):
    return [(a * i + b) % mod + 1 for i in range(n)]


#: scenario → (requests submitted together, or one at a time), each
#: request (prompt, max_tokens). Every scenario's prompts start with
#: their own first page, so no scenario hits another's pages; the pool
#: (32 pages) fills and evicts as they accumulate.
_SHARED = list(range(10, 50))  # 40 tokens: 2 full pages
_BASE = _seq(13, 4, 96)  # 6 pages
_HEAD = _seq(5, 11, 64)  # 4 pages
SCENARIOS = {
    # tests/test_tpuserve.py:732: the duplicate of a burst goes through
    # the per-request path and adopts the pages its batch-mate inserted
    "same_burst": ("burst", [(_SHARED, 5), (_SHARED, 5), ([7] * 8, 5)]),
    # tests/test_tpuserve.py:419: a partial hit, then a diverging tail
    "partial_hit": ("serial", [(list(range(1, 40)) + [100], 4),
                               (list(range(1, 40)) + [100], 4),
                               (list(range(1, 40)) + [200, 201], 4)]),
    # tests/test_tpuserve.py:441: three identical page-aligned prompts,
    # the second and third full hits whose CoW'd page isolates the
    # writer
    "full_hit_cow": ("serial", [(_seq(11, 5, 64, 250), 4)] * 3),
    # tests/test_tpuserve.py:461
    "no_false_hits": ("serial", [([3] * 33, 2), ([2] * 33, 2)]),
    # tests/test_ragged_prefill.py:136: a partial resume, then an exact
    # re-ask (the 1-token full-hit resume)
    "ragged_partial_full": ("serial", [(_BASE, 5),
                                       (_BASE[:64] + _seq(7, 3, 12), 5),
                                       (_BASE, 5)]),
    # tests/test_chunked_prefill.py:190: the repeat prefills only its
    # tail
    "chunked_reuse": ("serial", [(_seq(5, 1, 140), 6)] * 2),
    # tests/test_chunked_prefill.py:257: a 64-token head, then 76 tokens
    # resumed in budget calls ending at 88, 112, 136 (not page multiples)
    "partial_offset_chunked": ("serial", [(_HEAD + _seq(3, 7, 76), 6),
                                          (_HEAD + _seq(9, 2, 76), 6)]),
    # tests/test_chunked_prefill.py:271
    "miss_path": ("serial", [(_seq(7, 1, 70, 400), 6),
                             (_seq(7, 2, 70, 400), 6)]),
}
#: the scenarios also served over int8 and int4 pools
QUANT_SCENARIOS = ("partial_hit", "full_hit_cow")


@pytest.fixture(scope="module")
def weights():
    p = jllama.init_params(jax.random.PRNGKey(0), jllama.TINY,
                           dtype=jnp.float32)
    return p, convert.params_from_numpy(
        {k: np.asarray(v) for k, v in p.items()}, device="cpu")


def _idle(eng, timeout=120.0):
    """Wait until the engine has settled every window and page free."""
    deadline = time.monotonic() + timeout
    while not (all(s is None for s in eng._slots) and eng._inflight is None
               and not eng._pending_frees and eng._queue.qsize() == 0):
        assert time.monotonic() < deadline, "engine did not go idle"
        time.sleep(0.01)
    time.sleep(0.05)


def _submit(eng, req_cls, sp_cls, prompt, max_tokens, out, done, **sp):
    def emit(tok, fin):
        if tok >= 0:
            out.append(tok)
        if fin is not None:
            done.set()

    eng.submit(req_cls(prompt=prompt, max_tokens=max_tokens,
                       sampling=sp_cls(temperature=0.0, **sp), emit=emit))


def _serve_scenarios(eng, req_cls, sp_cls, names) -> dict:
    """Serve the scenarios in order on one engine (a "burst" scenario
    first, submitted before the loop starts so the whole burst is one
    admission pass). Returns scenario → (streams, counters, free
    pages, CoW pairs, page snapshot)."""
    cows: list[tuple[int, int]] = []
    copy = eng._copy_page_dev

    def recording_copy(src, dst):
        cows.append((src, dst))
        copy(src, dst)

    eng._copy_page_dev = recording_copy
    out = {}
    started = False
    try:
        for name in names:
            mode, reqs = SCENARIOS[name]
            streams = [[] for _ in reqs]
            if mode == "burst":
                assert not started
                dones = [threading.Event() for _ in reqs]
                for (prompt, mt), s, d in zip(reqs, streams, dones):
                    _submit(eng, req_cls, sp_cls, prompt, mt, s, d)
                eng.start()
                started = True
                assert all(d.wait(300) for d in dones)
            else:
                if not started:
                    eng.start()
                    started = True
                for (prompt, mt), s in zip(reqs, streams):
                    d = threading.Event()
                    _submit(eng, req_cls, sp_cls, prompt, mt, s, d)
                    assert d.wait(300), name
            _idle(eng)
            assert eng.healthy, eng.last_error
            out[name] = dict(
                streams=streams,
                counters={k: getattr(eng.stats, k) for k in COUNTERS},
                free=eng.allocator.free_pages, cows=list(cows),
                pages=_cow_pages(eng, cows[-1]) if cows else None)
            cows.clear()
    finally:
        eng.stop()
    return out


def _cow_pages(eng, pair):
    """(source page, copy) rows of a CoW pair as numpy, per leaf."""
    src, dst = pair
    ps = eng.cfg.page_size
    kv = eng.kv_cache
    leaves = kv.items() if isinstance(kv, dict) else [("kv", kv)]
    snap = {}
    for name, leaf in leaves:
        # copies: the port's numpy view would follow later writes
        a = np.array(leaf[:, :, src * ps:(src + 1) * ps])
        b = np.array(leaf[:, :, dst * ps:(dst + 1) * ps])
        snap[name] = (a, b)
    return snap


def _run_both(weights, kv_dtype, names):
    jp, tp = weights
    jeng = jengine.Engine(jp, jllama.TINY,
                          jengine.EngineConfig(**CFG, kv_cache_dtype=kv_dtype),
                          eos_token_ids=EOS)
    assert jeng.prefix_cache is not None
    want = _serve_scenarios(jeng, jengine.GenRequest, JSampling, names)
    teng = tengine.Engine(tp, tllama.TINY,
                          tengine.EngineConfig(**CFG, kv_cache_dtype=kv_dtype),
                          eos_token_ids=EOS, device="cpu")
    got = _serve_scenarios(teng, tengine.GenRequest, TSampling, names)
    return want, got, jeng, teng


@pytest.fixture(scope="module")
def served_f32(weights):
    return _run_both(weights, "float32", list(SCENARIOS))


@pytest.fixture(scope="module", params=["int8", "int4"])
def served_quant(weights, request):
    return request.param, _run_both(weights, request.param, QUANT_SCENARIOS)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_engine_scenario_matches_reference(served_f32, name):
    want, got, _, _ = served_f32
    w, g = want[name], got[name]
    assert g["streams"] == w["streams"]
    assert g["counters"] == w["counters"]
    assert g["free"] == w["free"]
    assert g["cows"] == w["cows"]


def test_engine_scenarios_hit_as_the_reference_tests_expect(served_f32):
    """The reference tests' own expectations hold on the port: hit
    counts, reused tokens, full hits, and evictions under the filled
    pool."""
    _, got, _, teng = served_f32

    def delta(name, key):
        names = list(SCENARIOS)
        i = names.index(name)
        before = got[names[i - 1]]["counters"][key] if i else 0
        return got[name]["counters"][key] - before

    assert delta("same_burst", "prefix_cache_hits") == 1
    assert got["same_burst"]["streams"][0] == got["same_burst"]["streams"][1]
    assert delta("partial_hit", "prefix_cache_hits") == 2
    s = got["partial_hit"]["streams"]
    assert s[0] == s[1]
    assert delta("full_hit_cow", "prefix_full_hits") == 2
    assert delta("full_hit_cow", "prefix_cow_copies") == 2
    assert delta("full_hit_cow", "prefix_tokens_reused") == 126
    s = got["full_hit_cow"]["streams"]
    assert s[0] == s[1] == s[2]
    assert delta("no_false_hits", "prefix_cache_hits") == 0
    assert delta("ragged_partial_full", "prefix_cache_hits") == 2
    assert delta("ragged_partial_full", "prefix_full_hits") == 1
    assert delta("chunked_reuse", "prefix_tokens_reused") == 128
    assert delta("partial_offset_chunked", "prefix_tokens_reused") == 64
    assert delta("miss_path", "prefix_cache_misses") == 2
    assert delta("miss_path", "prefix_cache_hits") == 0
    assert got["miss_path"]["counters"]["prefix_cache_evictions"] > 0
    st = teng.stats
    assert st.prefix_cache_hit_rate == pytest.approx(
        st.prefix_cache_hits / (st.prefix_cache_hits
                                + st.prefix_cache_misses))


def _assert_pages_equal_reference(got, want):
    """Port pages (the CoW pair's source and copy) against the
    reference's: float32 within 1e-5; a quantized page byte for byte
    except where a scale differs in its last place (the two sides' f32
    K/V differ there, ROADMAP §3), and there q within ±1."""
    if "kv" in got:
        for a, b in zip(got["kv"], want["kv"]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        return
    for j in (0, 1):  # source page, copy
        tq = kvq.int_values(torch.from_numpy(got["q"][j])).numpy()
        jq = np.asarray(want["q"][j]).astype(np.int8)
        ts, js = got["scale"][j], np.asarray(want["scale"][j])
        np.testing.assert_allclose(ts, js, rtol=1e-5)
        dq = np.abs(tq.astype(np.int32) - jq.astype(np.int32))
        assert dq.max() <= 1
        assert not dq[np.broadcast_to((ts == js)[..., None], dq.shape)].any()


def _assert_cow_copy(pages):
    """The copy equals its source byte for byte on every row the resume
    did not rewrite (all but the page's last, position n - 1)."""
    for a, b in pages.values():
        np.testing.assert_array_equal(b[:, :, :-1], a[:, :, :-1])


def test_full_hit_copy_is_byte_equal(served_f32):
    want, got, _, _ = served_f32
    _assert_cow_copy(got["full_hit_cow"]["pages"])
    _assert_cow_copy(want["full_hit_cow"]["pages"])
    _assert_pages_equal_reference(got["full_hit_cow"]["pages"],
                                  want["full_hit_cow"]["pages"])


@pytest.mark.parametrize("name", QUANT_SCENARIOS)
def test_quantized_pool_scenario_matches_reference(served_quant, name):
    qdt, (want, got, _, _) = served_quant
    w, g = want[name], got[name]
    assert g["streams"] == w["streams"], qdt
    assert g["counters"] == w["counters"]
    assert g["free"] == w["free"]
    assert g["cows"] == w["cows"]
    if name == "full_hit_cow":
        # q and scales of the CoW'd page equal their source's
        _assert_cow_copy(g["pages"])
        _assert_cow_copy(w["pages"])
        _assert_pages_equal_reference(g["pages"], w["pages"])


# -- speculation's lookahead drafts -------------------------------------------
def _spec_serve(eng, req_cls, sp_cls, reqs):
    out = []
    eng.start()
    try:
        for prompt, mt in reqs:
            toks, d = [], threading.Event()
            _submit(eng, req_cls, sp_cls, prompt, mt, toks, d)
            assert d.wait(300)
            out.append(toks)
            _idle(eng)
        assert eng.healthy, eng.last_error
    finally:
        eng.stop()
    keys = ("spec_lookahead_slots", "spec_drafted", "spec_accepted",
            "decode_steps") + COUNTERS
    return out, {k: getattr(eng.stats, k) for k in keys}


def test_speculation_lookahead_matches_reference(weights):
    """The reference's ``test_continuation_lookahead_used_end_to_end``
    and a repeated prompt (``tests/test_spec_decode.py``'s speculation x
    prefix-cache interplay): a long prompt teaches the radix chain its
    continuation, a shorter one sharing its head gets the lookahead
    draft source, the long one again full-hits. Streams and the
    lookahead-seeded slots, drafted and accepted counts equal the
    reference Engine's at draft width 3."""
    jp, tp = weights
    long_p = [(i * 7) % 150 + 1 for i in range(48)]
    reqs = [(long_p, 4), (long_p[:21], 10), (long_p, 12),
            (long_p[:33], 10)]
    cfg = dict(CFG, kv_cache_dtype="float32", spec_tokens=3)
    jeng = jengine.Engine(jp, jllama.TINY, jengine.EngineConfig(**cfg),
                          eos_token_ids=EOS)
    want = _spec_serve(jeng, jengine.GenRequest, JSampling, reqs)
    teng = tengine.Engine(tp, tllama.TINY, tengine.EngineConfig(**cfg),
                          eos_token_ids=EOS, device="cpu")
    got = _spec_serve(teng, tengine.GenRequest, TSampling, reqs)
    assert got == want
    assert got[1]["spec_lookahead_slots"] >= 1
    assert got[1]["spec_drafted"] > 0 and got[1]["prefix_full_hits"] == 1


# -- the server ---------------------------------------------------------------
MODEL = "tiny-random"
SERVER_CFG = dict(max_batch_size=2, max_seq_len=256, page_size=16)
_SYSTEM = ("You are a careful assistant. Answer in one short sentence and "
           "never repeat the question back to the user.")
#: (path, body): a shared system message over two user turns (the second
#: streamed with its usage chunk), then a page-aligned completion sent
#: twice (a full hit: n - 1 tokens cached)
SERVER_REQS = [
    ("/v1/chat/completions", {"messages": [
        {"role": "system", "content": _SYSTEM},
        {"role": "user", "content": "What is a page table?"}]}),
    ("/v1/chat/completions", {"messages": [
        {"role": "system", "content": _SYSTEM},
        {"role": "user", "content": "Why cache a prompt prefix?"}],
        "stream": True, "stream_options": {"include_usage": True}}),
    ("/v1/completions", {"prompt": "x" * 63}),
    ("/v1/completions", {"prompt": "x" * 63, "stream": True,
                         "stream_options": {"include_usage": True}}),
]
STATE_KEYS = ("prefix_cache_hit_rate", "prefix_pages_resident",
              "prefix_pages_pinned", "prefix_bytes_pinned",
              "prefix_cache_hits", "prefix_cache_misses",
              "prefix_cache_evictions")


def _http(port, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        headers={"content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.read().decode()


def _usage(raw: str, stream: bool) -> dict:
    if not stream:
        return json.loads(raw)["usage"]
    frames = [ln[6:] for ln in raw.split("\n") if ln.startswith("data: ")]
    assert frames[-1] == "[DONE]"
    return json.loads(frames[-2])["usage"]


def _drive(port) -> tuple[list, dict]:
    usages = []
    for path, body in SERVER_REQS:
        body = dict(body, model=MODEL, max_tokens=4, temperature=0)
        u = _usage(_http(port, path, body), body.get("stream", False))
        usages.append({"prompt_tokens": u["prompt_tokens"],
                       "prompt_tokens_details": u.get(
                           "prompt_tokens_details")})
    deadline = time.monotonic() + 60
    while True:  # the last request's pages are freed after its reply
        state = json.loads(_http(port, "/state"))
        if state["prefix_pages_pinned"] == 0 \
                or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    return usages, {k: state[k] for k in STATE_KEYS}


@pytest.fixture(scope="module")
def reference_server_run():
    """The reference TPUServeServer (aiohttp) in a thread, driven with
    the same requests."""
    from aiohttp import web

    from aigw_tpu.tpuserve.server import TPUServeServer as JServer

    holder = {}
    started = threading.Event()

    def run():
        async def main():
            server = JServer(MODEL, jengine.EngineConfig(
                attention_backend="pallas-ragged", **SERVER_CFG))
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


def test_server_prefix_surface_matches_reference(reference_server_run):
    from aigw_tpu_torch.tpuserve.server import TPUServeServer

    srv = TPUServeServer(MODEL, tengine.EngineConfig(**SERVER_CFG),
                         device="cpu", port=0)
    srv.start()
    try:
        got = _drive(srv.port)
        state = json.loads(_http(srv.port, "/state"))
    finally:
        srv.stop()
    assert got == reference_server_run
    usages, prefix = got
    # the second turn reuses the system message's full pages; the
    # repeated completion everything but its last token
    assert usages[1]["prompt_tokens_details"]["cached_tokens"] % 16 == 0
    assert usages[1]["prompt_tokens_details"]["cached_tokens"] >= 16
    assert usages[3]["prompt_tokens_details"] == {"cached_tokens": 63}
    assert usages[0]["prompt_tokens_details"] is None
    assert prefix["prefix_cache_hits"] == 2
    assert state["enable_prefix_cache"] is True
    assert state["prefix_full_hits"] == state["prefix_cow_copies"] == 1


@pytest.mark.parametrize("argv,want", [([], True),
                                       (["--no-prefix-cache"], False)])
def test_cli_prefix_cache_flag(argv, want):
    """The cache is on by default; ``--no-prefix-cache`` turns it off,
    as the reference's flag does."""
    from aigw_tpu_torch.cli import build_parser, engine_config

    args = build_parser().parse_args(
        ["tpuserve", "--model", MODEL, "--device", "cpu", *argv])
    assert engine_config(args).enable_prefix_cache is want
