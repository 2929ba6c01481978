"""The reference's default programs in the port: the bucketed prefill
(``prefill``, ``prefill_suffix``), the gather decode rung
(``decode_step(attn_impl="")``), the bucket ladder and the
``xla-bucketed`` backend, against the JAX package's.

Weights are the reference's ``init_params(PRNGKey(0), cfg, float32)``
(W8A16 / W4A16 where a case says so) carried across by
``models/convert.py``; tokens are made from a numpy seed. Both sides run
on the CPU: the reference's dense XLA programs, the port's plain
PyTorch ones. Logits and pooled vectors agree within ``LOGIT_TOL``,
written pool rows within ``POOL_TOL`` (quantized rows byte for byte up
to a one-ulp scale, as in ``test_torch_model.py``); MoE routing tapes
are equal.

The engine cases serve the same traffic on a port and a reference
``Engine(EngineConfig(...))`` at the defaults (``xla-bucketed`` prefill
with ``prefill_chunk_tokens`` chunking, the gather rung), float32 pools:
streams token for token (a greedy divergence only at a near-tie, as in
``test_torch_engine.py``), and the prefill counters equal.
"""

import contextlib
import dataclasses
import io
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aigw_tpu.models import kvq as jkvq
from aigw_tpu.models import llama as jllama
from aigw_tpu.models import mixtral as jmixtral
from aigw_tpu.models import quant as jquant
from aigw_tpu.tpuserve import engine as jengine
from aigw_tpu.tpuserve.sampling import SamplingParams as JSampling
from aigw_tpu_torch.models import convert, kvq
from aigw_tpu_torch.models import llama as tllama
from aigw_tpu_torch.models import mixtral as tmixtral
from aigw_tpu_torch.models.registry import family_fns
from aigw_tpu_torch.tpuserve import engine as tengine
from aigw_tpu_torch.tpuserve.sampling import SamplingParams as TSampling

LOGIT_TOL = 1e-4
POOL_TOL = 1e-5
PS = 8  # page size of the module cases
#: 128-aligned widths, so W8A16 matrices at M <= 64 reach K6 on both
#: sides (the reference's interpret-mode kernel, the port's plain one)
JCFG = jllama.LlamaConfig(vocab_size=512, dim=128, n_layers=2, n_heads=4,
                          n_kv_heads=2, ffn_dim=256, max_seq_len=256,
                          rope_theta=10000.0)
TCFG = tllama.LlamaConfig(**dataclasses.asdict(JCFG))
#: (weight mode, pool dtype) of the module cases. W8A16 weights meet a
#: float32 pool: over an int8 pool the gathered rows are bf16, so the
#: attention output rounds to bf16 before K6 multiplies it, and the two
#: sides' float32 noise (~1e-6, K6 summing in another order) can flip
#: that rounding by one bf16 ulp, which the layers carry to ~3e-3 in the
#: logits; the same rounding holds the bf16 rungs on the card to their
#: bf16 tolerance (``chip_smoke.py``)
POOLS = {"float32": ("", "float32"), "w8a16": ("int8", "float32"),
         "int8": ("", "int8"), "int4": ("int4", "int4")}


def _weights(wmode=""):
    p = jllama.init_params(jax.random.PRNGKey(0), JCFG, dtype=jnp.float32)
    if wmode:
        p = jquant.quantize_params(p, mode=wmode)
    return p, convert.params_from_numpy(
        {k: np.asarray(v) for k, v in p.items()}, device="cpu")


def _pools(cfg, qdt, n_pages=24):
    shape = (cfg.n_layers, 2, (n_pages + 1) * PS, cfg.n_kv_heads,
             cfg.head_dim)
    return (jkvq.make_pool(shape, qdt),
            kvq.make_pool(shape, qdt, torch.device("cpu")))


def _assert_pools_close(tkv, jkv):
    """Pools outside the dump page (the reference drops padding writes,
    the port parks them there): native rows within ``POOL_TOL``;
    quantized rows byte for byte except where a scale differs in its
    last place, and there q within +-1 and scales within rtol 1e-5."""
    got = convert.pool_to_numpy(tkv)
    if not isinstance(got, dict):
        n = got.shape[2] - PS
        np.testing.assert_allclose(got[:, :, :n], np.asarray(jkv)[:, :, :n],
                                   rtol=POOL_TOL, atol=POOL_TOL)
        return
    n = got["q"].shape[2] - PS
    jq = np.asarray(jkv["q"]).astype(np.int8)[:, :, :n]
    js = np.asarray(jkv["scale"])[:, :, :n]
    tq, ts = got["q"][:, :, :n], got["scale"][:, :, :n]
    np.testing.assert_allclose(ts, js, rtol=1e-5)
    dq = np.abs(tq.astype(np.int32) - jq.astype(np.int32))
    assert dq.max() <= 1
    assert not dq[ts == js].any()


def _close(got, want, rows=None):
    got, want = got.numpy(), np.asarray(want)
    if rows is not None:
        got, want = got[rows], want[rows]
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


# -- the model entry points ---------------------------------------------------
@pytest.mark.parametrize("pool", sorted(POOLS))
def test_bucketed_programs_match_jax(pool):
    """A [4, 16] bucketed prefill (one padding row of length 0), a
    prefill_suffix resuming sequence 0 at the non-page-aligned position
    11 over its power-of-two page window, then four gather decode steps
    with an inactive slot: logits within 1e-4 at every call, the pool's
    written rows as ``_assert_pools_close``."""
    wmode, qdt = POOLS[pool]
    jp, tp = _weights(wmode)
    rng = np.random.default_rng(3)
    B, S, max_pages = 4, 16, 6
    lens = np.array([11, 16, 5, 0], np.int32)
    tokens = rng.integers(0, JCFG.vocab_size, (B, S)).astype(np.int32)
    pt = rng.permutation(24)[:B * max_pages].reshape(B, max_pages).astype(
        np.int32)
    jkv, tkv = _pools(JCFG, qdt)
    jl, jkv = jllama.prefill(jp, JCFG, *_j(tokens, lens), jkv, *_j(pt), PS)
    tl, tkv = tllama.prefill(tp, TCFG, *_t(tokens, lens), tkv, *_t(pt), PS)
    _close(tl, jl, lens > 0)
    _assert_pools_close(tkv, jkv)

    # sequence 0 continues: 13 more tokens at position 11 in a 16-wide
    # rung, over a 4-page window
    suffix = np.zeros((1, 16), np.int32)
    suffix[0, :13] = rng.integers(0, JCFG.vocab_size, 13)
    pre, total = np.array([11], np.int32), np.array([24], np.int32)
    win = pt[:1, :4]
    jl, jkv = jllama.prefill_suffix(jp, JCFG, *_j(suffix, pre, total), jkv,
                                    *_j(win), PS)
    tl, tkv = tllama.prefill_suffix(tp, TCFG, *_t(suffix, pre, total), tkv,
                                    *_t(win), PS)
    _close(tl, jl)
    _assert_pools_close(tkv, jkv)

    toks = rng.integers(0, JCFG.vocab_size, B).astype(np.int32)
    pos = np.array([24, 16, 5, 0], np.int32)
    active = np.array([True, True, True, False])
    for _ in range(4):
        jl, jkv = jllama.decode_step(jp, JCFG, *_j(toks, pos), jkv,
                                     *_j(pt), PS, *_j(active), attn_impl="")
        tl, tkv = tllama.decode_step(tp, TCFG, *_t(toks, pos), tkv,
                                     *_t(pt), PS, *_t(active), attn_impl="")
        _close(tl, jl, active)
        toks = np.where(active, np.argmax(np.asarray(jl), -1),
                        toks).astype(np.int32)
        pos = np.where(active, pos + 1, pos).astype(np.int32)
    _assert_pools_close(tkv, jkv)


def test_gather_rung_equals_fused_rung():
    """The gather rung and the fused rung compute the same step: over one
    float32 pool prefilled once, four steps each, logits within 1e-4
    and the pools' allocatable rows within 1e-5."""
    _, tp = _weights()
    rng = np.random.default_rng(5)
    lens = np.array([9, 14], np.int32)
    tokens = rng.integers(0, JCFG.vocab_size, (2, 16)).astype(np.int32)
    pt = np.arange(12, dtype=np.int32).reshape(2, 6)
    _, kv = _pools(JCFG, "float32")
    _, kv = tllama.prefill(tp, TCFG, *_t(tokens, lens), kv, *_t(pt), PS)
    out = {}
    for rung in ("", "fused"):
        pool = kv.clone()
        toks, pos = tokens[:, 0].copy(), lens.copy()
        logits = []
        for _ in range(4):
            tl, pool = tllama.decode_step(
                tp, TCFG, *_t(toks, pos), pool, *_t(pt), PS,
                torch.ones(2, dtype=torch.bool), attn_impl=rung)
            logits.append(tl)
            toks = tl.argmax(-1).to(torch.int32).numpy()
            pos = pos + 1
        out[rung] = (torch.stack(logits), pool)
    _close(out[""][0], out["fused"][0].numpy())
    np.testing.assert_allclose(out[""][1][:, :, :-PS].numpy(),
                               out["fused"][1][:, :, :-PS].numpy(),
                               rtol=POOL_TOL, atol=POOL_TOL)


@pytest.mark.parametrize("wmode", ["", "int8"])
def test_hidden_states_matches_jax(wmode):
    """Mean-pooled hidden states of a [3, 16] block with an empty row
    (pooled to zeros, the ``max(count, 1)`` divisor): within 1e-4."""
    jp, tp = _weights(wmode)
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, JCFG.vocab_size, (3, 16)).astype(np.int32)
    lens = np.array([16, 7, 0], np.int32)
    want = jllama.hidden_states(jp, JCFG, *_j(tokens, lens))
    got = tllama.hidden_states(tp, TCFG, *_t(tokens, lens))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 128)
    _close(got, want)
    assert not got[2].any()


def test_mixtral_bucketed_programs_match_jax():
    """The Mixtral family's prefill, prefill_suffix and gather decode
    with ``moe_stats=True``: logits within 1e-4 and each call's [L, E +
    1] routing tape equal row for row, in float32; ``hidden_states``
    within 1e-4 and without a tape."""
    jcfg = jmixtral.TINY_MOE
    tcfg = tmixtral.MixtralConfig(**dataclasses.asdict(jcfg))
    jp = jmixtral.init_params(jax.random.PRNGKey(7), jcfg, jnp.float32)
    tp = convert.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                   device="cpu")
    rng = np.random.default_rng(13)
    lens = np.array([13, 6], np.int32)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    pt = rng.permutation(24)[:12].reshape(2, 6).astype(np.int32)
    jkv, tkv = _pools(jcfg, "float32")
    jl, jkv, jm = jmixtral.prefill(jp, jcfg, *_j(tokens, lens), jkv,
                                   *_j(pt), PS, moe_stats=True)
    tl, tkv, tm = tmixtral.prefill(tp, tcfg, *_t(tokens, lens), tkv,
                                   *_t(pt), PS, moe_stats=True)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    _close(tl, jl)
    suffix = rng.integers(0, jcfg.vocab_size, (1, 8)).astype(np.int32)
    pre, total = np.array([13], np.int32), np.array([19], np.int32)
    jl, jkv, jm = jmixtral.prefill_suffix(
        jp, jcfg, *_j(suffix, pre, total), jkv, *_j(pt[:1, :4]), PS,
        moe_stats=True)
    tl, tkv, tm = tmixtral.prefill_suffix(
        tp, tcfg, *_t(suffix, pre, total), tkv, *_t(pt[:1, :4]), PS,
        moe_stats=True)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    _close(tl, jl)
    toks = np.array([3, 4], np.int32)
    pos = np.array([19, 6], np.int32)
    active = np.array([True, False])
    jl, jkv, jm = jmixtral.decode_step(jp, jcfg, *_j(toks, pos), jkv,
                                       *_j(pt), PS, *_j(active),
                                       attn_impl="", moe_stats=True)
    tl, tkv, tm = tmixtral.decode_step(tp, tcfg, *_t(toks, pos), tkv,
                                       *_t(pt), PS, *_t(active),
                                       attn_impl="", moe_stats=True)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    _close(tl, jl, active)
    _assert_pools_close(tkv, jkv)
    want = jmixtral.hidden_states(jp, jcfg, *_j(tokens, lens))
    got = tmixtral.hidden_states(tp, tcfg, *_t(tokens, lens))
    _close(got, want)
    fns = family_fns("mixtral")
    assert (fns.prefill, fns.prefill_suffix, fns.hidden_states) == (
        tmixtral.prefill, tmixtral.prefill_suffix, tmixtral.hidden_states)


# -- the bucket ladder --------------------------------------------------------
@pytest.mark.parametrize("rungs", [1, 2, 4])
def test_bucket_ladder_equals_reference(rungs):
    """``_prefill_bucket(n)`` for every n in 1..max_seq_len, with a
    ``min_prefill_bucket`` (24) that divides neither ``max_seq_len``
    (208) nor the octaves' caps: the reference engine's values (both
    called on their configs, no engine built)."""
    from types import SimpleNamespace

    kw = dict(max_seq_len=208, page_size=16, min_prefill_bucket=24,
              prefill_bucket_rungs=rungs)
    j = SimpleNamespace(cfg=jengine.EngineConfig(**kw))
    t = SimpleNamespace(cfg=tengine.EngineConfig(**kw))
    got = [tengine.Engine._prefill_bucket(t, n) for n in range(1, 209)]
    want = [jengine.Engine._prefill_bucket(j, n) for n in range(1, 209)]
    assert got == want
    assert max(got) == 208 and min(got) == 24
    with pytest.raises(ValueError, match="prefill_bucket_rungs"):
        tengine.EngineConfig(prefill_bucket_rungs=3)


# -- whole engines at the reference's defaults --------------------------------
EOS = (257,)
TIE_GAP = 1e-4
#: the reference's defaults (xla-bucketed, the gather rung, 256-token
#: chunks, min bucket 64, page 128, batch 8), over a float32 pool: the
#: f32 rig of the reference's own chunked-prefill equivalence tests
ECFG = dict(kv_cache_dtype="float32")
#: (prompt length, max_tokens, sampling kwargs), submitted before the
#: engine starts, so one admission pass sees them all: a same-bucket pair
#: (one [2, 64] call), a 600-token prompt chunked twice while the pair
#: decodes, two prompts in their own buckets, a 300-token prompt chunked
#: once
BURST = [
    (5, 10, dict(temperature=0.0)),
    (40, 12, dict(temperature=0.8, top_k=20, seed=11)),
    (600, 8, dict(temperature=0.0)),
    (70, 10, dict(temperature=1.0, top_p=0.9, seed=5)),
    (100, 9, dict(temperature=0.0, frequency_penalty=0.5)),
    (300, 8, dict(temperature=0.0)),
]
PREFILL_COUNTERS = ("chunked_prefill_steps", "prefills",
                    "prefill_tokens_real", "prefill_tokens_padded")


@pytest.fixture(scope="module")
def eweights():
    p = jllama.init_params(jax.random.PRNGKey(0), jllama.TINY,
                           dtype=jnp.float32)
    return p, convert.params_from_numpy(
        {k: np.asarray(v) for k, v in p.items()}, device="cpu")


def _engines(eweights, **over):
    """(reference engine, port engine) at the defaults plus ``over``."""
    jp, tp = eweights
    cfg = {**ECFG, **over}
    return (jengine.Engine(jp, jllama.TINY, jengine.EngineConfig(**cfg),
                           eos_token_ids=EOS),
            tengine.Engine(tp, tllama.TINY, tengine.EngineConfig(**cfg),
                           eos_token_ids=EOS, device="cpu"))


def _burst_prompts(spec=BURST, seed=123):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).tolist() for n, _m, _kw in spec]


def _serve(eng, prompts, spec=BURST, make=None):
    """Submit every request (``make(i, emit)`` builds one, else plain),
    then start ``eng``; returns the streams (tokens, or with logprobs
    (token, chosen) pairs)."""
    mod = jengine if isinstance(eng, jengine.Engine) else tengine
    sp = JSampling if mod is jengine else TSampling
    out = [[] for _ in prompts]
    done = [threading.Event() for _ in prompts]
    for i, (prompt, (_n, max_tokens, kw)) in enumerate(zip(prompts, spec)):
        def emit(tok, fin, i=i):
            if tok >= 0:
                out[i].append(tok)
            if fin is not None:
                done[i].set()

        def emit_lp(tok, fin, chosen, _top, i=i):
            if tok >= 0:
                out[i].append((tok, round(chosen, 4)))
            if fin is not None:
                done[i].set()
        req = mod.GenRequest(prompt=prompt, max_tokens=max_tokens,
                             sampling=sp(**kw), emit=emit)
        if eng.cfg.logprobs_topk:
            req.emit_lp = emit_lp
        if make is not None:
            make(mod, i, req)
        eng.submit(req)
    eng.start()
    try:
        assert all(d.wait(300) for d in done), "a stream did not finish"
        assert eng.healthy, eng.last_error
    finally:
        eng.stop()
    return out


def _top2_gap(jp, tokens):
    S = 1 << max(3, (len(tokens) - 1).bit_length())
    toks = np.zeros((1, S), np.int32)
    toks[0, :len(tokens)] = tokens
    pool = jkvq.make_pool((2, 2, S, 2, 16), "float32")
    logits, _ = jllama.prefill(jp, jllama.TINY, jnp.asarray(toks),
                               jnp.asarray([len(tokens)], jnp.int32), pool,
                               jnp.arange(S // 8, dtype=jnp.int32)[None], 8)
    top = np.sort(np.asarray(logits[0]))[-2:]
    return float(top[1] - top[0])


def _assert_streams_match(got, want, jp, prompts, spec=BURST):
    """Identical streams; a greedy divergence only at a near-tie (top-2
    logit gap under 1e-4 in the reference model), after which the
    stream is not compared further."""
    for i, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        j = next((k for k, (a, b) in enumerate(zip(g, w)) if a != b),
                 min(len(g), len(w)))
        greedy = spec[i][2].get("temperature", 1.0) <= 0.0
        toks = [t if isinstance(t, int) else t[0] for t in w[:j]]
        gap = _top2_gap(jp, prompts[i] + toks) if greedy else None
        assert greedy and gap < TIE_GAP, (
            f"stream {i} diverges at token {j} (gap={gap}):\n port {g}\n"
            f"  ref {w}")


def test_engine_defaults_match_reference_burst(eweights):
    """The burst on both engines at the defaults: both resolve to
    xla-bucketed and the gather rung; streams equal; the chunked prompts
    ran their chunk loops (decode ticks between chunks for the pair
    already decoding) and every prefill counter equals the
    reference's."""
    jeng, teng = _engines(eweights)
    assert (teng.attn.name, teng.decode_attn_impl, teng.attn_reason) == (
        jeng.attn.name, "gather-torch", "requested")
    assert jeng.decode_attn_impl == "xla-gather"
    prompts = _burst_prompts()
    want = _serve(jeng, prompts)
    got = _serve(teng, prompts)
    _assert_streams_match(got, want, eweights[0], prompts)
    for key in PREFILL_COUNTERS:
        assert getattr(teng.stats, key) == getattr(jeng.stats, key), key
    assert teng.stats.chunked_prefill_steps == 3  # 600: 2 chunks, 300: 1
    assert teng.stats.prefills == len(BURST)


def _boundary_rows(eng, monkeypatch, prompt, chunk):
    """Prefill ``prompt`` through the backend's single path on a fresh
    sequence, snapshotting the pool rows of positions [0, consumed) at
    every chunk boundary (the decode tick after each chunk). Returns
    (snapshots, final rows)."""
    n = len(prompt)
    ps = eng.cfg.page_size
    eng.allocator.allocate(0, n + 4)
    pages = list(eng.allocator.pages(0))
    page_row = np.zeros((eng.cfg.max_pages_per_seq,), np.int32)
    page_row[:len(pages)] = pages
    slots = torch.tensor([pages[p // ps] * ps + p % ps for p in range(n)])
    snaps = []

    def tick():
        m = chunk * (len(snaps) + 1)
        snaps.append((m, eng.kv_cache[:, :, slots[:m]].clone()))

    monkeypatch.setattr(eng, "_decode_tick", tick)
    req = tengine.GenRequest(prompt=prompt, max_tokens=4,
                             sampling=TSampling(temperature=0.0))
    res = eng.attn.single_prefill(req, 0, prompt, 0, page_row, n + 4)
    assert not isinstance(res, str)
    return snaps, eng.kv_cache[:, :, slots].clone()


def test_kv_pages_at_every_chunk_boundary(eweights, monkeypatch):
    """Each chunk writes only its own positions' rows: the rows of every
    earlier chunk are bit-identical at every later boundary (200-token
    chunks on 128-token pages: boundaries mid-page), and the rows after
    the last chunk equal an unchunked prefill's within 1e-5."""
    _, tp = eweights
    prompt = _burst_prompts([(520, 0, {})], seed=4)[0]
    chunked = tengine.Engine(tp, tllama.TINY, tengine.EngineConfig(
        **ECFG, prefill_chunk_tokens=200), device="cpu")
    snaps, final = _boundary_rows(chunked, monkeypatch, prompt, 200)
    assert [m for m, _ in snaps] == [200, 400]
    assert any(m % 128 for m, _ in snaps)
    for m, rows in snaps:
        assert torch.equal(final[:, :, :m], rows), m
    whole = tengine.Engine(tp, tllama.TINY, tengine.EngineConfig(
        **ECFG, prefill_chunk_tokens=0), device="cpu")
    none, ref = _boundary_rows(whole, monkeypatch, prompt, 200)
    assert none == []
    np.testing.assert_allclose(final.numpy(), ref.numpy(), rtol=POOL_TOL,
                               atol=POOL_TOL)


def test_prefix_cache_hits_match_reference(eweights):
    """The reference's prefix-cache equivalence cases at the defaults,
    served one after another: a 256-token (page-aligned) prompt, the
    same prompt again (a full hit: both pages adopted, the last copied
    on write, one row resumed), then a prompt sharing its two pages with
    a 300-token tail (a partial hit resuming at 256 through one chunk
    and the tail). Streams and the cache and prefill counters equal the
    reference's."""
    rng = np.random.default_rng(21)
    a = rng.integers(0, 256, 256).tolist()
    b = a + rng.integers(0, 256, 300).tolist()
    spec = [(256, 8, dict(temperature=0.0))] * 2 + \
        [(556, 8, dict(temperature=0.0))]
    out = {}
    for eng in _engines(eweights):
        streams = []
        eng.start()
        try:
            for prompt, (_n, m, kw) in zip((a, a, b), spec):
                mod = jengine if isinstance(eng, jengine.Engine) else tengine
                sp = JSampling if mod is jengine else TSampling
                done, toks = threading.Event(), []
                eng.submit(mod.GenRequest(
                    prompt=prompt, max_tokens=m, sampling=sp(**kw),
                    emit=lambda t, f, toks=toks, done=done: (
                        toks.append(t) if t >= 0 else None,
                        done.set() if f else None)))
                assert done.wait(300)
                streams.append(toks)
        finally:
            eng.stop()
        out[mod] = (streams, eng.stats)
    (got, ts), (want, js) = out[tengine], out[jengine]
    _assert_streams_match(got, want, eweights[0], [a, a, b], spec)
    for key in PREFILL_COUNTERS + (
            "prefix_cache_hits", "prefix_full_hits", "prefix_cow_copies",
            "prefix_tokens_reused"):
        assert getattr(ts, key) == getattr(js, key), key
    assert (ts.prefix_full_hits, ts.prefix_tokens_reused) == (1, 255 + 256)
    assert ts.chunked_prefill_steps == 1


def test_cancel_mid_chunk_frees_pages(eweights, monkeypatch):
    """A request cancelled at its first chunk boundary stops there: its
    pages return to the pool, no slot is taken, and the next request is
    served."""
    _, tp = eweights
    eng = tengine.Engine(tp, tllama.TINY, tengine.EngineConfig(**ECFG),
                         eos_token_ids=EOS, device="cpu")
    free = eng.allocator.free_pages
    long_req = tengine.GenRequest(
        prompt=_burst_prompts([(700, 0, {})])[0], max_tokens=4,
        sampling=TSampling(temperature=0.0))
    ticks = []
    real_tick = eng._decode_tick

    def tick():
        ticks.append(1)
        long_req.cancelled.set()
        return real_tick()

    monkeypatch.setattr(eng, "_decode_tick", tick)
    assert eng._admit_one(long_req, []) == "skipped"
    assert ticks == [1] and eng.stats.chunked_prefill_steps == 1
    assert eng.allocator.free_pages == free
    assert all(s is None for s in eng._slots)
    got = _serve(eng, [[4, 8, 15]], [(3, 4, dict(temperature=0.0))])
    assert len(got[0]) == 4


def _constrained(jc_mod, tc_mod):
    from aigw_tpu.tpuserve.tokenizer import ByteTokenizer as JTok
    from aigw_tpu_torch.tpuserve.tokenizer import ByteTokenizer as TTok

    def make(mod, i, req):
        if i in (1, 2):  # the 40-token and the chunked 600-token prompt
            c, tok = (jc_mod, JTok()) if mod is jengine else (tc_mod, TTok())
            req.constraint = c.compile_constraint(
                tok, jllama.TINY.vocab_size, EOS,
                c.spec_for_response_format("json_object", None))
    return make


FEATURES = {
    "spec4": dict(spec_tokens=4),
    "logprobs2": dict(logprobs_topk=2),
    "constrained": {},
}


@pytest.mark.parametrize("feature", sorted(FEATURES))
def test_engine_defaults_with_feature_match_reference(eweights, feature):
    """The burst at the defaults with speculation (width 4, the gather
    verify path), logprobs (top 2: the chosen values within 1e-4) or two
    json_object requests (one of them the chunked prompt, its grammar
    mask in the tail's bias): streams and prefill counters equal the
    reference's."""
    from aigw_tpu.tpuserve import constrain as jc
    from aigw_tpu_torch.tpuserve import constrain as tc

    jeng, teng = _engines(eweights, **FEATURES[feature])
    make = _constrained(jc, tc) if feature == "constrained" else None
    prompts = _burst_prompts()
    want = _serve(jeng, prompts, make=make)
    got = _serve(teng, prompts, make=make)
    if feature == "logprobs2":
        for g, w in zip(got, want):
            assert [t for t, _ in g] == [t for t, _ in w]
            np.testing.assert_allclose([c for _, c in g], [c for _, c in w],
                                       atol=1e-4)
    else:
        _assert_streams_match(got, want, eweights[0], prompts)
    for key in PREFILL_COUNTERS:
        assert getattr(teng.stats, key) == getattr(jeng.stats, key), key
    if feature == "spec4":
        assert teng._verify_impl == "" and teng.stats.spec_drafted > 0
    if feature == "constrained":
        assert teng.stats.constraint_requests == 2


def test_migration_import_at_defaults_matches_reference(eweights):
    """A stream cut on a reference engine after three tokens and resumed
    on a port engine, both at the defaults: the continuation (a prefix
    hit on the imported pages, resumed through the bucketed
    ``prefill_suffix``) completes the reference's solo stream."""
    from test_torch_migration import _generate, _migrate

    jp, _ = eweights
    prompt = _burst_prompts([(300, 0, {})], seed=8)[0]
    sampling = dict(temperature=0.8, seed=7, presence_penalty=0.3)
    solo, src = _engines(eweights)[0], _engines(eweights)[0]
    _, dst = _engines(eweights)
    for e in (solo, src, dst):
        e.start()
    try:
        want = _generate(solo, prompt, 12, sampling)
        toks_a, toks_b, _out = _migrate(src, dst, prompt, 12, sampling)
    finally:
        for e in (solo, src, dst):
            e.stop()
    assert toks_a + toks_b == want
    assert dst.stats.migrations_in == 1 and dst.stats.prefix_cache_hits == 1


def test_mixtral_engine_defaults_match_reference():
    """The Mixtral family at the defaults (the reference's
    ``test_moe_family_chunked_prefill_works`` case, against the
    reference engine): a 300-token prompt chunks through
    ``prefill_suffix`` beside a short one; streams, the prefill counters
    and the folded routing totals (every chunk's rows) equal the
    reference's."""
    jcfg = jmixtral.TINY_MOE
    tcfg = tmixtral.MixtralConfig(**dataclasses.asdict(jcfg))
    jp = jmixtral.init_params(jax.random.PRNGKey(3), jcfg, jnp.float32)
    tp = convert.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                   device="cpu")
    from aigw_tpu.models.registry import family_fns as jfamily_fns

    spec = [(300, 6, dict(temperature=0.0)), (9, 6, dict(temperature=0.0))]
    prompts = _burst_prompts(spec, seed=17)
    cfg = dict(ECFG, max_seq_len=512)
    jeng = jengine.Engine(jp, jcfg, jengine.EngineConfig(**cfg),
                          eos_token_ids=EOS, fns=jfamily_fns("mixtral"))
    teng = tengine.Engine(tp, tcfg, tengine.EngineConfig(**cfg),
                          eos_token_ids=EOS, fns=family_fns("mixtral"),
                          device="cpu")
    want = _serve(jeng, prompts, spec)
    got = _serve(teng, prompts, spec)
    assert got == want
    for key in PREFILL_COUNTERS:
        assert getattr(teng.stats, key) == getattr(jeng.stats, key), key
    assert teng.stats.chunked_prefill_steps == 1
    np.testing.assert_array_equal(teng._moe_expert_tokens,
                                  jeng._moe_expert_tokens)
    np.testing.assert_array_equal(teng._moe_layer_drops,
                                  jeng._moe_layer_drops)


def test_cli_flags_of_the_default_programs():
    """The four flags keep the reference CLI's names and defaults (its
    defaults are the reference EngineConfig's) and reach EngineConfig,
    the two warm flags (ported: CUDA-graph captures ahead of traffic)
    with the reference CLI's help text."""
    from aigw_tpu_torch.cli import build_parser, engine_config

    base = ["tpuserve", "--model", "tiny-random"]
    want = jengine.EngineConfig()
    got = build_parser().parse_args(base)
    for name in ("prefill_chunk_tokens", "prefill_bucket_rungs",
                 "warm_prefill_buckets", "warm_decode_buckets",
                 "attention_backend", "decode_backend"):
        assert getattr(got, name) == getattr(want, name), name
    cfg = engine_config(build_parser().parse_args(
        base + ["--prefill-chunk-tokens", "0", "--prefill-bucket-rungs",
                "4"]))
    assert (cfg.prefill_chunk_tokens, cfg.prefill_bucket_rungs) == (0, 4)
    from aigw_tpu.cli import main as jmain

    def help_of(run, flag: str) -> str:
        out = io.StringIO()
        with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
            run(["tpuserve", "--help"])
        text = " ".join(out.getvalue().split())
        start = text.index(f"{flag} {flag[2:].upper().replace('-', '_')}",
                           text.index("options:"))
        return text[start:text.index(" --", start + len(flag))]

    for flag in ("--warm-prefill-buckets", "--warm-decode-buckets"):
        cfg = engine_config(build_parser().parse_args(base + [flag, "2"]))
        assert getattr(cfg, flag[2:].replace("-", "_")) == 2
        assert help_of(build_parser().parse_args, flag) \
            == help_of(jmain, flag)
