"""Per-token logprobs: the port's engine against the JAX package's.

- ``sampling.token_logprobs`` against ``jax.nn.log_softmax`` and
  ``jax.lax.top_k`` on the same logits.
- Whole engines: the reference ``Engine`` and the port's, with
  ``logprobs_topk`` 3 on the fused rung and 20 on the chained rung, on
  the reference's ``init_params(PRNGKey(0), TINY, float32)`` weights
  over a float32 pool, serve the same phases one after the other: a
  batched prefill of a greedy, a seeded and a penalized request (full
  windows, sampled), a lone greedy request (lean greedy windows), a
  prompt whose first two pages are cached (a resume at 32) and a
  page-aligned prompt sent twice (a miss, then a full hit: one row at
  n - 1). Every request's stream is identical to the reference's, and
  every token's chosen and top-k values lie within 2e-4 of the
  reference's; the top-k ids are equal except where neighbours tie
  within 2e-4. The first token's entry comes from each prefill path.
- The reference tests' cases: a greedy stream's chosen token is its
  top-1, and logprobs exclude speculation.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aigw_tpu.models import llama as jllama
from aigw_tpu.tpuserve import engine as jengine
from aigw_tpu.tpuserve.sampling import SamplingParams as JSampling
from aigw_tpu_torch.models import convert
from aigw_tpu_torch.models import llama as tllama
from aigw_tpu_torch.tpuserve import engine as tengine
from aigw_tpu_torch.tpuserve.sampling import SamplingParams as TSampling
from aigw_tpu_torch.tpuserve.sampling import token_logprobs

EOS = (257,)
TOL = 2e-4
CFG = dict(max_batch_size=4, max_seq_len=128, page_size=16,
           decode_steps_per_tick=4, kv_cache_dtype="float32",
           attention_backend="pallas-ragged", decode_backend="fused",
           ragged_chunk_tokens=16, ragged_max_chunks=4)
RUNGS = {
    "fused_top3": dict(decode_backend="fused", logprobs_topk=3),
    "chained_top20": dict(decode_backend="auto", pallas_attn=True,
                          logprobs_topk=20),
}
GREEDY = dict(temperature=0.0)
SEEDED = dict(temperature=0.8, seed=11)
PEN = dict(temperature=0.0, frequency_penalty=0.8, presence_penalty=0.3)
ALIGNED = [(7 * i + 3) % 250 for i in range(32)]  # two full pages
#: phases served one after the other: (prompt, max_tokens, sampling)
#: requests submitted together
PHASES = [
    # a batched prefill; penalties and a sampled slot: full windows
    [([10, 20, 30, 40, 50], 9, GREEDY), ([3, 1, 4, 1, 5, 9, 2], 9, SEEDED),
     ([99, 98, 97], 9, PEN)],
    # a lone greedy request: lean greedy windows
    [([5, 6, 7, 8], 7, GREEDY)],
    # the aligned prompt cached; then its two pages adopted and a suffix
    # resumed at 32; then the whole prompt again: a full hit
    [(ALIGNED, 5, GREEDY)],
    [(ALIGNED + [11, 12, 13], 6, SEEDED)],
    [(ALIGNED, 5, GREEDY)],
]


def _serve(eng, req_cls, sp_cls, phases):
    """Serve ``phases`` one after the other; returns per phase, per
    request, the [(token, chosen, top)] entries and the finish."""
    out = []
    eng.start()
    try:
        for phase in phases:
            got = [{"tokens": [], "finish": None} for _ in phase]
            done = [threading.Event() for _ in phase]
            reqs = []
            for i, (prompt, n, kw) in enumerate(phase):
                def emit_lp(t, f, chosen, top, i=i):
                    if t >= 0:
                        got[i]["tokens"].append((t, chosen, top))
                    if f is not None:
                        got[i]["finish"] = f
                        done[i].set()
                reqs.append(req_cls(prompt=list(prompt), max_tokens=n,
                                    sampling=sp_cls(**kw), emit_lp=emit_lp))
            for r in reqs:
                eng.submit(r)
            assert all(d.wait(300) for d in done), "a stream did not finish"
            deadline = time.monotonic() + 60
            while (eng._inflight is not None
                   or eng._device_state is not None) \
                    and time.monotonic() < deadline:
                time.sleep(0.01)
            out.append(got)
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


@pytest.fixture(scope="module", params=sorted(RUNGS))
def served(request, weights):
    jp, tp = weights
    cfg = {**CFG, **RUNGS[request.param]}
    jeng = jengine.Engine(jp, jllama.TINY, jengine.EngineConfig(**cfg),
                          eos_token_ids=EOS)
    want = _serve(jeng, jengine.GenRequest, JSampling, PHASES)
    teng = tengine.Engine(tp, tllama.TINY, tengine.EngineConfig(**cfg),
                          eos_token_ids=EOS, device="cpu")
    got = _serve(teng, tengine.GenRequest, TSampling, PHASES)
    return request.param, want, got, teng


def _ids_match(gid, gval, wid, wval, tol=TOL) -> bool:
    """Top-k ids equal, except where two neighbours' values tie within
    ``tol`` (their order, or which one closes the list, may differ)."""
    for j, (a, b) in enumerate(zip(gid, wid)):
        if a == b:
            continue
        if a in wid:
            if abs(wval[wid.index(a)] - wval[j]) > tol:
                return False
        elif abs(wval[-1] - gval[j]) > tol:
            return False  # a new id may only enter at the boundary
    return True


def test_engine_logprobs_match_reference(served):
    rung, want, got, _ = served
    k = RUNGS[rung]["logprobs_topk"]
    n_entries = 0
    for ph, (gp, wp) in enumerate(zip(got, want)):
        for r, (g, w) in enumerate(zip(gp, wp)):
            where = (rung, ph, r)
            assert g["finish"] == w["finish"], where
            assert [t for t, _c, _t in g["tokens"]] == \
                [t for t, _c, _t in w["tokens"]], where
            for (t, gc, gtop), (_t, wc, wtop) in zip(g["tokens"],
                                                     w["tokens"]):
                assert len(gtop) == len(wtop) == k, where
                assert abs(gc - wc) <= TOL, (where, gc, wc)
                gid, gval = zip(*gtop)
                wid, wval = zip(*wtop)
                assert np.abs(np.subtract(gval, wval)).max() <= TOL, where
                assert _ids_match(list(gid), gval, list(wid), wval), where
                n_entries += 1
    assert n_entries == sum(len(g["tokens"]) for p in got for g in p) > 40


def test_engine_logprobs_cover_every_prefill_path(served):
    """The phases took the batched prefill, a resume and a full hit, and
    every token (the first included) carries an entry whose values are
    log-probabilities in descending order."""
    rung, _want, got, teng = served
    st = teng.stats
    assert st.prefix_cache_hits == 2 and st.prefix_full_hits == 1
    assert st.prefix_tokens_reused == 32 + 31
    assert [len(p) for p in got] == [3, 1, 1, 1, 1]
    for phase in got:
        for g in phase:
            assert g["tokens"], rung
            for _t, chosen, top in g["tokens"]:
                vals = [v for _i, v in top]
                assert vals == sorted(vals, reverse=True)
                assert chosen <= 0.0 and all(v <= 0.0 for v in vals)
    # the seeded stream differs from a greedy one, and its tokens are
    # not all top-1
    seeded = got[0][1]["tokens"]
    assert any(t != top[0][0] for t, _c, top in seeded)


def test_engine_greedy_chosen_is_top1(weights):
    """The reference test's case on the port: greedy sampling's chosen
    token is the top-1 entry, its value equal to the top-1 value."""
    cfg = tengine.EngineConfig(**{**CFG, "logprobs_topk": 3})
    eng = tengine.Engine(weights[1], tllama.TINY, cfg, eos_token_ids=EOS,
                         device="cpu")
    rows = _serve(eng, tengine.GenRequest, TSampling,
                  [[([1, 2, 3] * 12, 6, GREEDY)]])[0][0]["tokens"]
    assert rows
    for tok, chosen, top in rows:
        assert len(top) == 3
        top_ids = [t for t, _ in top]
        top_vals = [v for _, v in top]
        assert tok == top_ids[0]
        assert chosen == pytest.approx(top_vals[0], abs=1e-5)
        assert top_vals == sorted(top_vals, reverse=True)
        assert all(v <= 0.0 for v in top_vals)


def test_spec_and_logprobs_exclusive():
    for mod in (jengine, tengine):
        with pytest.raises(ValueError, match="mutually exclusive"):
            mod.EngineConfig(logprobs_topk=3, spec_tokens=2)


def test_logprobs_off_emits_through_emit(weights):
    """With logprobs_topk == 0 a request with ``emit_lp`` gets (token,
    finish, None, None), the reference's behaviour, and the window
    computes no logprobs."""
    eng = tengine.Engine(weights[1], tllama.TINY, tengine.EngineConfig(**CFG),
                         eos_token_ids=EOS, device="cpu")
    got = _serve(eng, tengine.GenRequest, TSampling,
                 [[([4, 5, 6], 5, GREEDY)]])[0][0]
    assert len(got["tokens"]) == 5 and got["finish"] == "length"
    assert all(c is None and top is None for _t, c, top in got["tokens"])


@pytest.mark.parametrize("k", [1, 3, 20])
def test_token_logprobs_match_jax(k):
    rng = np.random.default_rng(k)
    logits = rng.normal(0.0, 3.0, (8, 512)).astype(np.float32)
    logits[2, :500] -= 1e9  # a masked row, as a grammar bias makes
    sampled = rng.integers(0, 512, 8).astype(np.int32)
    sampled[2] = 505
    chosen, ids, vals = token_logprobs(torch.from_numpy(logits),
                                       torch.from_numpy(sampled), k)
    lp = jax.nn.log_softmax(jnp.asarray(logits), axis=-1)
    wvals, wids = jax.lax.top_k(lp, k)
    want_chosen = np.asarray(lp)[np.arange(8), sampled]
    assert ids.dtype == torch.int32 and vals.dtype == torch.float32
    np.testing.assert_allclose(chosen.numpy(), want_chosen, atol=1e-5)
    np.testing.assert_allclose(vals.numpy(), np.asarray(wvals), atol=1e-5)
    # the masked row's alternates past its 12 live entries tie (float32
    # rounds -1e9 + noise to a few values): tie-aware there
    for r in range(8):
        assert _ids_match(ids[r].tolist(), vals[r].tolist(),
                          np.asarray(wids)[r].tolist(),
                          np.asarray(wvals)[r].tolist(), 1e-5), r
    live = [r for r in range(8) if r != 2]
    np.testing.assert_array_equal(ids.numpy()[live], np.asarray(wids)[live])
