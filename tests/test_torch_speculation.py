"""Speculative decoding: the port against the JAX package.

The draft sources, the acceptance rule and the adaptive controllers are
held identical to the reference's on seeded inputs (the shapes of
``tests/test_spec_decode.py``), and the port's speculative engine
serves the reference Engine's streams, with drafts accepted: a stream
pinned by ``logit_bias`` accepts exactly as many drafts on both
engines, on the port's fused rung (the gather verify path) and on its
chained rung (K5's plain version). Speculation on and off give
identical streams, as in the reference's f32 rig
(``tests/test_spec_equivalence_property.py``).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aigw_tpu.models import llama as jllama
from aigw_tpu.tpuserve import engine as jengine
from aigw_tpu.tpuserve import speculation as jspec
from aigw_tpu.tpuserve.sampling import SamplingParams as JSampling
from aigw_tpu.tpuserve.sampling import spec_accept as j_spec_accept
from aigw_tpu_torch.models import convert
from aigw_tpu_torch.models import llama as tllama
from aigw_tpu_torch.tpuserve import engine as tengine
from aigw_tpu_torch.tpuserve import speculation as tspec
from aigw_tpu_torch.tpuserve.sampling import SamplingParams as TSampling
from aigw_tpu_torch.tpuserve.sampling import spec_accept as t_spec_accept


def _t(a):
    return torch.from_numpy(np.array(a))


# -- draft sources and acceptance -------------------------------------------
def _history(seed, B=6, H=40, vocab=3):
    """A small vocabulary makes 2-gram matches common; positions cover
    0, 1 and the last column."""
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, vocab, (B, H)).astype(np.int32)
    pos = rng.integers(0, H, (B,)).astype(np.int32)
    pos[:3] = [0, 1, H - 1]
    return hist, pos


@pytest.mark.parametrize("n_draft", [1, 3, 8])
@pytest.mark.parametrize("seed", range(3))
def test_ngram_drafts_match_reference(seed, n_draft):
    hist, pos = _history(seed)
    want = np.asarray(jspec.ngram_drafts(jnp.asarray(hist), jnp.asarray(pos),
                                         n_draft))
    got = tspec.ngram_drafts(_t(hist), _t(pos), n_draft)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("hist,pos,n,want", [
    ([4, 5, 6, 9, 4, 5], 5, 3, [6, 9, 4]),  # basic match
    ([1, 2, 7, 1, 2, 8, 9, 1, 2], 8, 2, [8, 9]),  # most recent wins
    ([1, 2, 3, 4], 3, 4, [-1, -1, -1, -1]),  # no match
    ([3, 4, 9, 3, 4], 4, 3, [9, 3, 4]),  # continuation clipped
    ([5], 0, 2, [-1, -1]),  # short history
], ids=["basic", "most_recent", "none", "clipped", "short"])
def test_ngram_drafts_reference_cases(hist, pos, n, want):
    """The reference's own hand cases (``tests/test_spec_decode.py``)."""
    h = np.zeros((1, 32), np.int32)
    h[0, :len(hist)] = hist
    got = tspec.ngram_drafts(_t(h), torch.tensor([pos], dtype=torch.int32), n)
    assert got.tolist() == [want]


def test_lookahead_and_combine_match_reference():
    rng = np.random.default_rng(11)
    B, L, D = 8, 16, 5
    la = rng.integers(0, 50, (B, L)).astype(np.int32)
    base = rng.integers(0, 30, (B,)).astype(np.int32)
    ln = rng.integers(0, L + 1, (B,)).astype(np.int32)
    pos = (base + rng.integers(-4, L + 2, (B,))).astype(np.int32)
    want = np.asarray(jspec.lookahead_drafts(
        *(jnp.asarray(a) for a in (la, base, ln, pos)), D))
    got = tspec.lookahead_drafts(*(_t(a) for a in (la, base, ln, pos)), D)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == -1).any() and (want >= 0).any()
    fb = rng.integers(-1, 9, (B, D)).astype(np.int32)
    np.testing.assert_array_equal(
        tspec.combine_drafts(got, _t(fb)).numpy(),
        np.asarray(jspec.combine_drafts(jnp.asarray(want), jnp.asarray(fb))))


@pytest.mark.parametrize("D", [1, 4])
def test_accept_counts_and_spec_accept_match_reference(D):
    rng = np.random.default_rng(D)
    B = 16
    sampled = rng.integers(0, 3, (B, D + 1)).astype(np.int32)
    drafts = np.where(rng.random((B, D)) < 0.8, sampled[:, :D],
                      rng.integers(-1, 3, (B, D))).astype(np.int32)
    active = rng.random(B) < 0.8
    budget = rng.integers(-2, D + 3, (B,)).astype(np.int32)
    np.testing.assert_array_equal(
        tspec.accept_counts(_t(drafts), _t(sampled)).numpy(),
        np.asarray(jspec.accept_counts(jnp.asarray(drafts),
                                       jnp.asarray(sampled))))
    jn, jm = j_spec_accept(*(jnp.asarray(a) for a in
                             (drafts, sampled, active, budget)))
    tn, tm = t_spec_accept(*(_t(a) for a in
                             (drafts, sampled, active, budget)))
    assert tn.dtype == torch.int32
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


# -- adaptive controllers ---------------------------------------------------
def test_draft_rungs_match_reference():
    for n in range(-1, 20):
        assert tspec.draft_rungs(n) == jspec.draft_rungs(n)


@pytest.mark.parametrize("spec_tokens,adaptive", [(3, True), (8, True),
                                                  (4, False)])
def test_controllers_take_the_reference_rungs(spec_tokens, adaptive):
    """Four slots' controllers sharing one prior take the same rung, EWMA
    and moves as the reference's over a seeded series of windows
    (accepting, rejecting and proposal-less phases, long enough for a
    rung-0 re-probe), and fresh controllers start where the reference's
    do."""
    rng = np.random.default_rng(spec_tokens)
    rungs = tspec.draft_rungs(spec_tokens)
    jp, tp = jspec.AcceptancePrior(), tspec.AcceptancePrior()
    jc = [jspec.DraftController(rungs, jp, adaptive) for _ in range(4)]
    tc = [tspec.DraftController(rungs, tp, adaptive) for _ in range(4)]
    for w in range(400):
        phase = (w // 60) % 3  # accepting, rejecting, nothing proposed
        for i, (a, b) in enumerate(zip(jc, tc)):
            assert b.tick() == a.tick()
            proposed = 0 if phase == 2 else int(rng.integers(1, 9))
            accepted = (int(rng.integers(0, proposed + 1)) if phase == 0
                        else 0)
            assert b.observe_window(proposed, accepted) == \
                a.observe_window(proposed, accepted)
            assert (b.rung, b.ewma, b.idle_windows) == \
                (a.rung, a.ewma, a.idle_windows), (w, i)
        assert tp.value == jp.value
        if w % 37 == 0:  # a slot admitted mid-series
            jc[w % 4] = jspec.DraftController(rungs, jp, adaptive)
            tc[w % 4] = tspec.DraftController(rungs, tp, adaptive)
            assert tc[w % 4].draft_len() == jc[w % 4].draft_len()


# -- the speculative engine -------------------------------------------------
EOS = (257,)
CFG = dict(max_batch_size=2, max_seq_len=128, page_size=16,
           decode_steps_per_tick=4, kv_cache_dtype="float32",
           attention_backend="pallas-ragged", decode_backend="fused",
           ragged_chunk_tokens=16, ragged_max_chunks=2)
RUNGS = {"fused": dict(decode_backend="fused"),
         "chained": dict(decode_backend="auto", pallas_attn=True)}
#: greedy streams pinned to token 7: drafts are proposed once (7, 7)
#: repeats, and accepted (the reference's ``test_pallas_ops`` case)
PINNED = ([5, 6, 7, 5, 6], 10, dict(temperature=0.0,
                                   logit_bias=((7, 100.0),)))


@pytest.fixture(scope="module")
def weights():
    p = jllama.init_params(jax.random.PRNGKey(0), jllama.TINY,
                           dtype=jnp.float32)
    return p, convert.params_from_numpy(
        {k: np.asarray(v) for k, v in p.items()}, device="cpu")


def _serve(eng, req_cls, sp_cls, reqs):
    """Submit ``reqs`` [(prompt, max_tokens, sampling kwargs)] before the
    loop starts; returns [(tokens, finish)] and stops the engine."""
    out = [([], []) for _ in reqs]
    done = [threading.Event() for _ in reqs]
    for i, (prompt, max_tokens, kw) in enumerate(reqs):
        def emit(tok, fin, i=i):
            if tok >= 0:
                out[i][0].append(tok)
            if fin is not None:
                out[i][1].append(fin)
                done[i].set()
        eng.submit(req_cls(prompt=prompt, max_tokens=max_tokens,
                           sampling=sp_cls(**kw), emit=emit))
    eng.start()
    try:
        assert all(d.wait(180) for d in done), "stream did not finish"
        assert eng.healthy, eng.last_error
    finally:
        eng.stop()
    return [(toks, fin[0]) for toks, fin in out]


def _port(weights, reqs, **over):
    eng = tengine.Engine(weights[1], tllama.TINY,
                         tengine.EngineConfig(**{**CFG, **over}),
                         eos_token_ids=EOS, device="cpu")
    return eng, _serve(eng, tengine.GenRequest, TSampling, reqs)


@pytest.fixture(scope="module")
def reference_pinned(weights):
    """The reference Engine (its fused rung, so the gather verify path)
    with a fixed draft width of 3 on the pinned stream."""
    eng = jengine.Engine(weights[0], jllama.TINY, jengine.EngineConfig(
        enable_prefix_cache=False, spec_tokens=3, spec_adaptive=False,
        **CFG), eos_token_ids=EOS)
    out = _serve(eng, jengine.GenRequest, JSampling, [PINNED])
    return out, eng.stats


@pytest.mark.parametrize("rung", sorted(RUNGS))
def test_pinned_stream_accepts_like_the_reference(weights, reference_pinned,
                                                  rung):
    """The same stream and the same accepted and offered draft counts as
    the reference Engine, on both of the port's decode rungs."""
    want, jstats = reference_pinned
    eng, got = _port(weights, [PINNED], spec_tokens=3, spec_adaptive=False,
                     **RUNGS[rung])
    assert eng._verify_impl == ("chained" if rung == "chained" else "")
    assert got == want == [([7] * 10, "length")]
    assert eng.stats.spec_accepted == jstats.spec_accepted > 0
    assert eng.stats.spec_drafted == jstats.spec_drafted
    assert eng.stats.decode_steps == jstats.decode_steps
    assert eng.stats.spec_accept_rate == pytest.approx(
        jstats.spec_accept_rate)


#: a mixed batch (more requests than slots): pinned and free greedy
#: slots that speculate, a seeded sampling slot and a penalty slot that
#: decode plainly inside the verify window (their drafts poisoned)
MIXED = [
    PINNED,
    ([1, 2, 3, 1, 2, 3, 1, 2], 14, dict(temperature=0.0)),
    ([9, 9, 9, 4], 12, dict(temperature=0.9, top_k=20, seed=11)),
    ([4, 4, 2, 4, 4], 10, dict(temperature=0.0, frequency_penalty=0.5,
                               presence_penalty=0.2)),
    ([2, 3, 4], 16, dict(temperature=0.0, logit_bias=((9, 100.0),))),
]


@pytest.fixture(scope="module")
def port_plain_mixed(weights):
    return _port(weights, MIXED)[1]


@pytest.mark.parametrize("rung,adaptive", [("fused", True),
                                           ("chained", False)])
def test_speculation_on_and_off_give_identical_streams(
        weights, port_plain_mixed, rung, adaptive):
    """Speculation changes no token: the mixed batch's streams (finish
    reasons included) equal the port's own with speculation off, with
    the adaptive ladder and with a pinned width; drafts were accepted."""
    eng, got = _port(weights, MIXED, spec_tokens=4, spec_adaptive=adaptive,
                     **RUNGS[rung])
    assert got == port_plain_mixed
    assert eng.stats.spec_accepted > 0
    assert eng.stats.spec_drafted >= eng.stats.spec_accepted


def test_mixed_batch_matches_reference_engine(weights, port_plain_mixed):
    """The reference Engine with speculation on (adaptive, width 3)
    serves the mixed batch's streams, which are the port's."""
    eng = jengine.Engine(weights[0], jllama.TINY, jengine.EngineConfig(
        enable_prefix_cache=False, spec_tokens=3, **CFG), eos_token_ids=EOS)
    assert _serve(eng, jengine.GenRequest, JSampling, MIXED) \
        == port_plain_mixed


@pytest.mark.parametrize("bias,max_tokens,want", [
    (257, 16, ([], "stop")),  # EOS inside the first accepted burst
    (9, 2, ([9, 9], "length")),  # a burst overshooting max_tokens
], ids=["eos_mid_burst", "max_tokens_mid_burst"])
def test_bursts_end_exactly(weights, bias, max_tokens, want):
    """The reference's edge cases: EOS accepted inside a multi-token
    burst finishes with no trailing token; a burst past max_tokens is
    cut exactly."""
    _, got = _port(weights, [([2, 3, 4], max_tokens,
                              dict(temperature=0.0,
                                   logit_bias=((bias, 100.0),)))],
                   spec_tokens=3, spec_adaptive=False)
    assert got == [want]


def test_engine_refuses_nothing_for_spec_config():
    """``spec_tokens`` is ported: the config takes it, and the ladder is
    the reference's."""
    cfg = tengine.EngineConfig(spec_tokens=8, spec_adaptive=False)
    eng = tengine.Engine({}, tllama.TINY, cfg, device="cpu")
    assert eng._spec_rungs == jspec.draft_rungs(8) == (0, 2, 4, 8)
    assert tengine.EngineConfig().spec_adaptive is True


@pytest.mark.parametrize("argv,want", [
    (["--spec-tokens", "4"], (4, True)),
    (["--spec-tokens", "4", "--no-spec-adaptive"], (4, False)),
    (["--spec-tokens", "4", "--no-speculation"], (0, True)),
], ids=["adaptive", "pinned", "off"])
def test_cli_speculation_flags(argv, want):
    """The reference's ``tpuserve`` flags: ``--no-speculation`` overrides
    ``--spec-tokens``."""
    from aigw_tpu_torch import cli

    args = cli.build_parser().parse_args(["tpuserve", "--model", "m", *argv])
    cfg = cli.engine_config(args)
    assert (cfg.spec_tokens, cfg.spec_adaptive) == want
