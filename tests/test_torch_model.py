"""The port's Llama forward against the JAX package's, on the reference's
own weights.

Weights come from the reference's ``init_params(PRNGKey(0), cfg,
dtype=float32)`` and cross through ``aigw_tpu_torch.models.convert``;
token inputs are made from a seed with numpy. Both sides run in float32
on the CPU: the reference's entry points with ``attn_impl="pallas"`` /
``"fused-pallas"`` run its Pallas kernels in interpret mode, the port's
run its kernels' plain versions. Logits agree within 1e-4 (different
summation orders through two layers); the pools agree within 1e-5
outside the dump page (the reference drops padding writes, the port
parks them in the dump page).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aigw_tpu.models import llama as jllama
from aigw_tpu.ops.pallas.decode_fused import _rope_tables as jax_rope_tables
from aigw_tpu_torch.models import convert, kvq
from aigw_tpu_torch.models import llama as tllama
from aigw_tpu_torch.ops.decode_fused import rope_rotate, rope_tables

LOGIT_TOL = 1e-4
POOL_TOL = 1e-5
PS = 8  # page size
CFGS = {
    "tiny": (jllama.TINY, tllama.TINY),
    "tiny-qwen": (jllama.LlamaConfig(
        vocab_size=512, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
        ffn_dim=128, max_seq_len=512, rope_theta=10000.0, attn_bias=True,
        tie_embeddings=True), tllama.TINY_QWEN),
}


def _weights(jcfg):
    p = jllama.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    if jcfg.attn_bias:  # nonzero biases so the bias path is exercised
        rng = np.random.default_rng(5)
        p = {k: (jnp.asarray(rng.standard_normal(v.shape, np.float32) * 0.1)
                 if k.split(".")[-1] in ("bq", "bk", "bv") else v)
             for k, v in p.items()}
    return p, convert.params_from_numpy(
        {k: np.asarray(v) for k, v in p.items()}, device="cpu")


def _pool_shape(cfg, n_pages):
    return (cfg.n_layers, 2, (n_pages + 1) * PS, cfg.n_kv_heads,
            cfg.head_dim)


def _pack(lens, B, T):
    """Packed ragged layout: sequences back to back, padding at the tail
    (row_seq == B), positions from 0, last row per sequence."""
    row_seq = np.full((T,), B, np.int32)
    positions = np.zeros((T,), np.int32)
    last = np.zeros((B,), np.int32)
    o = 0
    for b, n in enumerate(lens):
        row_seq[o:o + n] = b
        positions[o:o + n] = np.arange(n)
        last[b] = o + n - 1
        o += n
    return row_seq, positions, last


def _prefill_both(name, lens, max_pages=6, n_pages=24, T=64, seed=0):
    jcfg, tcfg = CFGS[name]
    jp, tp = _weights(jcfg)
    B = len(lens)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, jcfg.vocab_size, (T,)).astype(np.int32)
    row_seq, positions, last = _pack(lens, B, T)
    pt = rng.permutation(n_pages)[: B * max_pages].reshape(
        B, max_pages).astype(np.int32)
    shape = _pool_shape(jcfg, n_pages)
    jl, jkv = jllama.prefill_ragged(
        jp, jcfg, jnp.asarray(tokens), jnp.asarray(row_seq),
        jnp.asarray(positions), jnp.asarray(last),
        jnp.zeros(shape, jnp.float32), jnp.asarray(pt), PS,
        attn_impl="pallas")
    tkv = torch.zeros(shape)
    tl, tkv = tllama.prefill_ragged(
        tp, tcfg, *(torch.from_numpy(a) for a in
                    (tokens, row_seq, positions, last)), tkv,
        torch.from_numpy(pt), PS)
    return (jcfg, tcfg, jp, tp, pt, np.asarray(jl), np.asarray(jkv),
            tl.numpy(), tkv)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_prefill_ragged_matches_jax(name):
    (_, _, _, _, _, jl, jkv, tl, tkv) = _prefill_both(
        name, lens=[5, 17, 9, 1])
    np.testing.assert_allclose(tl, jl, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    n = jkv.shape[2] - PS  # everything but the dump page
    np.testing.assert_allclose(tkv.numpy()[:, :, :n], jkv[:, :, :n],
                               rtol=POOL_TOL, atol=POOL_TOL)


def test_prefill_padding_never_lands_in_an_allocatable_page():
    """Padding rows (row_seq >= B) write only into the dump page: every
    allocatable row not owned by a prompt position stays zero."""
    lens = [3, 6]
    (_, tcfg, _, _, pt, _, _, _, tkv) = _prefill_both(
        "tiny", lens=lens, T=32)
    written = np.zeros(tkv.shape[2], bool)
    for b, n in enumerate(lens):
        for pos in range(n):
            written[pt[b, pos // PS] * PS + pos % PS] = True
    n_alloc = tkv.shape[2] - PS
    untouched = ~written[:n_alloc]
    assert not tkv[:, :, :n_alloc][:, :, torch.from_numpy(untouched)].any()
    assert tkv[:, :, n_alloc:].any()  # the padding went to the dump page


@pytest.mark.parametrize("name", sorted(CFGS))
@pytest.mark.parametrize("rung", ["fused", "chained"])
def test_decode_steps_match_jax(name, rung):
    """Prefill, then several decode steps on both sides with a mix of
    active and inactive slots and a page-boundary crossing."""
    lens = [5, 7, 3]
    (jcfg, tcfg, jp, tp, pt, jl, jkv, tl, tkv) = _prefill_both(name, lens)
    B = len(lens)
    jimpl = "fused-pallas" if rung == "fused" else "pallas"
    tokens = np.argmax(jl, -1).astype(np.int32)
    positions = np.asarray(lens, np.int32)
    active = np.array([True, True, False])
    jkv = jnp.asarray(jkv)
    for _ in range(4):
        jlog, jkv = jllama.decode_step(
            jp, jcfg, jnp.asarray(tokens), jnp.asarray(positions), jkv,
            jnp.asarray(pt), PS, jnp.asarray(active), attn_impl=jimpl)
        tlog, tkv = tllama.decode_step(
            tp, tcfg, torch.from_numpy(tokens), torch.from_numpy(positions),
            tkv, torch.from_numpy(pt), PS, torch.from_numpy(active),
            attn_impl=rung)
        jlog = np.asarray(jlog)
        np.testing.assert_allclose(tlog.numpy()[active], jlog[active],
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        tokens = np.where(active, np.argmax(jlog, -1), tokens).astype(
            np.int32)
        positions = np.where(active, positions + 1, positions).astype(
            np.int32)
    n = jkv.shape[2] - PS
    np.testing.assert_allclose(tkv.numpy()[:, :, :n],
                               np.asarray(jkv)[:, :, :n],
                               rtol=POOL_TOL, atol=POOL_TOL)


@pytest.mark.parametrize("rung", ["fused", "chained"])
def test_decode_inactive_slot_at_max_seq_len(rung):
    """A slot whose decode window ran to its limit at max_seq_len sits in
    the step as an inactive row at position max_pages * page: the step
    runs (no page index past the table) and matches the reference."""
    lens = [5, 7]
    max_pages = 6
    (jcfg, tcfg, jp, tp, pt, jl, jkv, _, tkv) = _prefill_both(
        "tiny", lens, max_pages=max_pages)
    tokens = np.argmax(jl, -1).astype(np.int32)
    positions = np.array([lens[0], max_pages * PS], np.int32)
    active = np.array([True, False])
    jlog, jkv = jllama.decode_step(
        jp, jcfg, jnp.asarray(tokens), jnp.asarray(positions),
        jnp.asarray(jkv), jnp.asarray(pt), PS, jnp.asarray(active),
        attn_impl="fused-pallas" if rung == "fused" else "pallas")
    tlog, tkv = tllama.decode_step(
        tp, tcfg, torch.from_numpy(tokens), torch.from_numpy(positions),
        tkv, torch.from_numpy(pt), PS, torch.from_numpy(active),
        attn_impl=rung)
    np.testing.assert_allclose(tlog.numpy()[active], np.asarray(jlog)[active],
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    n = jkv.shape[2] - PS
    np.testing.assert_allclose(tkv.numpy()[:, :, :n],
                               np.asarray(jkv)[:, :, :n],
                               rtol=POOL_TOL, atol=POOL_TOL)


def test_rope_rotation_matches_jax_bit_for_bit():
    """Given the same angle tables, the port's interleaved rotation is
    the reference's bit for bit in float32 (pairs (x[::2], x[1::2]),
    separately rounded products)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 4, 16), np.float32)
    pos = rng.integers(0, 2000, (3, 5)).astype(np.int32)
    want = np.asarray(jllama.rope(jnp.asarray(x), jnp.asarray(pos), 1e4))
    freqs = 1.0 / (1e4 ** (jnp.arange(0, 16, 2, dtype=jnp.float32) / 16))
    ang = jnp.asarray(pos).astype(jnp.float32)[..., None, None] * freqs
    got = rope_rotate(torch.from_numpy(x),
                             torch.from_numpy(np.array(jnp.cos(ang))),
                             torch.from_numpy(np.array(jnp.sin(ang))))
    np.testing.assert_array_equal(got.numpy(), want)


def test_rope_matches_jax():
    """The full rope, angle tables included: float32 cos/sin are not
    correctly rounded and the two libraries' implementations differ in
    the last ulp, so the result is held within 1e-5 (a few ulp of the
    rotated values)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 8, 128), np.float32)
    pos = rng.integers(0, 8192, (2, 9)).astype(np.int32)
    want = np.asarray(jllama.rope(jnp.asarray(x), jnp.asarray(pos), 5e5))
    got = tllama.rope(torch.from_numpy(x), torch.from_numpy(pos), 5e5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    cj, sj = jax_rope_tables(jnp.asarray(pos[0]), 128, 5e5)
    ct, st = rope_tables(torch.from_numpy(pos[0]), 128, 5e5)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=2e-6)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=2e-6)


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 64), np.float32)
    w = rng.standard_normal((64,), np.float32)
    want = np.asarray(jllama.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    got = tllama.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_params_and_pool_round_trip():
    p = jllama.init_params(jax.random.PRNGKey(1), jllama.TINY)  # bf16
    tp = convert.params_from_numpy(p, device="cpu")
    assert tp["l0.wq"].dtype == torch.bfloat16
    assert sorted(tp) == sorted(p)
    np.testing.assert_array_equal(
        tp["l1.w_up"].float().numpy(),
        np.asarray(p["l1.w_up"], np.float32))
    pool = np.random.default_rng(0).standard_normal(
        (2, 2, 16, 2, 16)).astype(np.float32)
    np.testing.assert_array_equal(
        convert.pool_to_numpy(convert.pool_from_numpy(pool, "cpu")), pool)


def test_init_params_shapes_and_scales():
    p = tllama.init_params(0, tllama.TINY_QWEN, dtype=torch.float32,
                           device="cpu")
    ref = jllama.init_params(jax.random.PRNGKey(0), CFGS["tiny-qwen"][0])
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    assert abs(float(p["embed"].std()) - 0.02) < 2e-3
    assert abs(float(p["l0.w_up"].std()) - 1 / 8) < 1e-2
    # same seed → same weights
    q = tllama.init_params(0, tllama.TINY_QWEN, dtype=torch.float32,
                           device="cpu")
    assert torch.equal(p["l1.wo"], q["l1.wo"])


def test_scatter_kv_padding_goes_to_dump_page():
    kv = kvq.make_pool((1, 2, 4 * PS, 1, 2), "float32", torch.device("cpu"))
    slot = torch.tensor([0, 9, 3])
    valid = torch.tensor([True, False, True])
    flat = kvq.padding_slots(kv, PS, valid, slot)
    assert flat.tolist()[0::2] == [0, 3]
    assert 3 * PS <= int(flat[1]) < 4 * PS
    kvq.scatter_kv(kv, 0, flat, torch.ones(3, 1, 2), torch.ones(3, 1, 2))
    assert kv[0, 0, 9].sum() == 0 and kv[0, 0, 3].sum() == 2


# -- quantized weights and pools ---------------------------------------------
# 128-aligned widths, so W8A16 matrices at decode (and T <= 64 prefill)
# shapes reach K6 on both sides (the reference's interpret-mode Pallas
# kernel, the port's plain version)
QCFG = (jllama.LlamaConfig(vocab_size=512, dim=128, n_layers=2, n_heads=4,
                           n_kv_heads=2, ffn_dim=256, max_seq_len=256,
                           rope_theta=10000.0),
        tllama.LlamaConfig(vocab_size=512, dim=128, n_layers=2, n_heads=4,
                           n_kv_heads=2, ffn_dim=256, max_seq_len=256,
                           rope_theta=10000.0))


def _qweights(wmode):
    from aigw_tpu.models import quant as jquant

    jcfg, _ = QCFG
    p = jllama.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    if wmode:
        p = jquant.quantize_params(p, mode=wmode)
    return p, convert.params_from_numpy(
        {k: np.asarray(v) for k, v in p.items()}, device="cpu")


def _assert_pools_close(tkv, jkv):
    """Quantized pools outside the dump page: rows byte for byte except
    where a scale differs in its last place, and there q within ±1 and
    scales within rtol 1e-5. The reference's functions called eagerly,
    as here, divide by qmax; the port scales by the float32 reciprocal,
    as the reference's compiled programs do (``models/kvq.py``)."""
    got = convert.pool_to_numpy(tkv)
    n = got["q"].shape[2] - PS
    jq = np.asarray(jkv["q"]).astype(np.int8)[:, :, :n]
    js = np.asarray(jkv["scale"])[:, :, :n]
    tq, ts = got["q"][:, :, :n], got["scale"][:, :, :n]
    np.testing.assert_allclose(ts, js, rtol=1e-5)
    dq = np.abs(tq.astype(np.int32) - jq.astype(np.int32))
    assert dq.max() <= 1
    assert not dq[ts == js].any()


def _qprefill_both(wmode, qdt, lens, T, n_pages=24, max_pages=6, seed=0):
    from aigw_tpu.models import kvq as jkvq

    jcfg, tcfg = QCFG
    jp, tp = _qweights(wmode)
    B = len(lens)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, jcfg.vocab_size, (T,)).astype(np.int32)
    row_seq, positions, last = _pack(lens, B, T)
    pt = rng.permutation(n_pages)[: B * max_pages].reshape(
        B, max_pages).astype(np.int32)
    shape = _pool_shape(jcfg, n_pages)
    jl, jkv = jllama.prefill_ragged(
        jp, jcfg, jnp.asarray(tokens), jnp.asarray(row_seq),
        jnp.asarray(positions), jnp.asarray(last), jkvq.make_pool(shape, qdt),
        jnp.asarray(pt), PS, attn_impl="")
    tkv = kvq.make_pool(shape, qdt, torch.device("cpu"))
    tl, tkv = tllama.prefill_ragged(
        tp, tcfg, *(torch.from_numpy(a) for a in
                    (tokens, row_seq, positions, last)), tkv,
        torch.from_numpy(pt), PS)
    return jp, tp, pt, np.asarray(jl), jkv, tl.numpy(), tkv


@pytest.mark.parametrize("wmode,qdt,T", [
    ("int8", "int8", 64),  # W8A16 at M = 64: K6 in both prefills
    ("int4", "int4", 96),
    ("", "int8", 48),
], ids=["w8_kv8_k6", "w4_kv4", "bf_kv8"])
def test_prefill_ragged_quantized_matches_jax(wmode, qdt, T):
    """A quantized pool prefills through the windowed program on both
    sides (the reference's ``attn_impl=""``): logits within 1e-4."""
    (_, _, _, jl, jkv, tl, tkv) = _qprefill_both(wmode, qdt, [5, 17, 9, 1],
                                                 T)
    np.testing.assert_allclose(tl, jl, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    _assert_pools_close(tkv, jkv)


def test_prefill_windowed_row_passes_match_one_pass(monkeypatch):
    """The windowed program attends ``WINDOW_ROWS`` packed rows per pass,
    each pass walking only up to its own highest valid position: with
    8-row passes (some all padding, some skipping pages) the logits and
    the pool's pages equal one pass over every row, bit for bit."""
    (_, tp, pt, _, _, tl, tkv) = _qprefill_both("", "int8", [5, 17, 9, 1],
                                                48)
    _, tcfg = QCFG
    B = 4
    row_seq, positions, last = _pack([5, 17, 9, 1], B, 48)
    tokens = np.random.default_rng(0).integers(
        0, tcfg.vocab_size, (48,)).astype(np.int32)
    monkeypatch.setattr(tllama, "WINDOW_ROWS", 8)
    kv8 = kvq.make_pool(_pool_shape(tcfg, 24), "int8", torch.device("cpu"))
    l8, kv8 = tllama.prefill_ragged(
        tp, tcfg, *(torch.from_numpy(a) for a in
                    (tokens, row_seq, positions, last)), kv8,
        torch.from_numpy(pt), PS)
    np.testing.assert_array_equal(l8.numpy(), tl)
    for key in ("q", "scale"):  # the dump page's rows are scratch
        assert torch.equal(kv8[key][:, :, :-PS], tkv[key][:, :, :-PS]), key


@pytest.mark.parametrize("wmode,qdt", [("int8", "int8"), ("int8", "int4"),
                                       ("int4", "int8"), ("", "int4")],
                         ids=["w8_kv8", "w8_kv4", "w4_kv8", "bf_kv4"])
def test_decode_steps_quantized_match_jax(wmode, qdt):
    """Prefill, then decode steps on both sides over a quantized pool
    with W8A16 / W4A16 / f32 weights: the reference's ``fused-pallas``
    rung (K6 and K7's Pallas kernels in interpret mode) against the
    port's fused rung (their plain versions). Active slots' logits
    within 1e-4; pools as ``_assert_pools_close``."""
    lens = [5, 7, 3]
    jcfg, tcfg = QCFG
    (jp, tp, pt, jl, jkv, _tl, tkv) = _qprefill_both(wmode, qdt, lens, 32)
    tokens = np.argmax(jl, -1).astype(np.int32)
    positions = np.asarray(lens, np.int32)
    active = np.array([True, True, False])
    for _ in range(4):
        jlog, jkv = jllama.decode_step(
            jp, jcfg, jnp.asarray(tokens), jnp.asarray(positions), jkv,
            jnp.asarray(pt), PS, jnp.asarray(active),
            attn_impl="fused-pallas")
        tlog, tkv = tllama.decode_step(
            tp, tcfg, torch.from_numpy(tokens), torch.from_numpy(positions),
            tkv, torch.from_numpy(pt), PS, torch.from_numpy(active))
        jlog = np.asarray(jlog)
        np.testing.assert_allclose(tlog.numpy()[active], jlog[active],
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        tokens = np.where(active, np.argmax(jlog, -1), tokens).astype(
            np.int32)
        positions = np.where(active, positions + 1, positions).astype(
            np.int32)
    _assert_pools_close(tkv, jkv)


def test_plain_flag_keeps_w8a16_off_the_kernel_wrapper(monkeypatch):
    """``plain=True`` sends every K6-shaped W8A16 matrix to K6's plain
    version: the wrapper is called on the default path (here, at every
    aligned projection and the lm_head) and never under ``plain``, and
    both give the same logits on the CPU."""
    from aigw_tpu_torch.ops import qmatmul

    _, tp = _qweights("int8")
    _, tcfg = QCFG
    calls = []
    wrapper = qmatmul.w8a16_matmul

    def counted(*args):
        calls.append(args[0].shape)
        return wrapper(*args)

    monkeypatch.setattr(qmatmul, "w8a16_matmul", counted)
    tokens = torch.tensor([3, 9], dtype=torch.int32)
    positions = torch.tensor([0, 4], dtype=torch.int32)
    pt = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    active = torch.ones(2, dtype=torch.bool)
    out = {}
    for plain in (False, True):
        kv = kvq.make_pool(_pool_shape(tcfg, 4), "int8", torch.device("cpu"))
        calls.clear()
        out[plain], _ = tllama.decode_step(tp, tcfg, tokens, positions, kv,
                                           pt, PS, active, plain=plain)
        n = len(calls)
        # wq, wo, w_gate, w_up, w_down per layer, then the lm_head (wk
        # and wv, 64 wide, are under K6's 128-column tile)
        assert n == (0 if plain else 5 * tcfg.n_layers + 1), (plain, n)
    torch.testing.assert_close(out[True], out[False], rtol=0, atol=0)


def test_chained_rung_refuses_quantized_pool():
    _, tcfg = QCFG
    kv = kvq.make_pool(_pool_shape(tcfg, 4), "int4", torch.device("cpu"))
    z = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="fused"):
        tllama.decode_step({}, tcfg, z, z, kv,
                           torch.zeros((1, 2), dtype=torch.int32), PS,
                           torch.ones(1, dtype=torch.bool),
                           attn_impl="chained")


# -- speculative verify ---------------------------------------------------------
def _verify_both(jp, tp, jcfg, tcfg, jkv, tkv, pt, tokens, positions, active,
                 limits, rung):
    """One verify step on each side: the reference's ``"pallas"`` (its
    verify kernel, interpret mode) against the port's ``"chained"`` (K5's
    plain version), or both gather paths (``""``). Returns (reference
    logits, reference pool, port logits, port pool, valid rows)."""
    jimpl, timpl = {"chained": ("pallas", "chained"), "gather": ("", "")}[
        rung]
    jl, jkv = jllama.verify_step(
        jp, jcfg, jnp.asarray(tokens), jnp.asarray(positions), jkv,
        jnp.asarray(pt), PS, jnp.asarray(active), jnp.asarray(limits),
        attn_impl=jimpl)
    tl, tkv = tllama.verify_step(
        tp, tcfg, *(torch.from_numpy(a) for a in (tokens, positions)), tkv,
        torch.from_numpy(pt), PS, torch.from_numpy(active),
        torch.from_numpy(limits), attn_impl=timpl)
    S = tokens.shape[1]
    pos = positions[:, None] + np.arange(S)[None]
    valid = active[:, None] & (pos < limits[:, None])
    return np.asarray(jl), jkv, tl.numpy(), tkv, valid


@pytest.mark.parametrize("rung", ["chained", "gather"])
@pytest.mark.parametrize("name", sorted(CFGS))
def test_verify_step_matches_jax(name, rung):
    """After a prefill, a 5-wide verify step with an inactive slot and a
    slot fenced by its limit mid-window (positions 7..11, limit 9): the
    logits of every valid row within 1e-4, and the pools (writes past
    the limit fenced out) within 1e-5 outside the dump page."""
    lens = [5, 7, 3]
    (jcfg, tcfg, jp, tp, pt, _jl, jkv, _tl, tkv) = _prefill_both(name, lens)
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, jcfg.vocab_size, (3, 5)).astype(np.int32)
    positions = np.asarray(lens, np.int32)
    active = np.array([True, True, False])
    limits = np.array([40, 9, 40], np.int32)
    jl, jkv, tl, tkv, valid = _verify_both(
        jp, tp, jcfg, tcfg, jnp.asarray(jkv), tkv, pt, tokens, positions,
        active, limits, rung)
    np.testing.assert_allclose(tl[valid], jl[valid], rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    n = jkv.shape[2] - PS
    np.testing.assert_allclose(tkv.numpy()[:, :, :n],
                               np.asarray(jkv)[:, :, :n],
                               rtol=POOL_TOL, atol=POOL_TOL)
    # the fence: slot 1 wrote positions 7 and 8 only
    for p_ in (9, 10, 11):
        row = pt[1, p_ // PS] * PS + p_ % PS
        assert not tkv[:, :, row].any()


@pytest.mark.parametrize("rung", ["chained", "gather"])
def test_verify_step_near_max_seq_len(rung):
    """A window at max_seq_len - 2 (positions past the page table) and
    an inactive slot parked at max_seq_len: no page index past the
    table, and the valid rows match the reference."""
    lens = [5, 7]
    max_pages = 6
    (jcfg, tcfg, jp, tp, pt, _jl, jkv, _tl, tkv) = _prefill_both(
        "tiny", lens, max_pages=max_pages)
    end = max_pages * PS
    tokens = np.arange(10, dtype=np.int32).reshape(2, 5)
    positions = np.array([end - 2, end], np.int32)
    active = np.array([True, False])
    limits = np.array([end, end], np.int32)
    jl, jkv, tl, tkv, valid = _verify_both(
        jp, tp, jcfg, tcfg, jnp.asarray(jkv), tkv, pt, tokens, positions,
        active, limits, rung)
    assert valid.sum() == 2
    np.testing.assert_allclose(tl[valid], jl[valid], rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    n = jkv.shape[2] - PS
    np.testing.assert_allclose(tkv.numpy()[:, :, :n],
                               np.asarray(jkv)[:, :, :n],
                               rtol=POOL_TOL, atol=POOL_TOL)


@pytest.mark.parametrize("wmode,qdt", [("", "int8"), ("int4", "int4")],
                         ids=["bf_kv8", "w4_kv4"])
def test_verify_step_quantized_matches_jax(wmode, qdt):
    """A quantized pool verifies on the gather path on both sides (the
    rows dequantized in float32 and rounded to bf16): valid rows' logits
    within 1e-4, pools as ``_assert_pools_close``; the chained path
    refuses the pool."""
    lens = [5, 7, 3]
    jcfg, tcfg = QCFG
    (jp, tp, pt, _jl, jkv, _tl, tkv) = _qprefill_both(wmode, qdt, lens, 32)
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, jcfg.vocab_size, (3, 4)).astype(np.int32)
    positions = np.asarray(lens, np.int32)
    active = np.array([True, True, False])
    limits = np.array([40, 9, 40], np.int32)
    jl, jkv, tl, tkv, valid = _verify_both(
        jp, tp, jcfg, tcfg, jkv, tkv, pt, tokens, positions, active, limits,
        "gather")
    np.testing.assert_allclose(tl[valid], jl[valid], rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    _assert_pools_close(tkv, jkv)
    with pytest.raises(NotImplementedError, match="gather"):
        tllama.verify_step(tp, tcfg, torch.from_numpy(tokens),
                           torch.from_numpy(positions), tkv,
                           torch.from_numpy(pt), PS,
                           torch.from_numpy(active),
                           torch.from_numpy(limits), attn_impl="chained")


def test_verify_step_equals_sequential_decode():
    """The port's verify logits at every position equal decode steps run
    one token at a time over the same inputs (the reference's own
    property, ``tests/test_spec_decode.py``), in float32 within 1e-4."""
    lens = [5]
    (jcfg, tcfg, jp, tp, pt, _jl, _jkv, _tl, tkv0) = _prefill_both(
        "tiny", lens)
    inputs = np.array([[9, 2, 6, 5]], np.int32)
    one = np.ones(1, bool)
    ver, _ = tllama.verify_step(
        tp, tcfg, torch.from_numpy(inputs), torch.tensor([5]), tkv0.clone(),
        torch.from_numpy(pt), PS, torch.from_numpy(one), torch.tensor([64]),
        attn_impl="chained")
    tkv = tkv0.clone()
    for d in range(inputs.shape[1]):
        lg, tkv = tllama.decode_step(
            tp, tcfg, torch.from_numpy(inputs[:, d]), torch.tensor([5 + d]),
            tkv, torch.from_numpy(pt), PS, torch.from_numpy(one),
            attn_impl="chained")
        np.testing.assert_allclose(ver[0, d].numpy(), lg[0].numpy(),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
