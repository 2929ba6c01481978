"""Multi-LoRA in the port against the JAX package: the adapter math,
the store and the model entry points.

The reference's adapters (``init_lora_adapters(PRNGKey(7), ...,
random_b=True)``, bf16 stacks as the reference serves them) and weights
(``init_params(PRNGKey(0), float32)``) cross through
``models/convert.py``; inputs are made from a seed with numpy, and both
sides run on the CPU in float32 over float32 pools (the reference's
Pallas kernels in interpret mode where its parity tests run them, the
port's plain versions). Every batch mixes adapter rows and the base
row:

- ``lora_delta`` within 1e-6 of the reference's (relative, and absolute
  against the delta's largest magnitude: float32 sums of rank-r products
  in another order), on ``[B, S, in]`` and on packed ``[T, 1, in]`` rows
  with per-sequence rows (the reference gathers per token), and exactly
  0 on the base row;
- ``validate_adapter_params``' and ``lora_delta``'s errors, message for
  message; ``init_lora_adapters``' A the same with ``random_b`` on and
  off;
- ``AdapterStore`` against the reference's store under one seeded
  ``acquire``/``release`` schedule (rows, loads, evictions, residency,
  invariants), its rows bit-equal to the host's bf16 cast;
- ``prefill_ragged`` (K1's path and the windowed int8 pool),
  ``decode_step`` (fused and chained), ``verify_step`` (gather and
  chained) and W8A16 weights: logits within 1e-4 of the reference's,
  and the base rows bit-equal to the same call with ``lora=None``.
"""

import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aigw_tpu.models import kvq as jkvq
from aigw_tpu.models import llama as jllama
from aigw_tpu.models import lora as jlora
from aigw_tpu.tpuserve import adapters as jadapters
from aigw_tpu_torch.models import convert, kvq
from aigw_tpu_torch.models import llama as tllama
from aigw_tpu_torch.models import lora as tlora
from aigw_tpu_torch.models import mixtral as tmixtral
from aigw_tpu_torch.tpuserve import adapters as tadapters

DELTA_TOL = 1e-6
LOGIT_TOL = 1e-4
PS = 8
ALL = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
JLORA = jlora.LoRAConfig(rank=4, alpha=8.0, targets=ALL)
N_AD = 3
BASE_ROW = N_AD


@functools.lru_cache(maxsize=None)
def _stacks(jcfg, targets=ALL):
    """The reference's stacked adapters (bf16) and the port's copy, made
    once per configuration (the reference's eager draws are slow)."""
    cfg = jlora.LoRAConfig(rank=4, alpha=8.0, targets=targets)
    j = jlora.init_lora_adapters(jax.random.PRNGKey(7), jcfg, cfg, N_AD,
                                 random_b=True)
    return j, convert.adapters_from_numpy(
        {k: np.asarray(v) for k, v in j.items()}, torch.bfloat16, "cpu")


# -- lora_delta ---------------------------------------------------------------
@pytest.mark.parametrize("key", ["l0.wq", "l1.w_down", "l0.wo"])
@pytest.mark.parametrize("layout", ["batched", "packed"])
def test_lora_delta_matches_reference(key, layout):
    jst, tst = _stacks(jllama.TINY)
    d_in = np.asarray(jst[key + ".lora_a"]).shape[-1]
    rng = np.random.default_rng(3)
    idx = np.array([0, BASE_ROW, 2, 1, BASE_ROW], np.int32)
    if layout == "batched":
        x = rng.standard_normal((len(idx), 3, d_in), np.float32)
        want = jlora.lora_delta(jst, key, jnp.asarray(x), jnp.asarray(idx))
        got = tlora.lora_delta(tst, key, torch.from_numpy(x),
                               torch.from_numpy(idx))
        base = idx == BASE_ROW
    else:  # packed rows, sequences back to back; the reference per token
        row_seq = np.repeat(np.arange(len(idx)), [4, 1, 6, 3, 2])
        x = rng.standard_normal((len(row_seq), 1, d_in), np.float32)
        want = jlora.lora_delta(jst, key, jnp.asarray(x),
                                jnp.asarray(idx[row_seq]))
        got = tlora.lora_delta(tst, key, torch.from_numpy(x),
                               torch.from_numpy(idx),
                               torch.from_numpy(row_seq))
        base = idx[row_seq] == BASE_ROW
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=DELTA_TOL,
                               atol=DELTA_TOL * np.abs(want).max())
    assert not got.numpy()[base].any()  # the base row: an exact zero
    assert np.abs(want[~base]).max() > 1e-2  # the adapters are visible


def test_lora_delta_none_and_half_pair():
    _, tst = _stacks(jllama.TINY, targets=("wq",))
    x = torch.zeros((1, 1, jllama.TINY.dim))
    idx = torch.tensor([0])
    assert tlora.lora_delta(None, "l0.wq", x, idx) is None
    assert tlora.lora_delta(tst, "l0.wq", x, None) is None
    assert tlora.lora_delta(tst, "l0.wv", x, idx) is None  # not a target
    half = {"l0.wq.lora_a": torch.zeros((2, 4, jllama.TINY.dim))}
    jhalf = {"l0.wq.lora_a": jnp.zeros((2, 4, jllama.TINY.dim))}
    with pytest.raises(ValueError) as je:
        jlora.lora_delta(jhalf, "l0.wq", jnp.zeros((1, 1, 64)),
                         jnp.array([0]))
    with pytest.raises(ValueError) as te:
        tlora.lora_delta(half, "l0.wq", x, idx)
    assert str(te.value) == str(je.value)
    assert "l0.wq.lora_b missing" in str(te.value)


@pytest.mark.parametrize("case", ["good", "missing_b", "missing_a",
                                  "unexpected", "rank"])
def test_validate_adapter_params_matches_reference(case):
    ad = dict(_zoo()["ad0"])
    a = next(k for k in ad if k.endswith(".lora_a"))
    b = a[:-1] + "b"
    if case == "missing_b":
        del ad[b]
    elif case == "missing_a":
        del ad[a]
    elif case == "unexpected":
        ad = {"l0.wq.weird": np.zeros((1,))}
    elif case == "rank":
        ad[a] = np.zeros((8, jllama.TINY.dim), np.float32)
    results = []
    for fn in (jlora.validate_adapter_params,
               tlora.validate_adapter_params):
        try:
            fn(ad, "zoo-entry")
            results.append(None)
        except ValueError as e:
            results.append(str(e))
    assert results[0] == results[1]
    assert (results[1] is None) == (case == "good")


def test_init_lora_adapters_key_stream_and_shapes():
    """A is the same whether B is drawn random or zero; the last row is
    zero; shapes and scales are the reference's."""
    cfg = tlora.LoRAConfig(rank=4, alpha=8.0, targets=ALL)
    on = tlora.init_lora_adapters(3, tllama.TINY, cfg, 2, torch.float32,
                                  random_b=True, device="cpu")
    off = tlora.init_lora_adapters(3, tllama.TINY, cfg, 2, torch.float32,
                                   random_b=False, device="cpu")
    ref = jax.eval_shape(lambda k: jlora.init_lora_adapters(
        k, jllama.TINY, JLORA, 2, random_b=True), jax.random.PRNGKey(3))
    assert {k: tuple(v.shape) for k, v in on.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    for k in on:
        assert not on[k][-1].any()  # the base row
        if k.endswith(".lora_a"):
            assert torch.equal(on[k], off[k])
        else:
            assert not off[k].any() and on[k][:-1].any()
    # A: N(0, 1/in) * alpha / rank; B: N(0, 1/r)
    a = on["l0.w_down.lora_a"][:-1]
    assert abs(float(a.std()) - 2.0 / np.sqrt(tllama.TINY.ffn_dim)) < 0.03
    assert abs(float(on["l0.w_up.lora_b"][:-1].std()) - 0.5) < 0.05
    assert tlora.LoRAConfig() == tlora.LoRAConfig(16, 32.0, ("wq", "wv"))


# -- AdapterStore ---------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _zoo():
    """Six single adapters (float32 numpy, rank 4, wq and wv)."""
    j = jlora.init_lora_adapters(jax.random.PRNGKey(7), jllama.TINY,
                                 jlora.LoRAConfig(rank=4, alpha=8.0), 6,
                                 random_b=True, dtype=jnp.float32)
    return {f"ad{i}": {k: np.asarray(v[i]) for k, v in j.items()}
            for i in range(6)}


def test_store_matches_reference_under_churn():
    """One seeded acquire/release schedule over a 3-row store and a
    6-adapter zoo, on both stores: the same row, error and counters at
    every step, the invariants, and every loaded row bit-equal to the
    reference's (the host's float32 rounded to bf16, nearest even)."""
    zoo = _zoo()
    js = jadapters.AdapterStore(n_slots=3)
    ts = tadapters.AdapterStore(n_slots=3, device="cpu")
    for name, ad in zoo.items():
        js.register(name, ad)
        ts.register(name, ad)
    assert ts.names() == js.names() and ts.base_row == js.base_row == 3
    rng = random.Random(0xADA)
    pins: dict[str, list[int]] = {}
    for step in range(300):
        name = f"ad{rng.randrange(7)}"  # ad6 is not in the zoo
        if pins.get(name) and rng.random() < 0.5:
            row = pins[name].pop()
            js.release(row)
            ts.release(row)
        else:
            out = []
            for st in (js, ts):
                try:
                    out.append(st.acquire(name))
                except (jadapters.AdapterCapacityError,
                        tadapters.AdapterCapacityError) as e:
                    out.append(type(e).__name__)
                except (jadapters.UnknownAdapterError,
                        tadapters.UnknownAdapterError) as e:
                    out.append(type(e).__name__)
            assert out[0] == out[1], (step, name, out)
            if isinstance(out[1], int):
                pins.setdefault(name, []).append(out[1])
            elif out[1] == "AdapterCapacityError":
                victim = next(n for n, rs in pins.items() if rs)
                row = pins[victim].pop()
                js.release(row)
                ts.release(row)
        ts.check_invariants()
        assert (ts.loads, ts.evictions, ts.resident_names()) == \
            (js.loads, js.evictions, js.resident_names())
        for n in pins:
            assert ts.refcount(n) == js.refcount(n)
    assert ts.evictions > 5 and ts.loads > 8
    for k, stack in ts.params.items():
        want = np.asarray(js.params[k]).astype(np.float32)
        np.testing.assert_array_equal(stack.float().numpy(), want)
        assert stack.dtype == torch.bfloat16
        assert not stack[ts.base_row].any()
    # a resident row equals its adapter's host values cast to bf16
    name = ts.resident_names()[0]
    row = ts.row_of(name)
    for k, v in zoo[name].items():
        host = torch.tensor(v).to(torch.bfloat16)
        assert torch.equal(ts.params[k][row], host)


def test_store_register_and_errors_match_reference():
    zoo = _zoo()
    # rank 8 against the zoo's rank 4
    wrong = {k: np.zeros(v.shape[:-2] + (8, v.shape[-1])
                         if k.endswith(".lora_a") else v.shape[:-1] + (8,),
                         np.float32)
             for k, v in zoo["ad0"].items()}
    msgs = []
    for st in (jadapters.AdapterStore(n_slots=2),
               tadapters.AdapterStore(n_slots=2, device="cpu")):
        st.register("ad0", zoo["ad0"])
        with pytest.raises(ValueError) as e:
            st.register("wrong", wrong)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "template" in msgs[1]
    with pytest.raises(ValueError, match="at least one row"):
        tadapters.AdapterStore(n_slots=0, device="cpu")
    ts = tadapters.AdapterStore(n_slots=1, device="cpu")
    assert ts.params == {}
    ts.warm()  # nothing registered: nothing to ready
    ts.register("ad0", zoo["ad0"])
    ts.warm()
    ts.release(ts.base_row)  # the base row is never tracked
    ts.release(0)  # nor is a row nothing holds
    ts.check_invariants()
    assert issubclass(tadapters.UnknownAdapterError, KeyError)
    with pytest.raises(KeyError):
        ts.row_of("ad0")  # not resident


# -- the model entry points ----------------------------------------------------
@functools.lru_cache(maxsize=None)
def _weights(jcfg, wmode=""):
    """The reference's float32 weights (quantized to ``wmode``) and the
    port's copy, drawn once per configuration."""
    from aigw_tpu.models import quant as jquant

    p = jllama.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    if wmode:
        p = jquant.quantize_params(p, mode=wmode)
    return p, convert.params_from_numpy(
        {k: np.asarray(v) for k, v in p.items()}, device="cpu")


#: 128-aligned widths, so W8A16 matrices reach K6 on both sides (the
#: reference's interpret-mode kernel, the port's plain version)
QCFG = dict(vocab_size=512, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
            ffn_dim=256, max_seq_len=256, rope_theta=10000.0)
MODELS = {
    "f32": (jllama.TINY, tllama.TINY, ""),
    "w8a16": (jllama.LlamaConfig(**QCFG), tllama.LlamaConfig(**QCFG),
              "int8"),
}
LENS = [5, 17, 9, 1]
ROWS = np.array([0, BASE_ROW, 2, 1], np.int32)
#: decode: the rows moved between slots; slot 3 inactive
DEC_ROWS = np.array([1, BASE_ROW, 0, 2], np.int32)
DEC_ACTIVE = np.array([True, True, True, False])
STEPS = 2


def _pack(lens, B, T):
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


def _base_rows_exact(tl, tl0, rows):
    """The base rows of a call with adapters bit-equal to the same call
    without them; every adapter row differs."""
    base = torch.from_numpy(rows == BASE_ROW)
    assert torch.equal(tl[base], tl0[base])
    assert all(not torch.equal(tl[i], tl0[i])
               for i in np.flatnonzero(rows != BASE_ROW))


@pytest.fixture(scope="module", params=sorted(MODELS))
def reference(request):
    """The reference's packed prefill of LENS with mixed adapter rows,
    then STEPS greedy decode steps (its gather rung; the attention is
    held to the port's rungs by ``tests/test_torch_model.py``), over a
    float32 pool. Eager, as the reference's functions are written: under
    ``jax.jit`` XLA contracts f32 RoPE into FMAs and keeps W8A16's
    dequantized operand unrounded, moving logits by up to 0.025."""
    jcfg, tcfg, wmode = MODELS[request.param]
    jp, tp = _weights(jcfg, wmode)
    jst, tst = _stacks(jcfg)
    B, T, n_pages, max_pages = len(LENS), 48, 24, 6
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_size, (T,)).astype(np.int32)
    row_seq, positions, last = _pack(LENS, B, T)
    pt = rng.permutation(n_pages)[: B * max_pages].reshape(
        B, max_pages).astype(np.int32)
    shape = (jcfg.n_layers, 2, (n_pages + 1) * PS, jcfg.n_kv_heads,
             jcfg.head_dim)
    jl, jkv0 = jllama.prefill_ragged(
        jp, jcfg, *(jnp.asarray(a) for a in (
            tokens, row_seq, positions, last)), jnp.zeros(shape, jnp.float32),
        jnp.asarray(pt), PS, attn_impl="", lora=jst,
        adapter_idx=jnp.asarray(ROWS))
    toks = [np.argmax(np.asarray(jl), -1).astype(np.int32)]
    pos = [np.asarray(LENS, np.int32)]
    logits = []
    jkv = jkv0
    for _ in range(STEPS):
        jlog, jkv = jllama.decode_step(
            jp, jcfg, jnp.asarray(toks[-1]), jnp.asarray(pos[-1]), jkv,
            jnp.asarray(pt), PS, jnp.asarray(DEC_ACTIVE), lora=jst,
            adapter_idx=jnp.asarray(DEC_ROWS))
        logits.append(np.asarray(jlog))
        toks.append(np.where(DEC_ACTIVE, np.argmax(logits[-1], -1),
                             toks[-1]).astype(np.int32))
        pos.append((pos[-1] + DEC_ACTIVE).astype(np.int32))
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, jst=jst, tst=tst,
                pt=pt, shape=shape, packed=(tokens, row_seq, positions,
                                            last),
                jl=np.asarray(jl), jkv=np.asarray(jkv0), dec_logits=logits,
                dec_tokens=toks, dec_pos=pos)


def _port_prefill(d, lora=True):
    kw = dict(lora=d["tst"], adapter_idx=torch.from_numpy(ROWS)) \
        if lora else {}
    return tllama.prefill_ragged(
        d["tp"], d["tcfg"], *(torch.from_numpy(a) for a in d["packed"]),
        torch.zeros(d["shape"]), torch.from_numpy(d["pt"]), PS, **kw)


def test_prefill_ragged_with_adapters_matches_reference(reference):
    """K1's path (its plain version) with per-sequence adapter rows; the
    pool too (K/V carry the wk/wv deltas)."""
    d = reference
    tl, tkv = _port_prefill(d)
    tl0, _ = _port_prefill(d, lora=False)
    np.testing.assert_allclose(tl.numpy(), d["jl"], rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    n = d["jkv"].shape[2] - PS  # everything but the dump page
    np.testing.assert_allclose(tkv.numpy()[:, :, :n], d["jkv"][:, :, :n],
                               rtol=1e-5, atol=1e-5)
    _base_rows_exact(tl, tl0, ROWS)


@pytest.mark.parametrize("rung", ["fused", "chained"])
def test_decode_steps_with_adapters_match_reference(reference, rung):
    """The fused rung (the kernel gets q/k/v carrying the deltas) and the
    chained rung, teacher-forced on the reference's tokens; the base row
    bit-equal to the same step without adapters on the same pool."""
    d = reference
    _, tkv = _port_prefill(d)
    pt = torch.from_numpy(d["pt"])
    act = torch.from_numpy(DEC_ACTIVE)
    for k in range(STEPS):
        args = (d["tp"], d["tcfg"], torch.from_numpy(d["dec_tokens"][k]),
                torch.from_numpy(d["dec_pos"][k]))
        tlog0, _ = tllama.decode_step(*args, tkv.clone(), pt, PS, act, rung)
        tlog, tkv = tllama.decode_step(*args, tkv, pt, PS, act, rung,
                                       lora=d["tst"],
                                       adapter_idx=torch.from_numpy(DEC_ROWS))
        np.testing.assert_allclose(tlog.numpy()[DEC_ACTIVE],
                                   d["dec_logits"][k][DEC_ACTIVE],
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        base = torch.from_numpy(DEC_ROWS == BASE_ROW)
        assert torch.equal(tlog[base], tlog0[base])
        assert not torch.equal(tlog[0], tlog0[0])


@pytest.mark.parametrize("impl", ["", "chained"])
def test_verify_step_with_adapters_matches_reference(reference, impl):
    d = reference
    S = 4
    rng = np.random.default_rng(9)
    toks = rng.integers(0, d["jcfg"].vocab_size, (4, S)).astype(np.int32)
    pos0 = np.asarray(LENS, np.int32)
    active = np.array([True, True, False, True])
    limits = pos0 + 3
    rows = np.array([2, BASE_ROW, 1, 0], np.int32)
    jlog, _ = jllama.verify_step(
        d["jp"], d["jcfg"], jnp.asarray(toks), jnp.asarray(pos0),
        jnp.asarray(d["jkv"]), jnp.asarray(d["pt"]), PS,
        jnp.asarray(active), jnp.asarray(limits), lora=d["jst"],
        adapter_idx=jnp.asarray(rows))
    args = (d["tp"], d["tcfg"], torch.from_numpy(toks),
            torch.from_numpy(pos0))
    kv = convert.pool_from_numpy(d["jkv"], "cpu")
    rest = (torch.from_numpy(d["pt"]), PS, torch.from_numpy(active),
            torch.from_numpy(limits), impl)
    tlog, _ = tllama.verify_step(*args, kv.clone(), *rest, lora=d["tst"],
                                 adapter_idx=torch.from_numpy(rows))
    tlog0, _ = tllama.verify_step(*args, kv.clone(), *rest)
    valid = active[:, None] & (pos0[:, None] + np.arange(S) < limits[:, None])
    np.testing.assert_allclose(tlog.numpy()[valid], np.asarray(jlog)[valid],
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    assert torch.equal(tlog[1], tlog0[1])  # the base row
    assert not torch.equal(tlog[0], tlog0[0])


def test_windowed_int8_prefill_with_adapters_matches_reference():
    """The quantized pool's windowed program, adapters on the packed
    rows, over an int8 pool."""
    jcfg, tcfg = jllama.TINY, tllama.TINY
    jp, tp = _weights(jcfg)
    jst, tst = _stacks(jcfg)
    lens, B, T, n_pages, max_pages = [11, 4, 20], 3, 40, 16, 4
    rows = np.array([BASE_ROW, 1, 0], np.int32)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, jcfg.vocab_size, (T,)).astype(np.int32)
    row_seq, positions, last = _pack(lens, B, T)
    pt = rng.permutation(n_pages)[: B * max_pages].reshape(
        B, max_pages).astype(np.int32)
    shape = (jcfg.n_layers, 2, (n_pages + 1) * PS, jcfg.n_kv_heads,
             jcfg.head_dim)
    jl, _ = jllama.prefill_ragged(
        jp, jcfg, *(jnp.asarray(a) for a in
                    (tokens, row_seq, positions, last)),
        jkvq.make_pool(shape, "int8"), jnp.asarray(pt), PS, attn_impl="",
        lora=jst, adapter_idx=jnp.asarray(rows))
    targs = [torch.from_numpy(a) for a in (tokens, row_seq, positions, last)]
    cpu = torch.device("cpu")
    tl, tkv = tllama.prefill_ragged(
        tp, tcfg, *targs, kvq.make_pool(shape, "int8", cpu),
        torch.from_numpy(pt), PS, lora=tst,
        adapter_idx=torch.from_numpy(rows))
    tl0, _ = tllama.prefill_ragged(tp, tcfg, *targs,
                                   kvq.make_pool(shape, "int8", cpu),
                                   torch.from_numpy(pt), PS)
    assert kvq.is_quantized(tkv)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    _base_rows_exact(tl, tl0, rows)


def test_mixtral_entry_points_ignore_adapters():
    """The mixtral family takes the adapter arguments and ignores them,
    as the reference's does: the same logits with and without."""
    cfg = tmixtral.TINY_MOE
    p = tmixtral.init_params(0, cfg, torch.float32, device="cpu")
    _, tst = _stacks(jllama.TINY)
    B, T = 2, 16
    row_seq, positions, last = _pack([7, 5], B, T)
    tokens = torch.arange(T) % cfg.vocab_size
    pt = torch.arange(B * 4, dtype=torch.int32).reshape(B, 4)
    shape = (cfg.n_layers, 2, (B * 4 + 1) * PS, cfg.n_kv_heads,
             cfg.dim // cfg.n_heads)
    out = [tmixtral.prefill_ragged(
        p, cfg, tokens, *(torch.from_numpy(a) for a in
                          (row_seq, positions, last)),
        torch.zeros(shape), pt, PS, **kw)[0]
        for kw in ({}, dict(lora=tst,
                            adapter_idx=torch.tensor([0, 1])))]
    assert torch.equal(out[0], out[1])
