"""The port's mixtral family (``aigw_tpu_torch/models/mixtral.py``) against
the JAX package's, on the reference's own weights.

Weights are the reference's ``init_params(PRNGKey(7), cfg, float32)``
(bf16 where a case says so) carried across by ``models/convert.py``;
activations and tokens are made from a numpy seed. Both sides run on
the CPU: the reference's entry points with its Pallas kernels in
interpret mode (``attn_impl="pallas"`` / ``"fused-pallas"``), the
port's with its kernels' plain versions.

- ``moe_mlp``: the output within 1e-5 in float32 and the routing tape
  equal, for a capacity that binds (drops > 0), padding-like repeated
  rows, a router with duplicated columns (exact ties, which top-k must
  break toward the lower expert), bf16 weights, and int8 / int4 expert
  stacks (float32 activations against bf16-dequantized weights).
- ``quantize_params`` on ``[E, in, out]`` stacks: q and scales equal to
  the reference's in both modes; ``_w`` on the stacks bit-equal.
- The entry points with ``moe_stats=True`` over float32, int8 and int4
  pools, fused and chained rungs: logits within 1e-4 and the ``[L, E +
  1]`` leaf equal.
- The random-weight stream: quantizing each tensor as it is drawn
  gives what quantizing the whole draw gives, bit for bit.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aigw_tpu.models import kvq as jkvq
from aigw_tpu.models import llama as jllama
from aigw_tpu.models import mixtral as jmixtral
from aigw_tpu.models import quant as jquant
from aigw_tpu_torch.models import convert, kvq, quant
from aigw_tpu_torch.models import llama as tllama
from aigw_tpu_torch.models import mixtral as tmixtral
from aigw_tpu_torch.models.registry import family_fns, get_model_spec

MLP_TOL = 1e-5
LOGIT_TOL = 1e-4
PS = 8  # page size
#: 128-aligned widths: every expert stack groups for int4
QMOE = dict(vocab_size=512, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
            ffn_dim=256, n_experts=4, experts_per_token=2, max_seq_len=256,
            rope_theta=10000.0)


def _cfgs(**over):
    """(reference config, port config) of tiny-moe with ``over``."""
    j = dataclasses.replace(jmixtral.TINY_MOE, **over)
    return j, tmixtral.MixtralConfig(**dataclasses.asdict(j))


def _carry(p):
    return convert.params_from_numpy({k: np.asarray(v) for k, v in p.items()},
                                     device="cpu")


def _weights(jcfg, dtype=jnp.float32, wmode=""):
    p = jmixtral.init_params(jax.random.PRNGKey(7), jcfg, dtype)
    if wmode:
        p = jquant.quantize_params(p, mode=wmode)
    return p, _carry(p)


def test_presets_and_registry_match_reference():
    from aigw_tpu.models.registry import get_model_spec as ref_spec

    for name in ("tiny-moe", "mixtral-8x7b"):
        got, want = get_model_spec(name), ref_spec(name)
        assert got.family == want.family == "mixtral"
        assert dataclasses.asdict(got.config) == dataclasses.asdict(
            want.config)
        assert got.weights == want.weights
    assert dataclasses.asdict(tmixtral.TINY_MOE.as_llama()) == \
        dataclasses.asdict(jmixtral.TINY_MOE.as_llama())
    fns = family_fns("mixtral")
    assert fns.moe_stats and fns.verify_step is tmixtral.verify_step
    assert not family_fns("llama").moe_stats


@pytest.mark.parametrize("T", [1, 2, 3, 7, 8, 40, 64, 1000])
@pytest.mark.parametrize("cf", [2.0, 0.5, 1.25])
def test_capacity_is_the_reference_expression(T, cf):
    jcfg, tcfg = _cfgs(capacity_factor=cf)
    C = max(jcfg.experts_per_token, int(math.ceil(
        T * jcfg.experts_per_token / jcfg.n_experts * cf)))
    assert tmixtral.capacity(T, tcfg) == min(C, T)


def test_top_k_breaks_ties_toward_the_lower_index():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((16, 8)).astype(np.float32)
    logits[:, 5] = logits[:, 2]  # exact ties
    logits[:, 7] = logits[:, 2]
    logits[3] = 0.5  # a row of all-equal values
    want_v, want_i = jax.lax.top_k(jnp.asarray(logits), 3)
    got_v, got_i = tmixtral.top_k(torch.from_numpy(logits), 3)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def _mlp_case(case):
    """(reference cfg, port cfg, reference params, port params, x) of
    one moe_mlp case."""
    over, dtype, wmode, xdt = {
        "f32": ({}, jnp.float32, "", np.float32),
        "binding": ({"capacity_factor": 0.5}, jnp.float32, "", np.float32),
        "ties": ({}, jnp.float32, "", np.float32),
        "padding": ({"capacity_factor": 1.0}, jnp.float32, "", np.float32),
        "bf16": ({}, jnp.bfloat16, "", jnp.bfloat16),
        "w8": ({}, jnp.float32, "int8", np.float32),
        "w4": (QMOE, jnp.float32, "int4", np.float32),
    }[case]
    jcfg, tcfg = _cfgs(**over)
    jp, tp = _weights(jcfg, dtype, wmode)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 6, jcfg.dim)).astype(np.float32)
    if case == "ties":
        # experts 1 and 3 share expert 0's router column: every token
        # ties three ways, so the lower expert must win each tie
        g = np.asarray(jp["l0.gate"]).copy()
        g[:, 1] = g[:, 0]
        g[:, 3] = g[:, 0]
        jp = dict(jp, **{"l0.gate": jnp.asarray(g)})
        tp = dict(tp, **{"l0.gate": torch.from_numpy(g)})
    if case == "padding":
        # the tail rows repeat one row, as a packed call's padding rows
        # (token 0 at position 0) do: they all route alike and fill
        # their experts' tail slots
        x[2:] = x[2, 0]
    return jcfg, tcfg, jp, tp, np.asarray(jnp.asarray(x, xdt))


@pytest.mark.parametrize("case", ["f32", "binding", "ties", "padding",
                                  "bf16", "w8", "w4"])
def test_moe_mlp_matches_reference(case):
    jcfg, tcfg, jp, tp, x = _mlp_case(case)
    tape: list = []
    want = jmixtral.moe_mlp(jp, 0, jnp.asarray(x), jcfg, tape=tape)
    stats: list = []
    xt = convert.tensor_from_numpy(x, "cpu")
    got = tmixtral.moe_mlp(tp, 0, xt, tcfg, stats)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    np.testing.assert_array_equal(stats[0].numpy(), np.asarray(tape[0]))
    if case == "bf16":
        # one bf16 ulp of the output: the two libraries round bf16
        # intermediates (silu, the products) in different places
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(want, np.float32),
            rtol=2 ** -7, atol=2 ** -7)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=MLP_TOL, atol=MLP_TOL)
    placed, dropped = stats[0][:-1], int(stats[0][-1])
    assert int(placed.sum()) + dropped == x.size // x.shape[-1] * 2
    if case == "binding":
        assert dropped > 0
    if case == "ties":
        # expert 3 loses every three-way tie; expert 1 wins as second
        assert int(placed[3]) == 0 and int(placed[1]) > 0


def test_dropped_assignment_keeps_the_other_expert():
    """At capacity 2 of 24 rows nearly every assignment is dropped: a
    token whose two assignments are both dropped gets exactly zero (the
    residual is outside the layer), the reference's semantics."""
    jcfg, tcfg = _cfgs(capacity_factor=0.01)
    jp, tp = _weights(jcfg)
    x = np.random.default_rng(4).standard_normal((24, jcfg.dim)).astype(
        np.float32)
    stats: list = []
    got = tmixtral.moe_mlp(tp, 1, torch.from_numpy(x), tcfg, stats)
    want = jmixtral.moe_mlp(jp, 1, jnp.asarray(x)[None], jcfg)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MLP_TOL)
    assert int(stats[0][:-1].sum()) == 2 * jcfg.n_experts
    zero_rows = (got.abs().sum(-1) == 0).sum().item()
    assert zero_rows > 0 and zero_rows < 24


# -- quantized expert stacks -----------------------------------------------
@pytest.mark.parametrize("cfg", ["tiny-moe", "qmoe"])
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantize_params_stacks_match_reference(cfg, mode):
    jcfg, _ = _cfgs(**(QMOE if cfg == "qmoe" else {}))
    jp, tp = _weights(jcfg)
    jq = jquant.quantize_params(dict(jp), mode=mode)
    tq = quant.quantize_params(dict(tp), mode=mode)
    assert sorted(tq) == sorted(jq)
    carried = _carry(jq)
    for name in tq:
        assert tq[name].dtype == carried[name].dtype, name
        assert torch.equal(tq[name], carried[name]), name
    E, D, F = jcfg.n_experts, jcfg.dim, jcfg.ffn_dim
    assert tq["l0.gate"].dtype == torch.float32  # the router stays
    if mode == "int8":
        assert tq["l1.w_up.q"].shape == (E, D, F)
        assert tq["l1.w_up.scale"].shape == (E, 1, F)
    else:
        # w_down's input (ffn) always groups; w_gate's (dim) only at 128
        assert tq["l1.w_down.q"].shape == (E, F // 2, D)
        assert tq["l1.w_down.scale"].shape == (E, F // quant.GROUP4, D)
        np.testing.assert_array_equal(
            kvq.unpack_int4(tq["l1.w_down.q"], dim=-2).numpy(),
            np.asarray(jq["l1.w_down.q"]).astype(np.int8))


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_w_on_stacks_is_bit_equal(mode):
    jcfg, _ = _cfgs(**QMOE)
    jq, tq = _weights(jcfg, wmode=mode)
    for key in ("l0.w_gate", "l1.w_up", "l1.w_down", "l0.wq", "lm_head"):
        got = tllama._w(tq, key)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(jllama._w(jq, key), np.float32))


def test_params_from_numpy_carries_stacks():
    jcfg, _ = _cfgs(**QMOE)
    jq, tq = _weights(jcfg, wmode="int4")
    assert tq["l0.w_up.q"].dtype == torch.uint8
    assert tq["l0.w_up.q"].shape == (jcfg.n_experts, jcfg.dim // 2,
                                      jcfg.ffn_dim)
    np.testing.assert_array_equal(
        kvq.unpack_int4(tq["l0.w_up.q"], dim=-2).numpy(),
        np.asarray(jq["l0.w_up.q"]).astype(np.int8))
    np.testing.assert_array_equal(tq["l0.w_up.scale"].numpy(),
                                  np.asarray(jq["l0.w_up.scale"]))


# -- the random-weight stream ----------------------------------------------
def test_init_params_names_shapes_and_scales():
    _, tcfg = _cfgs()
    want = jmixtral.init_params(jax.random.PRNGKey(0), jmixtral.TINY_MOE)
    got = tmixtral.init_params(0, tcfg, torch.float32, "cpu")
    assert list(got) == list(want)
    for k in got:
        assert tuple(got[k].shape) == want[k].shape, k
    E = tcfg.n_experts
    w = got["l0.w_gate"]
    assert abs(w.std().item() - 1 / math.sqrt(tcfg.dim)) < 0.01
    assert abs(got["l0.w_down"].std().item()
               - 1 / math.sqrt(tcfg.ffn_dim)) < 0.01
    # every expert drew its own weights
    assert len({float(w[e].sum()) for e in range(E)}) == E
    assert torch.equal(got["norm_f"], torch.ones(tcfg.dim))


@pytest.mark.parametrize("family,mode", [("mixtral", "int8"),
                                         ("mixtral", "int4"),
                                         ("llama", "int8")])
def test_streamed_quantization_equals_draw_then_quantize(family, mode):
    spec = get_model_spec("tiny-moe" if family == "mixtral"
                          else "tiny-random")
    cfg = (tmixtral.MixtralConfig(**QMOE) if family == "mixtral"
           else spec.config)
    fns = family_fns(family)
    whole = quant.quantize_params(
        fns.init_params(3, cfg, torch.bfloat16, "cpu"), mode=mode)
    streamed = {}
    for name, w in fns.iter_params(3, cfg, torch.bfloat16, "cpu"):
        streamed.update(quant.quantize_params({name: w}, consume=True,
                                              mode=mode))
    assert list(streamed) == list(whole)
    for k in whole:
        assert torch.equal(streamed[k], whole[k]), k


# -- the entry points --------------------------------------------------------
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


def _pools(jcfg, qdt, n_pages=24):
    shape = (jcfg.n_layers, 2, (n_pages + 1) * PS, jcfg.n_kv_heads,
             jcfg.head_dim)
    if qdt == "float32":
        return jnp.zeros(shape, jnp.float32), torch.zeros(shape)
    return (jkvq.make_pool(shape, qdt),
            kvq.make_pool(shape, qdt, torch.device("cpu")))


def _logits_close(got, want, rows=None):
    got, want = got.numpy(), np.asarray(want)
    if rows is not None:
        got, want = got[rows], want[rows]
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("qdt,rung", [
    ("float32", "fused"), ("float32", "chained"), ("int8", "fused"),
    ("int4", "fused")])
def test_entry_points_with_moe_stats_match_reference(qdt, rung):
    """A packed prefill (padding rows at the tail), four decode steps
    with an inactive slot, then a 5-wide verify step: logits of every
    live row within 1e-4 and each call's [L, E + 1] leaf equal."""
    jcfg, tcfg = _cfgs()
    jp, tp = _weights(jcfg)
    lens = [5, 17, 9]
    B, T, max_pages = len(lens), 40, 6
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, jcfg.vocab_size, (T,)).astype(np.int32)
    row_seq, positions, last = _pack(lens, B, T)
    pt = rng.permutation(24)[:B * max_pages].reshape(B, max_pages).astype(
        np.int32)
    jkv, tkv = _pools(jcfg, qdt)
    quantized = qdt != "float32"
    jl, jkv, jm = jmixtral.prefill_ragged(
        jp, jcfg, *(jnp.asarray(a) for a in (tokens, row_seq, positions,
                                             last)),
        jkv, jnp.asarray(pt), PS, attn_impl="" if quantized else "pallas",
        moe_stats=True)
    tl, tkv, tm = tmixtral.prefill_ragged(
        tp, tcfg, *(torch.from_numpy(a) for a in (tokens, row_seq,
                                                  positions, last)),
        tkv, torch.from_numpy(pt), PS, moe_stats=True)
    assert tuple(tm.shape) == (jcfg.n_layers, jcfg.n_experts + 1)
    assert tm.dtype == torch.int32
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert int(tm.sum()) == jcfg.n_layers * T * jcfg.experts_per_token
    _logits_close(tl, jl)

    jimpl = {"fused": "fused-pallas", "chained": "pallas"}[rung]
    toks = np.argmax(np.asarray(jl), -1).astype(np.int32)
    pos = np.asarray(lens, np.int32)
    active = np.array([True, False, True])
    for _ in range(4):
        jl, jkv, jm = jmixtral.decode_step(
            jp, jcfg, jnp.asarray(toks), jnp.asarray(pos), jkv,
            jnp.asarray(pt), PS, jnp.asarray(active), attn_impl=jimpl,
            moe_stats=True)
        tl, tkv, tm = tmixtral.decode_step(
            tp, tcfg, torch.from_numpy(toks), torch.from_numpy(pos), tkv,
            torch.from_numpy(pt), PS, torch.from_numpy(active),
            attn_impl=rung, moe_stats=True)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        _logits_close(tl, jl, active)
        toks = np.where(active, np.argmax(np.asarray(jl), -1),
                        toks).astype(np.int32)
        pos = np.where(active, pos + 1, pos).astype(np.int32)

    vt = rng.integers(0, jcfg.vocab_size, (B, 5)).astype(np.int32)
    vt[:, 0] = toks
    limits = np.array([40, 40, pos[2] + 2], np.int32)
    vimpl = ("pallas", "chained") if rung == "chained" else ("", "")
    jl, jkv, jm = jmixtral.verify_step(
        jp, jcfg, jnp.asarray(vt), jnp.asarray(pos), jkv, jnp.asarray(pt),
        PS, jnp.asarray(active), jnp.asarray(limits), attn_impl=vimpl[0],
        moe_stats=True)
    tl, tkv, tm = tmixtral.verify_step(
        tp, tcfg, torch.from_numpy(vt), torch.from_numpy(pos), tkv,
        torch.from_numpy(pt), PS, torch.from_numpy(active),
        torch.from_numpy(limits), attn_impl=vimpl[1], moe_stats=True)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    valid = active[:, None] & (pos[:, None] + np.arange(5) < limits[:, None])
    _logits_close(tl, jl, valid)


def test_entry_points_without_stats_return_two():
    """``moe_stats`` off: (logits, pool), as the llama family returns;
    the same logits as with stats on."""
    jcfg, tcfg = _cfgs()
    _, tp = _weights(jcfg)
    _, kv = _pools(jcfg, "float32")
    toks = torch.tensor([3, 4], dtype=torch.int32)
    pos = torch.tensor([0, 0], dtype=torch.int32)
    pt = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    act = torch.tensor([True, True])
    out = tmixtral.decode_step(tp, tcfg, toks, pos, kv.clone(), pt, PS, act)
    assert len(out) == 2
    with_stats = tmixtral.decode_step(tp, tcfg, toks, pos, kv.clone(), pt,
                                      PS, act, moe_stats=True)
    assert torch.equal(out[0], with_stats[0])


def test_dense_mlp_hook_default_is_the_dense_mlp():
    """``mlp=None`` and ``mlp=_mlp`` run the same dense layer: the hook
    changes nothing for the llama family."""
    cfg = tllama.TINY
    p = tllama.init_params(0, cfg, torch.float32, "cpu")
    kv = torch.zeros((cfg.n_layers, 2, 5 * PS, cfg.n_kv_heads,
                      cfg.head_dim))
    args = (torch.tensor([3, 4], dtype=torch.int32),
            torch.tensor([0, 0], dtype=torch.int32))
    pt = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    act = torch.tensor([True, True])
    a, _ = tllama.decode_step(p, cfg, *args, kv.clone(), pt, PS, act)
    seen = []

    def hook(p_, i, h, plain):
        seen.append((i, plain))
        return tllama._mlp(p_, i, h, plain)

    b, _ = tllama.decode_step(p, cfg, *args, kv.clone(), pt, PS, act,
                              mlp=hook)
    assert torch.equal(a, b)
    assert seen == [(0, False), (1, False)]
