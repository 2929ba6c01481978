"""The port's weight quantization (``aigw_tpu_torch/models/quant.py``) and
the quantized weight paths of its Llama forward against the JAX
package's.

Weights are the reference's ``init_params(PRNGKey(0), cfg, float32)`` at
128-aligned tiny widths (so int4 groups and the W8A16 kernel gate both
apply) carried across by ``models/convert.py``. ``quantize_params`` must
give the reference's q values and scales exactly, in both modes, and
the dequantized matmul operand (``_w``) and the embedding rows must
match bit for bit: both sides round the scale to bf16 and multiply in
the same float32 arithmetic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aigw_tpu.models import llama as jllama
from aigw_tpu.models import quant as jquant
from aigw_tpu_torch.models import convert, kvq, quant
from aigw_tpu_torch.models import llama as tllama

CFG = jllama.LlamaConfig(
    vocab_size=512, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
    ffn_dim=256, max_seq_len=256, rope_theta=10000.0)
MODES = ["int8", "int4"]


@pytest.fixture(scope="module")
def weights():
    p = jllama.init_params(jax.random.PRNGKey(0), CFG, dtype=jnp.float32)
    return p, convert.params_from_numpy(
        {k: np.asarray(v) for k, v in p.items()}, device="cpu")


def _f32(a):
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("mode", MODES)
def test_quantize_params_matches_reference(weights, mode):
    jp, tp = weights
    jq = jquant.quantize_params(dict(jp), mode=mode)
    tq = quant.quantize_params(dict(tp), mode=mode)
    assert sorted(tq) == sorted(jq)
    carried = convert.params_from_numpy(
        {k: np.asarray(v) for k, v in jq.items()}, device="cpu")
    for name in tq:
        assert tq[name].dtype == carried[name].dtype, name
        assert torch.equal(tq[name], carried[name]), name
    # int4 packs along the input axis, with group-128 scales
    if mode == "int4":
        assert tq["l0.wq.q"].dtype == torch.uint8
        assert tq["l0.wq.q"].shape == (CFG.dim // 2, CFG.dim)
        assert tq["l0.wq.scale"].shape == (CFG.dim // quant.GROUP4, CFG.dim)
        np.testing.assert_array_equal(
            kvq.unpack_int4(tq["l0.w_down.q"], dim=0).numpy(),
            np.asarray(jq["l0.w_down.q"]).astype(np.int8))
    assert tq["embed.q"].dtype == torch.int8  # per-row int8 either mode
    assert tq["embed.scale"].shape == (CFG.vocab_size, 1)
    assert quant.is_quantized(tq) and not quant.is_quantized(tp)


@pytest.mark.parametrize("mode", MODES)
def test_dequantized_operands_match_reference(weights, mode):
    jp, tp = weights
    jq = jquant.quantize_params(dict(jp), mode=mode)
    tq = quant.quantize_params(dict(tp), mode=mode)
    for key in ("l0.wq", "l1.w_down", "lm_head", "embed"):
        got = tllama._w(tq, key)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      _f32(jllama._w(jq, key)))
    toks = np.random.default_rng(0).integers(0, CFG.vocab_size, (3, 4))
    np.testing.assert_array_equal(
        tllama._embed_rows(tq, torch.from_numpy(toks)).float().numpy(),
        _f32(jllama._embed_rows(jq, jnp.asarray(toks))))


def test_matmul_promotes_like_jax(weights):
    """f32 activations against a bf16-dequantized operand: the port
    casts where JAX promotes (torch.matmul refuses mixed dtypes). The
    int4 path never reaches the W8A16 kernel; f32 within 1e-5 (summation
    order)."""
    jp, tp = weights
    jq = jquant.quantize_params(dict(jp), mode="int4")
    tq = quant.quantize_params(dict(tp), mode="int4")
    x = np.random.default_rng(1).standard_normal((70, CFG.dim), np.float32)
    want = _f32(jllama._matmul(jq, "l0.w_up", jnp.asarray(x)))
    got = tllama._matmul(tq, "l0.w_up", torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_consume_pops_the_bf16_leaves(weights):
    _, tp = weights
    src = dict(tp)
    out = quant.quantize_params(src, consume=True, mode="int8")
    assert src == {}
    assert "l0.wq.q" in out and "l0.attn_norm" in out
    assert "l0.wq" not in out
    with pytest.raises(ValueError):
        quant.quantize_params({}, mode="fp8")
