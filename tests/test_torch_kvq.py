"""The port's quantized KV pool (``aigw_tpu_torch/models/kvq.py``) against
the JAX package's ``aigw_tpu/models/kvq.py``.

Inputs are made from a seed with numpy. Row quantization, the scatter
that quantizes in the same pass and the byte math must equal the
reference's exactly (no tolerance), as the reference runs them: inside
a compiled program, where XLA turns ``absmax / qmax`` into a
multiplication by the float32 reciprocal (its eager functions divide,
and a scale then differs in its last place). The int4 values cross
through ``astype(np.int8)`` and the port's two-per-byte packing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aigw_tpu.models import kvq as jkvq
from aigw_tpu_torch.models import convert
from aigw_tpu_torch.models import kvq

DTS = ["int8", "int4"]
# the reference's row quantization and scatter as its programs run them
jquantize_rows = jax.jit(jkvq.quantize_rows, static_argnums=1)
jscatter_kv = jax.jit(jkvq.scatter_kv, static_argnums=1)


def _rows(seed=0, shape=(3, 5, 2, 16)):
    x = np.random.default_rng(seed).standard_normal(shape, np.float32)
    x[0, 0, 1] = 0.0  # an all-zero (row, head): scale 1.0
    x[1, 2, 0, 3] = 40.0  # an outlier
    return x


def _vals(q):
    """Integer values of a reference leaf (int4 widened to int8)."""
    return np.asarray(q).astype(np.int8)


@pytest.mark.parametrize("dt", DTS)
def test_quantize_rows_bit_for_bit(dt):
    x = _rows()
    jq, js = jquantize_rows(jnp.asarray(x), dt)
    tq, ts = kvq.quantize_rows(torch.from_numpy(x), dt)
    assert tq.dtype == (torch.int8 if dt == "int8" else torch.uint8)
    assert tuple(tq.shape) == (x.shape[:-1] + (x.shape[-1] // (
        2 if dt == "int4" else 1),))
    np.testing.assert_array_equal(kvq.int_values(tq).numpy(), _vals(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[0, 0, 1] == 1.0
    np.testing.assert_array_equal(
        kvq.dequantize_rows(tq, ts).numpy(),
        np.asarray(jkvq.dequantize_rows(jq, js)))


def test_scale_is_the_compiled_reciprocal_form():
    """The reference's eager and compiled scales differ in the last
    place on some rows; the port equals the compiled one."""
    x = _rows(5, (64, 4, 2, 32))
    eager = np.asarray(jkvq.quantize_rows(jnp.asarray(x), "int8")[1])
    compiled = np.asarray(jquantize_rows(jnp.asarray(x), "int8")[1])
    port = kvq.quantize_rows(torch.from_numpy(x), "int8")[1].numpy()
    np.testing.assert_array_equal(port, compiled)
    assert (port != eager).any()  # the two forms do differ here
    np.testing.assert_allclose(port, eager, rtol=2.5e-7)  # by one ulp


@pytest.mark.parametrize("ties", [False, True], ids=["random", "halves"])
def test_quantize_rows_rounds_half_to_even(ties):
    """x / scale landing exactly on .5 rounds to the even integer, as
    jnp.round does (never half away from zero)."""
    x = np.random.default_rng(1).standard_normal((4, 1, 8), np.float32)
    if ties:  # amax 127 → scale 1, so x / scale is x itself
        x[..., 0] = 127.0
        x[..., 1:] = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5],
                              np.float32)
    jq, js = jquantize_rows(jnp.asarray(x), "int8")
    tq, ts = kvq.quantize_rows(torch.from_numpy(x), "int8")
    np.testing.assert_array_equal(tq.numpy(), _vals(jq))
    if ties:
        assert tq[0, 0, 1:].tolist() == [0, 2, 2, 0, -2, -2, 4]


def test_int4_pack_round_trip():
    rng = np.random.default_rng(2)
    v = torch.from_numpy(rng.integers(-8, 8, (3, 4, 10)).astype(np.int8))
    for dim in (-1, 0, 1):
        if v.shape[dim] % 2:
            continue
        packed = kvq.pack_int4(v, dim=dim)
        assert packed.dtype == torch.uint8
        assert packed.shape[dim] == v.shape[dim] // 2
        assert torch.equal(kvq.unpack_int4(packed, dim=dim), v)
    # the low nibble holds the even element
    assert kvq.pack_int4(torch.tensor([1, -2], dtype=torch.int8)).item() \
        == (1 | (0xE << 4))


@pytest.mark.parametrize("dt", DTS)
def test_scatter_kv_matches_reference(dt):
    """scatter_kv quantizes and lands rows with their scale rows in one
    pass; the pool's bytes equal the reference's eager scatter."""
    L, n_slots, Hkv, D = 2, 32, 2, 16
    shape = (L, 2, n_slots, Hkv, D)
    rng = np.random.default_rng(3)
    k = rng.standard_normal((5, Hkv, D), np.float32)
    v = rng.standard_normal((5, Hkv, D), np.float32)
    flat = np.array([0, 7, 9, 17, 30], np.int32)
    jpool = jscatter_kv(jkvq.make_pool(shape, dt), 1, jnp.asarray(flat),
                        jnp.asarray(k), jnp.asarray(v))
    tpool = kvq.make_pool(shape, dt, torch.device("cpu"))
    assert kvq.is_quantized(tpool) and kvq.kv_dtype_of(tpool) == dt
    out = kvq.scatter_kv(tpool, 1, torch.from_numpy(flat),
                         torch.from_numpy(k), torch.from_numpy(v))
    assert out is tpool  # in place
    got = convert.pool_to_numpy(tpool)
    np.testing.assert_array_equal(got["q"], _vals(jpool["q"]))
    np.testing.assert_array_equal(got["scale"], np.asarray(jpool["scale"]))
    rows, scale = kvq.layer_pool(tpool, 1, 0)
    assert scale.shape == (n_slots, Hkv)
    assert rows.shape[-1] == (D // 2 if dt == "int4" else D)


@pytest.mark.parametrize("dt", DTS)
def test_pool_crosses_both_ways_bit_for_bit(dt):
    shape = (1, 2, 16, 2, 8)
    x = np.random.default_rng(4).standard_normal(shape, np.float32)
    q, s = jquantize_rows(jnp.asarray(x), dt)
    jpool = {"q": q, "scale": s}
    tpool = convert.pool_from_numpy(jpool, "cpu")
    assert tpool["q"].dtype == kvq.compute_dtype(dt)
    back = convert.pool_to_numpy(tpool)
    np.testing.assert_array_equal(back["q"], _vals(q))
    np.testing.assert_array_equal(back["scale"], np.asarray(s))
    again = jnp.asarray(back["q"]).astype(q.dtype)  # the reference leaf
    assert again.dtype == q.dtype
    np.testing.assert_array_equal(_vals(again), _vals(q))


def test_byte_math_matches_reference():
    for dt in ("float32", "bfloat16", "int8", "int4"):
        assert kvq.quant_bits(dt) == jkvq.quant_bits(dt)
        assert kvq.bytes_per_kv_element(dt) == jkvq.bytes_per_kv_element(dt)
        assert kvq.is_quantized_dtype(dt) == jkvq.is_quantized_dtype(dt)
    pool = kvq.make_pool((2, 2, 32, 4, 8), "int4", torch.device("cpu"))
    assert kvq.n_slots(pool) == 32
    assert pool["q"].shape == (2, 2, 32, 4, 4)
    assert pool["scale"].shape == (2, 2, 32, 4)
    with pytest.raises(ValueError):
        kvq.compute_dtype("fp8")


def test_quantized_padding_goes_to_dump_page():
    ps = 8
    pool = kvq.make_pool((1, 2, 4 * ps, 1, 4), "int8", torch.device("cpu"))
    flat = kvq.padding_slots(pool, ps, torch.tensor([True, False]),
                             torch.tensor([2, 5]))
    assert int(flat[0]) == 2 and 3 * ps <= int(flat[1]) < 4 * ps
    kvq.scatter_kv(pool, 0, flat, torch.ones(2, 1, 4), torch.ones(2, 1, 4))
    assert pool["scale"][0, 0, 5] == 0 and pool["scale"][0, 0, 2] > 0
