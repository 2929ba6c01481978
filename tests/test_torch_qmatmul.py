"""K6, the W8A16 matmul: the port's plain version against the JAX
package's Pallas kernel (``qmatmul.w8a16_matmul``, interpret mode on the
CPU), at the reference test's shapes (``tests/test_qmatmul.py``), with
float32 and bfloat16 activations made from a seed with numpy.

Tolerances: float32 x 1e-5 relative to the output's scale (the two
sides sum in different orders); bfloat16 x one bf16 rounding of the
output (2**-8 relative per element, plus 1e-5 of the scale for the
summation order). The shape gate must be the reference's exactly, since
which shapes reach the kernel changes the numbers. The CUDA kernel is
held against the same plain version on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aigw_tpu.ops.pallas import qmatmul as jq
from aigw_tpu_torch.ops import qmatmul

SHAPES = [(8, 256, 512), (8, 512, 1536), (16, 256, 384), (1, 128, 128),
          (64, 256, 256)]


def _case(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    q = rng.integers(-127, 128, (k, n), dtype=np.int8)
    s = (rng.random((1, n), np.float32) * 0.02).astype(np.float32)
    return x, q, s


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_plain_matches_pallas(m, k, n, dtype):
    x, q, s = _case(m, k, n)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else
                     jnp.float32)
    want = np.asarray(jq.w8a16_matmul(jx, jnp.asarray(q), jnp.asarray(s)),
                      np.float32)
    tx = torch.from_numpy(np.array(jx, np.float32)).to(
        getattr(torch, dtype))
    got = qmatmul.w8a16_matmul(tx, torch.from_numpy(q), torch.from_numpy(s))
    assert got.dtype == tx.dtype and got.shape == (m, n)
    got = got.float().numpy()
    scale = np.abs(want).max()
    rtol = 2.0 ** -8 if dtype == "bfloat16" else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-5 * scale)


def test_plain_applies_scale_after_the_sum():
    """The column scale multiplies the float32 sum (the kernel's order),
    not the weights: equal to the float64 product rounded once."""
    x, q, s = _case(4, 128, 128, seed=1)
    got = qmatmul.w8a16_matmul_plain(torch.from_numpy(x),
                                     torch.from_numpy(q),
                                     torch.from_numpy(s)).numpy()
    exact = (x.astype(np.float64) @ q.astype(np.float64)) * s
    np.testing.assert_allclose(got, exact, rtol=1e-5, atol=1e-5)


def test_supported_gates_like_reference():
    for m in (1, 8, 64, 65):
        for k in (100, 128, 4096, 14336):
            for n in (128, 130, 1024, 1536, 4096, 14336, 128256, 152064):
                assert qmatmul.supported(m, k, n) == jq.supported(m, k, n), \
                    (m, k, n)
    assert qmatmul.supported(8, 4096, 128256)  # Llama-3-8B lm_head


@pytest.mark.parametrize("k,n", [(4096, 1024), (4096, 4096), (4096, 14336),
                                 (14336, 4096), (4096, 128256), (128, 128)])
def test_k_splits_cover_k(k, n):
    """The CUDA launch's split of K across blocks: whole SPLIT_ROWS
    steps that cover K exactly once, and enough blocks to fill the card
    when N alone gives few, unless every split is already one step."""
    splits, rows = qmatmul.k_splits(k, n)
    assert rows % qmatmul.SPLIT_ROWS == 0
    assert splits * rows >= k > (splits - 1) * rows
    tiles = n // qmatmul.BLOCK_N
    if tiles < 132:
        assert (splits * tiles >= 132
                or splits == -(-k // qmatmul.SPLIT_ROWS))


@pytest.mark.parametrize("m", [1, 8, 40, 64])
@pytest.mark.parametrize("k,n", [(4096, 1024), (4096, 4096), (4096, 14336),
                                 (14336, 4096), (4096, 128256), (128, 128),
                                 (512, 1536)])
def test_launch_plan_covers_each_weight_once(m, k, n):
    """The grid's (column tile, split) blocks cover every weight row and
    column exactly once, splits are whole pipeline stages, and the
    scratch and counters match the plan: float32 partials [splits, M, N]
    and one counter per column tile when K is split, none otherwise."""
    plan = qmatmul.launch_plan(m, k, n)
    tiles, splits, rows = plan["tiles"], plan["splits"], plan["k_rows"]
    hits = np.zeros((k, n), np.int32)
    for t in range(tiles):
        for s in range(splits):
            hits[s * rows:min(k, (s + 1) * rows),
                 t * qmatmul.BLOCK_N:(t + 1) * qmatmul.BLOCK_N] += 1
    assert (hits == 1).all()
    assert rows % 64 == 0 and (splits - 1) * rows < k
    if splits > 1:
        assert plan["part_elems"] == splits * m * n
        assert plan["counters"] == tiles == n // qmatmul.BLOCK_N
    else:
        assert plan["part_elems"] == 0 and plan["counters"] == 0
    # K is split only where the column tiles alone leave the card short
    assert (splits > 1) == (tiles < qmatmul._TARGET_BLOCKS
                            and k > qmatmul.SPLIT_ROWS)
