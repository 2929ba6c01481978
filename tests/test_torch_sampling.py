"""The port's sampling against the JAX package's, token for token.

Logits, keys and per-slot parameters are made from a seed with numpy and
fed to both ``aigw_tpu.tpuserve.sampling.sample`` and
``aigw_tpu_torch.tpuserve.sampling.sample``. Keys are raw
``[seed, counter]`` uint32 pairs, as the engines build them; the port's
threefry categorical reproduces ``jax.random.categorical``, so seeded
draws must be identical, not only greedy ones.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aigw_tpu.tpuserve import sampling as jsampling
from aigw_tpu_torch.tpuserve import sampling as tsampling


def _inputs(seed, B, V):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, V)) * 3.0).astype(np.float32)
    keys = np.stack([rng.integers(0, 2**32, B, dtype=np.uint64),
                     rng.integers(0, 4096, B, dtype=np.uint64)],
                    axis=1).astype(np.uint32)
    return logits, keys


def _both(logits, keys, temp, top_p, top_k):
    want = np.asarray(jsampling.sample(
        jnp.asarray(logits), jnp.asarray(keys), jnp.asarray(temp),
        jnp.asarray(top_p), jnp.asarray(top_k)))
    got = tsampling.sample(
        torch.from_numpy(logits), torch.from_numpy(keys.astype(np.int64)),
        torch.from_numpy(temp), torch.from_numpy(top_p),
        torch.from_numpy(top_k)).numpy()
    return got, want


MIXES = {
    "greedy": ([0.0] * 4, [1.0] * 4, [0] * 4),
    "temperature": ([0.7, 1.0, 1.3, 2.0], [1.0] * 4, [0] * 4),
    "top_k": ([1.0] * 4, [1.0] * 4, [1, 5, 40, 0]),
    "top_p": ([0.8, 1.0, 1.0, 0.5], [0.9, 0.5, 0.95, 0.3], [0] * 4),
    "mixed": ([0.0, 0.9, 1.2, 0.6], [1.0, 0.8, 1.0, 0.9], [0, 0, 20, 7]),
}


@pytest.mark.parametrize("mix", sorted(MIXES))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_matches_jax(mix, seed):
    temp, top_p, top_k = (np.asarray(a, dt) for a, dt in zip(
        MIXES[mix], (np.float32, np.float32, np.int32)))
    logits, keys = _inputs(seed, 4, 512)
    got, want = _both(logits, keys, temp, top_p, top_k)
    np.testing.assert_array_equal(got, want)


def test_sample_matches_jax_many_keys():
    """200 seeded draws at a Llama-3 vocabulary slice: identical ids."""
    B, V = 200, 4096
    logits, keys = _inputs(7, B, V)
    temp = np.ones((B,), np.float32)
    got, want = _both(logits, keys, temp, np.ones((B,), np.float32),
                      np.zeros((B,), np.int32))
    np.testing.assert_array_equal(got, want)


def test_random_bits_match_jax():
    import jax

    keys = np.array([[0, 0], [42, 7], [2**32 - 1, 123456]], np.uint32)
    got = tsampling.uniform_bits(torch.from_numpy(keys.astype(np.int64)),
                                 1000).numpy()
    for b in range(3):
        want = np.asarray(jax.random.bits(jnp.asarray(keys[b]), (1000,),
                                          jnp.uint32))
        np.testing.assert_array_equal(got[b].astype(np.uint32), want)


def test_apply_penalties_matches_jax():
    rng = np.random.default_rng(3)
    B, V = 4, 256
    logits = rng.standard_normal((B, V)).astype(np.float32)
    counts = rng.integers(0, 4, (B, V)).astype(np.int32)
    freq = np.array([0.0, 0.5, 1.5, -0.5], np.float32)
    pres = np.array([0.0, 1.0, 0.2, 2.0], np.float32)
    bias = np.zeros((B, V), np.float32)
    bias[1, 7] = 5.0
    bias[2, 9] = -100.0
    want = np.asarray(jsampling.apply_penalties(
        jnp.asarray(logits), jnp.asarray(counts), jnp.asarray(freq),
        jnp.asarray(pres), jnp.asarray(bias)))
    got = tsampling.apply_penalties(
        torch.from_numpy(logits), torch.from_numpy(counts),
        torch.from_numpy(freq), torch.from_numpy(pres),
        torch.from_numpy(bias)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_sampling_params_from_request_matches_jax():
    body = {"temperature": None, "top_p": 0.9, "top_k": 5, "seed": 11,
            "frequency_penalty": 0.1, "logit_bias": {"3": 2.5}}
    a = jsampling.SamplingParams.from_request(body)
    b = tsampling.SamplingParams.from_request(body)
    assert a.__dict__ == b.__dict__
