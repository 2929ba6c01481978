"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: they need an NVIDIA GPU with ``nvcc`` and skip without
one. Run them on the card with

    python -m pytest -m gpu tests/test_torch_gpu.py

Inputs are seeded; each kernel sees the same tensors as its plain
version. Attention outputs are held per element to rtol * |plain| +
atol: float32 2e-5 and 2e-5 (summation order), bfloat16 2**-7 and 2e-3
(one bf16 ulp of the plain output: the two float32 results may round to
neighbouring bf16 values, the limit chip_smoke.py holds the kernels
to); the fused decode kernel's pools must match byte for byte in both.
"""

import pytest
import torch

from aigw_tpu_torch.ops import decode_fused, paged_attention

#: (rtol, atol) per dtype
TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2.0 ** -7, 2e-3)}
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _pools(g, n_pages, ps, Hkv, D, dtype, dev):
    def r(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    return r(n_pages * ps, Hkv, D), r(n_pages * ps, Hkv, D), r


GEOMS = [  # (H, Hkv, D, page)
    (4, 2, 16, 16),  # tiny
    (32, 8, 128, 128),  # Llama-3-8B attention
    (14, 2, 64, 16),  # Qwen2-0.5B attention (group 7)
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geom", GEOMS)
def test_paged_decode_kernel(cuda, geom, dtype):
    H, Hkv, D, ps = geom
    g = torch.Generator(device=cuda).manual_seed(0)
    B, P = 6, 12
    kp, vp, r = _pools(g, B * P + 1, ps, Hkv, D, dtype, cuda)
    pt = torch.randperm(B * P, generator=g, device=cuda).reshape(
        B, P).to(torch.int32)
    lens = torch.tensor([0, 1, ps - 1, ps, ps + 1, P * ps], device=cuda,
                        dtype=torch.int32)
    q = r(B, H, D)
    got = paged_attention.paged_attention_decode_v2(q, kp, vp, pt, lens,
                                                    page_size=ps)
    want = paged_attention.paged_attention_decode_v2_plain(
        q, kp, vp, pt, lens, page_size=ps)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype][0],
                               atol=TOL[dtype][1])
    assert not got[0].any()  # length 0 attends nothing


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geom", GEOMS)
def test_ragged_prefill_kernel(cuda, geom, dtype):
    H, Hkv, D, ps = geom
    g = torch.Generator(device=cuda).manual_seed(1)
    seq = [(3 * ps + 5, 0), (1, 0), (2 * ps, ps // 2 + 3), (ps - 1, 0)]
    B, P = len(seq), 8
    kp, vp, r = _pools(g, B * P + 1, ps, Hkv, D, dtype, cuda)
    pt = torch.randperm(B * P, generator=g, device=cuda).reshape(
        B, P).to(torch.int32)
    total = sum(n for n, _ in seq)
    T = total + 37  # padding rows at the tail
    cu = torch.tensor([0] + [sum(n for n, _ in seq[:i + 1])
                             for i in range(B)], dtype=torch.int32,
                      device=cuda)
    st = torch.tensor([s for _, s in seq], dtype=torch.int32, device=cuda)
    q = r(T, H, D)
    got = paged_attention.ragged_prefill_attention(q, kp, vp, pt, cu, st,
                                                   page_size=ps)
    want = paged_attention.ragged_prefill_attention_plain(
        q, kp, vp, pt, cu, st, page_size=ps)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype][0],
                               atol=TOL[dtype][1])
    assert not got[total:].any()  # rows owned by no sequence are zero


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geom", GEOMS)
def test_fused_decode_kernel(cuda, geom, dtype):
    H, Hkv, D, ps = geom
    g = torch.Generator(device=cuda).manual_seed(2)
    B, P = 6, 8
    kp, vp, r = _pools(g, B * P + 1, ps, Hkv, D, dtype, cuda)
    pt = torch.randperm(B * P, generator=g, device=cuda).reshape(
        B, P).to(torch.int32)
    positions = torch.tensor([0, 5, ps, 2 * ps + 1, 3 * ps - 1, 7],
                             dtype=torch.int32, device=cuda)
    active = torch.tensor([True, True, True, True, True, False],
                          device=cuda)
    q, kn, vn = r(B, H, D), r(B, Hkv, D), r(B, Hkv, D)
    kp2, vp2 = kp.clone(), vp.clone()
    got, _, _ = decode_fused.fused_paged_decode(
        q, kn, vn, kp, vp, pt, positions, active, rope_theta=500000.0,
        page_size=ps)
    want, _, _ = decode_fused.fused_paged_decode_plain(
        q, kn, vn, kp2, vp2, pt, positions, active, rope_theta=500000.0,
        page_size=ps)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype][0],
                               atol=TOL[dtype][1])
    assert torch.equal(kp, kp2) and torch.equal(vp, vp2)
    assert not got[5].any()  # the inactive slot attends nothing


def test_cuda_tensor_never_falls_back(cuda):
    """A CUDA call the kernel refuses raises instead of running the
    plain version."""
    q = torch.zeros(2, 4, 16, device=cuda)
    pool = torch.zeros(32, 2, 16, device=cuda)
    pt = torch.zeros(2, 2, dtype=torch.int64, device=cuda)  # not int32
    lens = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        paged_attention.paged_attention_decode_v2(q, pool, pool, pt, lens,
                                                  page_size=16)


# -- K6 W8A16 matmul ---------------------------------------------------------
QMM_SHAPES = [  # (M, K, N): Llama-3-8B decode and prefill-rung shapes
    (8, 4096, 4096), (8, 4096, 1024), (8, 4096, 14336), (8, 14336, 4096),
    (8, 4096, 128256), (1, 128, 128), (64, 256, 384), (37, 512, 1536),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", QMM_SHAPES)
def test_w8a16_matmul_kernel(cuda, shape, dtype):
    """Kernel against plain: float32 x within 1e-5 of the output's scale
    (summation order over K up to 14336); bfloat16 x within one bf16 ulp
    of the output (2**-7 relative: the two float32 sums may round to
    neighbouring bf16 values) plus that."""
    from aigw_tpu_torch.ops import qmatmul

    M, K, N = shape
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((M, K), generator=g, device=cuda).to(dtype)
    q = torch.randint(-127, 128, (K, N), generator=g, device=cuda,
                      dtype=torch.int8)
    s = torch.rand((1, N), generator=g, device=cuda) * 0.02
    got = qmatmul.w8a16_matmul(x, q, s)
    want = qmatmul.w8a16_matmul_plain(x, q, s)
    torch.cuda.synchronize()
    scale = want.float().abs().max().item()
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=1e-5 * scale)


# -- K7 fused decode, int8/int4 rung ---------------------------------------
@pytest.mark.parametrize("qdt", ["int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geom", GEOMS)
def test_fused_decode_quantized_kernel(cuda, geom, dtype, qdt):
    """Attention within the dtype's tolerance; the pools (q bytes and
    scales) equal the plain version's byte for byte: appended rows,
    fresh-page zeroing and the dump page included."""
    from aigw_tpu_torch.models import kvq

    H, Hkv, D, ps = geom
    g = torch.Generator(device=cuda).manual_seed(4)
    B, P = 6, 8
    n_slots = (B * P + 1) * ps
    kf = torch.randn((n_slots, Hkv, D), generator=g, device=cuda)
    vf = torch.randn((n_slots, Hkv, D), generator=g, device=cuda)
    kq, ks = kvq.quantize_rows(kf, qdt)
    vq, vs = kvq.quantize_rows(vf, qdt)
    pt = torch.randperm(B * P, generator=g, device=cuda).reshape(
        B, P).to(torch.int32)
    positions = torch.tensor([0, 5, ps, 2 * ps + 1, 3 * ps - 1, 7],
                             dtype=torch.int32, device=cuda)
    active = torch.tensor([True, True, True, True, True, False],
                          device=cuda)

    def r(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(dtype)

    q, kn, vn = r(B, H, D), r(B, Hkv, D), r(B, Hkv, D)
    a = [t.clone() for t in (kq, vq, ks, vs)]
    b = [t.clone() for t in (kq, vq, ks, vs)]
    got = decode_fused.fused_paged_decode(
        q, kn, vn, a[0], a[1], pt, positions, active, a[2], a[3],
        rope_theta=500000.0, page_size=ps)
    want = decode_fused.fused_paged_decode_plain(
        q, kn, vn, b[0], b[1], pt, positions, active, b[2], b[3],
        rope_theta=500000.0, page_size=ps)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0].float(), want[0].float(),
                               rtol=TOL[dtype][0], atol=TOL[dtype][1])
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not got[0][5].any()  # the inactive slot attends nothing


def test_quantized_pool_needs_its_scales(cuda):
    """A CUDA call on an int8 pool without scales raises, never runs a
    plain version."""
    q = torch.zeros(2, 4, 16, device=cuda)
    kv_new = torch.zeros(2, 2, 16, device=cuda)
    pool = torch.zeros(32, 2, 16, dtype=torch.int8, device=cuda)
    pt = torch.zeros(2, 2, dtype=torch.int32, device=cuda)
    pos = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="scale"):
        decode_fused.fused_paged_decode(
            q, kv_new, kv_new, pool, pool, pt, pos, pos > 0,
            rope_theta=1e4, page_size=16)


# -- K4 split decode and K5 verify ------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geom", GEOMS)
def test_paged_decode_split_kernel(cuda, geom, dtype):
    """K4 against its plain version (K3's function), with lengths of 0,
    one page and the whole table, at two batch sizes (8 splits and 1)."""
    H, Hkv, D, ps = geom
    g = torch.Generator(device=cuda).manual_seed(5)
    for B, P in ((6, 12), (64, 4)):
        kp, vp, r = _pools(g, B * P + 1, ps, Hkv, D, dtype, cuda)
        pt = torch.randperm(B * P, generator=g, device=cuda).reshape(
            B, P).to(torch.int32)
        lens = torch.randint(0, P * ps + 1, (B,), generator=g, device=cuda,
                             dtype=torch.int32)
        lens[:3] = torch.tensor([0, ps, P * ps])
        q = r(B, H, D)
        got = paged_attention.paged_attention_decode(q, kp, vp, pt, lens,
                                                     page_size=ps)
        want = paged_attention.paged_attention_decode_plain(
            q, kp, vp, pt, lens, page_size=ps)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=TOL[dtype][0], atol=TOL[dtype][1])
        assert not got[0].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geom", GEOMS)
def test_paged_verify_kernel(cuda, geom, dtype):
    """K5 against its plain version: windows at 0, across a page, at the
    table's end (rows past it stop at its last key) and a slot that is
    off (zeros)."""
    H, Hkv, D, ps = geom
    g = torch.Generator(device=cuda).manual_seed(6)
    B, S, P = 5, 5, 6
    kp, vp, r = _pools(g, B * P + 1, ps, Hkv, D, dtype, cuda)
    pt = torch.randperm(B * P, generator=g, device=cuda).reshape(
        B, P).to(torch.int32)
    pos = torch.tensor([0, ps - 2, 3 * ps + 7, P * ps - 2, -(S + 1)],
                       dtype=torch.int32, device=cuda)
    q = r(B, S, H, D)
    got = paged_attention.paged_attention_verify(q, kp, vp, pt, pos,
                                                 page_size=ps)
    want = paged_attention.paged_attention_verify_plain(q, kp, vp, pt, pos,
                                                        page_size=ps)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype][0],
                               atol=TOL[dtype][1])
    assert not got[4].any()
