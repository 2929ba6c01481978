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
    """K1 against its plain version: bf16 on the tensor-core kernel (at
    G 2, 4 and 7: tiles of 32, 16 and 9 whole queries), float32 on the
    CUDA-core one. Sequences of one query, of 1000, one resumed at ps /
    2 + 3 (its tiles straddle pages), one short of a page; padding rows
    at the tail come out zero; a second call gives the same bits."""
    H, Hkv, D, ps = geom
    g = torch.Generator(device=cuda).manual_seed(1)
    seq = [(3 * ps + 5, 0), (1, 0), (2 * ps, ps // 2 + 3), (ps - 1, 0),
           (1000, 0)]
    B = len(seq)
    P = max(-(-(n + s) // ps) for n, s in seq)
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
    again = paged_attention.ragged_prefill_attention(q, kp, vp, pt, cu, st,
                                                     page_size=ps)
    want = paged_attention.ragged_prefill_attention_plain(
        q, kp, vp, pt, cu, st, page_size=ps)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype][0],
                               atol=TOL[dtype][1])
    assert not got[total:].any()  # rows owned by no sequence are zero
    assert torch.equal(got, again)


#: prefix-cache resume geometries at a start of 8 pages: short suffixes
#: resumed there (a partial hit) beside a cold sequence, and the single
#: row at n - 1 of an 8-page prompt (a full hit's resume)
RESUME_CASES = {
    "partial_hit": lambda ps: [(150, 8 * ps), (7, 8 * ps), (1, 8 * ps),
                               (ps + 3, 0)],
    "full_hit_row": lambda ps: [(1, 8 * ps - 1)],
}


@pytest.mark.parametrize("case", sorted(RESUME_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geom", GEOMS)
def test_ragged_prefill_kernel_resume(cuda, geom, dtype, case):
    """K1 at the prefix cache's resume geometries against its plain
    version: every tile walks the 8 cached pages before its own rows'
    causal edge; padding rows come out zero."""
    H, Hkv, D, ps = geom
    g = torch.Generator(device=cuda).manual_seed(2)
    seq = RESUME_CASES[case](ps)
    B = len(seq)
    P = max(-(-(n + s) // ps) for n, s in seq)
    kp, vp, r = _pools(g, B * P + 1, ps, Hkv, D, dtype, cuda)
    pt = torch.randperm(B * P, generator=g, device=cuda).reshape(
        B, P).to(torch.int32)
    total = sum(n for n, _ in seq)
    T = total + 9
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
    assert not got[total:].any()


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8", "int4"])
def test_copy_page_is_byte_equal(cuda, kv_dtype):
    """The prefix cache's copy-on-write on the card: the copy equals its
    source byte for byte in every tensor of the pool (q rows and scale
    rows of a quantized pool), and no other page changes."""
    from aigw_tpu_torch.models import kvq

    ps, n_pages = 16, 6
    kv = kvq.make_pool((2, 2, n_pages * ps, 2, 32), kv_dtype, cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    for leaf in (kv.values() if isinstance(kv, dict) else (kv,)):
        if leaf.dtype.is_floating_point:
            leaf.copy_(torch.randn(leaf.shape, generator=g, device=cuda))
        else:
            leaf.copy_(torch.randint(0, 255, leaf.shape, generator=g,
                                     device=cuda).to(leaf.dtype))
    before = {k: v.clone() for k, v in (
        kv.items() if isinstance(kv, dict) else [("kv", kv)])}
    kvq.copy_page(kv, 4, 1, ps)
    torch.cuda.synchronize()
    for k, v in (kv.items() if isinstance(kv, dict) else [("kv", kv)]):
        assert torch.equal(v[:, :, ps:2 * ps], before[k][:, :, 4 * ps:5 * ps])
        assert torch.equal(v[:, :, :ps], before[k][:, :, :ps])
        assert torch.equal(v[:, :, 2 * ps:], before[k][:, :, 2 * ps:])


def _fused_case(case, g, ps, Hkv, dev):
    """(B, P, positions, active) of a fused decode case. The kernel
    splits each sequence's pages into ``split_pages`` splits of ``pps``
    pages (``span`` keys); the block whose split holds the position
    appends."""
    if case == "mixed":  # fresh pages, a mid-page append, position 0
        B, P = 6, 8
        pos = [0, 5, ps, 2 * ps + 1, 3 * ps - 1, 7]
    elif case == "split_edges":
        # appends at the last key of a split and the first of the next
        # (a fresh page in a split other than the first), and a length
        # equal to the whole table
        B, P = 6, 8
        span = decode_fused.split_pages(B, Hkv, P)[0] * ps
        pos = [span - 1, span, 2 * span - 1, 2 * span, P * ps - 1, 3]
    elif case == "batch1":
        B, P = 1, 8
        pos = [3 * ps + 5]
    else:  # "batch64", "one_split": the card full without a split
        B = 64 if case == "batch64" else -(-decode_fused.SPLIT_TARGET_BLOCKS
                                           // Hkv)
        P = 4 if case == "batch64" else 2
        pos = torch.randint(0, P * ps, (B,), generator=g,
                            device=dev).tolist()
        pos[:2] = [P * ps - 1, ps]
        if case == "one_split":
            assert decode_fused.split_pages(B, Hkv, P)[1] == 1
    active = [True] * B
    if B > 1:
        active[-1] = False  # an inactive slot (the dump page)
    return (B, P, torch.tensor(pos, dtype=torch.int32, device=dev),
            torch.tensor(active, device=dev))


FUSED_CASES = ["mixed", "split_edges", "batch1", "batch64", "one_split"]


@pytest.mark.parametrize("case", FUSED_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geom", GEOMS)
def test_fused_decode_kernel(cuda, geom, dtype, case):
    H, Hkv, D, ps = geom
    g = torch.Generator(device=cuda).manual_seed(2)
    B, P, positions, active = _fused_case(case, g, ps, Hkv, cuda)
    kp, vp, r = _pools(g, B * P + 1, ps, Hkv, D, dtype, cuda)
    pt = torch.randperm(B * P, generator=g, device=cuda).reshape(
        B, P).to(torch.int32)
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
    assert not got[~active].any()  # an inactive slot attends nothing


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
QMM_SHAPES = [  # (K, N): Llama-3-8B's weights (wq/wo, wk/wv, gate/up,
    # down, lm_head) and small prefill-rung shapes
    (4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
    (4096, 128256), (128, 128), (256, 384), (512, 1536),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", QMM_SHAPES)
@pytest.mark.parametrize("M", [1, 8, 40, 64])
def test_w8a16_matmul_kernel(cuda, M, shape, dtype):
    """Kernel against plain: float32 x within 1e-5 of the output's scale
    (summation order over K up to 14336); bfloat16 x within one bf16 ulp
    of the output (2**-7 relative: the two float32 sums may round to
    neighbouring bf16 values) plus that. A second call on the same
    inputs gives the same bits (the split-K fold runs in split order)."""
    from aigw_tpu_torch.ops import qmatmul

    K, N = shape
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((M, K), generator=g, device=cuda).to(dtype)
    q = torch.randint(-127, 128, (K, N), generator=g, device=cuda,
                      dtype=torch.int8)
    s = torch.rand((1, N), generator=g, device=cuda) * 0.02
    got = qmatmul.w8a16_matmul(x, q, s)
    again = qmatmul.w8a16_matmul(x, q, s)
    want = qmatmul.w8a16_matmul_plain(x, q, s)
    torch.cuda.synchronize()
    scale = want.float().abs().max().item()
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=1e-5 * scale)
    assert torch.equal(got, again)


# -- K7 fused decode, int8/int4 rung ---------------------------------------
@pytest.mark.parametrize("case", FUSED_CASES)
@pytest.mark.parametrize("qdt", ["int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geom", GEOMS)
def test_fused_decode_quantized_kernel(cuda, geom, dtype, qdt, case):
    """Attention within the dtype's tolerance; the pools (q bytes and
    scales) equal the plain version's byte for byte: appended rows,
    fresh-page zeroing and the dump page included."""
    from aigw_tpu_torch.models import kvq

    H, Hkv, D, ps = geom
    g = torch.Generator(device=cuda).manual_seed(4)
    B, P, positions, active = _fused_case(case, g, ps, Hkv, cuda)
    n_slots = (B * P + 1) * ps
    kf = torch.randn((n_slots, Hkv, D), generator=g, device=cuda)
    vf = torch.randn((n_slots, Hkv, D), generator=g, device=cuda)
    kq, ks = kvq.quantize_rows(kf, qdt)
    vq, vs = kvq.quantize_rows(vf, qdt)
    pt = torch.randperm(B * P, generator=g, device=cuda).reshape(
        B, P).to(torch.int32)

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
    assert not got[0][~active].any()  # an inactive slot attends nothing


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


# -- K4 decode (v1) and K5 verify ------------------------------------------
@pytest.mark.parametrize("case", ["split_edges", "batch1", "batch64",
                                  "one_split"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geom", GEOMS)
def test_paged_decode_split_kernel(cuda, geom, dtype, case):
    """K4 (one launch of K3's body) against its plain version over K3's
    cases: lengths at the split and page edges, zero, and past the table
    (capped at its end); a second call gives the same bits."""
    H, Hkv, D, ps = geom
    g = torch.Generator(device=cuda).manual_seed(5)
    B, P, xs = _mq_case(case, 1, ps, Hkv, g, cuda)
    lens = torch.clamp(xs + 1, min=0)
    lens[0] = P * ps + 5  # past the table
    kp, vp, r = _pools(g, B * P + 1, ps, Hkv, D, dtype, cuda)
    pt = torch.randperm(B * P, generator=g, device=cuda).reshape(
        B, P).to(torch.int32)
    q = r(B, H, D)
    n0 = paged_attention.paged_attention_decode.launches
    got = paged_attention.paged_attention_decode(q, kp, vp, pt, lens,
                                                 page_size=ps)
    again = paged_attention.paged_attention_decode(q, kp, vp, pt, lens,
                                                   page_size=ps)
    want = paged_attention.paged_attention_decode_plain(
        q, kp, vp, pt, lens, page_size=ps)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=TOL[dtype][0], atol=TOL[dtype][1])
    assert torch.equal(got, again)
    assert not got[lens == 0].any()
    assert paged_attention.paged_attention_decode.launches == n0 + 2


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


# -- K3 and K5: the multi-query staged split body ---------------------------
def _mq_case(case, S, ps, Hkv, g, dev):
    """(B, P, xs) of a K3/K5 case: K5 positions (query s attends keys
    <= xs[b] + s) or K3 lengths. Each case covers the split edges the
    launch plan (``mq_plan``) draws, a window crossing a page, rows
    capped at the table's end, a partly negative window (-2) and a slot
    that is off (-(S + 1))."""
    if case == "split_edges":
        B, P = 8, 8
        span = paged_attention.split_pages(B, Hkv, P)[0] * ps
        xs = [span - 1 - S // 2, span - S, 2 * span - 1, ps - 2,
              P * ps - 2, -2, -(S + 1), 0]
    elif case == "batch1":
        B, P = 1, 8
        xs = [3 * ps + 5 - S // 2]
    else:  # "batch64", "one_split": the card full without a split
        B = 64 if case == "batch64" else -(-decode_fused.SPLIT_TARGET_BLOCKS
                                           // Hkv)
        P = 4 if case == "batch64" else 2
        xs = torch.randint(-S - 1, P * ps, (B,), generator=g,
                           device=dev).tolist()
        xs[:4] = [P * ps - 1, -2, -(S + 1), ps - 1 - S // 2]
        if case == "one_split":
            assert paged_attention.split_pages(B, Hkv, P)[1] == 1
    return B, P, torch.tensor(xs, dtype=torch.int32, device=dev)


MQ_CASES = ["split_edges", "batch1", "batch64", "one_split"]


@pytest.mark.parametrize("case", MQ_CASES)
@pytest.mark.parametrize("S", [1, 2, 5, 9, 17])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geom", GEOMS)
def test_paged_verify_mq_kernel(cuda, geom, dtype, S, case):
    """K5 against its plain version at every S the engine's draft
    widths give (17 x G rows need two row groups at G 4 and 7), over the
    split and page edges of ``_mq_case``; a slot that is off comes out
    exactly zero; a second call gives the same bits (the fold runs in
    split order)."""
    H, Hkv, D, ps = geom
    g = torch.Generator(device=cuda).manual_seed(7)
    B, P, pos = _mq_case(case, S, ps, Hkv, g, cuda)
    kp, vp, r = _pools(g, B * P + 1, ps, Hkv, D, dtype, cuda)
    pt = torch.randperm(B * P, generator=g, device=cuda).reshape(
        B, P).to(torch.int32)
    q = r(B, S, H, D)
    got = paged_attention.paged_attention_verify(q, kp, vp, pt, pos,
                                                 page_size=ps)
    again = paged_attention.paged_attention_verify(q, kp, vp, pt, pos,
                                                   page_size=ps)
    want = paged_attention.paged_attention_verify_plain(q, kp, vp, pt, pos,
                                                        page_size=ps)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype][0],
                               atol=TOL[dtype][1])
    assert torch.equal(got, again)
    assert not got[pos <= -S].any()  # a slot that is off attends nothing


@pytest.mark.parametrize("case", MQ_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geom", GEOMS)
def test_paged_decode_mq_kernel(cuda, geom, dtype, case):
    """K3 (the K3/K5 body at S = 1) against its plain version over
    lengths at the split and page edges, zero, and past the table (capped
    at its end); a second call gives the same bits."""
    H, Hkv, D, ps = geom
    g = torch.Generator(device=cuda).manual_seed(8)
    B, P, xs = _mq_case(case, 1, ps, Hkv, g, cuda)
    lens = torch.clamp(xs + 1, min=0)
    lens[0] = P * ps + 5  # past the table
    kp, vp, r = _pools(g, B * P + 1, ps, Hkv, D, dtype, cuda)
    pt = torch.randperm(B * P, generator=g, device=cuda).reshape(
        B, P).to(torch.int32)
    q = r(B, H, D)
    got = paged_attention.paged_attention_decode_v2(q, kp, vp, pt, lens,
                                                    page_size=ps)
    again = paged_attention.paged_attention_decode_v2(q, kp, vp, pt, lens,
                                                      page_size=ps)
    want = paged_attention.paged_attention_decode_v2_plain(
        q, kp, vp, pt, lens, page_size=ps)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype][0],
                               atol=TOL[dtype][1])
    assert torch.equal(got, again)
    assert not got[lens == 0].any()
