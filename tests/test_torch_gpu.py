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
The constrained engine's streams on the card equal the CPU's, and the
pool rows it rewrote after grammar rollbacks equal a cold prefill.
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


# -- grammar-constrained serving: streams and rows across rollbacks -----------
CN_SCHEMA = {"type": "object", "properties": {
    "t": {"type": "string", "maxLength": 12},
    "n": {"type": "integer"},
    "k": {"enum": ["cat", "dog"]}},
    "required": ["t", "n", "k"], "additionalProperties": False}
CN_TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "parameters": {"type": "object", "properties": {
        "city": {"type": "string", "maxLength": 6}},
        "required": ["city"], "additionalProperties": False}}}]
#: rungs the constrained engine runs on: the fused rung (K2), and the
#: chained rung speculating at width 4 (K5 verifies, K3 decodes)
CN_RUNGS = {
    "fused": dict(decode_backend="fused"),
    "chained_spec": dict(decode_backend="auto", pallas_attn=True,
                         spec_tokens=4, spec_adaptive=False),
}


def _cn_engine(device, params, kv_dtype, rung):
    from aigw_tpu_torch.models import llama
    from aigw_tpu_torch.tpuserve.engine import Engine, EngineConfig

    return Engine({k: v.to(device) for k, v in params.items()}, llama.TINY,
                  EngineConfig(max_batch_size=4, max_seq_len=128,
                               page_size=16, decode_steps_per_tick=4,
                               kv_cache_dtype=kv_dtype,
                               attention_backend="pallas-ragged",
                               **CN_RUNGS[rung]),
                  eos_token_ids=(257,), device=device)


def _cn_requests(streams):
    """A constrained batch (json_schema greedy and seeded, json_object,
    a required tool call) and a plain request; emitted tokens land in
    ``streams``."""
    from aigw_tpu_torch.models import llama
    from aigw_tpu_torch.tpuserve import constrain
    from aigw_tpu_torch.tpuserve.engine import GenRequest
    from aigw_tpu_torch.tpuserve.sampling import SamplingParams
    from aigw_tpu_torch.tpuserve.tokenizer import ByteTokenizer

    tok = ByteTokenizer()

    def fsm(spec):
        return constrain.compile_constraint(tok, llama.TINY.vocab_size,
                                            (257,), spec)

    schema = fsm(constrain.spec_for_response_format("json_schema",
                                                    CN_SCHEMA))
    cases = [
        ("a json reply", dict(temperature=0.0), schema),
        ("seeded", dict(temperature=0.8, seed=5), schema),
        ("object", dict(temperature=0.7, seed=9), fsm(
            constrain.spec_for_response_format("json_object", None))),
        ("call a tool", dict(temperature=0.0), fsm(
            constrain.spec_for_tools(constrain.parse_tools(CN_TOOLS)))),
        ("plain text", dict(temperature=0.0), None),
    ]
    reqs = []
    for i, (prompt, kw, cn) in enumerate(cases):
        streams.append([])

        def emit(t, f, out=streams[i]):
            if t >= 0:
                out.append(t)
            if f is not None:
                out.append(f)

        reqs.append(GenRequest(prompt=tok.encode(prompt), max_tokens=60,
                               sampling=SamplingParams(**kw), emit=emit,
                               constraint=cn))
    return reqs


def _cn_serve(eng, reqs):
    """Serve ``reqs`` on the engine's own loop, driven from this thread
    (admit, then tick) until every request has finished."""
    for r in reqs:
        eng.submit(r)
    for _ in range(5000):
        eng._admit()
        if not eng._decode_tick() and eng._queue.empty():
            break
    assert all(s is None for s in eng._slots)


@pytest.mark.parametrize("rung", sorted(CN_RUNGS))
def test_constrained_streams_match_cpu(cuda, rung):
    """The constrained engine on the card (the kernels) and on the CPU
    (their plain versions), float32, the same weights: identical streams
    and the same rollback and mask-patch counts; on the chained rung
    drafts are verified (K5) and accepted."""
    from aigw_tpu_torch.models import llama

    params = llama.init_params(0, llama.TINY, torch.float32, "cpu")
    out = {}
    for dev in ("cpu", cuda):
        eng = _cn_engine(dev, params, "float32", rung)
        streams: list = []
        _cn_serve(eng, _cn_requests(streams))
        out[str(dev)] = (streams, eng.stats)
    (cpu, cst), (gpu, gst) = out["cpu"], out[str(cuda)]
    assert gpu == cpu
    assert gst.constraint_rollbacks == cst.constraint_rollbacks > 0
    assert gst.constraint_mask_updates == cst.constraint_mask_updates
    assert gst.constraint_requests == cst.constraint_requests == 4
    assert gst.spec_accepted == cst.spec_accepted
    if rung == "chained_spec":
        assert gst.spec_accepted > 0


@pytest.mark.parametrize("rung", sorted(CN_RUNGS))
@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16"])
def test_rows_rewritten_after_a_cut(cuda, kv_dtype, rung):
    """After windows cut by grammar rollbacks (the window in flight wrote
    K/V past the cut, later windows wrote those rows again), each live
    slot's pool rows [0, pos) equal a cold prefill of its prompt and
    emitted tokens, within the card tolerance of the pool's dtype."""
    from aigw_tpu_torch.models import kvq, llama

    cfg = llama.TINY
    params = llama.init_params(0, cfg, torch.float32, "cpu")
    eng = _cn_engine(cuda, params, kv_dtype, rung)
    streams: list = []
    for r in _cn_requests(streams):
        r.max_tokens = 100
        eng.submit(r)
    for _ in range(400):
        eng._admit()
        eng._decode_tick()
        live = [s for s in eng._slots if s is not None and s.cn is not None
                and s.pos > len(s.req.prompt) + 8]
        if eng.stats.constraint_rollbacks >= 6 and len(live) >= 2:
            break
    eng._drain_inflight()
    live = [s for s in eng._slots if s is not None]
    assert eng.stats.constraint_rollbacks >= 6 and live
    ps = eng.cfg.page_size
    rtol, atol = TOL[kvq.compute_dtype(kv_dtype)]
    for s in live:
        toks = s.req.prompt + s.gen_tokens[:-1]
        n = len(toks)
        assert n == s.pos
        rows = torch.tensor([int(s.page_row[r // ps]) * ps + r % ps
                             for r in range(n)], device=cuda)
        got = eng.kv_cache[:, :, rows]
        P = -(-n // ps)
        pool = kvq.make_pool((cfg.n_layers, 2, (P + 1) * ps, cfg.n_kv_heads,
                              cfg.head_dim), kv_dtype, cuda)
        T = P * ps
        tk = torch.zeros(T, dtype=torch.int32, device=cuda)
        tk[:n] = torch.tensor(toks, device=cuda)
        row_seq = torch.ones(T, dtype=torch.int32, device=cuda)
        row_seq[:n] = 0
        pos = torch.zeros(T, dtype=torch.int32, device=cuda)
        pos[:n] = torch.arange(n, device=cuda)
        _, cold = llama.prefill_ragged(
            eng.params, cfg, tk, row_seq, pos,
            torch.tensor([n - 1], dtype=torch.int32, device=cuda), pool,
            torch.arange(P, dtype=torch.int32, device=cuda)[None], ps)
        torch.testing.assert_close(got.float(), cold[:, :, :n].float(),
                                   rtol=rtol, atol=atol)


# -- the mixtral family -------------------------------------------------------
def _moe_params(dev, wmode):
    """A 128-aligned MoE config (K6 takes its attention projections and
    lm_head at decode sizes) and its weights in float32, bf16 or W8A16."""
    from aigw_tpu_torch.models import mixtral, quant

    cfg = mixtral.MixtralConfig(
        vocab_size=512, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
        ffn_dim=512, n_experts=4, experts_per_token=2, max_seq_len=512,
        rope_theta=10000.0)
    dtype = torch.float32 if wmode == "float32" else torch.bfloat16
    params = mixtral.init_params(3, cfg, dtype, dev)
    if wmode == "w8a16":
        params = quant.quantize_params(params, consume=True, mode="int8")
    return cfg, params, dtype


class _Routes:
    """Every router top-k of the mixtral layers while on (the MoE layer
    looks ``top_k`` up at each call)."""

    def __init__(self, monkeypatch):
        from aigw_tpu_torch.models import mixtral

        self.calls = []
        orig = mixtral.top_k

        def record(logits, k):
            vals, idx = orig(logits, k)
            self.calls.append(idx.clone())
            return vals, idx

        monkeypatch.setattr(mixtral, "top_k", record)


@pytest.mark.parametrize("wmode", ["float32", "bf16", "w8a16"])
def test_mixtral_entry_points_kernels_vs_plain(cuda, monkeypatch, wmode):
    """A packed prefill, 4 fused and 4 chained decode steps and a verify
    step of width 5 through K5, through the kernels against the same
    calls with ``plain=True`` (teacher-forced on the kernel path's
    tokens). Float32: the [L, E + 1] routing counts equal and the logits
    within TOL. bf16 (and W8A16, whose attention projections and lm_head
    run K6): the logits of every slot whose routing agreed so far within
    0.1 of the logit scale, a greedy flip only at a top-2 gap under 0.1
    (routing may flip at bf16 near-ties: counted, not held)."""
    from aigw_tpu_torch.models import kvq, mixtral
    from aigw_tpu_torch.ops import qmatmul

    cfg, params, dtype = _moe_params(cuda, wmode)
    routes = {False: _Routes(monkeypatch), True: None}
    ps, P, B, S = 16, 8, 3, 5
    lens = [5, 17, 9]
    T = 48
    g = torch.Generator(device=cuda).manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (T,), generator=g,
                           device=cuda, dtype=torch.int32)
    row_seq = torch.full((T,), B, dtype=torch.int32, device=cuda)
    positions = torch.zeros((T,), dtype=torch.int32, device=cuda)
    last = torch.zeros((B,), dtype=torch.int32, device=cuda)
    o = 0
    for b, n in enumerate(lens):
        row_seq[o:o + n] = b
        positions[o:o + n] = torch.arange(n, device=cuda)
        last[b] = o + n - 1
        o += n
    pt = torch.arange(B * P, dtype=torch.int32, device=cuda).reshape(B, P)
    kv_dtype = "float32" if dtype == torch.float32 else "bfloat16"
    shape = (cfg.n_layers, 2, (B * P + 1) * ps, cfg.n_kv_heads, cfg.head_dim)
    pools = {p: kvq.make_pool(shape, kv_dtype, cuda) for p in (False, True)}
    flipped: set[int] = set()
    k6 = qmatmul.w8a16_matmul.launches

    def both(fn, *args, rows):
        out, idx = {}, {}
        for plain in (False, True):
            routes[False].calls = []
            a = tuple(pools[plain] if x is None else x for x in args)
            logits, pools[plain], stats = fn(params, cfg, *a, plain=plain,
                                             moe_stats=True)
            out[plain], idx[plain] = (logits, stats), routes[False].calls
        (lk, sk), (lp, sp) = out[False], out[True]
        assert torch.isfinite(lk).all() and torch.isfinite(lp).all()
        for a, b in zip(idx[False], idx[True]):
            flipped.update(rows[r] for r in torch.nonzero(
                (a != b).any(-1))[:, 0].tolist() if rows[r] is not None)
        if dtype == torch.float32:
            assert torch.equal(sk, sp)
            assert not flipped
            torch.testing.assert_close(lk, lp, rtol=TOL[dtype][0],
                                       atol=TOL[dtype][1])
        return lk, lp

    def hold(lk, lp, slots):
        keep = torch.tensor([s not in flipped for s in slots], device=cuda)
        a, b = lk[keep], lp[keep]
        if not len(a):
            return
        scale = b.abs().max().item()
        assert (a - b).abs().max().item() <= 0.1 * scale
        top2 = torch.topk(b, 2, dim=-1).values
        differ = a.argmax(-1) != b.argmax(-1)
        if differ.any():
            assert (top2[:, 0] - top2[:, 1])[differ].max().item() <= 0.1

    slot_of = [row_seq[t].item() if row_seq[t].item() < B else None
               for t in range(T)]
    lk, lp = both(mixtral.prefill_ragged, tokens, row_seq, positions, last,
                  None, pt, ps, rows=slot_of)
    hold(lk, lp, range(B))
    tok = lk.argmax(-1).to(torch.int32)
    pos = torch.tensor(lens, dtype=torch.int32, device=cuda)
    active = torch.ones((B,), dtype=torch.bool, device=cuda)
    for rung in ("fused", "chained"):
        for _ in range(4):
            lk, lp = both(mixtral.decode_step, tok, pos, None, pt, ps,
                          active, rung, rows=list(range(B)))
            hold(lk, lp, range(B))
            tok = lk.argmax(-1).to(torch.int32)
            pos = pos + 1
    draft = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                          device=cuda, dtype=torch.int32)
    draft[:, 0] = tok
    active[2] = False
    limits = pos + 32
    lk, lp = both(mixtral.verify_step, draft, pos, None, pt, ps, active,
                  limits, "chained", rows=[b for b in range(B)
                                           for _ in range(S)])
    hold(lk[:2].reshape(2 * S, -1), lp[:2].reshape(2 * S, -1),
         [b for b in range(2) for _ in range(S)])
    if wmode == "w8a16":
        assert qmatmul.w8a16_matmul.launches > k6


# -- multi-LoRA -------------------------------------------------------------------
LORA_ALL = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@pytest.mark.parametrize("layout", ["batched", "packed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lora_delta_on_card_matches_cpu(cuda, dtype, layout):
    """``lora_delta`` on the card against its CPU result on the same
    tensors (float32 within 1e-5 of the delta's scale, bf16 within one
    bf16 ulp plus 2**-7 of the scale), at Llama-3-8B's wq and w_down
    shapes, rank 16; the base row exactly 0 on both."""
    from aigw_tpu_torch.models import llama, lora

    cfg = llama.LlamaConfig(n_layers=1)
    stacks = lora.init_lora_adapters(3, cfg, lora.LoRAConfig(
        targets=("wq", "w_down")), 4, dtype, random_b=True, device="cpu")
    g = torch.Generator().manual_seed(4)
    idx = torch.tensor([0, 4, 1, 2, 0, 4, 3, 1])
    for key, d_in in (("l0.wq", cfg.dim), ("l0.w_down", cfg.ffn_dim)):
        if layout == "batched":
            x = torch.randn((8, 1, d_in), generator=g).to(dtype)
            row_seq, base = None, idx == 4
        else:
            row_seq = torch.repeat_interleave(
                torch.arange(8), torch.tensor([300, 1, 45, 700, 3, 128, 90,
                                               20]))
            x = torch.randn((len(row_seq), 1, d_in), generator=g).to(dtype)
            base = idx[row_seq] == 4
        want = lora.lora_delta(stacks, key, x, idx, row_seq)
        got = lora.lora_delta({k: v.to(cuda) for k, v in stacks.items()},
                              key, x.to(cuda), idx.to(cuda),
                              None if row_seq is None else row_seq.to(cuda))
        scale = want.float().abs().max().item()
        rtol, atol = ((1e-5, 1e-5 * scale) if dtype == torch.float32
                      else (2.0 ** -7, 2.0 ** -7 * scale))
        torch.testing.assert_close(got.cpu().float(), want.float(),
                                   rtol=rtol, atol=atol)
        assert not got[base.to(cuda)].any() and not want[base].any()


def _lora_engine(device, params, zoo, **over):
    from aigw_tpu_torch.models import llama
    from aigw_tpu_torch.tpuserve.adapters import AdapterStore
    from aigw_tpu_torch.tpuserve.engine import Engine, EngineConfig

    store = AdapterStore(n_slots=1, device=device)
    for name, ad in zoo.items():
        store.register(name, ad)
    cfg = dict(max_batch_size=4, max_seq_len=128, page_size=16,
               decode_steps_per_tick=4, kv_cache_dtype="float32",
               attention_backend="pallas-ragged", decode_backend="fused")
    return Engine({k: v.to(device) for k, v in params.items()}, llama.TINY,
                  EngineConfig(**{**cfg, **over}), eos_token_ids=(257,),
                  device=device, adapter_store=store)


@pytest.mark.parametrize("rung", sorted(CN_RUNGS))
def test_adapter_row_loaded_under_a_window_in_flight(cuda, rung):
    """One adapter row, two adapters: ad0's short request finishes while
    the next window (still carrying its slot) is in flight, and ad1's
    load rewrites that row in place behind it on the stream. Every
    stream equals the CPU engine's (the plain versions, the same
    schedule), and at least one load happened under a window in
    flight."""
    from aigw_tpu_torch.models import llama, lora
    from aigw_tpu_torch.tpuserve.engine import GenRequest
    from aigw_tpu_torch.tpuserve.sampling import SamplingParams

    params = llama.init_params(0, llama.TINY, torch.float32, "cpu")
    stacks = lora.init_lora_adapters(7, llama.TINY, lora.LoRAConfig(
        rank=4, alpha=8.0, targets=("wq", "wv", "w_down")), 2,
        torch.bfloat16, random_b=True, device="cpu")
    zoo = {f"ad{i}": {k: v[i] for k, v in stacks.items()} for i in range(2)}
    out = {}
    for dev in ("cpu", cuda):
        eng = _lora_engine(dev, params, zoo, **CN_RUNGS[rung])
        store = eng._adapter_store
        under = []
        load = store._load

        def traced(row, name, load=load, eng=eng, under=under):
            under.append(eng._inflight is not None)
            load(row, name)

        store._load = traced
        streams: list = []
        reqs = []
        for i, (adapter, prompt, n) in enumerate([
                ("ad0", [3, 1, 4], 4), ("", [5, 6, 7, 5, 6], 40),
                ("ad1", [2, 7, 1], 12)]):
            streams.append([])

            def emit(t, f, s=streams[i]):
                if t >= 0:
                    s.append(t)
                if f is not None:
                    s.append(f)

            reqs.append(GenRequest(prompt=prompt, max_tokens=n,
                                   sampling=SamplingParams(temperature=0.0),
                                   emit=emit, adapter=adapter))
        _cn_serve(eng, reqs)
        out[str(dev)] = (streams, under, store.loads, store.evictions)
        row = store.row_of("ad1")
        for k, v in zoo["ad1"].items():
            assert torch.equal(store.params[k][row].cpu(), v)
    cpu, gpu = out["cpu"], out[str(cuda)]
    assert gpu == cpu
    assert any(gpu[1]) and gpu[3] == 1


def test_lora_base_rows_bitwise_on_card(cuda):
    """At 2 layers with Llama-3-8B's head geometry (bf16, every target,
    rank 16): the base rows of a packed prefill, fused and chained
    decode steps and a verify step through the kernels are bit-equal to
    the same calls with ``lora=None``, and every adapter row differs."""
    from aigw_tpu_torch.models import kvq, llama, lora

    cfg = llama.LlamaConfig(vocab_size=1024, dim=1024, n_layers=2,
                            n_heads=8, n_kv_heads=2, ffn_dim=2048)
    params = llama.init_params(0, cfg, torch.bfloat16, cuda)
    stacks = lora.init_lora_adapters(1, cfg, lora.LoRAConfig(
        targets=LORA_ALL), 3, torch.bfloat16, random_b=True, device=cuda)
    rows = torch.tensor([0, 3, 1, 2, 3], device=cuda)
    base = rows == 3
    lens, PS, P = [40, 7, 130, 1, 64], 16, 12
    B, T = len(lens), 256
    row_seq = torch.full((T,), B, dtype=torch.int32, device=cuda)
    positions = torch.zeros((T,), dtype=torch.int32, device=cuda)
    last = torch.zeros((B,), dtype=torch.int32, device=cuda)
    o = 0
    for b, n in enumerate(lens):
        row_seq[o:o + n] = b
        positions[o:o + n] = torch.arange(n, device=cuda)
        last[b] = o + n - 1
        o += n
    g = torch.Generator(device=cuda).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (T,), generator=g,
                           device=cuda)
    pt = torch.arange(B * P, dtype=torch.int32, device=cuda).reshape(B, P)
    shape = (cfg.n_layers, 2, (B * P + 1) * PS, cfg.n_kv_heads,
             cfg.head_dim)
    pos = torch.tensor(lens, dtype=torch.int32, device=cuda)
    act = torch.ones((B,), dtype=torch.bool, device=cuda)
    step_toks = torch.randint(0, cfg.vocab_size, (B, 5), generator=g,
                              device=cuda, dtype=torch.int32)

    def calls(lo):
        kw = dict(lora=lo, adapter_idx=rows) if lo is not None else {}
        kv = kvq.make_pool(shape, "bfloat16", cuda)
        out = [llama.prefill_ragged(params, cfg, tokens, row_seq, positions,
                                    last, kv, pt, PS, **kw)[0]]
        for impl in ("fused", "chained"):
            kv2 = kv.clone()
            for s in range(3):
                out.append(llama.decode_step(
                    params, cfg, step_toks[:, s], pos + s, kv2, pt, PS, act,
                    impl, **kw)[0])
        out.append(llama.verify_step(params, cfg, step_toks, pos, kv.clone(),
                                     pt, PS, act, pos + 5, "chained",
                                     **kw)[0])
        return out

    with_lora, without = calls(stacks), calls(None)
    for a, b in zip(with_lora, without):
        assert torch.isfinite(a).all()
        assert torch.equal(a[base], b[base])
        assert all(not torch.equal(a[i], b[i])
                   for i in torch.nonzero(~base).flatten().tolist())


# -- per-token logprobs and n > 1 ------------------------------------------------
LP_RUNGS = {"fused": dict(decode_backend="fused"),
            "chained": dict(decode_backend="auto", pallas_attn=True)}


def _lp_engine(device, params, rung, **over):
    from aigw_tpu_torch.models import llama
    from aigw_tpu_torch.tpuserve.engine import Engine, EngineConfig

    return Engine({k: v.to(device) for k, v in params.items()}, llama.TINY,
                  EngineConfig(**{**dict(
                      max_batch_size=4, max_seq_len=128, page_size=16,
                      decode_steps_per_tick=4, kv_cache_dtype="float32",
                      attention_backend="pallas-ragged", logprobs_topk=5),
                      **LP_RUNGS[rung], **over}),
                  eos_token_ids=(257,), device=device)


def _lp_requests(rows):
    """A greedy, a seeded and a penalized request whose (token, chosen,
    top) entries land in ``rows``."""
    from aigw_tpu_torch.tpuserve.engine import GenRequest
    from aigw_tpu_torch.tpuserve.sampling import SamplingParams

    reqs = []
    for i, (prompt, kw) in enumerate([
            ([10, 20, 30, 40], dict(temperature=0.0)),
            ([3, 1, 4, 1, 5], dict(temperature=0.8, seed=11)),
            ([99, 98, 97], dict(temperature=0.0, frequency_penalty=0.8))]):
        rows.append([])

        def emit_lp(t, f, chosen, top, out=rows[i]):
            out.append((t, f, chosen, top))

        reqs.append(GenRequest(prompt=prompt, max_tokens=20,
                               sampling=SamplingParams(**kw),
                               emit_lp=emit_lp))
    return reqs


@pytest.mark.parametrize("rung", sorted(LP_RUNGS))
def test_decode_window_logprobs_match_plain_path(cuda, rung):
    """The engine on the card (K1, and K2 or K3) against the same engine
    on the CPU (their plain versions), float32, the same weights:
    identical streams, and every chosen and top-5 value within 1e-4."""
    from aigw_tpu_torch.models import llama

    params = llama.init_params(0, llama.TINY, torch.float32, "cpu")
    out = {}
    for dev in ("cpu", cuda):
        rows: list = []
        _cn_serve(_lp_engine(dev, params, rung), _lp_requests(rows))
        out[str(dev)] = rows
    cpu, gpu = out["cpu"], out[str(cuda)]
    assert [[r[:2] for r in s] for s in gpu] == \
        [[r[:2] for r in s] for s in cpu]
    n = 0
    for gs, cs in zip(gpu, cpu):
        for (t, f, gc, gtop), (_t, _f, cc, ctop) in zip(gs, cs):
            if t < 0:
                assert gc is None and gtop is None
                continue
            assert abs(gc - cc) <= 1e-4
            assert max(abs(a[1] - b[1]) for a, b in zip(gtop, ctop)) <= 1e-4
            n += 1
    assert n >= 40


def test_window_logprobs_host_copy_is_async(cuda):
    """Under async_transfers the window's [K, B] chosen values and
    [K, B, k] top ids and values are pinned host copies made under the
    tokens' event, and the entries equal a blocking copy's bit for bit."""
    from aigw_tpu_torch.models import llama

    params = llama.init_params(0, llama.TINY, torch.float32, "cpu")
    out = {}
    for sync in (False, True):
        eng = _lp_engine(cuda, params, "fused", async_transfers=not sync)
        rows: list = []
        for r in _lp_requests(rows):
            eng.submit(r)
        eng._admit()
        eng._decode_tick()
        w = eng._inflight
        chosen, ids, vals = w.lp
        K, B = w.k, eng.cfg.max_batch_size
        assert chosen.shape == (K, B) and ids.shape == vals.shape == (K, B, 5)
        assert all(t.device.type == "cpu" for t in w.lp)
        if not sync:
            assert w.ready is not None
            assert all(t.is_pinned() for t in (w.sampled, *w.lp))
        _cn_serve(eng, [])
        out[sync] = rows
    assert out[False] == out[True]


def test_n4_fan_out_under_a_lora_zoo(cuda):
    """A replica with a zoo of 2 adapters over 2 rows on the card and on
    the CPU: an ``n: 4`` sampled chat to ``tiny-random:ad0`` beside a
    base request; the 4 choices equal the CPU's, differ from one
    another, and each was submitted with the adapter as its tenant."""
    import concurrent.futures
    import json
    import urllib.request

    from aigw_tpu_torch.models import llama, lora
    from aigw_tpu_torch.tpuserve.engine import Engine, EngineConfig
    from aigw_tpu_torch.tpuserve.server import TPUServeServer

    params = llama.init_params(0, llama.TINY, torch.float32, "cpu")
    stacks = lora.init_lora_adapters(7, llama.TINY, lora.LoRAConfig(
        rank=4, alpha=8.0, targets=("wq", "wv")), 2, torch.bfloat16,
        random_b=True, device="cpu")
    zoo = {f"ad{i}": {k: v[i] for k, v in stacks.items()} for i in range(2)}
    bodies = [("/v1/chat/completions", {
        "model": "tiny-random:ad0", "n": 4, "temperature": 0.9, "seed": 7,
        "max_tokens": 12, "messages": [{"role": "user", "content": "hi"}]}),
        ("/v1/completions", {"model": "tiny-random", "prompt": "ab",
                             "max_tokens": 12, "temperature": 0.0})]

    def post(port, path, body):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
            headers={"content-type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            return json.loads(r.read())

    out = {}
    for dev in ("cpu", cuda):
        srv = TPUServeServer("tiny-random", EngineConfig(
            max_batch_size=8, max_seq_len=128, page_size=16,
            decode_steps_per_tick=4, kv_cache_dtype="float32",
            attention_backend="pallas-ragged", decode_backend="fused"),
            device=dev, port=0, param_dtype="float32", lora_adapters=zoo,
            lora_slots=2)
        srv.engine = Engine({k: v.to(dev) for k, v in params.items()},
                            llama.TINY, srv.engine.cfg, eos_token_ids=(257,),
                            fns=srv.fns, device=dev,
                            adapter_store=srv.adapter_store)
        tenants = []
        submit = srv.engine.submit

        def recording(req, submit=submit, tenants=tenants):
            tenants.append(req.tenant)
            submit(req)

        srv.engine.submit = recording
        srv.start()
        try:
            with concurrent.futures.ThreadPoolExecutor(2) as ex:
                replies = list(ex.map(lambda b: post(srv.port, *b), bodies))
        finally:
            srv.stop()
        out[str(dev)] = ([c["message"]["content"]
                          for c in replies[0]["choices"]],
                         replies[1]["choices"][0]["text"], sorted(tenants))
    assert out[str(cuda)] == out["cpu"]
    choices, _base, tenants = out[str(cuda)]
    assert len(choices) == 4 and len(set(choices)) > 1
    assert tenants == ["", "ad0", "ad0", "ad0", "ad0"]


def _ops_replica(cuda, **kw):
    from aigw_tpu_torch.tpuserve.engine import EngineConfig
    from aigw_tpu_torch.tpuserve.server import TPUServeServer

    srv = TPUServeServer("tiny-random", EngineConfig(
        max_batch_size=4, max_seq_len=256, page_size=16,
        decode_steps_per_tick=4, attention_backend="pallas-ragged",
        decode_backend="fused"), device=cuda, port=0, **kw)
    srv.start()
    return srv


def _post(port, path, body):
    import json
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def test_profile_capture_names_the_kernels(cuda):
    """``/debug/profile`` on the card: a bf16 request served inside the
    window puts K1's tensor-core kernel and K2's kernel in the Chrome
    trace, K2's events as many as its launch counter moved."""
    import json
    import os
    import shutil
    import threading
    import time

    srv = _ops_replica(cuda, enable_profile_endpoint=True)
    try:
        _post(srv.port, "/v1/completions", {"model": "tiny-random",
                                            "prompt": "warm", "max_tokens": 4})
        out = {}
        th = threading.Thread(target=lambda: out.update(r=srv.profile(
            "seconds=6")))
        th.start()
        from torch.autograd import profiler as autograd_profiler

        while not autograd_profiler._is_profiler_enabled:
            time.sleep(0.01)  # CUPTI's first set-up takes seconds
        time.sleep(0.5)
        k2 = decode_fused.fused_paged_decode.launches
        k1 = paged_attention.ragged_prefill_attention.launches
        reply = _post(srv.port, "/v1/completions", {
            "model": "tiny-random", "prompt": "profile me " * 5,
            "max_tokens": 24, "temperature": 0.0})
        d_k2 = decode_fused.fused_paged_decode.launches - k2
        d_k1 = paged_attention.ragged_prefill_attention.launches - k1
        th.join(timeout=120)
    finally:
        srv.stop()
    status, body = out["r"]
    assert status == 200, body
    info = json.loads(body)
    with open(os.path.join(info["profile_dir"], "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    shutil.rmtree(info["profile_dir"])
    names = [e["name"] for e in events if e.get("cat") == "kernel"]
    assert reply["usage"]["completion_tokens"] == 24 and d_k2 > 0
    assert sum("fused_decode_kernel" in n for n in names) == d_k2
    assert sum("ragged_prefill_tc_kernel" in n for n in names) == d_k1 > 0


def test_device_gauges_on_card(cuda):
    """The engine's device entry on the card: its memory from
    ``mem_get_info`` (at least what PyTorch allocated), the pool and the
    weights' bytes, rendered on ``/metrics`` under ``device="<index>"``."""
    import time

    from aigw_tpu_torch.obs.metrics import parse_exposition

    srv = _ops_replica(cuda)
    try:
        eng = srv.engine
        eng._mem_next = 0.0
        eng._refresh_stats()
        dev = eng.device_stats[0]
        free_b, total_b = torch.cuda.mem_get_info(eng.device)
        assert dev["platform"] == "gpu" and dev["bytes_limit"] == total_b
        assert dev["bytes_in_use"] >= torch.cuda.memory_allocated(eng.device)
        assert dev["param_bytes"] == sum(
            t.numel() * t.element_size() for t in eng.params.values()) > 0
        assert dev["kv_pool_bytes"] == eng.stats.kv_pool_bytes > 0
        assert eng.stats.device_memory_frac_worst == dev["memory_frac"] > 0
        text = srv.metrics().decode()
        parse_exposition(text)
        idx = dev["id"]
        assert f'tpuserve_device_bytes_limit_per_device{{device="{idx}"}} ' \
            f"{total_b}" in text
        assert "tpuserve_device_count 1" in text
        assert 'tpuserve_decode_attn_impl{impl="fused-cuda"} 1' in text
        time.sleep(0)
    finally:
        srv.stop()


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8", "int4"])
def test_page_movers_are_bit_exact(cuda, kv_dtype):
    """The engine's page movers on the card: ``_export_pages`` copies
    pages off the pool (int4 unpacked to one element per byte, the
    reference's host form), ``_import_pages_dev`` scatters host pages
    back (int4 packed again), and an import followed by an export gives
    back the same bytes, through the wire codec too; ``_export_page_dev``
    is the pool's page as it stands; no other page changes."""
    from aigw_tpu_torch.models import kvq, llama
    from aigw_tpu_torch.tpuserve.engine import Engine, EngineConfig
    from aigw_tpu_torch.tpuserve.server import (decode_wire_page,
                                                encode_wire_page)

    ps = 16
    eng = Engine(llama.init_params(0, llama.TINY, torch.bfloat16, cuda),
                 llama.TINY, EngineConfig(max_batch_size=2, max_seq_len=128,
                                          page_size=ps,
                                          kv_cache_dtype=kv_dtype),
                 device=cuda)
    g = torch.Generator(device=cuda).manual_seed(4)
    leaves = (eng.kv_cache.values() if isinstance(eng.kv_cache, dict)
              else (eng.kv_cache,))
    for leaf in leaves:
        if leaf.dtype.is_floating_point:
            leaf.copy_(torch.randn(leaf.shape, generator=g, device=cuda))
        else:
            leaf.copy_(torch.randint(0, 255, leaf.shape, generator=g,
                                     device=cuda).to(leaf.dtype))

    def pages_of(kv, p):
        if isinstance(kv, dict):
            return {k: v[:, :, p * ps:(p + 1) * ps].clone()
                    for k, v in kv.items()}
        return kv[:, :, p * ps:(p + 1) * ps].clone()

    src = [5, 1, 9]
    want = [pages_of(eng.kv_cache, p) for p in src]
    host = eng._export_pages(src)
    for p, h, w in zip(src, host, want):
        dev_page = eng._export_page_dev(p)
        if kv_dtype == "bfloat16":
            assert h.device.type == "cpu" and h.dtype == torch.bfloat16
            assert torch.equal(h, w.cpu()) and torch.equal(dev_page, w)
        else:
            q = (kvq.unpack_int4(w["q"]) & 0xF).to(torch.uint8) \
                if kv_dtype == "int4" else w["q"]
            assert h["dtype"] == kv_dtype
            assert torch.equal(h["q"], q.cpu())
            assert torch.equal(h["scale"], w["scale"].cpu())
            assert torch.equal(dev_page["q"], w["q"])
    before = pages_of(eng.kv_cache, 0)  # a page the import leaves alone
    dst = [3, 7, 2]
    wired = [decode_wire_page(encode_wire_page(h)) for h in host]
    eng._import_pages_dev(dst, wired)
    torch.cuda.synchronize()
    for p, w in zip(dst, want):
        got = pages_of(eng.kv_cache, p)
        if isinstance(w, dict):
            assert all(torch.equal(got[k], w[k]) for k in w)
        else:
            assert torch.equal(got, w)
    again = eng._export_pages(dst)
    assert [encode_wire_page(h) for h in again] \
        == [encode_wire_page(h) for h in host]
    keep = pages_of(eng.kv_cache, 0)
    if isinstance(keep, dict):
        assert all(torch.equal(keep[k], before[k]) for k in keep)
    else:
        assert torch.equal(keep, before)


# -- captured programs (CUDA graphs) --------------------------------------------
#: replay against the eager body, per program family: (engine overrides,
#: model family, the call). Decode calls are (k, lean, greedy, draft);
#: prefill calls name the entry point
GRAPH_CASES = {
    "lean_greedy": (dict(), "llama", (4, True, True, 0)),
    "lean_sampled": (dict(), "llama", (4, True, False, 0)),
    "full_greedy": (dict(), "llama", (4, False, True, 0)),
    "full_sampled": (dict(), "llama", (4, False, False, 0)),
    "chained": (dict(decode_backend="auto", pallas_attn=True), "llama",
                (4, False, False, 0)),
    "gather": (dict(decode_backend="auto"), "llama", (4, False, False, 0)),
    "int8_pool": (dict(kv_cache_dtype="int8"), "llama", (4, False, False, 0)),
    "spec_chained": (dict(decode_backend="auto", pallas_attn=True,
                          spec_tokens=3, spec_adaptive=False), "llama",
                     (4, False, False, 3)),
    "spec_fused": (dict(spec_tokens=3, spec_adaptive=False), "llama",
                   (4, False, True, 3)),
    "lora": (dict(), "lora", (4, False, False, 0)),
    "logprobs": (dict(logprobs_topk=5), "llama", (4, False, False, 0)),
    "mixtral": (dict(), "mixtral", (4, False, False, 0)),
    "prefill": (dict(attention_backend="xla-bucketed"), "llama", "prefill"),
    "prefill_suffix": (dict(attention_backend="xla-bucketed"), "llama",
                       "prefill_suffix"),
    "k1_rung": (dict(), "llama", "prefill_ragged"),
    "k1_mixtral": (dict(), "mixtral", "prefill_ragged"),
}


def _graph_engine(device, family="llama", **over):
    """A bf16 tiny engine on the kernel path (K1, K2), not started."""
    from aigw_tpu_torch.models import llama, lora, mixtral
    from aigw_tpu_torch.models.registry import family_fns
    from aigw_tpu_torch.tpuserve.engine import Engine, EngineConfig

    cfg = EngineConfig(**{**dict(
        max_batch_size=4, max_seq_len=128, page_size=16,
        decode_steps_per_tick=4, kv_cache_dtype="bfloat16",
        attention_backend="pallas-ragged", decode_backend="fused",
        enable_prefix_cache=False), **over})
    if family == "mixtral":
        return Engine(mixtral.init_params(7, mixtral.TINY_MOE, torch.bfloat16,
                                          device), mixtral.TINY_MOE, cfg,
                      eos_token_ids=(257,), fns=family_fns("mixtral"),
                      device=device)
    kw = {}
    if family == "lora":
        stacks = lora.init_lora_adapters(
            7, llama.TINY, lora.LoRAConfig(rank=4, alpha=8.0),
            2, torch.bfloat16, random_b=True, device=device)
        kw = dict(lora_params=stacks, adapter_names=("ad0", "ad1"))
    return Engine(llama.init_params(0, llama.TINY, torch.bfloat16, device),
                  llama.TINY, cfg, eos_token_ids=(257,), device=device, **kw)


def _live(eng):
    """Admit a mixed batch (greedy, seeded top-p, penalized, biased; an
    adapter row with a zoo) and build the decode state as a tick does."""
    from aigw_tpu_torch.tpuserve.engine import GenRequest
    from aigw_tpu_torch.tpuserve.sampling import SamplingParams

    for i, (n, kw) in enumerate([
            (5, dict(temperature=0.0)),
            (21, dict(temperature=0.8, top_p=0.9, seed=3)),
            (9, dict(temperature=0.7, seed=5, frequency_penalty=0.6)),
            (14, dict(temperature=0.0, logit_bias=((7, 3.0),)))]):
        eng.submit(GenRequest(
            prompt=[(17 * i + 3 * j) % 250 + 1 for j in range(n)],
            max_tokens=40, sampling=SamplingParams(**kw),
            adapter="ad1" if eng.adapter_rows and i % 2 else ""))
    eng._admit()
    eng._device_state = eng._build_device_state()
    eng._state_bucket = eng._decode_bucket_pages()


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _leaves(x)]
    return []


def _prefill_inputs(eng, name):
    """(entry point, model inputs, sampling rows) of one prefill call
    at the tiny geometry, on pages 1-6."""
    dev = eng.device
    B = eng.cfg.max_batch_size
    P = eng.cfg.max_pages_per_seq

    def i32(*v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    def rows(n):
        return (torch.tensor([[11, 0], [12, 0], [13, 0], [14, 0]][:n],
                             dtype=torch.int64, device=dev),
                torch.tensor([0.0, 0.8, 0.0, 1.0][:n], device=dev),
                torch.tensor([1.0, 0.9, 1.0, 1.0][:n], device=dev),
                i32(*[0, 20, 0, 0][:n]),
                torch.zeros((n, eng.model_cfg.vocab_size), device=dev),
                i32(*[eng._base_row] * n))

    pt = torch.zeros((B, P), dtype=torch.int32, device=dev)
    pt[0, :3], pt[1, :3] = i32(1, 2, 3), i32(4, 5, 6)
    g = torch.Generator(device="cpu").manual_seed(9)
    toks = torch.randint(1, 250, (2, 48), generator=g).to(torch.int32)
    if name == "prefill":
        return (eng.fns.prefill, (toks.to(dev), i32(30, 48), pt[:2]),
                rows(2))
    if name == "prefill_suffix":
        return (eng.fns.prefill_suffix, (toks[:1].to(dev), i32(16),
                                         i32(44), pt[:1, :4]), rows(1))
    T = 48  # no rung of the engine's own packs
    flat = torch.zeros((T,), dtype=torch.int32)
    flat[:30], flat[30:48] = toks[0, :30], toks[1, :18]
    seq = torch.full((T,), B, dtype=torch.int32)
    seq[:30], seq[30:48] = 0, 1
    pos = torch.zeros((T,), dtype=torch.int32)
    pos[:30], pos[30:48] = torch.arange(30), torch.arange(18)
    last = i32(29, 47, 0, 0)
    return (eng.fns.prefill_ragged, (flat.to(dev), seq.to(dev), pos.to(dev),
                                     last, pt), rows(B))


@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_program_replay_equals_eager_body(cuda, case):
    """Each program family's replay against its eager body, bit for
    bit: the first call of a key runs the body eagerly (and captures
    it); with the decode state and the pool put back, the second call
    replays the graph. Tokens, logprobs and routing counts, the decode
    state and every pool byte must be equal."""
    from aigw_tpu_torch.tpuserve.programs import clone_tree

    over, family, call = GRAPH_CASES[case]
    eng = _graph_engine(cuda, family, **over)
    _live(eng)
    if isinstance(call, str):
        fn, args, sampling = _prefill_inputs(eng, call)
        run = lambda: eng._prefill_step(fn, args, sampling)  # noqa: E731
    else:
        k, lean, greedy, draft = call
        run = lambda: eng._decode_fn_for(k, lean, greedy, draft)()  # noqa

    ps = eng.cfg.page_size

    def live():
        # the pool less its dump page: padding rows race into it (several
        # may share a row), so its bytes are garbage that nothing reads
        return _leaves(eng._state) + [t[:, :, :-ps]
                                      for t in _leaves(eng.kv_cache)]

    def snap():
        return clone_tree(tuple(live()))

    before = snap()
    n0 = eng.compile_tracker.compiles()
    eager = clone_tree(run())
    after = snap()
    assert eng.compile_tracker.compiles() == n0 + 1
    for dst, src in zip(live(), before):
        dst.copy_(src)
    replay = clone_tree(run())
    torch.cuda.synchronize()
    assert eng.compile_tracker.compiles() == n0 + 1  # replayed, no capture
    got, want = _leaves(replay), _leaves(eager)
    assert len(got) == len(want) > 0
    assert all(torch.equal(a, b) for a, b in zip(got, want)), case
    now = snap()
    assert all(torch.equal(a, b) for a, b in zip(now, after)), case
    if not isinstance(call, str):
        assert not all(torch.equal(a, b) for a, b in zip(after, before))


def test_replays_keep_the_host_copy_order(cuda):
    """A warmed engine on the card serves every window as a replay of a
    captured graph whose output buffers the next replay overwrites; the
    host copy of window N is queued behind replay N and ahead of replay
    N + 1 on the engine's stream, so its streams equal the CPU engine's
    (float32: plain versions), and no program is built after warm-up."""
    from aigw_tpu_torch.models import llama

    params = llama.init_params(0, llama.TINY, torch.float32, "cpu")
    out = {}
    for dev in ("cpu", cuda):
        eng = _cn_engine(dev, params, "float32", "fused")
        eng.cfg.warm_decode_buckets = 4
        eng.cfg.warm_prefill_buckets = 1
        eng.warmup()
        cp = eng.compile_tracker.checkpoint()
        rows: list = []
        _cn_serve(eng, _cn_requests(rows))
        assert eng.compile_tracker.compiles_since(cp) == 0
        assert eng.stats.decode_steps > 3 * eng.cfg.decode_steps_per_tick
        out[str(dev)] = rows
    assert out[str(cuda)] == out["cpu"]


def test_capture_of_a_host_sync_raises(cuda):
    """A body that reads the device on the host cannot be captured: the
    call raises, no graph is kept, and the next call raises again (no
    eager run in the graph's place). The card is still sound after it: a
    clean body captures and replays in a new pool (the void capture's
    pool takes no further capture; the engine stops on the error)."""
    from aigw_tpu_torch.obs.graph_events import CompileTracker
    from aigw_tpu_torch.tpuserve.programs import CapturedProgram, ProgramPool

    pool = ProgramPool(cuda, CompileTracker())
    bad = CapturedProgram(lambda x: x * float(x.sum().item()), pool)
    x = torch.ones(4, device=cuda)
    with pytest.raises(RuntimeError, match="captur"):
        bad(x)
    assert bad.graph is None
    with pytest.raises(RuntimeError):  # again: no eager run in its place
        bad(x)
    assert bad.graph is None and pool.tracker.compiles() == 0
    fresh = ProgramPool(cuda, CompileTracker())
    good = CapturedProgram(lambda x: x * 2 + 1, fresh)
    assert torch.equal(good(x), x * 2 + 1)
    assert torch.equal(good(x * 3), x * 7) and good.graph is not None
    assert fresh.tracker.compiles() == 1 and fresh.bytes() > 0


def test_lazy_capture_beside_embeddings(cuda):
    """Lazy captures on the engine thread while a handler thread serves
    ``/v1/embeddings`` (``hidden_states`` on the card) in a loop: every
    reply succeeds, programs were captured during the loop, and the
    engine stays healthy."""
    import threading

    srv = _ops_replica(cuda)
    stop = threading.Event()
    embeds: list = []

    def embed_loop():
        while not stop.is_set():
            embeds.append(_post(srv.port, "/v1/embeddings", {
                "model": "tiny-random",
                "input": ["x" * 90, [1, 2, 3] * 20, "hello"]}))

    t = threading.Thread(target=embed_loop)
    try:
        cp = srv.engine.compile_tracker.checkpoint()
        t.start()
        while not embeds:
            threading.Event().wait(0.01)
        outs = [_post(srv.port, "/v1/completions", {
            "model": "tiny-random", "prompt": "y" * n, "max_tokens": m,
            "temperature": 0.0}) for n, m in ((10, 8), (100, 60), (180, 70))]
        stop.set()
        t.join(timeout=120)
        assert not t.is_alive()
        assert srv.engine.compile_tracker.compiles_since(cp) > 0
        assert srv.engine.healthy, srv.engine.last_error
        assert all(o["usage"]["completion_tokens"] > 0 for o in outs)
        assert len(embeds) > 1 and all(
            len(e["data"]) == 3 for e in embeds)
    finally:
        stop.set()
        srv.stop()


def test_launch_counters_count_replays(cuda):
    """On a warmed engine every window replays a captured graph: K2's
    counter moves by the layers of every step the windows ran, K1's by
    the layers of every packed prefill call, though no wrapper runs."""
    from aigw_tpu_torch.models import llama

    eng = _graph_engine(cuda, warm_decode_buckets=4, warm_prefill_buckets=1)
    eng.warmup()
    cp = eng.compile_tracker.checkpoint()
    k2 = decode_fused.fused_paged_decode.launches
    k1 = paged_attention.ragged_prefill_attention.launches
    rows: list = []
    _cn_serve(eng, _cn_requests(rows))
    assert eng.compile_tracker.compiles_since(cp) == 0
    L = llama.TINY.n_layers
    assert decode_fused.fused_paged_decode.launches - k2 \
        == eng.stats.decode_steps * L > 0
    d1 = paged_attention.ragged_prefill_attention.launches - k1
    assert d1 > 0 and d1 % L == 0
