"""The port's kernels against the JAX package's Pallas kernels.

On the CPU each kernel wrapper of ``aigw_tpu_torch.ops`` runs its plain
PyTorch version; these tests hold that version against the reference
Pallas kernel run in interpret mode, on the same seeded numpy inputs, in
float32 (rtol/atol 2e-5: the two sides sum in different orders). The
fused decode kernel's pool must match byte for byte: the appended row,
fresh-page zeroing, the dump page of inactive slots, and every other
row untouched. The one exception is float32's appended K rows: on the
CPU, XLA contracts the reference kernel's jitted RoPE into a fused
multiply-add, ``fma(x, cos, round(rot * sin))``, while the port rounds
each product as the reference's eager ``llama.rope`` does, so those rows
may differ in the last place. The test pins each side to its formula
bit for bit instead (in bfloat16 the two match byte for byte). The CUDA kernels themselves are held against the same
plain versions on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aigw_tpu.ops.pallas.decode_fused import (
    _rope_tables as jax_rope_tables,
    fused_paged_decode as jax_fused,
)
from aigw_tpu.ops.pallas.paged_attention import (
    paged_attention_decode as jax_decode_v1,
    paged_attention_decode_v2 as jax_decode_v2,
    paged_attention_verify as jax_verify,
    ragged_prefill_attention as jax_ragged,
)
from aigw_tpu_torch.ops.decode_fused import (
    appending_split,
    fused_paged_decode,
)
from aigw_tpu_torch.ops.paged_attention import (
    PF_ROWS,
    mq_blocks,
    mq_plan,
    paged_attention_decode,
    paged_attention_decode_v2,
    paged_attention_verify,
    prefill_plan,
    prefill_tile,
    prefill_tiles,
    ragged_prefill_attention,
    split_pages,
)

TOL = 2e-5


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


# -- K1 ragged prefill -------------------------------------------------------
@pytest.mark.parametrize("lens,starts,page_size,q_block,H,Hkv,D,n_pages", [
    # q blocks span sequence boundaries; one short sequence
    ([3, 12, 7, 20], [0, 0, 0, 0], 8, 16, 4, 2, 32, 16),
    # nonzero, page-misaligned resume offsets
    ([5, 9, 14], [3, 8, 21], 8, 8, 4, 4, 32, 24),
    # tiny-moe attention geometry, one offset-resumed sequence
    ([7, 30, 13], [0, 5, 0], 16, 16, 4, 2, 16, 16),
    # prefix-cache partial hits: short suffixes resumed at long,
    # page-aligned prefixes (8 pages, 4, 6)
    ([12, 7, 3], [128, 64, 96], 16, 16, 4, 2, 32, 32),
    # full hits: the single row at n - 1 of a page-aligned prompt
    ([1, 1], [127, 63], 16, 16, 4, 2, 32, 24),
], ids=["mixed_lengths", "misaligned_starts", "q_tile_spanning",
        "resume_long_prefix", "full_hit_row"])
def test_ragged_prefill_matches_pallas(lens, starts, page_size, q_block, H,
                                       Hkv, D, n_pages):
    rng = np.random.default_rng(42)
    B = len(lens)
    total = sum(lens)
    T = -(-total // q_block) * q_block
    cu = np.zeros((B + 1,), np.int32)
    cu[1:] = np.cumsum(lens)
    P = max(2, max(-(-(s + n) // page_size) for s, n in zip(starts, lens)))
    q = rng.standard_normal((T, H, D), np.float32)
    kp = rng.standard_normal((n_pages * page_size, Hkv, D), np.float32)
    vp = rng.standard_normal((n_pages * page_size, Hkv, D), np.float32)
    pt = rng.permutation(n_pages)[: B * P].reshape(B, P).astype(np.int32)
    st = np.asarray(starts, np.int32)
    want = np.asarray(jax_ragged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pt),
        jnp.asarray(cu), jnp.asarray(st), page_size=page_size,
        q_block=q_block, interpret=True))
    got = ragged_prefill_attention(
        _t(q), _t(kp), _t(vp), _t(pt), _t(cu), _t(st),
        page_size=page_size, q_block=q_block).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    if T > cu[-1]:  # tail rows owned by no sequence are zero
        assert not got[cu[-1]:].any()


# -- K1's tensor-core launch plan --------------------------------------------
PREFILL_PLAN_CASES = {
    # chip_smoke's case at Llama-3-8B heads (group 4: 16 queries a
    # tile), one sequence resumed at 77, padding rows at the tail
    "served_g4": dict(H=32, Hkv=8, P=16, ps=128, pad=156,
                      seq=[(700, 0), (300, 0), (1, 0), (129, 77), (250, 0)]),
    # Qwen2-0.5B heads (group 7): 9 queries a tile, the 64th row unused
    "qwen_g7": dict(H=14, Hkv=2, P=8, ps=16, pad=5,
                    seq=[(37, 0), (1, 0), (20, 11), (9, 0)]),
    # group 8, resumed past a page, sequences with no queries
    "g8_offsets": dict(H=8, Hkv=1, P=6, ps=16, pad=0,
                       seq=[(0, 0), (17, 40), (8, 3), (0, 5), (33, 0)]),
    # group 1 (64 queries a tile), tiles of equal weight in three
    # sequences, a row past the table (capped at its last key)
    "g1_ties": dict(H=2, Hkv=2, P=4, ps=32, pad=7,
                    seq=[(64, 0), (64, 0), (1, 63), (100, 29)]),
}


@pytest.mark.parametrize("case", sorted(PREFILL_PLAN_CASES))
def test_prefill_tile_plan_covers_each_row_once(case):
    """K1's tensor-core tiles (``prefill_tiles``, as the kernel's blocks
    find them): every (packed row, head of the group) of every sequence
    is in exactly one tile and attends keys [0, start + row + 1), capped
    at the table; padding rows are in none; a tile holds whole queries
    of one sequence, at most ``PF_ROWS // G`` of them; the grid's blocks
    cover every tile."""
    c = PREFILL_PLAN_CASES[case]
    H, Hkv, P, ps = c["H"], c["Hkv"], c["P"], c["ps"]
    grp = H // Hkv
    lens = [n for n, _ in c["seq"]]
    starts = [s for _, s in c["seq"]]
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    T = int(cu[-1]) + c["pad"]
    qt, n_blocks = prefill_plan(T, len(lens), H, Hkv)
    assert qt == PF_ROWS // grp and n_blocks % Hkv == 0
    cover = np.zeros((T, grp), np.int32)
    n_tiles = 0
    for b, j, rows in prefill_tiles(cu, starts, T=T, H=H, Hkv=Hkv, P=P,
                                    page_size=ps):
        n_tiles += 1
        assert 1 <= len(rows) <= qt * grp and len(rows) % grp == 0
        for t, g, n_keys in rows:
            assert cu[b] + j * qt <= t < min(cu[b + 1], cu[b] + (j + 1) * qt)
            assert n_keys == min(starts[b] + t - cu[b] + 1, P * ps)
            cover[t, g] += 1
    want = np.zeros((T, grp), np.int32)
    want[:cu[-1]] = 1
    np.testing.assert_array_equal(cover, want)
    assert n_tiles == sum(-(-n // qt) for n in lens) <= n_blocks // Hkv


@pytest.mark.parametrize("case", sorted(PREFILL_PLAN_CASES))
def test_prefill_tiles_heaviest_first(case):
    """Block rank t works on the t-th tile in descending order of its
    key count (its last query's keys; ties go to the lower sequence), so
    the last tile of the longest sequence launches first; ranks past the
    last tile find none. The kernel's binary search (mirrored by
    ``prefill_tile``) equals a sort."""
    c = PREFILL_PLAN_CASES[case]
    lens = [n for n, _ in c["seq"]]
    starts = [s for _, s in c["seq"]]
    qt = PF_ROWS // (c["H"] // c["Hkv"])
    tiles = sorted(((s + min((j + 1) * qt, n), b, j)
                    for b, (n, s) in enumerate(zip(lens, starts))
                    for j in range(-(-n // qt))),
                   key=lambda x: (-x[0], x[1]))
    got = [prefill_tile(t, lens, starts, qt) for t in range(len(tiles) + 3)]
    assert got[:len(tiles)] == [(b, j) for _, b, j in tiles]
    assert got[len(tiles):] == [None] * 3
    b0, j0 = got[0]
    assert starts[b0] + lens[b0] == max(s + n for n, s in zip(lens, starts))
    assert j0 == -(-lens[b0] // qt) - 1  # its last tile


@pytest.mark.parametrize("seed", range(6))
def test_prefill_grid_bound_holds(seed):
    """``prefill_plan``'s block count, from T and B alone, covers the
    tiles of any packing of B sequences into T rows (empty sequences and
    one-query tiles included)."""
    rng = np.random.default_rng(seed)
    B = int(rng.integers(1, 9))
    for G in (1, 4, 7, 8):
        lens = [int(x) for x in rng.integers(0, 90, B)]
        lens[int(rng.integers(B))] = int(rng.integers(0, 3))
        T = sum(lens) + int(rng.integers(0, 40))
        qt, n_blocks = prefill_plan(max(T, 1), B, 8 * G, 8)
        assert sum(-(-n // qt) for n in lens) <= n_blocks // 8


# -- K3 chained decode -------------------------------------------------------
@pytest.mark.parametrize("lengths", [[7, 33], [1, 64], [40, 17], [0, 5]])
def test_paged_decode_v2_matches_pallas(lengths):
    B, H, Hkv, D, page_size, n_pages, P = 2, 4, 2, 128, 16, 16, 4
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, H, D), np.float32)
    kp = rng.standard_normal((n_pages * page_size, Hkv, D), np.float32)
    vp = rng.standard_normal((n_pages * page_size, Hkv, D), np.float32)
    pt = rng.permutation(n_pages)[: B * P].reshape(B, P).astype(np.int32)
    ln = np.asarray(lengths, np.int32)
    want = np.asarray(jax_decode_v2(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pt),
        jnp.asarray(ln), page_size=page_size, interpret=True))
    got = paged_attention_decode_v2(
        _t(q), _t(kp), _t(vp), _t(pt), _t(ln), page_size=page_size).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


# -- K4 decode v1 and K5 verify ----------------------------------------------
THETA = 10000.0
_ML = {"float32": np.float32, "bfloat16": jnp.bfloat16}
_TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: attention tolerance per dtype: summation order (f32), one bf16
#: rounding of the output (bf16)
ATOL = {"float32": TOL, "bfloat16": 1e-2}


def _paged_inputs(rng, shape_q, Hkv, D, ps, n_pages, B, P, dtype):
    """Seeded q, K/V pools (rounded once to ``dtype``) and a permuted
    page table, as numpy arrays in the case dtype."""
    def draw(shape):
        return rng.standard_normal(shape, np.float32).astype(_ML[dtype])

    q = draw(shape_q)
    kp, vp = draw((n_pages * ps, Hkv, D)), draw((n_pages * ps, Hkv, D))
    pt = rng.permutation(n_pages)[: B * P].reshape(B, P).astype(np.int32)
    return q, kp, vp, pt


def _tt(a, dtype):
    return _t(np.asarray(a, np.float32)).to(_TD[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lengths", [[7, 33, 0], [64, 1, 17]])
def test_paged_decode_v1_matches_pallas(lengths, dtype):
    """K4's plain version against the reference's v1 kernel (grid
    (B, Hkv, P)), including a sequence of length 0 and full tables."""
    B, H, Hkv, D, ps, n_pages, P = 3, 4, 2, 32, 16, 16, 4
    q, kp, vp, pt = _paged_inputs(np.random.default_rng(3), (B, H, D), Hkv,
                                  D, ps, n_pages, B, P, dtype)
    ln = np.asarray(lengths, np.int32)
    want = np.asarray(jax_decode_v1(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pt),
        jnp.asarray(ln), page_size=ps, interpret=True), np.float32)
    got = paged_attention_decode(
        _tt(q, dtype), _tt(kp, dtype), _tt(vp, dtype), _t(pt), _t(ln),
        page_size=ps).float().numpy()
    np.testing.assert_allclose(got, want, rtol=ATOL[dtype],
                               atol=ATOL[dtype])


@pytest.mark.parametrize("B,Hkv,P,want", [
    (8, 8, 16, (2, 8)),  # Llama-3-8B heads at batch 8: 512 blocks
    (1, 2, 4, (1, 4)),  # small batch: one page per split
    (128, 8, 16, (16, 1)),  # the card is full without a split
])
def test_paged_decode_v1_split_from_shapes(B, Hkv, P, want):
    """K4 sizes its split from the shapes alone: (pages per split,
    splits), every page in exactly one split."""
    pps, n = split_pages(B, Hkv, P)
    assert (pps, n) == want
    assert (n - 1) * pps < P <= n * pps


@pytest.mark.parametrize("B,Hkv,P,ps", [
    (8, 8, 16, 128),  # Llama-3-8B heads at batch 8: 8 splits of 2 pages
    (1, 2, 4, 16),  # one page per split
    (6, 2, 8, 16),
    (64, 8, 4, 128),  # batch 64: 2 splits of 2 pages
    (66, 8, 16, 128),  # the card is full without a split
    (3, 4, 7, 16),  # a last split shorter than the others
])
def test_fused_decode_split_plan(B, Hkv, P, ps):
    """The fused decode kernel's split over keys (K4's ``split_pages``):
    every key of the table in exactly one split; the appending block is
    the split holding the position; an inactive slot appends in split
    0 (the dump page)."""
    pps, n = split_pages(B, Hkv, P)
    span = pps * ps
    hits = np.zeros(P * ps, np.int32)
    for s in range(n):
        hits[s * span:min(P * ps, (s + 1) * span)] += 1
    assert (hits == 1).all()
    pos = torch.arange(P * ps)
    split = appending_split(pos, torch.ones_like(pos, dtype=torch.bool),
                            P=P, page_size=ps, pps=pps)
    assert ((split * span <= pos) & (pos < (split + 1) * span)).all()
    assert int(split.max()) == n - 1
    off = appending_split(pos, torch.zeros_like(pos, dtype=torch.bool),
                          P=P, page_size=ps, pps=pps)
    assert not off.any()


VERIFY_CASES = {
    # a window crossing a page boundary (pos 14..18 over page 16), a
    # slot that is off (the engine passes -(S + 1)), a fresh sequence
    "cross_page_off_slot": dict(B=3, S=5, H=4, Hkv=2, D=32, ps=16, P=4,
                                positions=[14, -6, 0]),
    # Llama-3-8B heads (group 4, D 128), page 128, windows at 126 and 300
    "llama3_8b_heads": dict(B=2, S=4, H=32, Hkv=8, D=128, ps=128, P=3,
                            positions=[126, 300]),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(VERIFY_CASES))
def test_paged_verify_matches_pallas(case, dtype):
    """K5's plain version against the reference's verify kernel in
    interpret mode: query s attends keys <= pos0 + s; a slot that is off
    comes out zero on both sides."""
    c = VERIFY_CASES[case]
    B, S, H, Hkv, D, ps, P = (c[k] for k in ("B", "S", "H", "Hkv", "D",
                                             "ps", "P"))
    n_pages = B * P + 2
    q, kp, vp, pt = _paged_inputs(np.random.default_rng(4), (B, S, H, D),
                                  Hkv, D, ps, n_pages, B, P, dtype)
    pos = np.asarray(c["positions"], np.int32)
    want = np.asarray(jax_verify(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pt),
        jnp.asarray(pos), page_size=ps, interpret=True), np.float32)
    got = paged_attention_verify(
        _tt(q, dtype), _tt(kp, dtype), _tt(vp, dtype), _t(pt), _t(pos),
        page_size=ps).float().numpy()
    np.testing.assert_allclose(got, want, rtol=ATOL[dtype],
                               atol=ATOL[dtype])
    off = pos <= -S
    assert not got[off].any() and not want[off].any()


def test_paged_verify_rows_are_decode_rows():
    """Query s of K5's plain version equals K3's walk over pos0 + s + 1
    keys, bit for bit, including a window that runs past the table (its
    rows stop at the table's last key, as the reference's grid does)."""
    B, S, H, Hkv, D, ps, P = 2, 5, 4, 2, 16, 8, 3
    q, kp, vp, pt = _paged_inputs(np.random.default_rng(5), (B, S, H, D),
                                  Hkv, D, ps, B * P, B, P, "float32")
    pos = np.asarray([5, P * ps - 2], np.int32)
    got = paged_attention_verify(_t(q), _t(kp), _t(vp), _t(pt), _t(pos),
                                 page_size=ps)
    for s in range(S):
        ln = np.minimum(pos + s + 1, P * ps).astype(np.int32)
        want = paged_attention_decode_v2(_t(q[:, s]), _t(kp), _t(vp),
                                         _t(pt), _t(ln), page_size=ps)
        assert torch.equal(got[:, s], want)


# -- the K3/K5 launch plan ---------------------------------------------------
MQ_PLAN_CASES = {
    # K5 at the served verify shapes: windows across pages and splits, a
    # slot that is off (-(S + 1)), a partly negative window (-2), rows
    # capped at the table's end
    "k5_served": dict(B=8, S=5, H=32, Hkv=8, D=128, P=16, ps=128, off=1,
                      xs=[126, 0, 254, 1022, -6, 1534, -2, 2046]),
    # --spec-tokens 16: 17 x 4 rows, three groups of 32
    "k5_s17": dict(B=3, S=17, H=32, Hkv=8, D=128, P=4, ps=16, off=1,
                   xs=[30, -18, 60]),
    # Qwen2 geometry (group 7): 63 rows, padded rows never emitted
    "k5_g7": dict(B=4, S=9, H=14, Hkv=2, D=64, P=6, ps=16, off=1,
                  xs=[15, -2, 88, 47]),
    # D 256: one m16 tile per group
    "k5_d256": dict(B=2, S=2, H=16, Hkv=2, D=256, P=3, ps=16, off=1,
                    xs=[40, 3]),
    # K3: lengths 0, at page and split edges, the whole table and past it
    "k3": dict(B=7, S=1, H=32, Hkv=8, D=128, P=16, ps=128, off=0,
               xs=[0, 1, 127, 256, 257, 2048, 2053]),
    # batch 66: the card is full without a split
    "k3_batch66": dict(B=66, S=1, H=8, Hkv=8, D=64, P=4, ps=16, off=0,
                       xs=list(range(0, 66))),
}


@pytest.mark.parametrize("tensor_cores", [True, False])
@pytest.mark.parametrize("case", sorted(MQ_PLAN_CASES))
def test_mq_launch_plan_covers_each_pair_once(case, tensor_cores):
    """The K3/K5 body's blocks (``mq_blocks``, as the kernel picks them
    from ``mq_plan``): every (row, key) pair the plain version attends
    (row s * G + g attends keys < clamp(xs[b] + s + off, 0, P * page)) is
    covered by exactly one (split, row group), and no key at or past the
    row's count by any; no block lies past the grid."""
    c = MQ_PLAN_CASES[case]
    B, S, H, Hkv, D, P, ps = (c[k] for k in ("B", "S", "H", "Hkv", "D",
                                             "P", "ps"))
    grp = H // Hkv
    R = S * grp
    pps, n_split, rows, n_rg = mq_plan(B, S, H, Hkv, D, P,
                                       tensor_cores=tensor_cores)
    assert rows in ((16, 32) if tensor_cores else (4, 8))
    cover = np.zeros((B, R, P * ps + 8), np.int32)
    for b, rg, sp, block_rows in mq_blocks(
            c["xs"], S=S, H=H, Hkv=Hkv, P=P, page_size=ps, off=c["off"],
            pps=pps, group_rows=rows):
        assert 0 <= rg < n_rg and 0 <= sp < n_split
        assert 1 <= len(block_rows) <= rows
        for r, lo, hi in block_rows:
            assert rg * rows <= r < (rg + 1) * rows
            assert sp * pps * ps <= lo <= hi <= (sp + 1) * pps * ps
            cover[b, r, lo:hi] += 1
    s_of_row = np.arange(R) // grp
    n_keys = np.clip(np.asarray(c["xs"])[:, None] + s_of_row + c["off"], 0,
                     P * ps)  # [B, R]
    want = (np.arange(P * ps + 8)[None, None, :]
            < n_keys[:, :, None]).astype(np.int32)
    np.testing.assert_array_equal(cover, want)


def test_mq_plan_reads_each_key_once_at_served_shapes():
    """At Llama-3-8B heads, S 5 (20 rows) fits one row group, so each
    key of a (sequence, KV head) is read by one block for all S queries;
    S 17 needs three groups of 32 rows, the CUDA-core body groups of 8."""
    assert mq_plan(8, 5, 32, 8, 128, 16, tensor_cores=True) == (2, 8, 32, 1)
    assert mq_plan(8, 1, 32, 8, 128, 16, tensor_cores=True)[2:] == (16, 1)
    assert mq_plan(8, 17, 32, 8, 128, 16, tensor_cores=True)[2:] == (32, 3)
    assert mq_plan(8, 5, 32, 8, 128, 16, tensor_cores=False)[2:] == (8, 3)
    assert mq_plan(2, 2, 16, 2, 256, 3, tensor_cores=True)[2:] == (16, 1)


# -- K2 fused decode ---------------------------------------------------------


def _fused_case(B, H, Hkv, D, ps, n_pages, P, positions, active,
                dtype="float32", seed=0):
    """Run the reference Pallas kernel (interpret mode) and the port on
    one seeded case; returns numpy float32 views of (attn, k pool,
    v pool) for both, the input K pool, the page table, the flat slots
    the active appends land in, and the active slots' new K rows with
    their cos/sin tables."""
    rng = np.random.default_rng(seed)

    def draw(shape):  # seeded values, rounded once to the case dtype
        return rng.standard_normal(shape, np.float32).astype(_ML[dtype])

    q, kn, vn = draw((B, H, D)), draw((B, Hkv, D)), draw((B, Hkv, D))
    kp, vp = draw((n_pages * ps, Hkv, D)), draw((n_pages * ps, Hkv, D))
    # the LAST pool page stays out of every table: the dump page
    pt = rng.permutation(n_pages - 1)[: B * P].reshape(B, P).astype(np.int32)
    pos = np.asarray(positions, np.int32)
    act = np.asarray(active, bool)
    attn_j, kp_j, vp_j = jax_fused(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(pt), jnp.asarray(pos),
        jnp.asarray(act), rope_theta=THETA, page_size=ps, interpret=True)

    def tt(a):
        return _t(np.asarray(a, np.float32)).to(_TD[dtype])

    kp_t, vp_t = tt(kp), tt(vp)
    # the reference's own cos/sin tables, computed as its jitted kernel
    # computes them: f32 cos/sin differ between libms (and between XLA's
    # eager and fused programs), see test_torch_model.py::test_rope_*
    cos, sin = jax.jit(jax_rope_tables, static_argnums=(1, 2))(
        jnp.asarray(pos), D, THETA)
    attn_t, kp_o, vp_o = fused_paged_decode(
        tt(q), tt(kn), tt(vn), kp_t, vp_t, _t(pt), _t(pos), _t(act),
        rope_theta=THETA, page_size=ps,
        tables=(_t(np.asarray(cos)), _t(np.asarray(sin))))
    assert kp_o is kp_t and vp_o is vp_t  # updated in place
    slots = [int(pt[b, p // ps]) * ps + p % ps
             for b, p in enumerate(positions) if active[b]]

    def f32(a):
        return np.asarray(a, np.float32)

    act_rows = [b for b in range(B) if active[b]]
    new_k = (f32(kn)[act_rows], np.asarray(cos)[act_rows],
             np.asarray(sin)[act_rows])
    return (f32(attn_j), f32(kp_j), f32(vp_j), attn_t.float().numpy(),
            kp_o.float().numpy(), vp_o.float().numpy(), f32(kp), pt, slots,
            new_k)


def _rope_recipes(x, cos, sin):
    """The interleaved RoPE of f32 rows ``x [N, Hkv, D]`` two ways:
    every product rounded (the port, and the reference's eager rope), and
    XLA's contraction on the CPU, ``fma(x, cos, round(rot * sin))`` with
    ``rot`` the pair swap (-x[2i+1], x[2i])."""
    c, s = cos[:, None, :], sin[:, None, :]
    rot = np.empty_like(x)
    rot[..., ::2], rot[..., 1::2] = -x[..., 1::2], x[..., ::2]
    rounded = x * c + rot * s  # numpy rounds each f32 product and sum
    fused = (x.astype(np.float64) * c
             + (rot * s).astype(np.float64)).astype(np.float32)
    return rounded, fused


GEOMS = {
    # llama-3-8B heads: misaligned mid-page append, page-straddling length
    "llama3_8b_heads": dict(B=2, H=32, Hkv=8, D=128, ps=128, n_pages=9,
                            P=4, positions=[385, 129], active=[True, True]),
    # tiny geometry: mid-page, position 0, page-aligned third slot
    "tiny_geometry": dict(B=3, H=4, Hkv=2, D=16, ps=16, n_pages=16, P=4,
                          positions=[17, 0, 48], active=[True, True, True]),
    # fresh page at 16, pos 0, and an inactive slot
    "fresh_page_inactive": dict(B=3, H=4, Hkv=2, D=128, ps=16, n_pages=16,
                                P=4, positions=[16, 0, 33],
                                active=[True, True, False]),
}


@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_fused_decode_matches_pallas(geom):
    """float32: attention within 2e-5; every pool row byte for byte
    except the appended K rows, whose RoPE XLA contracts into an FMA
    inside the jitted reference: there each side equals its own recipe
    bit for bit (the bfloat16 case below holds them byte for byte)."""
    g = GEOMS[geom]
    (attn_j, kp_j, vp_j, attn_t, kp_t, vp_t, _kp0, _pt,
     slots, new_k) = _fused_case(**g)
    act = np.asarray(g["active"])
    np.testing.assert_allclose(attn_t[act], attn_j[act], rtol=TOL, atol=TOL)
    # inactive slots attend nothing: zeros on both sides
    assert not attn_t[~act].any() and not attn_j[~act].any()
    np.testing.assert_array_equal(vp_t, vp_j)  # values need no RoPE
    rest = np.ones(kp_t.shape[0], bool)
    rest[slots] = False
    np.testing.assert_array_equal(kp_t[rest], kp_j[rest])
    rounded, fused = _rope_recipes(*new_k)
    np.testing.assert_array_equal(kp_t[slots], rounded)
    np.testing.assert_array_equal(kp_j[slots], fused)


@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_fused_decode_matches_pallas_bf16(geom):
    """bfloat16 (the serving dtype): the pools match byte for byte,
    appended rows, fresh-page zeroing and the dump page included;
    attention within one bf16 rounding (1e-2)."""
    g = GEOMS[geom]
    (attn_j, kp_j, vp_j, attn_t, kp_t, vp_t, _kp0, _pt,
     _slots, _new_k) = _fused_case(**g, dtype="bfloat16")
    act = np.asarray(g["active"])
    np.testing.assert_allclose(attn_t[act], attn_j[act], rtol=1e-2,
                               atol=1e-2)
    np.testing.assert_array_equal(kp_t, kp_j)
    np.testing.assert_array_equal(vp_t, vp_j)


def test_fused_decode_page_semantics():
    """Fresh page at a page-aligned append, the dump page for an
    inactive slot, and every other row untouched."""
    g = dict(B=3, H=4, Hkv=2, D=16, ps=16, n_pages=16, P=4,
             positions=[16, 5, 33], active=[True, True, False])
    (_, _, _, _, kp_t, _, kp0, pt, _, _) = _fused_case(**g)
    ps, n_pages = 16, 16
    fresh = int(pt[0, 1])  # slot 0 appends at row 0 of its 2nd page
    pages = kp_t.reshape(n_pages, ps, 2, 16)
    assert not pages[fresh, 1:].any()  # rest of the fresh page zeroed
    assert not pages[n_pages - 1].any()  # dump page zeroed
    mid = int(pt[1, 0])
    touched = np.zeros((n_pages, ps), bool)
    touched[fresh] = True
    touched[n_pages - 1] = True
    touched[mid, 5] = True
    np.testing.assert_array_equal(
        pages[~touched], kp0.reshape(n_pages, ps, 2, 16)[~touched])


# -- K7 fused decode, int8/int4 rung -----------------------------------------
def _fused_quant_case(B, H, Hkv, D, ps, n_pages, P, positions, active, qdt,
                      dtype="float32", seed=0):
    """The reference Pallas kernel (interpret mode) and the port on one
    seeded case over an int8/int4 pool quantized by the reference's own
    ``kvq.quantize_rows``; returns (reference outputs, port outputs,
    page table, active slots' append slots), pools as integer values."""
    from aigw_tpu.models import kvq as jkvq
    from aigw_tpu_torch.models import convert

    rng = np.random.default_rng(seed)

    def draw(shape):
        return rng.standard_normal(shape, np.float32).astype(_ML[dtype])

    q, kn, vn = draw((B, H, D)), draw((B, Hkv, D)), draw((B, Hkv, D))
    kf = rng.standard_normal((n_pages * ps, Hkv, D), np.float32)
    vf = rng.standard_normal((n_pages * ps, Hkv, D), np.float32)
    kq, ks = jkvq.quantize_rows(jnp.asarray(kf), qdt)
    vq, vs = jkvq.quantize_rows(jnp.asarray(vf), qdt)
    pt = rng.permutation(n_pages - 1)[: B * P].reshape(B, P).astype(np.int32)
    pos = np.asarray(positions, np.int32)
    act = np.asarray(active, bool)
    ref = jax_fused(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), kq, vq,
        jnp.asarray(pt), jnp.asarray(pos), jnp.asarray(act), ks, vs,
        rope_theta=THETA, page_size=ps, interpret=True)
    kp = convert.pool_from_numpy({"q": kq, "scale": ks}, "cpu")
    vp = convert.pool_from_numpy({"q": vq, "scale": vs}, "cpu")
    cos, sin = jax.jit(jax_rope_tables, static_argnums=(1, 2))(
        jnp.asarray(pos), D, THETA)

    def tt(a):
        return _t(np.asarray(a, np.float32)).to(_TD[dtype])

    got = fused_paged_decode(
        tt(q), tt(kn), tt(vn), kp["q"], vp["q"], _t(pt), _t(pos), _t(act),
        kp["scale"], vp["scale"], rope_theta=THETA, page_size=ps,
        tables=(_t(np.asarray(cos)), _t(np.asarray(sin))))
    assert got[1] is kp["q"] and got[3] is kp["scale"]  # in place
    to_np = [np.asarray(ref[0], np.float32),
             *(np.asarray(r).astype(np.int8) for r in ref[1:3]),
             *(np.asarray(r) for r in ref[3:])]
    port = [got[0].float().numpy(),
            *(convert.pool_to_numpy({"q": g, "scale": kp["scale"]})["q"]
              for g in got[1:3]),
            got[3].numpy(), got[4].numpy()]
    slots = [int(pt[b, p // ps]) * ps + p % ps
             for b, p in enumerate(positions) if active[b]]
    return to_np, port, pt, slots


QGEOMS = {
    # the reference's production-shape quantized case
    "llama3_8b_heads": dict(B=2, H=32, Hkv=8, D=128, ps=128, n_pages=9,
                            P=4, positions=[385, 129], active=[True, True]),
    # tiny geometry: a page-aligned append, position 0, an inactive slot
    "fresh_page_inactive": dict(B=3, H=4, Hkv=2, D=16, ps=16, n_pages=16,
                                P=4, positions=[16, 0, 33],
                                active=[True, True, False]),
}


@pytest.mark.parametrize("qdt", ["int8", "int4"])
@pytest.mark.parametrize("geom", sorted(QGEOMS))
def test_fused_decode_quantized_matches_pallas(geom, qdt):
    """float32: attention within 2e-5; every pool row not appended this
    step byte for byte (fresh-page zeroing and the dump page included);
    the appended rows' q values within ±1 and scales within rtol 1e-5,
    as the reference's own test asserts (its jitted kernel contracts the
    f32 RoPE of the new key into an FMA, see the module docstring)."""
    g = QGEOMS[geom]
    ref, port, _pt, slots = _fused_quant_case(**g, qdt=qdt)
    act = np.asarray(g["active"])
    np.testing.assert_allclose(port[0][act], ref[0][act], rtol=TOL,
                               atol=TOL)
    assert not port[0][~act].any()
    rest = np.ones(port[1].shape[0], bool)
    rest[slots] = False
    for i in (1, 2, 3, 4):
        np.testing.assert_array_equal(port[i][rest], ref[i][rest])
    for i in (1, 2):
        assert np.abs(port[i][slots].astype(np.int32)
                      - ref[i][slots].astype(np.int32)).max() <= 1
    for i in (3, 4):
        np.testing.assert_allclose(port[i][slots], ref[i][slots], rtol=1e-5)


@pytest.mark.parametrize("qdt", ["int8", "int4"])
def test_fused_decode_quantized_matches_pallas_bf16(qdt):
    """bfloat16 (the serving dtype): attention within one bf16 rounding
    (1e-2); the pools, q bytes and scales, byte for byte, appended rows,
    fresh-page zeroing and the dump page included."""
    for geom in sorted(QGEOMS):
        ref, port, _pt, _slots = _fused_quant_case(**QGEOMS[geom], qdt=qdt,
                                                   dtype="bfloat16")
        np.testing.assert_allclose(port[0], ref[0], rtol=1e-2, atol=1e-2)
        for i in (1, 2, 3, 4):
            np.testing.assert_array_equal(port[i], ref[i])
