"""Paged attention for prefill, chained decode and speculative verify
(counterpart of ``aigw_tpu/ops/pallas/paged_attention.py``).

- ``ragged_prefill_attention`` (K1): causal prefill attention over a
  packed variable-length query stream against the paged KV pool. Row t
  of sequence b (``cu_seqlens[b] <= t < cu_seqlens[b+1]``) attends pool
  positions ``<= start_pos[b] + (t - cu_seqlens[b])``; rows owned by no
  sequence come out zero.
- ``paged_attention_decode_v2`` (K3): one query token per sequence
  attends its first ``lengths[b]`` pool rows; GQA group = H / Hkv.
- ``paged_attention_decode`` (K4, the reference's v1): K3's function,
  launched on K3's body. No engine path selects it, as in the
  reference.
- ``paged_attention_verify`` (K5): S consecutive queries per sequence
  (the pending token and its drafts); query s attends pool positions
  ``<= positions[b] + s``, and a slot with ``positions[b] <= -S``
  attends nothing (zeros).

On the card K3, K4 and K5 are one kernel body (K3 is K5 at S = 1 over
``lengths[b]`` keys): every (sequence, KV head) holds its S x G query
rows in one block and reads each key once for all of them, its keys
split over blocks as the fused decode's are (``split_pages``), folded in
the same launch. ``mq_plan`` sizes the launch from the shapes alone and
``mq_blocks`` lists what each block covers. K1 in bf16 runs on the
tensor cores in tiles of whole queries of one sequence and KV head,
heaviest first; ``prefill_plan`` sizes its grid from the shapes and
``prefill_tile`` / ``prefill_tiles`` mirror how its blocks find their
tiles.

Each function has a plain PyTorch version beside it with the same
signature (``*_plain``). The public function runs the plain version for
CPU tensors and the CUDA kernel (``csrc/paged_attention.cu``) for CUDA
tensors — it never falls back from one to the other. Each public
function counts its kernel launches in ``.launches``.

The pool layout is the reference's: ``[n_slots, Hkv, D]`` flattened
pages, page p of a sequence at slots ``page_table[b, p] * page_size``
onward.
"""

from __future__ import annotations

import math

import torch

from aigw_tpu_torch.ops import _build
from aigw_tpu_torch.ops.decode_fused import paged_decode_walk, split_pages


def ragged_prefill_attention_plain(
    q: torch.Tensor,  # [T, H, D] packed queries
    k_pool: torch.Tensor,  # [n_slots, Hkv, D]
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # [B, P] int32
    cu_seqlens: torch.Tensor,  # [B + 1] int32
    start_pos: torch.Tensor,  # [B] int32
    *,
    page_size: int,
    q_block: int = 128,
) -> torch.Tensor:
    """Plain version of K1: per sequence, an online-softmax walk over its
    pages (the math of the reference's ``_ragged_window_attention``,
    ``aigw_tpu/models/llama.py``) with f32 state and -1e30 masking.
    ``q_block`` is accepted for signature parity and unused."""
    del q_block
    T, H, D = q.shape
    Hkv = k_pool.shape[1]
    grp = H // Hkv
    out = torch.zeros((T, H, D), dtype=q.dtype, device=q.device)
    cu = cu_seqlens.tolist()
    st = start_pos.tolist()
    pt = page_table.long()
    offs = torch.arange(page_size, device=q.device)
    for b in range(page_table.shape[0]):
        lo, hi, start = cu[b], cu[b + 1], st[b]
        if hi <= lo:
            continue
        qf = q[lo:hi].float().reshape(hi - lo, Hkv, grp, D) / math.sqrt(D)
        pos = start + torch.arange(hi - lo, device=q.device)  # [Lq]
        m = torch.full((hi - lo, Hkv, grp, 1), -1e30, device=q.device)
        l = torch.zeros((hi - lo, Hkv, grp, 1), device=q.device)
        acc = torch.zeros((hi - lo, Hkv, grp, D), device=q.device)
        n_pages = (start + (hi - lo) - 1) // page_size + 1
        for p in range(n_pages):
            slots = pt[b, p] * page_size + offs
            k = k_pool[slots].float()  # [page, Hkv, D]
            v = v_pool[slots].float()
            logits = torch.einsum("thgd,shd->thgs", qf, k)
            kp = p * page_size + offs
            mask = kp[None, :] <= pos[:, None]  # [Lq, page]
            logits = torch.where(mask[:, None, None, :], logits,
                                 torch.full_like(logits, -1e30))
            m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            probs = torch.exp(logits - m_new)
            l = alpha * l + probs.sum(-1, keepdim=True)
            acc = acc * alpha + torch.einsum("thgs,shd->thgd", probs, v)
            m = m_new
        res = acc / torch.clamp(l, min=1e-30)
        out[lo:hi] = res.reshape(hi - lo, H, D).to(q.dtype)
    return out


#: (query, head) rows of a K1 tensor-core tile (PF_ROWS in the source)
PF_ROWS = 64


def _tc(q: torch.Tensor, k_pool: torch.Tensor) -> bool:
    """Whether the tensor-core bodies (K1's and K3-K5's) take these
    operands: bf16 q over a bf16 pool, D a multiple of 16."""
    return (q.dtype == torch.bfloat16 and k_pool.dtype == torch.bfloat16
            and q.shape[-1] % 16 == 0)


def prefill_plan(T: int, B: int, H: int, Hkv: int) -> tuple[int, int]:
    """Launch plan of K1's tensor-core kernel for T packed rows of B
    sequences: ``(qt, n_blocks)``. A tile holds ``qt`` whole queries of
    one sequence (``PF_ROWS // G`` of them, G = H / Hkv, so all G heads
    of a query sit in one tile); the B sequences hold at most ``(T + B
    (qt - 1)) // qt`` tiles, and the grid has that many blocks per KV
    head, sized with no look at ``cu_seqlens``."""
    qt = PF_ROWS // (H // Hkv)
    return qt, (T + B * (qt - 1)) // qt * Hkv


def _tiles_ge(n_q: int, start: int, qt: int, w: int) -> int:
    """Tiles of a sequence of ``n_q`` queries at ``start`` weighing at
    least ``w`` keys (tile j weighs ``start + min((j + 1) qt, n_q)``,
    its last query's keys); the kernel's ``tiles_ge``."""
    if n_q <= 0 or w > start + n_q:
        return 0
    n = -(-n_q // qt)
    j = 0 if w <= start else -(-(w - start) // qt) - 1
    return n - min(j, n - 1)


def prefill_tile(t: int, lens, starts, qt: int):
    """The tile block rank ``t`` of K1's tensor-core launch works on, as
    the kernel's ``prefill_tile`` finds it: tiles ordered by weight,
    heaviest first (ties: lower sequence first); ``(b, j)``, or None
    past the last tile. A binary search on the weight of rank t, then
    the sequence holding a tile of that weight."""
    def count_ge(w):
        return sum(_tiles_ge(n, s, qt, w) for n, s in zip(lens, starts))

    w_max = max([s + n for n, s in zip(lens, starts) if n > 0], default=0)
    if w_max < 1 or count_ge(1) <= t:
        return None
    lo, hi = 1, w_max
    while lo < hi:
        mid = lo + (hi - lo + 1) // 2
        if count_ge(mid) > t:
            lo = mid
        else:
            hi = mid - 1
    k = t - count_ge(lo + 1)
    for b, (n, s) in enumerate(zip(lens, starts)):
        n_ge = _tiles_ge(n, s, qt, lo)
        if n_ge - _tiles_ge(n, s, qt, lo + 1) == 1:
            if k == 0:
                return b, -(-n // qt) - n_ge
            k -= 1
    return None


def prefill_tiles(cu_seqlens, start_pos, *, T: int, H: int, Hkv: int,
                  P: int, page_size: int):
    """What K1's tensor-core blocks attend, in launch order (rank 0
    first; each rank is one block per KV head): yields ``(b, j, rows)``
    for every rank that holds a tile, ``rows`` a list of ``(t, g,
    n_keys)``: packed row t, head h * G + g of KV head h, attending keys
    ``[0, n_keys)``."""
    cu = [int(v) for v in cu_seqlens]
    starts = [int(v) for v in start_pos]
    B = len(starts)
    lens = [cu[b + 1] - cu[b] for b in range(B)]
    grp = H // Hkv
    qt, n_blocks = prefill_plan(T, B, H, Hkv)
    cap = P * page_size
    for rank in range(n_blocks // Hkv):
        tile = prefill_tile(rank, lens, starts, qt)
        if tile is None:
            continue
        b, j = tile
        q0 = j * qt
        nq = min(qt, lens[b] - q0)
        yield b, j, [(cu[b] + q0 + r // grp, r % grp,
                      min(starts[b] + q0 + r // grp + 1, cap))
                     for r in range(nq * grp)]


def ragged_prefill_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,
    cu_seqlens: torch.Tensor,
    start_pos: torch.Tensor,
    *,
    page_size: int,
    q_block: int = 128,
) -> torch.Tensor:
    """K1. Returns ``[T, H, D]`` in q's dtype. CPU tensors: the plain
    version. CUDA tensors: the kernel (``aigw_ragged_prefill``): bf16 q
    over a bf16 pool on the tensor cores in tiles of whole queries
    (``prefill_plan``), other dtypes on the CUDA cores, one warp per
    packed row (``q_block`` is the reference's TPU query block and
    unused here)."""
    if q.device.type == "cpu":
        return ragged_prefill_attention_plain(
            q, k_pool, v_pool, page_table, cu_seqlens, start_pos,
            page_size=page_size, q_block=q_block)
    T, H, D = q.shape
    n_slots, Hkv, D2 = k_pool.shape
    B, P = page_table.shape
    if D2 != D or v_pool.shape != k_pool.shape:
        raise ValueError("ragged_prefill_attention: shape mismatch "
                         f"q {tuple(q.shape)} pool {tuple(k_pool.shape)}")
    _build.check_heads(H, Hkv, D)
    if cu_seqlens.shape != (B + 1,) or start_pos.shape != (B,):
        raise ValueError("cu_seqlens must be [B + 1] and start_pos [B]")
    for t, name in ((q, "q"), (k_pool, "k_pool"), (v_pool, "v_pool")):
        _build.check_cuda(t, name)
    for t, name in ((page_table, "page_table"), (cu_seqlens, "cu_seqlens"),
                    (start_pos, "start_pos")):
        _build.check_cuda(t, name, torch.int32)
    if v_pool.dtype != k_pool.dtype:
        raise ValueError("k_pool and v_pool dtypes differ")
    # the tensor-core kernel writes every row (zeros outside the
    # sequences); the CUDA-core one only the sequences' rows
    out = torch.empty_like(q) if _tc(q, k_pool) else torch.zeros_like(q)
    _build.launch(
        "aigw_ragged_prefill", q.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), page_table.data_ptr(), cu_seqlens.data_ptr(),
        start_pos.data_ptr(), out.data_ptr(), T, B, P, H, Hkv, D,
        page_size, _build.dtype_code(q, "q"),
        _build.dtype_code(k_pool, "k_pool"))
    _build.count_launch(ragged_prefill_attention)
    return out


ragged_prefill_attention.launches = 0


def _check_decode_args(name, q, k_pool, v_pool, page_table, rows):
    """Shapes, devices and dtypes K3-K5 take: q ``[B, ..., H, D]``, the
    native pools, an int32 page table and an int32 ``[B]`` row."""
    B, H, D = q.shape[0], q.shape[-2], q.shape[-1]
    Hkv, D2 = k_pool.shape[1], k_pool.shape[2]
    if D2 != D or v_pool.shape != k_pool.shape \
            or page_table.shape[0] != B or rows.shape != (B,):
        raise ValueError(f"{name}: shape mismatch q {tuple(q.shape)} pool "
                         f"{tuple(k_pool.shape)} page table "
                         f"{tuple(page_table.shape)} {tuple(rows.shape)}")
    _build.check_heads(H, Hkv, D)
    for t, what in ((q, "q"), (k_pool, "k_pool"), (v_pool, "v_pool")):
        _build.check_cuda(t, what)
    for t, what in ((page_table, "page_table"), (rows, "lengths/positions")):
        _build.check_cuda(t, what, torch.int32)
    if v_pool.dtype != k_pool.dtype:
        raise ValueError("k_pool and v_pool dtypes differ")


def mq_plan(B: int, S: int, H: int, Hkv: int, D: int, P: int, *,
            tensor_cores: bool) -> tuple[int, int, int, int]:
    """Launch plan of the K3/K5 body for q ``[B, S, H, D]`` over a ``[B,
    P]`` page table: ``(pps, n_split, group_rows, n_rg)``. Keys split
    as the fused decode's (``split_pages``); the S x G rows of a
    (sequence, KV head) run in ``n_rg`` groups of ``group_rows``: the
    tensor-core body (bf16 q over a bf16 pool, D a multiple of 16) holds
    16 rows, or 32 (two m16 tiles) where more rows come and D <= 128;
    the CUDA-core body 4 or 8 (``csrc/paged_attention.cu``)."""
    R = S * (H // Hkv)
    if tensor_cores:
        rows = 32 if R > 16 and D <= 128 else 16
    else:
        rows = 4 if R <= 4 else 8
    pps, n_split = split_pages(B, Hkv, P)
    return pps, n_split, rows, -(-R // rows)


def mq_blocks(xs, *, S: int, H: int, Hkv: int, P: int, page_size: int,
              off: int, pps: int, group_rows: int):
    """What each block of the K3/K5 launch attends, as the kernel
    decides it: yields ``(b, rg, sp, rows)`` for every block that does
    not exit at once, ``rows`` a list of ``(row, key_lo, key_hi)`` (row
    r of the (b, h) pair is query r // G, head h * G + r % G; it attends
    keys ``[key_lo, key_hi)``, possibly none). Row r's keys are ``[0,
    clamp(xs[b] + r // G + off, 0, P * page_size))``: K3 passes lengths
    with ``off`` 0 and S 1, K5 positions with ``off`` 1."""
    grp = H // Hkv
    R = S * grp
    span = pps * page_size
    cap = P * page_size
    n_rg = -(-R // group_rows)
    for b, x in enumerate(int(v) for v in xs):
        for rg in range(n_rg):
            r0 = rg * group_rows
            nr = min(group_rows, R - r0)

            def row_keys(r):
                return max(0, min(x + (r0 + r) // grp + off, cap))

            n_keys = row_keys(nr - 1)
            n_used = max(1, -(-n_keys // span))
            for sp in range(n_used):
                k_lo = sp * span
                n_mine = max(0, min(n_keys - k_lo, span))
                yield b, rg, sp, [
                    (r0 + r, k_lo, k_lo + max(0, min(row_keys(r) - k_lo,
                                                     n_mine)))
                    for r in range(nr)]


def _paged_mq(name, q4, k_pool, v_pool, page_table, xs, out, page_size,
              counter_key):
    """Launch the K3/K5 body (``aigw_paged_decode`` / ``_verify``) for
    q ``[B, S, H, D]``; allocates the split partials and takes the
    arrival counters (``_build.counters``)."""
    B, S, H, D = q4.shape
    Hkv = k_pool.shape[1]
    P = page_table.shape[1]
    pps, n_split, rows, n_rg = mq_plan(B, S, H, Hkv, D, P,
                                       tensor_cores=_tc(q4, k_pool))
    part = counters = None
    if n_split > 1:
        part = torch.empty((n_split * B * S * H * (D + 2),),
                           dtype=torch.float32, device=q4.device)
        counters = _build.counters(q4.device, counter_key, B * Hkv * n_rg)
    head = (q4.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_table.data_ptr(), xs.data_ptr(), out.data_ptr(),
            _build.ptr(part), _build.ptr(counters), B)
    dims = (P, H, Hkv, D) if name == "aigw_paged_decode" else (S, P, H, Hkv, D)
    _build.launch(name, *head, *dims, page_size, pps, n_split, rows,
                  _build.dtype_code(q4, "q"),
                  _build.dtype_code(k_pool, "k_pool"))


def paged_attention_decode_v2_plain(
    q: torch.Tensor,  # [B, H, D]
    k_pool: torch.Tensor,  # [n_slots, Hkv, D]
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # [B, P]
    lengths: torch.Tensor,  # [B]
    *,
    page_size: int,
) -> torch.Tensor:
    """Plain version of K3: the fused rung's page walk without the
    append (``paged_decode_walk``)."""
    return paged_decode_walk(q, k_pool, v_pool, page_table, lengths,
                             page_size=page_size)


def paged_attention_decode_v2(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    page_size: int,
) -> torch.Tensor:
    """K3. Returns ``[B, H, D]`` in q's dtype; rows with length 0 are
    zero. CPU tensors: the plain version; CUDA tensors: the K3/K5 body
    at S = 1 (``aigw_paged_decode``)."""
    if q.device.type == "cpu":
        return paged_attention_decode_v2_plain(
            q, k_pool, v_pool, page_table, lengths, page_size=page_size)
    _check_decode_args("paged_attention_decode_v2", q, k_pool, v_pool,
                       page_table, lengths)
    out = torch.empty_like(q)
    _paged_mq("aigw_paged_decode", q[:, None], k_pool, v_pool, page_table,
              lengths, out, page_size, "paged_attention_decode_v2")
    _build.count_launch(paged_attention_decode_v2)
    return out


paged_attention_decode_v2.launches = 0


def paged_attention_decode_plain(
    q: torch.Tensor,  # [B, H, D]
    k_pool: torch.Tensor,  # [n_slots, Hkv, D]
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # [B, P]
    lengths: torch.Tensor,  # [B]
    *,
    page_size: int,
) -> torch.Tensor:
    """Plain version of K4: K3's page walk (the two compute one
    function)."""
    return paged_decode_walk(q, k_pool, v_pool, page_table, lengths,
                             page_size=page_size)


def paged_attention_decode(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    page_size: int,
) -> torch.Tensor:
    """K4. Returns ``[B, H, D]`` in q's dtype; rows with length 0 are
    zero. CPU tensors: the plain version; CUDA tensors: K3's body at S =
    1 (``aigw_paged_decode``, one launch; the reference's v1 page axis
    is its split over keys, folded in the launch)."""
    if q.device.type == "cpu":
        return paged_attention_decode_plain(
            q, k_pool, v_pool, page_table, lengths, page_size=page_size)
    _check_decode_args("paged_attention_decode", q, k_pool, v_pool,
                       page_table, lengths)
    out = torch.empty_like(q)
    _paged_mq("aigw_paged_decode", q[:, None], k_pool, v_pool, page_table,
              lengths, out, page_size, "paged_attention_decode")
    _build.count_launch(paged_attention_decode)
    return out


paged_attention_decode.launches = 0


def paged_attention_verify_plain(
    q: torch.Tensor,  # [B, S, H, D]
    k_pool: torch.Tensor,  # [n_slots, Hkv, D]
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # [B, P]
    positions: torch.Tensor,  # [B] position of q[:, 0]; <= -S = off
    *,
    page_size: int,
) -> torch.Tensor:
    """Plain version of K5: query s of sequence b is a decode row over
    ``positions[b] + s + 1`` keys (none when that is not positive), at
    most the table's ``P * page_size`` (the reference kernel's grid ends
    there too)."""
    B, S, H, D = q.shape
    P = page_table.shape[1]
    s_off = torch.arange(S, device=q.device)
    lengths = torch.clamp(positions.long()[:, None] + s_off + 1, 0,
                          P * page_size)
    out = paged_decode_walk(
        q.reshape(B * S, H, D), k_pool, v_pool,
        page_table.repeat_interleave(S, dim=0), lengths.reshape(-1),
        page_size=page_size)
    return out.reshape(B, S, H, D)


def paged_attention_verify(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,
    positions: torch.Tensor,
    *,
    page_size: int,
) -> torch.Tensor:
    """K5. Returns ``[B, S, H, D]`` in q's dtype. CPU tensors: the plain
    version; CUDA tensors: the kernel (``aigw_paged_verify``)."""
    if q.device.type == "cpu":
        return paged_attention_verify_plain(
            q, k_pool, v_pool, page_table, positions, page_size=page_size)
    _check_decode_args("paged_attention_verify", q, k_pool, v_pool,
                       page_table, positions)
    out = torch.empty_like(q)
    _paged_mq("aigw_paged_verify", q, k_pool, v_pool, page_table,
              positions, out, page_size, "paged_attention_verify")
    _build.count_launch(paged_attention_verify)
    return out


paged_attention_verify.launches = 0
