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
  its keys split over blocks (``csrc/paged_attention.cu``). No engine
  path selects it, as in the reference.
- ``paged_attention_verify`` (K5): S consecutive queries per sequence
  (the pending token and its drafts); query s attends pool positions
  ``<= positions[b] + s``, and a slot with ``positions[b] <= -S``
  attends nothing (zeros).

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
    version. CUDA tensors: the kernel (``aigw_ragged_prefill``), one warp
    per packed row (``q_block`` is the reference's TPU query block and
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
    out = torch.zeros_like(q)
    _build.launch(
        "aigw_ragged_prefill", q.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), page_table.data_ptr(), cu_seqlens.data_ptr(),
        start_pos.data_ptr(), out.data_ptr(), T, B, P, H, Hkv, D,
        page_size, _build.dtype_code(q, "q"),
        _build.dtype_code(k_pool, "k_pool"))
    ragged_prefill_attention.launches += 1
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
    zero. CPU tensors: the plain version; CUDA tensors: the kernel."""
    if q.device.type == "cpu":
        return paged_attention_decode_v2_plain(
            q, k_pool, v_pool, page_table, lengths, page_size=page_size)
    _check_decode_args("paged_attention_decode_v2", q, k_pool, v_pool,
                       page_table, lengths)
    B, H, D = q.shape
    Hkv = k_pool.shape[1]
    P = page_table.shape[1]
    out = torch.empty_like(q)
    _build.launch(
        "aigw_paged_decode", q.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), B, P, H, Hkv, D, page_size,
        _build.dtype_code(q, "q"), _build.dtype_code(k_pool, "k_pool"))
    paged_attention_decode_v2.launches += 1
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
    zero. CPU tensors: the plain version; CUDA tensors: the split walk
    and its fold (``aigw_paged_decode_split``, two launches counted as
    one)."""
    if q.device.type == "cpu":
        return paged_attention_decode_plain(
            q, k_pool, v_pool, page_table, lengths, page_size=page_size)
    _check_decode_args("paged_attention_decode", q, k_pool, v_pool,
                       page_table, lengths)
    B, H, D = q.shape
    Hkv = k_pool.shape[1]
    P = page_table.shape[1]
    pps, n_split = split_pages(B, Hkv, P)
    out = torch.empty_like(q)
    part = torch.empty((n_split * B * H * (D + 2),), dtype=torch.float32,
                       device=q.device)
    _build.launch(
        "aigw_paged_decode_split", q.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), part.data_ptr(), B, P, H, Hkv, D, page_size, pps,
        n_split, _build.dtype_code(q, "q"),
        _build.dtype_code(k_pool, "k_pool"))
    paged_attention_decode.launches += 1
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
    B, S, H, D = q.shape
    Hkv = k_pool.shape[1]
    P = page_table.shape[1]
    out = torch.empty_like(q)
    _build.launch(
        "aigw_paged_verify", q.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), page_table.data_ptr(), positions.data_ptr(),
        out.data_ptr(), B, S, P, H, Hkv, D, page_size,
        _build.dtype_code(q, "q"), _build.dtype_code(k_pool, "k_pool"))
    paged_attention_verify.launches += 1
    return out


paged_attention_verify.launches = 0
