"""Fused decode step (counterpart of
``aigw_tpu/ops/pallas/decode_fused.py``).

``fused_paged_decode`` runs, per layer and decode step, in one launch:
interleaved RoPE of q and of the new key from per-step ``[B, D]``
cos/sin tables, the in-place append of the new K/V row into its page,
and online-softmax paged attention over the slot's rows up to and
including the new one. It has two rungs: K2 for native (bf16/f32)
pools, and K7 for int8 and packed-int4 pools (``models/kvq.py``) with
their ``[n_slots, Hkv]`` float32 scales, which dequantizes pool rows as
``q * scale`` in float32 and quantizes the new rows by the kvq recipe.
Append semantics follow the reference kernel bit for bit:

- a page-aligned append (``position % page == 0``) starts a fresh page:
  the page's other rows, and their scales, are zeroed;
- inactive slots write zeros (scale 0) into the dump page (the pool's
  last page, which the engine never allocates) and attend nothing;
- every other pool row is left untouched.

The pools (and scales) are updated IN PLACE (the reference aliases them
through ``input_output_aliases``) and returned. The plain version is
the scatter (with those page semantics) followed by
``paged_decode_walk``; the kernels live in ``csrc/decode_fused.cu``.
On the card each sequence's keys are split over blocks by
``split_pages`` (shared with K4), the block whose split holds the
position appends (``appending_split``), and the splits fold in the same
launch.
On a tensor-parallel mesh each rank runs this fused decode on its own
head shard (``fused_paged_decode_shard``, the counterpart of the
reference's ``paged_decode_walk_spmd``).
"""

from __future__ import annotations

import math

import torch

from aigw_tpu_torch.models import kvq
from aigw_tpu_torch.ops import _build


def rope_tables(positions: torch.Tensor, head_dim: int,
                rope_theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Interleaved cos/sin tables ``[B, D]`` (f32): column d carries
    angle(pos, d // 2) — the reference's ``_rope_tables``."""
    freqs = 1.0 / (rope_theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32,
                     device=positions.device) / head_dim))
    full = torch.repeat_interleave(freqs, 2)  # [D]
    ang = positions.float()[:, None] * full[None, :]
    return torch.cos(ang), torch.sin(ang)


def rope_rotate(x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
    """Rotate the interleaved pairs of ``x [..., S, H, D]`` by angle
    tables ``[..., S, 1, D/2]`` in float32: out[2i] = x[2i] cos -
    x[2i+1] sin, out[2i+1] = x[2i+1] cos + x[2i] sin, each product
    rounded on its own (as the fused kernel computes them); the result
    is rounded to x's dtype."""
    x1, x2 = x[..., ::2].float(), x[..., 1::2].float()
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.stack([o1, o2], dim=-1).reshape(x.shape).to(x.dtype)


def paged_decode_walk(
    q: torch.Tensor,  # [B, H, D] roped query
    k_rows: torch.Tensor,  # [n_slots, Hkv, D]
    v_rows: torch.Tensor,
    page_table: torch.Tensor,  # [B, P]
    lengths: torch.Tensor,  # [B] rows to attend (incl. the new token)
    *,
    page_size: int,
    k_scale: torch.Tensor | None = None,  # [n_slots, Hkv] (quantized)
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Online-softmax paged attention, one page per loop step — the
    reference's ``paged_decode_walk``; quantized pools dequantize at the
    read (``q * scale`` in float32). Returns ``[B, H, D]`` in q's dtype;
    rows with length 0 come out zero."""
    B, H, D = q.shape
    Hkv = k_rows.shape[1]
    grp = H // Hkv
    P = page_table.shape[1]
    qf = q.float().reshape(B, Hkv, grp, D) / math.sqrt(D)
    offs = torch.arange(page_size, device=q.device)
    pt = page_table.long()
    lens = lengths.long()
    m = torch.full((B, Hkv, grp, 1), -1e30, device=q.device)
    l = torch.zeros((B, Hkv, grp, 1), device=q.device)
    acc = torch.zeros((B, Hkv, grp, D), device=q.device)
    max_len = int(lens.max()) if B else 0
    p_hi = min(max(0, (max_len - 1) // page_size + 1), P)
    for p in range(p_hi):
        slots = pt[:, p][:, None] * page_size + offs[None, :]  # [B, page]
        if k_scale is None:
            k = k_rows[slots].float()  # [B, page, Hkv, D]
            v = v_rows[slots].float()
        else:
            k = kvq.dequantize_rows(k_rows[slots], k_scale[slots])
            v = kvq.dequantize_rows(v_rows[slots], v_scale[slots])
        logits = torch.einsum("bhgd,bshd->bhgs", qf, k)
        kpos = p * page_size + offs
        mask = kpos[None, :] < lens[:, None]  # [B, page]
        logits = torch.where(mask[:, None, None, :], logits,
                             torch.full_like(logits, -1e30))
        m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        probs = torch.exp(logits - m_new)
        l = alpha * l + probs.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhgs,bshd->bhgd", probs, v)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    # a row that attends nothing is zero, as in the kernels (the masked
    # walk alone would average its sequence's values)
    out = torch.where((lens > 0)[:, None, None, None], out,
                      torch.zeros_like(out))
    return out.reshape(B, H, D).to(q.dtype)


#: the split decode kernels (K2/K7, K4) split each sequence's pages over
#: enough blocks to put about this many (sequence, KV head, split) blocks
#: on the card: four per SM of the H100's 132
SPLIT_TARGET_BLOCKS = 4 * 132


def split_pages(B: int, Hkv: int, P: int) -> tuple[int, int]:
    """(pages per split, number of splits) for a ``[B, P]`` page table:
    from the shapes alone, so the launch needs no host sync. Split s
    holds pages ``[s * pps, min(P, (s + 1) * pps))``."""
    want = max(1, min(P, -(-SPLIT_TARGET_BLOCKS // max(1, B * Hkv))))
    pps = -(-P // want)
    return pps, -(-P // pps)


def appending_split(positions: torch.Tensor, active: torch.Tensor, *,
                    P: int, page_size: int, pps: int) -> torch.Tensor:
    """The split whose block appends each slot's new row, as the kernel
    picks it: the last split holding any of the slot's keys ``[0,
    min(position + 1, P * page))`` (so the one holding the position),
    split 0 for an inactive slot (the dump page)."""
    n_keys = torch.clamp(positions.long() + 1, max=P * page_size)
    span = pps * page_size
    used = torch.clamp(-(-n_keys // span), min=1)
    return torch.where(active.bool(), used - 1, torch.zeros_like(used))


def _append_targets(page_table: torch.Tensor, positions: torch.Tensor,
                    active: torch.Tensor, n_slots: int, page_size: int):
    """(page, row) each slot's new row lands in: its own page for active
    slots, row 0 of the dump page for inactive ones."""
    P = page_table.shape[1]
    dump_page = n_slots // page_size - 1
    idx = torch.clamp(positions.long() // page_size, 0, P - 1)
    own = torch.gather(page_table.long(), 1, idx[:, None])[:, 0]
    page = torch.where(active, own, torch.full_like(own, dump_page))
    row = torch.where(active, positions.long() % page_size,
                      torch.zeros_like(own))
    return page, row


def fused_paged_decode_plain(
    q: torch.Tensor,  # [B, H, D] unroped query
    k_new: torch.Tensor,  # [B, Hkv, D] unroped new key
    v_new: torch.Tensor,  # [B, Hkv, D]
    k_rows: torch.Tensor,  # [n_slots, Hkv, D or D/2] pool (in place)
    v_rows: torch.Tensor,
    page_table: torch.Tensor,  # [B, P]
    positions: torch.Tensor,  # [B]
    active: torch.Tensor,  # [B] bool (or 0/1 integers)
    k_scale: torch.Tensor | None = None,  # [n_slots, Hkv] f32 (in place)
    v_scale: torch.Tensor | None = None,
    *,
    rope_theta: float,
    page_size: int,
    tables: tuple[torch.Tensor, torch.Tensor] | None = None,
):
    """Plain version of K2 (native pool) and K7 (with scales): RoPE,
    the append (quantized by the kvq recipe when the pool is; fresh-page
    zeroing, the dump page for inactive slots), then
    ``paged_decode_walk`` over rows ``<= position``. Returns ``(attn,
    k_rows, v_rows)``, plus ``(k_scale, v_scale)`` for a quantized
    pool."""
    B, H, D = q.shape
    n_slots, Hkv, _ = k_rows.shape
    quant = k_scale is not None
    active = active.bool()
    cos, sin = tables or rope_tables(positions, D, rope_theta)
    # columns 2i and 2i+1 of a table carry the same angle
    cos, sin = cos[:, None, ::2], sin[:, None, ::2]
    qr = rope_rotate(q, cos, sin)
    knr = rope_rotate(k_new, cos, sin)
    page, row = _append_targets(page_table, positions, active, n_slots,
                                page_size)
    fresh = page[row == 0]
    slot = page * page_size + row
    keep = active[:, None, None]
    new = [torch.where(keep, x, torch.zeros_like(x)) for x in (knr, v_new)]
    leaves = [(k_rows, v_rows)]
    if quant:
        dt = "int8" if k_rows.dtype == torch.int8 else "int4"
        qk, sk = kvq.quantize_rows(new[0], dt)
        qv, sv = kvq.quantize_rows(new[1], dt)
        zero = torch.zeros_like(sk)
        new = [qk, qv, torch.where(active[:, None], sk, zero),
               torch.where(active[:, None], sv, zero)]
        leaves.append((k_scale, v_scale))
    flat = [t for pair in leaves for t in pair]
    for t, x in zip(flat, new):
        pages = t.view(n_slots // page_size, page_size, *t.shape[1:])
        pages[fresh] = 0
        t[slot] = x.to(t.dtype)
    lengths = torch.where(active, positions.long() + 1,
                          torch.zeros_like(positions.long()))
    attn = paged_decode_walk(qr, k_rows, v_rows, page_table, lengths,
                             page_size=page_size, k_scale=k_scale,
                             v_scale=v_scale)
    if quant:
        return attn, k_rows, v_rows, k_scale, v_scale
    return attn, k_rows, v_rows


def fused_paged_decode(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    k_rows: torch.Tensor,
    v_rows: torch.Tensor,
    page_table: torch.Tensor,
    positions: torch.Tensor,
    active: torch.Tensor,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    *,
    rope_theta: float,
    page_size: int,
    tables: tuple[torch.Tensor, torch.Tensor] | None = None,
):
    """K2 (native pool) or K7 (int8 / packed-int4 pool with ``k_scale``
    / ``v_scale``). Returns ``(attn [B, H, D] in q's dtype, k_rows,
    v_rows)``, plus ``(k_scale, v_scale)`` for a quantized pool, all
    updated in place. ``tables`` are this step's ``rope_tables(positions,
    D, rope_theta)`` when the caller computed them once for all layers.
    CPU tensors: the plain version; CUDA tensors: the kernel
    (``aigw_fused_decode``). Launches count in ``.launches`` (K2),
    ``.launches_int8`` and ``.launches_int4`` (K7)."""
    if q.device.type == "cpu":
        return fused_paged_decode_plain(
            q, k_new, v_new, k_rows, v_rows, page_table, positions, active,
            k_scale, v_scale, rope_theta=rope_theta, page_size=page_size,
            tables=tables)
    quant = k_scale is not None
    B, H, D = q.shape
    n_slots, Hkv, RW = k_rows.shape
    P = page_table.shape[1]
    packed = k_rows.dtype == torch.uint8
    if (RW != (D // 2 if packed else D) or k_new.shape != (B, Hkv, D)
            or v_new.shape != k_new.shape or v_rows.shape != k_rows.shape
            or page_table.shape[0] != B or positions.shape != (B,)
            or active.shape != (B,) or n_slots % page_size):
        raise ValueError("fused_paged_decode: shape mismatch")
    _build.check_heads(H, Hkv, D)
    for t, name in ((q, "q"), (k_new, "k_new"), (v_new, "v_new"),
                    (k_rows, "k_rows"), (v_rows, "v_rows")):
        _build.check_cuda(t, name)
    if k_new.dtype != q.dtype or v_new.dtype != q.dtype:
        raise ValueError("q, k_new and v_new must share a dtype")
    if v_rows.dtype != k_rows.dtype:
        raise ValueError("k_rows and v_rows dtypes differ")
    if quant != (k_rows.dtype in (torch.int8, torch.uint8)) \
            or (v_scale is None) == quant:
        raise ValueError("an int8/int4 pool takes k_scale and v_scale; a "
                         "native pool takes neither")
    scale_ptrs = (None, None)
    if quant:
        for t, name in ((k_scale, "k_scale"), (v_scale, "v_scale")):
            _build.check_cuda(t, name, torch.float32)
            if t.shape != (n_slots, Hkv):
                raise ValueError(f"{name} must be [n_slots, Hkv]")
        scale_ptrs = (k_scale.data_ptr(), v_scale.data_ptr())
    _build.check_cuda(page_table, "page_table", torch.int32)
    pos32 = positions.to(torch.int32).contiguous()
    act32 = active.to(torch.int32).contiguous()
    cos, sin = tables or rope_tables(positions, D, rope_theta)
    for t, name in ((cos, "cos"), (sin, "sin")):
        _build.check_cuda(t, name, torch.float32)
        if t.shape != (B, D):
            raise ValueError(f"rope table {name} must be [B, D]")
    out = torch.empty_like(q)
    pps, n_split = split_pages(B, Hkv, P)
    part = counters = None
    if n_split > 1:
        part = torch.empty((n_split * B * H * (D + 2),), dtype=torch.float32,
                           device=q.device)
        counters = _build.counters(q.device, "fused_paged_decode", B * Hkv)
    _build.launch(
        "aigw_fused_decode", q.data_ptr(), k_new.data_ptr(),
        v_new.data_ptr(), cos.data_ptr(), sin.data_ptr(),
        k_rows.data_ptr(), v_rows.data_ptr(), *scale_ptrs,
        page_table.data_ptr(), pos32.data_ptr(), act32.data_ptr(),
        out.data_ptr(), _build.ptr(part), _build.ptr(counters), B, P, H,
        Hkv, D, page_size, n_slots, pps, n_split,
        _build.dtype_code(q, "q"),
        _build.dtype_code(k_rows, "k_rows", tuple(_build.DTYPE_CODE)))
    if not quant:
        _build.count_launch(fused_paged_decode)
        return out, k_rows, v_rows
    if packed:
        _build.count_launch(fused_paged_decode, "launches_int4")
    else:
        _build.count_launch(fused_paged_decode, "launches_int8")
    return out, k_rows, v_rows, k_scale, v_scale


fused_paged_decode.launches = 0
fused_paged_decode.launches_int8 = 0
fused_paged_decode.launches_int4 = 0


def fused_paged_decode_shard(*args, step=fused_paged_decode, mesh,
                             n_heads: int, n_kv_heads: int, **kw):
    """The fused decode over this rank's head shard: the port's
    counterpart of the reference's ``paged_decode_walk_spmd``
    (``aigw_tpu/ops/pallas/decode_fused.py``), which walks each device's
    local head shard of the pool inside ``shard_map``. Here every rank
    is its own process and already holds only its shard: q ``[B,
    H/tp, D]``, the new K/V ``[B, Hkv/tp, D]`` and the pool's ``[n_slots,
    Hkv/tp, ...]`` rows (and scales), so the step is ``step`` (K2 on a
    native pool, K7 on int8/int4; ``fused_paged_decode_plain`` for the
    plain version) over them, with no collective: the layer's all-reduce
    after ``wo`` is the model's. Raises unless the shapes are whole head
    shards of ``n_heads`` / ``n_kv_heads`` over the mesh's ``tp``."""
    tp = mesh.shape["tp"]
    q, k_rows = args[0], args[3]
    if n_heads % tp or n_kv_heads % tp or q.shape[1] * tp != n_heads \
            or k_rows.shape[1] * tp != n_kv_heads:
        raise ValueError(
            f"fused_paged_decode_shard: q {tuple(q.shape)} and pool rows "
            f"{tuple(k_rows.shape)} are not one of tp={tp} shards of "
            f"{n_heads}q/{n_kv_heads}kv heads")
    return step(*args, **kw)
