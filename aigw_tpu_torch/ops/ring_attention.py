"""Sequence-parallel attention over the ``sp`` mesh axis (counterpart of
``aigw_tpu/ops/ring_attention.py``).

A prompt chunk of ``S`` rows is sharded over the ``n`` ranks of
``group("sp")``: rank ``r`` holds the queries of rows ``[r S/n,
(r + 1) S/n)``. Its attention over the whole chunk is computed block by
block in the ring's visiting order, ``src = (r - i) mod n`` for ``i = 0
.. n - 1``, under one float32 online-softmax carry ``(acc, m, l)``: the
reference's fill (``-1e30``), causal mask (``q_pos >= k_pos``) and final
``max(l, 1e-30)``, so the merge is the reference's, block for block.

**Why an all-gather and not a ring of point-to-point hops.** The
reference rotates the K/V blocks with ``lax.ppermute``: ``n - 1``
neighbour hops per layer. The port gathers every rank's block once per
layer (``gather_blocks``) and visits the gathered blocks in the ring's
order instead, for two reasons:

1. The pool is replicated over ``sp`` (the reference's ``kv_cache_spec``
   names no ``sp``), so every rank must write every K/V row of the chunk
   into its own copy anyway. The gather moves exactly the bytes of the
   ring's ``n - 1`` hops, and the same rows then serve the scatter.
2. gloo carries ``all_gather`` of CUDA tensors and not ``send`` /
   ``recv`` (``tools/torch_dist_probe.py``), and gloo is the only
   backend that holds two ranks on one card. On NCCL the gather is just
   as valid.

**The cached window needs no collective.** ``ring_attention_prefix``'s
window pass (the chunk's queries over the page window of a resumed
sequence, masked to ``t < prefix_len``) reads the rank's own pool, which
holds the whole window: the rank visits it in ``n`` blocks of ``T / n``
in the same ring order, after the chunk pass, as the reference's second
scan does over its window shards.

**Ulysses** (``strategy="ulysses"``) exchanges heads for rows with two
``all_to_all_single`` calls over ``group("sp")``: each rank attends every
row of ``H / n`` query heads (``Hkv % n == 0``), then gets its rows of
every head back. No engine path selects it, as in the reference.

The block products are plain ``torch`` einsums over float32 operands
(the reference leaves them to XLA, outside any Pallas kernel). The
local functions (``_ring_attention_local``, ``_ring_prefix_attention_
local``, ``_ulysses_attention_local``) take ``mesh=None`` with an
explicit ``(idx, n)`` and every rank's blocks stacked ``[n, ...]``, so a
test can drive each rank's computation in one process; with a mesh they
take the rank's own shards and issue the collective themselves.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist


def gather_blocks(x: torch.Tensor, mesh, axis: str = "sp") -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, stacked ``[n, *x.shape]`` in
    axis order (block ``j`` is rank ``j``'s)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, x, group=mesh.group(axis))
    return torch.stack(parts)


def _carry(B: int, S: int, Hkv: int, g: int, D: int, dev: torch.device):
    """The empty online-softmax carry: acc ``[B, S, Hkv, g, D]``, m and
    l ``[B, Hkv, g, S]``, all float32."""
    return (torch.zeros((B, S, Hkv, g, D), dtype=torch.float32, device=dev),
            torch.full((B, Hkv, g, S), -1e30, dtype=torch.float32,
                       device=dev),
            torch.zeros((B, Hkv, g, S), dtype=torch.float32, device=dev))


def _logits(qg: torch.Tensor, kb: torch.Tensor, scale: float
            ) -> torch.Tensor:
    """float32 ``[B, Hkv, g, S, T]`` logits of queries ``qg [B, S, Hkv,
    g, D]`` against keys ``kb [B, T, Hkv, D]``."""
    return torch.einsum("bshgd,bthd->bhgst", qg.float(), kb.float()) * scale


def _merge(acc, m, l, logits, vb):
    """One block of masked logits merged into the carry (the reference's
    ``merge``): the probabilities cast to the values' dtype before the
    PV product, which rounds once to that dtype."""
    m_new = torch.maximum(m, logits.amax(-1))
    alpha = torch.exp(m - m_new)
    probs = torch.exp(logits - m_new[..., None])
    l_new = l * alpha + probs.sum(-1)
    pv = torch.einsum("bhgst,bthd->bshgd", probs.to(vb.dtype).float(),
                      vb.float()).to(vb.dtype)
    acc = acc * alpha.permute(0, 3, 1, 2)[..., None] + pv
    return acc, m_new, l_new


def _finish(acc, l, dtype) -> torch.Tensor:
    B, S, Hkv, g, D = acc.shape
    denom = torch.clamp(l, min=1e-30).permute(0, 3, 1, 2)[..., None]
    return (acc / denom).to(dtype).reshape(B, S, Hkv * g * D)


def _ring_attention_local(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, idx: int, n: int,
                          causal: bool = True, mesh=None,
                          axis: str = "sp") -> torch.Tensor:
    """Rank ``idx``'s queries ``q [B, S, H, D]`` (rows ``[idx S, (idx +
    1) S)`` of the ``n S``-row sequence) over every rank's K/V block.
    With ``mesh``, ``k``/``v`` are this rank's ``[B, S, Hkv, D]`` blocks
    and are gathered here; without, they are every rank's, stacked
    ``[n, B, S, Hkv, D]``. Returns ``[B, S, H * D]`` in q's dtype."""
    if mesh is not None:
        k, v = gather_blocks(k, mesh, axis), gather_blocks(v, mesh, axis)
    B, S, H, D = q.shape
    Hkv = k.shape[3]
    g = H // Hkv
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, S, Hkv, g, D)
    ar = torch.arange(S, device=q.device)
    q_pos = idx * S + ar
    acc, m, l = _carry(B, S, Hkv, g, D, q.device)
    for i in range(n):
        src = (idx - i) % n
        logits = _logits(qg, k[src], scale)
        if causal:
            mask = q_pos[:, None] >= (src * S + ar)[None, :]
            logits.masked_fill_(~mask, -1e30)
        acc, m, l = _merge(acc, m, l, logits, v[src])
    return _finish(acc, l, q.dtype)


def _ring_prefix_attention_local(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        kc: torch.Tensor, vc: torch.Tensor, prefix_lens: torch.Tensor, *,
        idx: int, n: int, mesh=None, axis: str = "sp") -> torch.Tensor:
    """A chunk resuming at ``prefix_lens`` (the reference's two ring
    passes under one carry). The chunk pass first: rank ``idx``'s
    queries ``q [B, S, H, D]`` over every rank's chunk block under the
    chunk-relative causal mask (``k``/``v`` as in
    ``_ring_attention_local``); its diagonal block seeds a finite running
    max, so a fully masked window adds exactly nothing. Then the window
    pass: ``kc``/``vc [B, T, Hkv, D]``, the whole page window (every
    rank's pool holds all of it), visited in ``n`` blocks of ``T / n`` in
    the same order and masked to ``t < prefix_lens``; the chunk's own
    rows, already scattered into the window at ``t >= prefix_len``, are
    masked out there. Returns ``[B, S, H * D]`` in q's dtype."""
    if mesh is not None:
        k, v = gather_blocks(k, mesh, axis), gather_blocks(v, mesh, axis)
    B, S, H, D = q.shape
    Hkv = k.shape[3]
    g = H // Hkv
    T = kc.shape[1]
    if T % n:
        raise ValueError(f"the window ({T} rows) does not divide over "
                         f"{axis}={n}")
    Tn = T // n
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, S, Hkv, g, D)
    ar = torch.arange(S, device=q.device)
    q_pos = idx * S + ar
    acc, m, l = _carry(B, S, Hkv, g, D, q.device)
    for i in range(n):
        src = (idx - i) % n
        logits = _logits(qg, k[src], scale)
        logits.masked_fill_(~(q_pos[:, None] >= (src * S + ar)[None, :]),
                            -1e30)
        acc, m, l = _merge(acc, m, l, logits, v[src])
    ct = torch.arange(Tn, device=q.device)
    pl = prefix_lens.long().to(q.device)
    for i in range(n):
        src = (idx - i) % n
        kb = kc[:, src * Tn:(src + 1) * Tn]
        vb = vc[:, src * Tn:(src + 1) * Tn]
        logits = _logits(qg, kb, scale)
        mask = (src * Tn + ct)[None, :] < pl[:, None]  # [B, Tn]
        logits.masked_fill_(~mask[:, None, None, None, :], -1e30)
        acc, m, l = _merge(acc, m, l, logits, vb)
    return _finish(acc, l, q.dtype)


def _head_scatter(x: torch.Tensor, idx: int, n: int, mesh, axis: str
                  ) -> torch.Tensor:
    """Rows for heads: ``[B, S, h, D]`` on each rank → this rank's
    ``h / n`` heads over all ``n S`` rows ``[B, n S, h / n, D]``. Without
    a mesh ``x`` is every rank's, stacked ``[n, B, S, h, D]``."""
    if mesh is None:
        _, B, S, h, D = x.shape
        got = x.reshape(n, B, S, n, h // n, D)[:, :, :, idx]
    else:
        B, S, h, D = x.shape
        send = x.reshape(B, S, n, h // n, D).permute(
            2, 0, 1, 3, 4).contiguous()
        got = torch.empty_like(send)
        dist.all_to_all_single(got, send, group=mesh.group(axis))
    # got[j]: rank j's rows of this rank's heads
    return got.permute(1, 0, 2, 3, 4).reshape(B, n * S, h // n, D)


def _dense_causal(qh, kh, vh, causal: bool) -> torch.Tensor:
    """Full-sequence attention of ``qh [B, T, hq, D]`` over ``kh``/``vh
    [B, T, hkv, D]`` (one softmax), ``[B, T, hq, D]`` in q's dtype."""
    B, T, hq, D = qh.shape
    hkv = kh.shape[2]
    qg = qh.reshape(B, T, hkv, hq // hkv, D)
    logits = _logits(qg, kh, 1.0 / math.sqrt(D))
    if causal:
        pos = torch.arange(T, device=qh.device)
        logits.masked_fill_(~(pos[:, None] >= pos[None, :]), -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", probs.to(vh.dtype).float(),
                       vh.float()).to(vh.dtype)
    return out.reshape(B, T, hq, D).to(qh.dtype)


def _ulysses_attention_local(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, idx: int, n: int,
                             causal: bool = True, mesh=None,
                             axis: str = "sp") -> torch.Tensor:
    """Ulysses: an all-to-all gives each rank every row of ``H / n``
    query heads (and ``Hkv / n`` KV heads), it attends them, and a second
    all-to-all returns each rank its rows of every head. Needs
    ``Hkv % n == 0``. With ``mesh``, q/k/v are this rank's ``[B, S, h,
    D]`` shards; without, every rank's stacked ``[n, B, S, h, D]`` (each
    rank's heads are then attended here). Returns ``[B, S, H * D]``."""
    Hkv = k.shape[-2]
    if Hkv % n:
        raise ValueError(f"ulysses needs n_kv_heads ({Hkv}) divisible by "
                         f"{axis}={n}")
    if mesh is not None:
        B, S, H, D = q.shape
        out = _dense_causal(_head_scatter(q, idx, n, mesh, axis),
                            _head_scatter(k, idx, n, mesh, axis),
                            _head_scatter(v, idx, n, mesh, axis), causal)
        send = out.reshape(B, n, S, H // n, D).permute(
            1, 0, 2, 3, 4).contiguous()
        got = torch.empty_like(send)
        dist.all_to_all_single(got, send, group=mesh.group(axis))
    else:
        _, B, S, H, D = q.shape
        # every rank's heads over the whole sequence; this rank keeps
        # its rows of each
        got = torch.stack([
            _dense_causal(_head_scatter(q, j, n, None, axis),
                          _head_scatter(k, j, n, None, axis),
                          _head_scatter(v, j, n, None, axis),
                          causal)[:, idx * S:(idx + 1) * S]
            for j in range(n)])
    # got[j]: this rank's rows of rank j's heads
    return got.permute(1, 2, 0, 3, 4).reshape(B, S, H * D)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   mesh, axis: str = "sp", causal: bool = True,
                   strategy: str = "ring") -> torch.Tensor:
    """Sequence-parallel attention of this rank's shard: ``q [B, S/n, H,
    D]``, ``k``/``v [B, S/n, Hkv, D]`` (rows ``[r S/n, (r + 1) S/n)`` on
    rank ``r`` of ``axis``); returns ``[B, S/n, H * D]``, sharded like
    q."""
    if strategy not in ("ring", "ulysses"):
        raise ValueError(f"strategy must be 'ring' or 'ulysses' (got "
                         f"{strategy!r})")
    local = (_ring_attention_local if strategy == "ring"
             else _ulysses_attention_local)
    return local(q, k, v, idx=mesh.axis_index(axis), n=mesh.shape[axis],
                 causal=causal, mesh=mesh, axis=axis)


def ring_attention_prefix(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, kc: torch.Tensor,
                          vc: torch.Tensor, prefix_lens: torch.Tensor, *,
                          mesh, axis: str = "sp") -> torch.Tensor:
    """A chunk's sequence-parallel attention with a cached-prefix
    resume: this rank's chunk shard (``q``, ``k``, ``v`` as in
    ``ring_attention``) over the whole chunk and the page window
    ``kc``/``vc [B, T, Hkv, D]`` this rank's pool holds (``T % n ==
    0``: a whole number of pages, ``page_size % sp == 0``), masked to
    ``t < prefix_lens``. Ring strategy only, as in the reference.
    Returns ``[B, S/n, H * D]``."""
    return _ring_prefix_attention_local(
        q, k, v, kc, vc, prefix_lens, idx=mesh.axis_index(axis),
        n=mesh.shape[axis], mesh=mesh, axis=axis)
