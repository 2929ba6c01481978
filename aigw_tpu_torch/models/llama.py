"""Llama-family transformer in PyTorch (counterpart of
``aigw_tpu/models/llama.py``).

Plain functions over a flat parameter dict, with the reference's layout
kept at every public function so the parity tests compare like with
like: weights ``[in, out]`` under the reference's names (``l{i}.wq`` …),
the paged pool ``[L, 2, n_slots, Hkv, D]``, and the same entry-point
signatures. RMSNorm accumulates in float32, RoPE rotates interleaved
pairs ``(x[::2], x[1::2])`` (not the HF half split), logits come out in
float32. The dense projections and the lm_head are ``torch.matmul``, as
the reference leaves them to XLA; the attention runs through the
hand-written kernels (``aigw_tpu_torch/ops``) on CUDA tensors and their
plain versions on CPU tensors.

Weights may be quantized (``models/quant.py``): a W8A16 matrix at a
shape ``qmatmul.supported`` takes goes through K6
(``ops.qmatmul.w8a16_matmul``); every other quantized matrix (int4,
prefill-sized M, unaligned widths) is dequantized to bf16 by ``_w`` and
multiplied, as in the reference. torch's matmul does not promote mixed
dtypes the way JAX's does, so ``_mm`` casts both operands to the
promoted dtype first (float32 activations against bf16-dequantized
weights in the parity rig).

The pool (native tensor or the quantized ``{"q", "scale"}`` dict of
``models/kvq.py``) is updated IN PLACE and returned (the reference
donates it).

The port has ``prefill_ragged`` (K1, or the windowed program that
quantized pools take), the dense bucketed ``prefill`` and
``prefill_suffix`` (the reference's default prefill programs: dense
masked attention over an unpaged ``[B, S]`` block, or over the gathered
page window), ``hidden_states`` (the embeddings pass), ``decode_step``
(fused, chained and gather rungs) and ``verify_step`` (K5 on the
chained rung, the gather path otherwise). The dense attention
(``_attention``) is the counterpart of an XLA op, not of a Pallas
kernel, and stays plain PyTorch. Each entry point takes ``lora=``
(stacked adapters, ``models/lora.py``) and ``adapter_idx=`` (the adapter
row of each sequence): the deltas join the projections before the bias
and RoPE, the out-projection and the dense MLP, as in the reference.

**On a mesh** (``mesh=``, ``parallel/mesh.py``) each entry point is the
rank-local model over this rank's shards (``parallel/sharding.py``):
H/tp query and Hkv/tp KV heads, F/tp MLP columns and V/tp vocabulary
rows. The embedding is a masked lookup of the rows this rank holds,
summed over ``tp``; ``wo`` and ``w_down`` end in an all-reduce over
``tp`` (a family's ``mlp`` hook reduces its own output); the logits end
in a gather over ``tp``, so every rank holds the same full logits. An
adapter's column-parallel targets use the rank's B columns, ``wo`` and
``w_down`` its A rows, whose partial delta joins the partial product
before the all-reduce. The attention kernels run as they are on the
local heads. Without a mesh nothing changes and no collective is
issued.

**The sequence-parallel prefills** (``prefill_sp``, ``prefill_sp_suffix``,
on a mesh with an ``sp`` axis of ``n`` ranks): rank ``r`` owns rows
``[r S/n, (r + 1) S/n)`` of the padded ``[B, S]`` chunk, at their global
positions. The embedding, the projections, ``wo`` and the MLP run on its
rows only (the compute ``sp`` divides; the ``tp`` reductions stay as
they are). In each layer the rank gathers every rank's K/V block over
``sp``, scatters all ``S`` rows into its own copy of the pool (the pool
is replicated over ``sp``, as in the reference), and its queries attend
the gathered blocks in the ring's order (``ops/ring_attention.py``);
``prefill_sp_suffix`` then visits its pool's page window. The final row
of each sequence lives on one rank: every rank offers its candidate row,
the rows are gathered over ``sp``, and each rank keeps the owner's, so
every rank computes the same logits.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

from aigw_tpu_torch.models import kvq
from aigw_tpu_torch.models.lora import lora_delta
from aigw_tpu_torch.ops import decode_fused, paged_attention, qmatmul
from aigw_tpu_torch.ops.ring_attention import (
    _ring_attention_local,
    _ring_prefix_attention_local,
    _ulysses_attention_local,
    gather_blocks,
)


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14336
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 8192
    tie_embeddings: bool = False
    # QKV projection bias (the Qwen2 family uses it; Llama doesn't)
    attn_bias: bool = False

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


# Published Llama-3 / Qwen2 architecture shapes (public model cards),
# the reference's presets.
LLAMA3_8B = LlamaConfig()
LLAMA3_70B = LlamaConfig(
    dim=8192, n_layers=80, n_heads=64, n_kv_heads=8, ffn_dim=28672
)
QWEN2_7B = LlamaConfig(
    vocab_size=152064, dim=3584, n_layers=28, n_heads=28, n_kv_heads=4,
    ffn_dim=18944, rope_theta=1e6, max_seq_len=32768, attn_bias=True,
)
QWEN2_05B = LlamaConfig(
    vocab_size=151936, dim=896, n_layers=24, n_heads=14, n_kv_heads=2,
    ffn_dim=4864, rope_theta=1e6, max_seq_len=32768, attn_bias=True,
    tie_embeddings=True,
)
#: tiny config for tests and CPU serving
TINY = LlamaConfig(
    vocab_size=512, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
    ffn_dim=128, max_seq_len=512, rope_theta=10000.0,
)
#: the reference registry's ``tiny-qwen`` geometry: TINY + QKV bias +
#: tied embeddings
TINY_QWEN = LlamaConfig(
    vocab_size=512, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
    ffn_dim=128, max_seq_len=512, rope_theta=10000.0, attn_bias=True,
    tie_embeddings=True,
)


def iter_params(seed: int, cfg: LlamaConfig, dtype=torch.bfloat16,
                device: str | torch.device = "cuda"):
    """Random weights from a seeded ``torch.Generator`` on ``device``,
    yielded as ``(name, tensor)`` one at a time in ``init_params``'
    order, so a caller can quantize each as it is drawn. The scales are
    the reference's (``init_params``: dense weights N(0, 1/in),
    embeddings N(0, 0.02²), norms one, biases zero). The draws differ
    from ``jax.random``'s; parity tests carry the reference's own
    weights across with ``models.convert``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def dense(shape, scale=None):
        scale = scale or 1.0 / math.sqrt(shape[0])
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device)
        return (w * scale).to(dtype)

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=device)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=device)

    yield "embed", dense((cfg.vocab_size, cfg.dim), scale=0.02)
    yield "norm_f", ones(cfg.dim)
    if not cfg.tie_embeddings:
        yield "lm_head", dense((cfg.dim, cfg.vocab_size))
    hd = cfg.head_dim
    for i in range(cfg.n_layers):
        yield f"l{i}.attn_norm", ones(cfg.dim)
        yield f"l{i}.wq", dense((cfg.dim, cfg.n_heads * hd))
        yield f"l{i}.wk", dense((cfg.dim, cfg.n_kv_heads * hd))
        yield f"l{i}.wv", dense((cfg.dim, cfg.n_kv_heads * hd))
        if cfg.attn_bias:
            yield f"l{i}.bq", zeros(cfg.n_heads * hd)
            yield f"l{i}.bk", zeros(cfg.n_kv_heads * hd)
            yield f"l{i}.bv", zeros(cfg.n_kv_heads * hd)
        yield f"l{i}.wo", dense((cfg.n_heads * hd, cfg.dim))
        yield f"l{i}.mlp_norm", ones(cfg.dim)
        yield f"l{i}.w_gate", dense((cfg.dim, cfg.ffn_dim))
        yield f"l{i}.w_up", dense((cfg.dim, cfg.ffn_dim))
        yield f"l{i}.w_down", dense((cfg.ffn_dim, cfg.dim))


def init_params(seed: int, cfg: LlamaConfig, dtype=torch.bfloat16,
                device: str | torch.device = "cuda"
                ) -> dict[str, torch.Tensor]:
    """Every weight of ``iter_params`` at once."""
    return dict(iter_params(seed, cfg, dtype, device))


def _w(p: dict[str, torch.Tensor], key: str) -> torch.Tensor:
    """A weight stored bf16/f32, int8 + per-channel scale (W8A16) or
    packed int4 + group scales (W4A16), as the matmul operand, over
    ``[..., in, out]`` (an ``[E, in, out]`` expert stack too): quantized
    weights come back as ``q * scale`` in bf16 with the scale rounded to
    bf16 first, exactly as the reference's ``_w``. The integer values
    multiply the bf16 scale in one pass (they convert to bf16 exactly;
    each product is rounded once, as after an explicit conversion), so
    the only temporary is the bf16 result."""
    q = p.get(key + ".q")
    if q is None:
        return p[key]
    scale = p[key + ".scale"].to(torch.bfloat16)
    if q.dtype == torch.uint8:
        # int4 packed along the input axis; scales [..., in / G, out]
        wi = kvq.unpack_int4(q, dim=-2)
        *lead, n_in, n_out = wi.shape
        groups = scale.shape[-2]
        wf = wi.reshape(*lead, groups, n_in // groups, n_out) \
            * scale[..., :, None, :]
        return wf.reshape(*lead, n_in, n_out)
    return q * scale


def _embed_rows(p: dict[str, torch.Tensor], tokens: torch.Tensor,
                mesh=None) -> torch.Tensor:
    """Embedding rows of ``tokens``. On a mesh this rank holds rows
    ``[r V/tp, (r + 1) V/tp)``: it looks up the tokens in its range and
    zeros the others, and the sum over ``tp`` is every row exactly."""
    q = p.get("embed.q")
    ok = None
    if mesh is not None:
        n = (p["embed"] if q is None else q).shape[0]
        tokens = tokens - mesh.axis_index("tp") * n
        ok = (tokens >= 0) & (tokens < n)
        tokens = torch.where(ok, tokens, torch.zeros_like(tokens))
    if q is None:
        rows = p["embed"][tokens]
    else:
        rows = q[tokens].to(torch.bfloat16)
        scales = p["embed.scale"][:, 0][tokens]
        rows = rows * scales[..., None].to(torch.bfloat16)
    if ok is None:
        return rows
    rows = torch.where(ok[..., None], rows, torch.zeros_like(rows))
    return mesh.all_reduce(rows, "tp")


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with JAX's dtype promotion (torch refuses mixed
    dtypes)."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        return x.to(dt) @ w.to(dt)
    return x @ w


def _matmul(p: dict[str, torch.Tensor], key: str, x: torch.Tensor,
            plain: bool = False) -> torch.Tensor:
    """``x @ weight``: K6 for int8 weights at the shapes it takes
    (decode-sized M, aligned K/N; its plain version when ``plain``),
    else ``x @ _w(p, key)``. int4 carries group-wise scales the
    per-column kernel would misapply, so it always takes ``_w``."""
    q = p.get(key + ".q")
    if q is None or q.dtype != torch.int8:
        return _mm(x, _w(p, key))
    lead, k = x.shape[:-1], x.shape[-1]
    m = math.prod(lead)
    n = q.shape[-1]
    if not qmatmul.supported(m, k, n):
        return _mm(x, _w(p, key))
    mm = qmatmul.w8a16_matmul_plain if plain else qmatmul.w8a16_matmul
    y = mm(x.reshape(m, k).contiguous(), q, p[key + ".scale"])
    return y.reshape(*lead, n)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype) * w


def rope_freqs(head_dim: int, theta: float,
               device: torch.device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embeddings. x: [..., S, H, D], positions broadcastable to
    [..., S]."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions.float()[..., :, None, None] * freqs
    return decode_fused.rope_rotate(x, torch.cos(angles), torch.sin(angles))


def _adapters(lora, adapter_idx, row_seq=None, mesh=None):
    """The (stacks, row per sequence, sequence per packed row) triple
    the projections hand ``lora_delta``, or None without adapters. On a
    mesh the stacks are this rank's views (``_lora_shard``)."""
    if lora is None or adapter_idx is None:
        return None
    if mesh is not None:
        lora = {k: _lora_shard(k, t, mesh) for k, t in lora.items()}
    return lora, adapter_idx, row_seq


def _lora_shard(key: str, t: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's view of one adapter stack (A ``[n, r, in]``, B ``[n,
    out, r]``): the B rows of a column-parallel target's output columns,
    the A columns of ``wo``'s and ``w_down``'s input rows; the other
    stack of the pair is whole."""
    row_parallel = key.split(".")[-2] in ("wo", "w_down")
    if key.endswith(".lora_a") != row_parallel:
        return t
    dim = 2 if row_parallel else 1
    n = t.shape[dim] // mesh.shape["tp"]
    return t.narrow(dim, mesh.axis_index("tp") * n, n)


def _with_delta(y: torch.Tensor, ad, key: str,
                x: torch.Tensor) -> torch.Tensor:
    """``y = x @ W[key]`` plus its adapter delta, when ``ad`` has one."""
    d = None if ad is None else lora_delta(ad[0], key, x, ad[1], ad[2])
    return y if d is None else y + d


def _project_qkv(p, i, x, positions, cfg, apply_rope=True, plain=False,
                 ad=None):
    hd = cfg.head_dim
    B, S, _ = x.shape
    q = _with_delta(_matmul(p, f"l{i}.wq", x, plain), ad, f"l{i}.wq", x)
    k = _with_delta(_matmul(p, f"l{i}.wk", x, plain), ad, f"l{i}.wk", x)
    v = _with_delta(_matmul(p, f"l{i}.wv", x, plain), ad, f"l{i}.wv", x)
    if cfg.attn_bias:
        q, k, v = q + p[f"l{i}.bq"], k + p[f"l{i}.bk"], v + p[f"l{i}.bv"]
    # this rank's heads (all of them without a mesh)
    q = q.reshape(B, S, -1, hd)
    k = k.reshape(B, S, -1, hd)
    v = v.reshape(B, S, -1, hd)
    if apply_rope:  # the fused decode kernel ropes Q/K itself
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attention(q: torch.Tensor,  # [B, S, H, D]
               k: torch.Tensor,  # [B, T, Hkv, D]
               v: torch.Tensor,  # [B, T, Hkv, D]
               mask: torch.Tensor,  # [B, S, T] bool, True = attend
               ) -> torch.Tensor:
    """Dense masked attention over gathered rows (the reference's
    ``_attention``): float32 logits and softmax; the probabilities cast
    to the rows' dtype before the PV product, which sums in float32 and
    rounds once to that dtype. Returns ``[B, S, H * D]``. The logits are
    scaled and masked in place and dropped before the PV product: at a
    dense ``[B, S, S]`` block they are the pass's largest tensor."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, S, Hkv, H // Hkv, D)
    logits = torch.einsum("bshgd,bthd->bhgst", qg.float(), k.float())
    logits.div_(math.sqrt(D))
    logits.masked_fill_(~mask[:, None, None], -1e30)
    probs = torch.softmax(logits, dim=-1)
    del logits
    probs = probs.to(v.dtype)
    out = torch.einsum("bhgst,bthd->bshgd", probs.float(), v.float())
    return out.to(v.dtype).reshape(B, S, H * D)


def _reduce(x: torch.Tensor, mesh) -> torch.Tensor:
    """A row-parallel product's partial sums, summed over ``tp``."""
    return x if mesh is None else mesh.all_reduce(x, "tp")


def _wo(p, i, attn, plain=False, ad=None, mesh=None):
    """The attention out-projection with its adapter delta."""
    return _reduce(_with_delta(_matmul(p, f"l{i}.wo", attn, plain), ad,
                               f"l{i}.wo", attn), mesh)


def _mlp(p, i, x, plain=False, ad=None, mesh=None):
    gate = F.silu(_with_delta(_matmul(p, f"l{i}.w_gate", x, plain), ad,
                              f"l{i}.w_gate", x))
    up = _with_delta(_matmul(p, f"l{i}.w_up", x, plain), ad,
                     f"l{i}.w_up", x)
    h = gate * up
    return _reduce(_with_delta(_matmul(p, f"l{i}.w_down", h, plain), ad,
                               f"l{i}.w_down", h), mesh)


def _dense_mlp(mlp, ad, mesh=None):
    """The layer MLP an entry point runs: a family's ``mlp`` hook as
    given (no adapter deltas; on a mesh it reduces its own output), else
    the dense MLP with ``ad``'s."""
    if mlp is not None:
        return mlp
    return lambda p, i, h, plain: _mlp(p, i, h, plain, ad, mesh)


def _logits(p, cfg: LlamaConfig, x: torch.Tensor,
            plain: bool = False, mesh=None) -> torch.Tensor:
    if cfg.tie_embeddings:
        y = _mm(x, _w(p, "embed").T)
    else:
        y = _matmul(p, "lm_head", x, plain)
    if mesh is not None:
        y = mesh.all_gather_last(y, "tp")
    return y.float()


def _write_slots(kv_cache: Any, page_table: torch.Tensor, pos: torch.Tensor,
                 valid: torch.Tensor, page_size: int) -> torch.Tensor:
    """Flat pool rows the tokens at positions ``pos`` ([B, S]) write:
    ``page_table[b, pos // page] * page + pos % page`` where ``valid``,
    else a row of the dump page. Page indices past the table (padding
    near ``max_seq_len``, an inactive slot at it) are clamped as the
    reference's gather clamps them; their rows go to the dump page
    anyway."""
    page_idx = torch.clamp(pos // page_size, 0, page_table.shape[1] - 1)
    slot = torch.gather(page_table.long(), 1, page_idx) * page_size \
        + pos % page_size
    return kvq.padding_slots(kv_cache, page_size, valid, slot)


def _window_slots(page_table: torch.Tensor, page_size: int) -> torch.Tensor:
    """``[B, P * page]`` flat pool rows of each sequence's page window
    (the gather of the reference's XLA attention paths), in position
    order."""
    B, P = page_table.shape
    return (page_table.long()[:, :, None] * page_size
            + torch.arange(page_size, device=page_table.device)
            ).reshape(B, P * page_size)


def _causal_block(seq_lens: torch.Tensor, S: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(positions ``[B, S]``, valid ``[B, S]``, mask ``[B, S, S]``) of an
    unpaged right-padded block: causal, keys past each row's length
    masked out (the reference's ``prefill``/``hidden_states`` mask)."""
    B = seq_lens.shape[0]
    pos = torch.arange(S, device=seq_lens.device)[None, :].expand(B, S)
    valid = pos < seq_lens.long()[:, None]
    mask = (pos[:, :, None] >= pos[:, None, :]) & valid[:, None, :]
    return pos, valid, mask


#: packed rows the windowed prefill attends per pass: bounds its
#: [rows, page, Hkv, D] float32 gathers (~270 MB at Llama-3-8B widths)
WINDOW_ROWS = 256


def _window_pages(positions: torch.Tensor, valid: torch.Tensor,
                  page_size: int, max_pages: int) -> list[int]:
    """Pages each ``WINDOW_ROWS`` pass of the windowed prefill walks:
    up to its highest valid position (one host read per call)."""
    top = torch.where(valid, positions.long(), 0)
    pad = -len(top) % WINDOW_ROWS
    top = torch.nn.functional.pad(top, (0, pad)).reshape(-1, WINDOW_ROWS)
    return [min(int(x) // page_size + 1, max_pages)
            for x in top.amax(1).tolist()]


def _ragged_window_attention(
    q: torch.Tensor,  # [T, H, D] packed queries
    k_pool: torch.Tensor,  # [n_slots, Hkv, D] (or int8 / packed int4)
    v_pool: torch.Tensor,
    pt_rows: torch.Tensor,  # [T, P] page ids of each token's sequence
    positions: torch.Tensor,  # [T] absolute position per token
    valid: torch.Tensor,  # [T] bool — False for padding rows
    page_size: int,
    k_scale: torch.Tensor | None,  # [n_slots, Hkv] (quantized), or None
    v_scale: torch.Tensor | None,
    chunk_pages: list[int],  # _window_pages, computed once for all layers
) -> torch.Tensor:
    """The reference's windowed ragged prefill attention: online softmax
    over each row's page window, one page per loop step, quantized pages
    dequantized at the read. Rows go ``WINDOW_ROWS`` at a time, each
    pass walking pages up to its own highest valid position (the pages
    it skips are fully masked for its valid rows, so skipping them
    changes nothing). Plain PyTorch on every device: the reference has
    no kernel for it either. Returns
    ``[T, H * D]`` in q's dtype."""
    T, H, D = q.shape
    Hkv = k_pool.shape[1]
    grp = H // Hkv
    offs = torch.arange(page_size, device=q.device)
    pos = positions.long()
    out = torch.empty((T, H * D), dtype=q.dtype, device=q.device)
    for lo, n_pages in zip(range(0, T, WINDOW_ROWS), chunk_pages):
        hi = min(T, lo + WINDOW_ROWS)
        n = hi - lo
        qf = q[lo:hi].float().reshape(n, Hkv, grp, D) / math.sqrt(D)
        m = torch.full((n, Hkv, grp, 1), -1e30, device=q.device)
        l = torch.zeros((n, Hkv, grp, 1), device=q.device)
        acc = torch.zeros((n, Hkv, grp, D), device=q.device)
        for pg in range(n_pages):
            slots = pt_rows[lo:hi, pg].long()[:, None] * page_size \
                + offs[None, :]
            if k_scale is None:
                k = k_pool[slots].float()  # [n, page, Hkv, D]
                v = v_pool[slots].float()
            else:
                k = kvq.dequantize_rows(k_pool[slots], k_scale[slots])
                v = kvq.dequantize_rows(v_pool[slots], v_scale[slots])
            logits = torch.einsum("thgd,tshd->thgs", qf, k)
            kp = pg * page_size + offs
            mask = (kp[None, :] <= pos[lo:hi, None]) & valid[lo:hi, None]
            logits = torch.where(mask[:, None, None, :], logits,
                                 torch.full_like(logits, -1e30))
            m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            probs = torch.exp(logits - m_new)
            l = alpha * l + probs.sum(-1, keepdim=True)
            acc = acc * alpha + torch.einsum("thgs,tshd->thgd", probs, v)
            m = m_new
        res = acc / torch.clamp(l, min=1e-30)
        out[lo:hi] = res.reshape(n, H * D).to(q.dtype)
    return out


def prefill_ragged(
    p: dict[str, torch.Tensor],
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [T] int — PACKED new tokens, all sequences
    row_seq: torch.Tensor,  # [T] int — sequence row per token; >= B = padding
    positions: torch.Tensor,  # [T] int — absolute position per token
    last_rows: torch.Tensor,  # [B] int — packed index of each row's last token
    kv_cache: Any,  # [L, 2, n_slots, Hkv, D] or quantized dict, in place
    page_table: torch.Tensor,  # [B, max_pages] int32
    page_size: int,
    *,
    plain: bool = False,
    mlp: Any = None,
    lora: dict[str, torch.Tensor] | None = None,
    adapter_idx: torch.Tensor | None = None,  # [B] adapter row per sequence
    mesh: Any = None,
) -> tuple[torch.Tensor, Any]:
    """Ragged prefill: sequence b's new tokens occupy a contiguous run of
    packed rows (grouped and ascending in b, padding at the tail), at
    absolute positions ``positions``. Per layer the chunk's K/V are
    scattered into the pool (padding rows into the dump page; quantized
    in the same pass for an int8/int4 pool), then every packed query
    attends its own sequence's pages under a causal mask: through K1
    (``ops.paged_attention.ragged_prefill_attention``, the reference's
    ``"pallas"``) on a native pool, through ``_ragged_window_attention``
    in plain PyTorch (the reference's ``""``) on an int8/int4 pool, as
    the reference's fallback matrix routes them.

    ``plain=True`` runs the kernels' plain versions (K1's and K6's)
    whatever the device (the on-card reference). ``mlp(p, i, h, plain)``
    replaces the dense MLP of every layer (the mixtral family's MoE
    layer). ``lora``/``adapter_idx`` add each sequence's adapter deltas
    (``models/lora.lora_delta`` over the packed rows, gathered per
    sequence). Returns (logits at each row's last packed token [B, V]
    float32, pool)."""
    windowed = kvq.is_quantized(kv_cache)
    T = tokens.shape[0]
    B, P = page_table.shape
    dev = tokens.device
    valid = row_seq < B
    rs = torch.clamp(row_seq, max=B - 1).long()
    ad = _adapters(lora, adapter_idx, rs, mesh)
    mlp = _dense_mlp(mlp, ad, mesh)
    pt_rows = page_table.long()[rs]  # [T, P]
    pos = positions.long()
    slot = torch.gather(pt_rows, 1, (pos // page_size)[:, None])[:, 0] \
        * page_size + pos % page_size
    flat = kvq.padding_slots(kv_cache, page_size, valid, slot)
    # K1's metadata, derived from the packed layout
    cu = torch.searchsorted(
        row_seq.to(torch.int32).contiguous(),
        torch.arange(B + 1, dtype=torch.int32, device=dev),
        side="left").to(torch.int32)
    start = positions.to(torch.int32)[torch.clamp(cu[:B], max=T - 1)]
    attend = (paged_attention.ragged_prefill_attention_plain if plain
              else paged_attention.ragged_prefill_attention)
    pt32 = page_table.to(torch.int32).contiguous()

    if windowed:
        chunk_pages = _window_pages(pos, valid, page_size, P)
    x = _embed_rows(p, tokens.long(), mesh)[:, None]  # [T, 1, dim]
    pos2 = pos[:, None]
    for i in range(cfg.n_layers):
        h = rms_norm(x, p[f"l{i}.attn_norm"], cfg.norm_eps)
        q, k, v = _project_qkv(p, i, h, pos2, cfg, plain=plain, ad=ad)
        kv_cache = kvq.scatter_kv(kv_cache, i, flat, k, v)
        kr, ksc = kvq.layer_pool(kv_cache, i, 0)
        vr, vsc = kvq.layer_pool(kv_cache, i, 1)
        if windowed:
            attn = _ragged_window_attention(
                q[:, 0], kr, vr, pt_rows, pos, valid, page_size, ksc, vsc,
                chunk_pages)
        else:
            attn = attend(q[:, 0].contiguous(), kr, vr, pt32, cu,
                          start.contiguous(), page_size=page_size)
        x = x + _wo(p, i, attn.reshape(T, 1, -1), plain, ad, mesh)
        h = rms_norm(x, p[f"l{i}.mlp_norm"], cfg.norm_eps)
        x = x + mlp(p, i, h, plain)
    x = rms_norm(x, p["norm_f"], cfg.norm_eps)
    last = x[torch.clamp(last_rows.long(), 0, T - 1), 0]  # [B, dim]
    return _logits(p, cfg, last, plain, mesh), kv_cache


def prefill(
    p: dict[str, torch.Tensor],
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [B, S] int, right-padded
    seq_lens: torch.Tensor,  # [B] int true lengths (0 = a padding row)
    kv_cache: Any,  # [L, 2, n_slots, Hkv, D] or quantized dict, in place
    page_table: torch.Tensor,  # [B, max_pages] int32
    page_size: int,
    *,
    plain: bool = False,
    mlp: Any = None,
    lora: dict[str, torch.Tensor] | None = None,
    adapter_idx: torch.Tensor | None = None,  # [B] adapter row per sequence
    mesh: Any = None,
) -> tuple[torch.Tensor, Any]:
    """The bucketed prefill (the reference's ``prefill``): whole prompts
    right-padded to one ``[B, S]`` block. The prompt attends only itself
    (dense causal attention over the block's fresh K/V, never the pool);
    each layer's K/V are scattered into the pool, padded positions into
    the dump page. ``plain``, ``mlp``, ``lora`` and ``adapter_idx`` as
    in ``prefill_ragged``. Returns (logits at each row's last valid
    position [B, V] float32, pool)."""
    B, S = tokens.shape
    pos, valid, mask = _causal_block(seq_lens, S)
    flat = _write_slots(kv_cache, page_table, pos, valid, page_size)
    ad = _adapters(lora, adapter_idx, mesh=mesh)
    mlp = _dense_mlp(mlp, ad, mesh)
    x = _embed_rows(p, tokens.long(), mesh)  # [B, S, dim]
    for i in range(cfg.n_layers):
        h = rms_norm(x, p[f"l{i}.attn_norm"], cfg.norm_eps)
        q, k, v = _project_qkv(p, i, h, pos, cfg, plain=plain, ad=ad)
        kv_cache = kvq.scatter_kv(kv_cache, i, flat, k, v)
        x = x + _wo(p, i, _attention(q, k, v, mask), plain, ad, mesh)
        h = rms_norm(x, p[f"l{i}.mlp_norm"], cfg.norm_eps)
        x = x + mlp(p, i, h, plain)
    x = rms_norm(x, p["norm_f"], cfg.norm_eps)
    last = torch.clamp(seq_lens.long() - 1, 0, S - 1)
    return _logits(p, cfg, x[torch.arange(B, device=x.device), last],
                   plain, mesh), kv_cache


def prefill_suffix(
    p: dict[str, torch.Tensor],
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [B, S] suffix tokens, right-padded
    prefix_lens: torch.Tensor,  # [B] int tokens already in the pool
    seq_lens: torch.Tensor,  # [B] int TOTAL length, prefix included
    kv_cache: Any,  # native tensor or quantized dict, updated in place
    page_table: torch.Tensor,  # [B, window pages] int32
    page_size: int,
    *,
    plain: bool = False,
    mlp: Any = None,
    lora: dict[str, torch.Tensor] | None = None,
    adapter_idx: torch.Tensor | None = None,  # [B] adapter row per sequence
    mesh: Any = None,
) -> tuple[torch.Tensor, Any]:
    """Prefill the suffix of a prompt whose prefix K/V already sits in
    the pool (a prefix-cache resume, or one chunk of the chunked
    prefill): the reference's ``prefill_suffix``. Per layer the suffix's
    K/V are scattered first (padding into the dump page), then every
    suffix query attends the gathered page window (a quantized pool
    dequantized at the gather) under the global causal mask, so it sees
    the cached prefix and the suffix itself. ``page_table``'s width is
    the window (the engine passes the sequence's power-of-two page
    bucket). Returns (logits at each row's last valid position [B, V]
    float32, pool)."""
    B, S = tokens.shape
    dev = tokens.device
    pos = prefix_lens.long()[:, None] + torch.arange(S, device=dev)[None, :]
    valid = pos < seq_lens.long()[:, None]
    flat = _write_slots(kv_cache, page_table, pos, valid, page_size)
    gslot = _window_slots(page_table, page_size)
    mask = (torch.arange(gslot.shape[1], device=dev)[None, None, :]
            <= pos[:, :, None]) & valid[..., None]
    ad = _adapters(lora, adapter_idx, mesh=mesh)
    mlp = _dense_mlp(mlp, ad, mesh)
    x = _embed_rows(p, tokens.long(), mesh)
    for i in range(cfg.n_layers):
        h = rms_norm(x, p[f"l{i}.attn_norm"], cfg.norm_eps)
        q, k, v = _project_qkv(p, i, h, pos, cfg, plain=plain, ad=ad)
        kv_cache = kvq.scatter_kv(kv_cache, i, flat, k, v)
        k_all, v_all = kvq.gather_kv(kv_cache, i, gslot)
        x = x + _wo(p, i, _attention(q, k_all, v_all, mask), plain, ad,
                    mesh)
        h = rms_norm(x, p[f"l{i}.mlp_norm"], cfg.norm_eps)
        x = x + mlp(p, i, h, plain)
    x = rms_norm(x, p["norm_f"], cfg.norm_eps)
    last = torch.clamp(seq_lens.long() - prefix_lens.long() - 1, 0, S - 1)
    return _logits(p, cfg, x[torch.arange(B, device=dev), last],
                   plain, mesh), kv_cache


def _sp_shard(mesh, S: int) -> tuple[int, int, int]:
    """(this rank's ``sp`` index, ``sp``, rows per rank) of an ``S``-row
    chunk."""
    n = mesh.shape["sp"]
    if S % n:
        raise ValueError(f"a sequence-parallel chunk of {S} rows does not "
                         f"divide over sp={n}")
    return mesh.axis_index("sp"), n, S // n


def _sp_kv(k: torch.Tensor, v: torch.Tensor, mesh
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                      torch.Tensor]:
    """Every ``sp`` rank's K/V block, gathered in one collective: the
    blocks ``[n, B, S/n, Hkv, D]`` (for the attention) and the whole
    chunk's rows ``[B, S, Hkv, D]`` (for the pool)."""
    blocks = gather_blocks(torch.stack([k, v]), mesh, "sp")
    kb, vb = blocks[:, 0], blocks[:, 1]
    n, B, Sl, Hkv, D = kb.shape

    def rows(x):
        return x.permute(1, 0, 2, 3, 4).reshape(B, n * Sl, Hkv, D)

    return kb, vb, rows(kb), rows(vb)


def _sp_last(x: torch.Tensor, last: torch.Tensor, lo: int,
             mesh) -> torch.Tensor:
    """Row ``last[b]`` of each sequence (``x`` holds this rank's rows
    ``[lo, lo + S/n)``), on every rank: each rank offers its candidate,
    the candidates are gathered over ``sp``, and the owner's is kept."""
    B, Sl = x.shape[0], x.shape[1]
    rows = torch.arange(B, device=x.device)
    mine = x[rows, torch.clamp(last - lo, 0, Sl - 1)]
    every = gather_blocks(mine, mesh, "sp")  # [n, B, dim]
    owner = torch.clamp(last // Sl, 0, every.shape[0] - 1)
    return every[owner, rows]


def prefill_sp(
    p: dict[str, torch.Tensor],
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [B, S] int, right-padded; S divisible by sp
    seq_lens: torch.Tensor,  # [B] int true lengths
    kv_cache: Any,  # native tensor or quantized dict, updated in place
    page_table: torch.Tensor,  # [B, max_pages] int32
    page_size: int,
    *,
    mesh: Any,  # a parallel.mesh.Mesh with an sp axis
    strategy: str = "ring",  # "ring" | "ulysses"
    plain: bool = False,
    mlp: Any = None,
    lora: dict[str, torch.Tensor] | None = None,
    adapter_idx: torch.Tensor | None = None,  # [B] adapter row per sequence
) -> tuple[torch.Tensor, Any]:
    """The sequence-parallel prefill (the reference's ``prefill_sp``):
    ``prefill`` with the chunk's rows sharded over ``sp`` and its
    attention the ring's (``strategy="ring"``) or Ulysses'. Every rank
    gets the whole ``tokens`` and runs its own rows (see the module
    docstring). The attention is causal with no validity mask, as the
    reference's: padding sits past ``seq_len``, so a valid query only
    reaches valid keys; padded rows compute garbage no one reads, and
    their K/V go to the dump page. ``plain``, ``mlp``, ``lora`` and
    ``adapter_idx`` as in ``prefill_ragged``. Returns (logits at each
    row's last valid position [B, V] float32, the same on every rank;
    pool)."""
    if strategy not in ("ring", "ulysses"):
        raise ValueError(f"strategy must be 'ring' or 'ulysses' (got "
                         f"{strategy!r})")
    S = tokens.shape[1]
    r, n, Sl = _sp_shard(mesh, S)
    lo = r * Sl
    pos, valid, _ = _causal_block(seq_lens, S)
    flat = _write_slots(kv_cache, page_table, pos, valid, page_size)
    ad = _adapters(lora, adapter_idx, mesh=mesh)
    mlp = _dense_mlp(mlp, ad, mesh)
    lpos = pos[:, lo:lo + Sl]
    x = _embed_rows(p, tokens[:, lo:lo + Sl].long(), mesh)
    for i in range(cfg.n_layers):
        h = rms_norm(x, p[f"l{i}.attn_norm"], cfg.norm_eps)
        q, k, v = _project_qkv(p, i, h, lpos, cfg, plain=plain, ad=ad)
        kb, vb, k_rows, v_rows = _sp_kv(k, v, mesh)
        kv_cache = kvq.scatter_kv(kv_cache, i, flat, k_rows, v_rows)
        if strategy == "ring":
            attn = _ring_attention_local(q, kb.to(q.dtype), vb.to(q.dtype),
                                         idx=r, n=n, causal=True)
        else:
            attn = _ulysses_attention_local(
                q, k.to(q.dtype), v.to(q.dtype), idx=r, n=n, causal=True,
                mesh=mesh)
        x = x + _wo(p, i, attn.to(x.dtype), plain, ad, mesh)
        h = rms_norm(x, p[f"l{i}.mlp_norm"], cfg.norm_eps)
        x = x + mlp(p, i, h, plain)
    x = rms_norm(x, p["norm_f"], cfg.norm_eps)
    last = torch.clamp(seq_lens.long() - 1, 0, S - 1)
    return _logits(p, cfg, _sp_last(x, last, lo, mesh), plain,
                   mesh), kv_cache


def prefill_sp_suffix(
    p: dict[str, torch.Tensor],
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [B, S] chunk tokens, right-padded; S % sp == 0
    prefix_lens: torch.Tensor,  # [B] int tokens already in the pool
    seq_lens: torch.Tensor,  # [B] int TOTAL length, prefix included
    kv_cache: Any,  # native tensor or quantized dict, updated in place
    page_table: torch.Tensor,  # [B, pages]; pages * page_size % sp == 0
    page_size: int,
    *,
    mesh: Any,  # a parallel.mesh.Mesh with an sp axis
    plain: bool = False,
    mlp: Any = None,
    lora: dict[str, torch.Tensor] | None = None,
    adapter_idx: torch.Tensor | None = None,  # [B] adapter row per sequence
) -> tuple[torch.Tensor, Any]:
    """The sequence-parallel chunk resuming at a page-aligned offset (the
    reference's ``prefill_sp_suffix``): ``prefill_suffix``'s contract
    with the chunk's rows sharded over ``sp``. Per layer every rank
    scatters the whole chunk's K/V (gathered over ``sp``) into its pool
    first, so a later chunk's window sees them; then its queries attend
    the chunk causally and the pool's page window masked to ``t <
    prefix_len`` under one carry (``ring_attention``'s
    ``_ring_prefix_attention_local``). With ``prefix_lens == 0`` the
    window adds nothing and this is ``prefill_sp`` over one chunk.
    ``page_table``'s width is the window (the engine passes the
    sequence's power-of-two page bucket). Returns (logits at each row's
    last valid position [B, V] float32, the same on every rank;
    pool)."""
    S = tokens.shape[1]
    dev = tokens.device
    r, n, Sl = _sp_shard(mesh, S)
    lo = r * Sl
    pos = prefix_lens.long()[:, None] + torch.arange(S, device=dev)[None, :]
    valid = pos < seq_lens.long()[:, None]
    flat = _write_slots(kv_cache, page_table, pos, valid, page_size)
    gslot = _window_slots(page_table, page_size)
    ad = _adapters(lora, adapter_idx, mesh=mesh)
    mlp = _dense_mlp(mlp, ad, mesh)
    lpos = pos[:, lo:lo + Sl]
    x = _embed_rows(p, tokens[:, lo:lo + Sl].long(), mesh)
    for i in range(cfg.n_layers):
        h = rms_norm(x, p[f"l{i}.attn_norm"], cfg.norm_eps)
        q, k, v = _project_qkv(p, i, h, lpos, cfg, plain=plain, ad=ad)
        kb, vb, k_rows, v_rows = _sp_kv(k, v, mesh)
        kv_cache = kvq.scatter_kv(kv_cache, i, flat, k_rows, v_rows)
        k_all, v_all = kvq.gather_kv(kv_cache, i, gslot)
        attn = _ring_prefix_attention_local(
            q, kb.to(q.dtype), vb.to(q.dtype), k_all.to(q.dtype),
            v_all.to(q.dtype), prefix_lens, idx=r, n=n)
        x = x + _wo(p, i, attn.to(x.dtype), plain, ad, mesh)
        h = rms_norm(x, p[f"l{i}.mlp_norm"], cfg.norm_eps)
        x = x + mlp(p, i, h, plain)
    x = rms_norm(x, p["norm_f"], cfg.norm_eps)
    last = torch.clamp(seq_lens.long() - prefix_lens.long() - 1, 0, S - 1)
    return _logits(p, cfg, _sp_last(x, last, lo, mesh), plain,
                   mesh), kv_cache


def hidden_states(
    p: dict[str, torch.Tensor],
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [B, S] int, right-padded
    seq_lens: torch.Tensor,  # [B] int true lengths
    *,
    plain: bool = False,
    mlp: Any = None,
    lora: dict[str, torch.Tensor] | None = None,
    adapter_idx: torch.Tensor | None = None,
    mesh: Any = None,
) -> torch.Tensor:
    """Mean-pooled final hidden states (the ``/v1/embeddings`` pass, the
    reference's ``hidden_states``): the prefill's dense causal pass with
    no pool, then the final norm's rows averaged in float32 over each
    row's valid positions (``max(count, 1)`` as the divisor, so an empty
    input pools to zeros). Returns ``[B, dim]`` float32."""
    B, S = tokens.shape
    pos, valid, mask = _causal_block(seq_lens, S)
    ad = _adapters(lora, adapter_idx, mesh=mesh)
    mlp = _dense_mlp(mlp, ad, mesh)
    x = _embed_rows(p, tokens.long(), mesh)
    for i in range(cfg.n_layers):
        h = rms_norm(x, p[f"l{i}.attn_norm"], cfg.norm_eps)
        q, k, v = _project_qkv(p, i, h, pos, cfg, plain=plain, ad=ad)
        x = x + _wo(p, i, _attention(q, k, v, mask), plain, ad, mesh)
        h = rms_norm(x, p[f"l{i}.mlp_norm"], cfg.norm_eps)
        x = x + mlp(p, i, h, plain)
    x = rms_norm(x, p["norm_f"], cfg.norm_eps)
    w = valid[..., None].float()
    return (x.float() * w).sum(1) / torch.clamp(w.sum(1), min=1.0)


def decode_step(
    p: dict[str, torch.Tensor],
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [B] int current token per slot
    positions: torch.Tensor,  # [B] int position of `tokens`
    kv_cache: Any,  # native tensor or quantized dict, updated in place
    page_table: torch.Tensor,  # [B, max_pages] int32
    page_size: int,
    active: torch.Tensor,  # [B] bool slot occupied
    attn_impl: str = "fused",
    *,
    plain: bool = False,
    mlp: Any = None,
    lora: dict[str, torch.Tensor] | None = None,
    adapter_idx: torch.Tensor | None = None,  # [B] adapter row per slot
    mesh: Any = None,
) -> tuple[torch.Tensor, Any]:
    """One continuous-batching decode step; returns (logits [B, V]
    float32, pool). ``attn_impl`` selects the decode rung:

    - ``"fused"`` — ``ops.decode_fused.fused_paged_decode``: RoPE +
      append + paged attention in one launch per layer (K2 on a native
      pool, K7 on an int8/int4 pool); inactive slots write into the dump
      page.
    - ``"chained"`` — RoPE and the K/V scatter in PyTorch (inactive
      slots scatter into the dump page), then K3
      (``ops.paged_attention.paged_attention_decode_v2``). Native pools
      only, as in the reference.
    - ``""`` — the gather rung (the reference's XLA default): RoPE and
      the scatter as on the chained rung, then each slot's whole page
      window gathered (a quantized pool dequantized to bf16 at the
      gather, ``kvq.gather_kv``) and dense attention masked to
      ``pos + 1``, in plain PyTorch on every device, as the reference
      runs it in XLA.

    ``plain=True`` runs the kernels' plain versions (the attention
    rung's and K6's) whatever the device; ``mlp``, ``lora`` and
    ``adapter_idx`` as in ``prefill_ragged``. On the fused rung the
    kernel gets q/k/v that already carry the adapter deltas.
    """
    if attn_impl not in ("fused", "chained", ""):
        raise ValueError(f"attn_impl must be 'fused', 'chained' or '' "
                         f"(got {attn_impl!r})")
    if attn_impl == "chained" and kvq.is_quantized(kv_cache):
        raise NotImplementedError(
            "the chained decode kernel has no quantized-pool rung: the "
            "fallback matrix resolves int8/int4 to the fused rung")
    ad = _adapters(lora, adapter_idx, mesh=mesh)
    mlp = _dense_mlp(mlp, ad, mesh)
    B = tokens.shape[0]
    pos1 = positions.long()[:, None]
    active = active.bool()
    pt32 = page_table.to(torch.int32).contiguous()
    fused = attn_impl == "fused"
    if fused:
        step = (decode_fused.fused_paged_decode_plain if plain
                else decode_fused.fused_paged_decode)
        if mesh is not None:
            # each rank walks its local head shard of the pool (the
            # counterpart of the reference's paged_decode_walk_spmd)
            step = functools.partial(decode_fused.fused_paged_decode_shard,
                                     step=step, mesh=mesh,
                                     n_heads=cfg.n_heads,
                                     n_kv_heads=cfg.n_kv_heads)
        # converted once per step, shared by every layer's launch
        tables = decode_fused.rope_tables(positions, cfg.head_dim,
                                          cfg.rope_theta)
        pos32 = positions.to(torch.int32).contiguous()
        act32 = active.to(torch.int32)
    else:
        # an inactive slot may sit at max_seq_len (its window ran out at
        # its limit): _write_slots clamps its page index and sends its
        # row to the dump page
        flat = _write_slots(kv_cache, page_table, pos1, active[:, None],
                            page_size)
    if attn_impl == "chained":
        walk = (paged_attention.paged_attention_decode_v2_plain if plain
                else paged_attention.paged_attention_decode_v2)
        lengths = torch.where(active, pos1[:, 0] + 1,
                              torch.zeros_like(pos1[:, 0])).to(torch.int32)
    elif not fused:
        gslot = _window_slots(page_table, page_size)
        mask = (torch.arange(gslot.shape[1], device=gslot.device)[None, :]
                <= pos1)[:, None, :]  # [B, 1, T]
    x = _embed_rows(p, tokens.long(), mesh)[:, None]  # [B, 1, dim]
    for i in range(cfg.n_layers):
        h = rms_norm(x, p[f"l{i}.attn_norm"], cfg.norm_eps)
        q, k, v = _project_qkv(p, i, h, pos1, cfg, apply_rope=not fused,
                               plain=plain, ad=ad)
        if fused:
            kr, ksc = kvq.layer_pool(kv_cache, i, 0)
            vr, vsc = kvq.layer_pool(kv_cache, i, 1)
            attn = step(
                q[:, 0].contiguous(), k[:, 0].contiguous(),
                v[:, 0].contiguous(), kr, vr, pt32, pos32, act32, ksc, vsc,
                rope_theta=cfg.rope_theta, page_size=page_size,
                tables=tables)[0].reshape(B, 1, -1)
        else:
            kv_cache = kvq.scatter_kv(kv_cache, i, flat, k, v)
            if attn_impl == "chained":
                kr, _ = kvq.layer_pool(kv_cache, i, 0)
                vr, _ = kvq.layer_pool(kv_cache, i, 1)
                attn = walk(q[:, 0].contiguous(), kr, vr, pt32, lengths,
                            page_size=page_size).reshape(B, 1, -1)
            else:
                k_all, v_all = kvq.gather_kv(kv_cache, i, gslot)
                attn = _attention(q, k_all, v_all, mask)
        x = x + _wo(p, i, attn, plain, ad, mesh)
        h = rms_norm(x, p[f"l{i}.mlp_norm"], cfg.norm_eps)
        x = x + mlp(p, i, h, plain)
    x = rms_norm(x, p["norm_f"], cfg.norm_eps)
    return _logits(p, cfg, x[:, 0], plain, mesh), kv_cache


def verify_step(
    p: dict[str, torch.Tensor],
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [B, S] pending token + S - 1 draft tokens
    positions: torch.Tensor,  # [B] int position of tokens[:, 0]
    kv_cache: Any,  # native tensor or quantized dict, updated in place
    page_table: torch.Tensor,  # [B, max_pages] int32
    page_size: int,
    active: torch.Tensor,  # [B] bool slot occupied
    limits: torch.Tensor,  # [B] int exclusive max write position
    attn_impl: str = "",
    *,
    plain: bool = False,
    mlp: Any = None,
    lora: dict[str, torch.Tensor] | None = None,
    adapter_idx: torch.Tensor | None = None,  # [B] adapter row per slot
    mesh: Any = None,
) -> tuple[torch.Tensor, Any]:
    """Speculative decoding's verifier: S candidate positions per slot
    in one step; returns (logits at every position [B, S, V] float32,
    pool). K/V of all S positions are scattered; a rejected draft's
    rows are rewritten by a later step before any causal read can reach
    them. Writes at positions ``>= limits`` and from inactive slots go
    to the dump page. ``attn_impl``:

    - ``"chained"`` (the reference's ``"pallas"``) — K5
      (``ops.paged_attention.paged_attention_verify``); native pools
      only, as in the reference;
    - ``""`` — the gather path: every slot's page window gathered (a
      quantized pool dequantized to bf16) and dense masked attention,
      rows past ``limits`` masked out.

    ``plain=True`` runs the kernels' plain versions (K5's and K6's)
    whatever the device; ``mlp``, ``lora`` and ``adapter_idx`` as in
    ``prefill_ragged``."""
    if attn_impl not in ("", "chained"):
        raise ValueError(f"attn_impl must be '' or 'chained' "
                         f"(got {attn_impl!r})")
    ad = _adapters(lora, adapter_idx, mesh=mesh)
    mlp = _dense_mlp(mlp, ad, mesh)
    chained = attn_impl == "chained"
    if chained and kvq.is_quantized(kv_cache):
        raise NotImplementedError(
            "the verify kernel has no quantized-pool rung: the fallback "
            "matrix keeps int8/int4 on the gather-dequant path")
    B, S = tokens.shape
    dev = tokens.device
    start = positions.long()
    pos = start[:, None] + torch.arange(S, device=dev)[None, :]  # [B, S]
    active = active.bool()
    valid = active[:, None] & (pos < limits.long()[:, None])
    flat = _write_slots(kv_cache, page_table, pos, valid, page_size)
    if chained:
        attend = (paged_attention.paged_attention_verify_plain if plain
                  else paged_attention.paged_attention_verify)
        pt32 = page_table.to(torch.int32).contiguous()
        # an inactive slot sits at -(S + 1): no attendable key
        pos0 = torch.where(active, start,
                           torch.full_like(start, -(S + 1))
                           ).to(torch.int32).contiguous()
    else:
        gslot = _window_slots(page_table, page_size)
        mask = (torch.arange(gslot.shape[1], device=dev)[None, None, :]
                <= pos[:, :, None]) & valid[..., None]
    x = _embed_rows(p, tokens.long(), mesh)  # [B, S, dim]
    for i in range(cfg.n_layers):
        h = rms_norm(x, p[f"l{i}.attn_norm"], cfg.norm_eps)
        q, k, v = _project_qkv(p, i, h, pos, cfg, plain=plain, ad=ad)
        kv_cache = kvq.scatter_kv(kv_cache, i, flat, k, v)
        if chained:
            kr, _ = kvq.layer_pool(kv_cache, i, 0)
            vr, _ = kvq.layer_pool(kv_cache, i, 1)
            attn = attend(q.contiguous(), kr, vr, pt32, pos0,
                          page_size=page_size).reshape(B, S, -1)
        else:
            k_all, v_all = kvq.gather_kv(kv_cache, i, gslot)
            attn = _attention(q, k_all, v_all, mask)
        x = x + _wo(p, i, attn, plain, ad, mesh)
        h = rms_norm(x, p[f"l{i}.mlp_norm"], cfg.norm_eps)
        x = x + mlp(p, i, h, plain)
    x = rms_norm(x, p["norm_f"], cfg.norm_eps)
    return _logits(p, cfg, x, plain, mesh), kv_cache
