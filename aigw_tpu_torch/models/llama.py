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
quantized pools take), ``decode_step`` (fused and chained rungs) and
``verify_step`` (K5 on the chained rung, the gather path otherwise).
``prefill``, ``prefill_suffix``, ``hidden_states``, the
sequence-parallel prefills, the gather rung and LoRA wait for later
slices (ROADMAP queue 1).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

from aigw_tpu_torch.models import kvq
from aigw_tpu_torch.ops import decode_fused, paged_attention, qmatmul


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


def init_params(seed: int, cfg: LlamaConfig, dtype=torch.bfloat16,
                device: str | torch.device = "cuda"
                ) -> dict[str, torch.Tensor]:
    """Random weights from a seeded ``torch.Generator`` on ``device``,
    with the reference's scales (``init_params``: dense weights
    N(0, 1/in), embeddings N(0, 0.02²), norms one, biases zero). The
    draws differ from ``jax.random``'s; parity tests carry the
    reference's own weights across with ``models.convert``."""
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

    p = {"embed": dense((cfg.vocab_size, cfg.dim), scale=0.02),
         "norm_f": ones(cfg.dim)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense((cfg.dim, cfg.vocab_size))
    hd = cfg.head_dim
    for i in range(cfg.n_layers):
        p[f"l{i}.attn_norm"] = ones(cfg.dim)
        p[f"l{i}.wq"] = dense((cfg.dim, cfg.n_heads * hd))
        p[f"l{i}.wk"] = dense((cfg.dim, cfg.n_kv_heads * hd))
        p[f"l{i}.wv"] = dense((cfg.dim, cfg.n_kv_heads * hd))
        if cfg.attn_bias:
            p[f"l{i}.bq"] = zeros(cfg.n_heads * hd)
            p[f"l{i}.bk"] = zeros(cfg.n_kv_heads * hd)
            p[f"l{i}.bv"] = zeros(cfg.n_kv_heads * hd)
        p[f"l{i}.wo"] = dense((cfg.n_heads * hd, cfg.dim))
        p[f"l{i}.mlp_norm"] = ones(cfg.dim)
        p[f"l{i}.w_gate"] = dense((cfg.dim, cfg.ffn_dim))
        p[f"l{i}.w_up"] = dense((cfg.dim, cfg.ffn_dim))
        p[f"l{i}.w_down"] = dense((cfg.ffn_dim, cfg.dim))
    return p


def _w(p: dict[str, torch.Tensor], key: str) -> torch.Tensor:
    """A weight stored bf16/f32, int8 + per-channel scale (W8A16) or
    packed int4 + group scales (W4A16), as the matmul operand: quantized
    weights come back as ``q * scale`` in bf16 with the scale rounded to
    bf16 first, exactly as the reference's ``_w``."""
    q = p.get(key + ".q")
    if q is None:
        return p[key]
    scale = p[key + ".scale"].to(torch.bfloat16)
    if q.dtype == torch.uint8:
        # int4 packed along the input axis; scales [in / G, out]
        wf = kvq.unpack_int4(q, dim=0).to(torch.bfloat16)
        n_in, n_out = wf.shape
        groups = scale.shape[0]
        wf = wf.reshape(groups, n_in // groups, n_out) * scale[:, None, :]
        return wf.reshape(n_in, n_out)
    return q.to(torch.bfloat16) * scale


def _embed_rows(p: dict[str, torch.Tensor],
                tokens: torch.Tensor) -> torch.Tensor:
    q = p.get("embed.q")
    if q is None:
        return p["embed"][tokens]
    rows = q[tokens].to(torch.bfloat16)
    scales = p["embed.scale"][:, 0][tokens]
    return rows * scales[..., None].to(torch.bfloat16)


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


def _project_qkv(p, i, x, positions, cfg, apply_rope=True, plain=False):
    hd = cfg.head_dim
    B, S, _ = x.shape
    q = _matmul(p, f"l{i}.wq", x, plain)
    k = _matmul(p, f"l{i}.wk", x, plain)
    v = _matmul(p, f"l{i}.wv", x, plain)
    if cfg.attn_bias:
        q, k, v = q + p[f"l{i}.bq"], k + p[f"l{i}.bk"], v + p[f"l{i}.bv"]
    q = q.reshape(B, S, cfg.n_heads, hd)
    k = k.reshape(B, S, cfg.n_kv_heads, hd)
    v = v.reshape(B, S, cfg.n_kv_heads, hd)
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
    rounds once to that dtype. Returns ``[B, S, H * D]``."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, S, Hkv, H // Hkv, D)
    logits = torch.einsum("bshgd,bthd->bhgst", qg.float(), k.float())
    logits = logits / math.sqrt(D)
    logits = torch.where(mask[:, None, None], logits,
                         torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgst,bthd->bshgd", probs.float(), v.float())
    return out.to(v.dtype).reshape(B, S, H * D)


def _mlp(p, i, x, plain=False):
    gate = F.silu(_matmul(p, f"l{i}.w_gate", x, plain))
    up = _matmul(p, f"l{i}.w_up", x, plain)
    return _matmul(p, f"l{i}.w_down", gate * up, plain)


def _logits(p, cfg: LlamaConfig, x: torch.Tensor,
            plain: bool = False) -> torch.Tensor:
    if cfg.tie_embeddings:
        return _mm(x, _w(p, "embed").T).float()
    return _matmul(p, "lm_head", x, plain).float()


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
    whatever the device (the on-card reference). Returns (logits at
    each row's last packed token [B, V] float32, pool)."""
    windowed = kvq.is_quantized(kv_cache)
    T = tokens.shape[0]
    B, P = page_table.shape
    dev = tokens.device
    valid = row_seq < B
    rs = torch.clamp(row_seq, max=B - 1).long()
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
    x = _embed_rows(p, tokens.long())[:, None]  # [T, 1, dim]
    pos2 = pos[:, None]
    HD = cfg.n_heads * cfg.head_dim
    for i in range(cfg.n_layers):
        h = rms_norm(x, p[f"l{i}.attn_norm"], cfg.norm_eps)
        q, k, v = _project_qkv(p, i, h, pos2, cfg, plain=plain)
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
        x = x + _matmul(p, f"l{i}.wo", attn.reshape(T, 1, HD), plain)
        h = rms_norm(x, p[f"l{i}.mlp_norm"], cfg.norm_eps)
        x = x + _mlp(p, i, h, plain)
    x = rms_norm(x, p["norm_f"], cfg.norm_eps)
    last = x[torch.clamp(last_rows.long(), 0, T - 1), 0]  # [B, dim]
    return _logits(p, cfg, last, plain), kv_cache


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

    ``plain=True`` runs the kernels' plain versions (the attention
    rung's and K6's) whatever the device.
    """
    if attn_impl not in ("fused", "chained"):
        raise ValueError(f"attn_impl must be 'fused' or 'chained' "
                         f"(got {attn_impl!r})")
    if attn_impl == "chained" and kvq.is_quantized(kv_cache):
        raise NotImplementedError(
            "the chained decode kernel has no quantized-pool rung: the "
            "fallback matrix resolves int8/int4 to the fused rung")
    B = tokens.shape[0]
    pos = positions.long()
    pos1 = pos[:, None]
    active = active.bool()
    pt32 = page_table.to(torch.int32).contiguous()
    fused = attn_impl == "fused"
    if fused:
        step = (decode_fused.fused_paged_decode_plain if plain
                else decode_fused.fused_paged_decode)
        # converted once per step, shared by every layer's launch
        tables = decode_fused.rope_tables(positions, cfg.head_dim,
                                          cfg.rope_theta)
        pos32 = positions.to(torch.int32).contiguous()
        act32 = active.to(torch.int32)
    else:
        walk = (paged_attention.paged_attention_decode_v2_plain if plain
                else paged_attention.paged_attention_decode_v2)
        # an inactive slot may sit at max_seq_len (its window ran out at
        # its limit): clamp the page index as the reference's gather does;
        # padding_slots sends its row to the dump page anyway
        page_idx = torch.clamp(pos1 // page_size, max=page_table.shape[1] - 1)
        slot = torch.gather(page_table.long(), 1, page_idx)[:, 0] \
            * page_size + pos % page_size
        flat = kvq.padding_slots(kv_cache, page_size, active, slot)
        lengths = torch.where(active, pos + 1,
                              torch.zeros_like(pos)).to(torch.int32)
    HD = cfg.n_heads * cfg.head_dim
    x = _embed_rows(p, tokens.long())[:, None]  # [B, 1, dim]
    for i in range(cfg.n_layers):
        h = rms_norm(x, p[f"l{i}.attn_norm"], cfg.norm_eps)
        q, k, v = _project_qkv(p, i, h, pos1, cfg, apply_rope=not fused,
                               plain=plain)
        kr, ksc = kvq.layer_pool(kv_cache, i, 0)
        vr, vsc = kvq.layer_pool(kv_cache, i, 1)
        if fused:
            attn = step(
                q[:, 0].contiguous(), k[:, 0].contiguous(),
                v[:, 0].contiguous(), kr, vr, pt32, pos32, act32, ksc, vsc,
                rope_theta=cfg.rope_theta, page_size=page_size,
                tables=tables)[0]
        else:
            kv_cache = kvq.scatter_kv(kv_cache, i, flat, k, v)
            attn = walk(q[:, 0].contiguous(), kr, vr, pt32, lengths,
                        page_size=page_size)
        x = x + _matmul(p, f"l{i}.wo", attn.reshape(B, 1, HD), plain)
        h = rms_norm(x, p[f"l{i}.mlp_norm"], cfg.norm_eps)
        x = x + _mlp(p, i, h, plain)
    x = rms_norm(x, p["norm_f"], cfg.norm_eps)
    return _logits(p, cfg, x[:, 0], plain), kv_cache


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
    whatever the device."""
    if attn_impl not in ("", "chained"):
        raise ValueError(f"attn_impl must be '' or 'chained' "
                         f"(got {attn_impl!r})")
    chained = attn_impl == "chained"
    if chained and kvq.is_quantized(kv_cache):
        raise NotImplementedError(
            "the verify kernel has no quantized-pool rung: the fallback "
            "matrix keeps int8/int4 on the gather-dequant path")
    B, S = tokens.shape
    P = page_table.shape[1]
    dev = tokens.device
    start = positions.long()
    pos = start[:, None] + torch.arange(S, device=dev)[None, :]  # [B, S]
    active = active.bool()
    valid = active[:, None] & (pos < limits.long()[:, None])
    # positions near max_seq_len (or of an inactive slot) may index past
    # the table: clamp as the reference's gather does; padding_slots
    # sends those rows to the dump page anyway
    page_idx = torch.clamp(pos // page_size, 0, P - 1)
    slot = torch.gather(page_table.long(), 1, page_idx) * page_size \
        + pos % page_size
    flat = kvq.padding_slots(kv_cache, page_size, valid, slot)
    if chained:
        attend = (paged_attention.paged_attention_verify_plain if plain
                  else paged_attention.paged_attention_verify)
        pt32 = page_table.to(torch.int32).contiguous()
        # an inactive slot sits at -(S + 1): no attendable key
        pos0 = torch.where(active, start,
                           torch.full_like(start, -(S + 1))
                           ).to(torch.int32).contiguous()
    else:
        T = P * page_size
        gslot = (page_table.long()[:, :, None] * page_size
                 + torch.arange(page_size, device=dev)).reshape(B, T)
        mask = (torch.arange(T, device=dev)[None, None, :]
                <= pos[:, :, None]) & valid[..., None]
    HD = cfg.n_heads * cfg.head_dim
    x = _embed_rows(p, tokens.long())  # [B, S, dim]
    for i in range(cfg.n_layers):
        h = rms_norm(x, p[f"l{i}.attn_norm"], cfg.norm_eps)
        q, k, v = _project_qkv(p, i, h, pos, cfg, plain=plain)
        kv_cache = kvq.scatter_kv(kv_cache, i, flat, k, v)
        if chained:
            kr, _ = kvq.layer_pool(kv_cache, i, 0)
            vr, _ = kvq.layer_pool(kv_cache, i, 1)
            attn = attend(q.contiguous(), kr, vr, pt32, pos0,
                          page_size=page_size).reshape(B, S, HD)
        else:
            k_all, v_all = kvq.gather_kv(kv_cache, i, gslot)
            attn = _attention(q, k_all, v_all, mask)
        x = x + _matmul(p, f"l{i}.wo", attn, plain)
        h = rms_norm(x, p[f"l{i}.mlp_norm"], cfg.norm_eps)
        x = x + _mlp(p, i, h, plain)
    x = rms_norm(x, p["norm_f"], cfg.norm_eps)
    return _logits(p, cfg, x, plain), kv_cache
