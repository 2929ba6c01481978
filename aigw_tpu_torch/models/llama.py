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

The pool is updated IN PLACE and returned (the reference donates it).

This slice ports ``prefill_ragged`` and ``decode_step`` (fused and
chained rungs). ``prefill``, ``prefill_suffix``, ``verify_step``,
``hidden_states``, the sequence-parallel prefills, the gather rung, LoRA
and quantized weights wait for later slices (ROADMAP queue 1).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from aigw_tpu_torch.models import kvq
from aigw_tpu_torch.ops import decode_fused, paged_attention


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


def _project_qkv(p, i, x, positions, cfg, apply_rope=True):
    hd = cfg.head_dim
    B, S, _ = x.shape
    q = x @ p[f"l{i}.wq"]
    k = x @ p[f"l{i}.wk"]
    v = x @ p[f"l{i}.wv"]
    if cfg.attn_bias:
        q, k, v = q + p[f"l{i}.bq"], k + p[f"l{i}.bk"], v + p[f"l{i}.bv"]
    q = q.reshape(B, S, cfg.n_heads, hd)
    k = k.reshape(B, S, cfg.n_kv_heads, hd)
    v = v.reshape(B, S, cfg.n_kv_heads, hd)
    if apply_rope:  # the fused decode kernel ropes Q/K itself
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mlp(p, i, x):
    gate = F.silu(x @ p[f"l{i}.w_gate"])
    up = x @ p[f"l{i}.w_up"]
    return (gate * up) @ p[f"l{i}.w_down"]


def _logits(p, cfg: LlamaConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return (x @ p["embed"].T).float()
    return (x @ p["lm_head"]).float()


def prefill_ragged(
    p: dict[str, torch.Tensor],
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [T] int — PACKED new tokens, all sequences
    row_seq: torch.Tensor,  # [T] int — sequence row per token; >= B = padding
    positions: torch.Tensor,  # [T] int — absolute position per token
    last_rows: torch.Tensor,  # [B] int — packed index of each row's last token
    kv_cache: torch.Tensor,  # [L, 2, n_slots, Hkv, D], updated in place
    page_table: torch.Tensor,  # [B, max_pages] int32
    page_size: int,
    *,
    plain: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Ragged prefill: sequence b's new tokens occupy a contiguous run of
    packed rows (grouped and ascending in b, padding at the tail), at
    absolute positions ``positions``. Per layer the chunk's K/V are
    scattered into the pool (padding rows into the dump page), then
    every packed query attends its own sequence's pages under a causal
    mask through K1 (``ops.paged_attention.ragged_prefill_attention``).
    ``plain=True`` runs K1's plain version whatever the device (the
    on-card reference). Returns (logits at each row's last packed token
    [B, V] float32, pool)."""
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

    x = p["embed"][tokens.long()][:, None]  # [T, 1, dim]
    pos2 = pos[:, None]
    for i in range(cfg.n_layers):
        h = rms_norm(x, p[f"l{i}.attn_norm"], cfg.norm_eps)
        q, k, v = _project_qkv(p, i, h, pos2, cfg)
        kv_cache = kvq.scatter_kv(kv_cache, i, flat, k, v)
        attn = attend(q[:, 0].contiguous(), kvq.layer_pool(kv_cache, i, 0),
                      kvq.layer_pool(kv_cache, i, 1), pt32, cu,
                      start.contiguous(), page_size=page_size)
        x = x + attn.reshape(T, 1, cfg.n_heads * cfg.head_dim) \
            @ p[f"l{i}.wo"]
        h = rms_norm(x, p[f"l{i}.mlp_norm"], cfg.norm_eps)
        x = x + _mlp(p, i, h)
    x = rms_norm(x, p["norm_f"], cfg.norm_eps)
    last = x[torch.clamp(last_rows.long(), 0, T - 1), 0]  # [B, dim]
    return _logits(p, cfg, last), kv_cache


def decode_step(
    p: dict[str, torch.Tensor],
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [B] int current token per slot
    positions: torch.Tensor,  # [B] int position of `tokens`
    kv_cache: torch.Tensor,  # updated in place
    page_table: torch.Tensor,  # [B, max_pages] int32
    page_size: int,
    active: torch.Tensor,  # [B] bool slot occupied
    attn_impl: str = "fused",
    *,
    plain: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One continuous-batching decode step; returns (logits [B, V]
    float32, pool). ``attn_impl`` selects the decode rung:

    - ``"fused"`` — K2 (``ops.decode_fused.fused_paged_decode``): RoPE +
      append + paged attention in one launch per layer; inactive slots
      write into the dump page.
    - ``"chained"`` — RoPE and the K/V scatter in PyTorch (inactive
      slots scatter into the dump page), then K3
      (``ops.paged_attention.paged_attention_decode_v2``).

    ``plain=True`` runs the kernels' plain versions whatever the device.
    """
    if attn_impl not in ("fused", "chained"):
        raise ValueError(f"attn_impl must be 'fused' or 'chained' "
                         f"(got {attn_impl!r})")
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
    x = p["embed"][tokens.long()][:, None]  # [B, 1, dim]
    for i in range(cfg.n_layers):
        h = rms_norm(x, p[f"l{i}.attn_norm"], cfg.norm_eps)
        q, k, v = _project_qkv(p, i, h, pos1, cfg, apply_rope=not fused)
        if fused:
            attn, _, _ = step(
                q[:, 0].contiguous(), k[:, 0].contiguous(),
                v[:, 0].contiguous(), kvq.layer_pool(kv_cache, i, 0),
                kvq.layer_pool(kv_cache, i, 1), pt32, pos32, act32,
                rope_theta=cfg.rope_theta, page_size=page_size,
                tables=tables)
        else:
            kv_cache = kvq.scatter_kv(kv_cache, i, flat, k, v)
            attn = walk(q[:, 0].contiguous(), kvq.layer_pool(kv_cache, i, 0),
                        kvq.layer_pool(kv_cache, i, 1), pt32, lengths,
                        page_size=page_size)
        x = x + attn.reshape(B, 1, HD) @ p[f"l{i}.wo"]
        h = rms_norm(x, p[f"l{i}.mlp_norm"], cfg.norm_eps)
        x = x + _mlp(p, i, h)
    x = rms_norm(x, p["norm_f"], cfg.norm_eps)
    return _logits(p, cfg, x[:, 0]), kv_cache
