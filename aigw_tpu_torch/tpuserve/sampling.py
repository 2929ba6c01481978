"""Batched on-device sampling (counterpart of
``aigw_tpu/tpuserve/sampling.py``).

Temperature / top-k / top-p over the whole decode batch, with per-slot
parameters carried as tensors so one call serves any mix of greedy and
sampled requests. Random state is explicit: every slot carries a raw
``[seed, counter]`` uint32 key (held in an int64 tensor), and the draw is
the reference's ``jax.random.categorical`` reproduced exactly — threefry
2x32 over the key with the flat element index as a 64-bit counter, the
reference's uniform-from-bits recipe and Gumbel argmax — so seeded
streams match the JAX engine token for token, not only greedy ones.
``spec_accept`` turns a verify step's samples into what the engine
emits.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from aigw_tpu_torch.tpuserve.speculation import accept_counts

_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = float(torch.finfo(torch.float32).tiny)


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0  # 0 = disabled
    seed: int = 0
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    # token id → additive logit bias (OpenAI logit_bias)
    logit_bias: tuple[tuple[int, float], ...] = ()

    @staticmethod
    def from_request(body: dict) -> "SamplingParams":
        """JSON null falls back to the OpenAI defaults; explicit 0
        temperature means greedy."""

        def pick(key: str, default: float) -> float:
            v = body.get(key)
            return default if v is None else float(v)

        bias = body.get("logit_bias") or {}
        return SamplingParams(
            temperature=pick("temperature", 1.0),
            top_p=pick("top_p", 1.0),
            top_k=int(pick("top_k", 0)),
            seed=int(pick("seed", 0)),
            frequency_penalty=pick("frequency_penalty", 0.0),
            presence_penalty=pick("presence_penalty", 0.0),
            logit_bias=tuple(
                (int(k), float(v)) for k, v in bias.items()
            ),
        )


def apply_penalties(
    logits: torch.Tensor,  # [B, V] float32
    counts: torch.Tensor,  # [B, V] occurrences of each token so far
    freq_penalty: torch.Tensor,  # [B]
    pres_penalty: torch.Tensor,  # [B]
    bias: torch.Tensor | None = None,  # [B, V] additive logit bias
) -> torch.Tensor:
    """OpenAI-semantics penalties: logit -= freq·count + pres·(count>0),
    plus per-request logit_bias."""
    countf = counts.float()
    out = (logits - freq_penalty[:, None] * countf
           - pres_penalty[:, None] * (countf > 0).float())
    if bias is not None:
        out = out + bias
    return out


def spec_accept(
    drafts: torch.Tensor,  # [B, D] proposed tokens (-1 = no proposal)
    sampled: torch.Tensor,  # [B, D + 1] model samples per position
    active: torch.Tensor,  # [B] bool slot occupied + below its limit
    budget: torch.Tensor,  # [B] tokens the slot may still emit
) -> tuple[torch.Tensor, torch.Tensor]:
    """Acceptance masks for speculative verification: ``n_acc`` drafts
    whose cumulative match with the model's own samples is unbroken are
    accepted and the sample after them rides along, so a step emits
    ``n_acc + 1`` model-exact tokens, clipped to ``budget`` (the
    page-safety fence). Returns (n_emit [B] int32, emit_mask [B, D + 1]
    bool); everything past the mask was conditioned on a rejected
    draft."""
    n_acc = accept_counts(drafts, sampled)
    n_emit = torch.where(
        active, torch.minimum(n_acc + 1, torch.clamp(budget, min=0)),
        torch.zeros_like(n_acc)).to(torch.int32)
    d_idx = torch.arange(drafts.shape[1] + 1, device=drafts.device)[None, :]
    return n_emit, d_idx < n_emit[:, None]


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _MASK32


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds) on uint32 values held in int64 tensors;
    keys broadcast against the counters."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _MASK32
    x1 = (x1 + k1) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK32
    return x0, x1


def uniform_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """32 random bits per element for a ``[n]`` draw under each row's
    key (``keys [B, 2]``): threefry over the 64-bit flat index
    ``(i >> 32, i & 0xffffffff)``, the two output words XORed."""
    k = keys.long() & _MASK32
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(k[:, 0:1], k[:, 1:2], (idx >> 32)[None],
                          (idx & _MASK32)[None])
    return y0 ^ y1  # [B, n]


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """Standard Gumbel noise ``[B, n]`` in float32:
    -log(-log(u)), u uniform in [tiny, 1) from the mantissa bits."""
    bits = uniform_bits(keys, n)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    f = mant.view(torch.float32) - 1.0
    u = torch.clamp(f * (1.0 - _F32_TINY) + _F32_TINY, min=_F32_TINY)
    return -torch.log(-torch.log(u))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Per-row ``jax.random.categorical(key_b, logits_b)``: argmax of
    logits plus Gumbel noise (first index wins ties, as in JAX)."""
    return torch.argmax(logits + gumbel(keys, logits.shape[-1]), dim=-1)


def sample(
    logits: torch.Tensor,  # [B, V] float32
    keys: torch.Tensor,  # [B, 2] raw [seed, counter] keys (uint32 values)
    temperature: torch.Tensor,  # [B] float32; 0 = greedy
    top_p: torch.Tensor,  # [B] float32
    top_k: torch.Tensor,  # [B] int; 0 = off
) -> torch.Tensor:
    """Returns sampled token ids [B] int32."""
    V = logits.shape[-1]
    # top-k mask: keep the k highest logits (k == 0 → keep all)
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    k_idx = torch.clamp(top_k.long() - 1, 0, V - 1)
    kth = torch.gather(sorted_logits, 1, k_idx[:, None])
    keep_k = (top_k[:, None] <= 0) | (logits >= kth)
    # top-p over the temperature-scaled sorted distribution
    inv_t = 1.0 / torch.clamp(temperature[:, None], min=1e-6)
    probs_sorted = torch.softmax(sorted_logits * inv_t, dim=-1)
    cum = torch.cumsum(probs_sorted, dim=-1)
    keep_sorted = (cum - probs_sorted) < top_p[:, None]
    last_kept = keep_sorted.int().sum(-1) - 1
    thresh = torch.gather(sorted_logits, 1,
                          torch.clamp(last_kept, 0, V - 1).long()[:, None])
    keep_p = (top_p[:, None] >= 1.0) | (logits >= thresh)
    masked = torch.where(keep_k & keep_p, logits,
                         torch.full_like(logits, float("-inf")))
    scaled = masked / torch.clamp(temperature[:, None], min=1e-6)
    sampled = categorical(keys, scaled)
    greedy = torch.argmax(logits, dim=-1)
    return torch.where(temperature <= 0.0, greedy, sampled).to(torch.int32)
