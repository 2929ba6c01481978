"""Multi-LoRA serving: per-slot low-rank adapters, batched (counterpart
of ``aigw_tpu/models/lora.py``).

Adapters live stacked on the device: ``l{i}.{kind}.lora_a`` is
``[n_rows, r, in]`` and ``…lora_b`` is ``[n_rows, out, r]``. Every
sequence of a call carries an adapter row, so one call serves any mix
of adapters:

    delta = (x @ A[idx]ᵀ) @ B[idx]ᵀ      (two thin matmuls per target)

The last row is the all-zeros "no adapter" row: requests without an
adapter point there, and their delta is an exact zero, so base-model
output is exact, not approximate. The α/r scaling is folded into A when
the adapters are made.

The deltas are plain ``torch.matmul``, as the reference computes them in
plain XLA with no Pallas kernel: two matmuls of rank r (16 by default)
beside each projection, a few percent of its work, which cuBLAS does at
the projection's own rate. No TPU kernel covers them, so the port writes
no CUDA kernel for them either; whether a segmented kernel would pay is
measured on the card (``chip_smoke.py``'s ``serve_lora`` line).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class LoRAConfig:
    rank: int = 16
    alpha: float = 32.0
    # matmul targets by weight kind (the classic attention-only default)
    targets: tuple[str, ...] = ("wq", "wv")


_DIMS = {
    "wq": lambda c: (c.dim, c.n_heads * c.head_dim),
    "wk": lambda c: (c.dim, c.n_kv_heads * c.head_dim),
    "wv": lambda c: (c.dim, c.n_kv_heads * c.head_dim),
    "wo": lambda c: (c.n_heads * c.head_dim, c.dim),
    "w_gate": lambda c: (c.dim, c.ffn_dim),
    "w_up": lambda c: (c.dim, c.ffn_dim),
    "w_down": lambda c: (c.ffn_dim, c.dim),
}


def init_lora_adapters(
    seed: int,
    model_cfg,
    lora_cfg: LoRAConfig,
    n_adapters: int,
    dtype: torch.dtype = torch.bfloat16,
    random_b: bool = False,
    device: str | torch.device = "cuda",
) -> dict[str, torch.Tensor]:
    """Stacked adapter weights, ``n_adapters`` rows plus a trailing
    all-zero row, from a seeded ``torch.Generator`` on ``device``.

    B matrices start at zero (the LoRA convention: adapters start as
    no-ops); ``random_b`` fills them, for tests that need visible deltas.
    Both draws of every target are made whatever ``random_b`` is, so A
    is the same in both modes. The scales are the reference's (A
    N(0, 1/in) times alpha / rank, B N(0, 1/r)); the draws differ from
    ``jax.random``'s, and parity tests carry the reference's adapters
    across with ``models.convert``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    scale = lora_cfg.alpha / lora_cfg.rank
    rows = n_adapters + 1  # + the zero row
    out: dict[str, torch.Tensor] = {}
    for i in range(model_cfg.n_layers):
        for kind in lora_cfg.targets:
            d_in, d_out = _DIMS[kind](model_cfg)
            a = torch.randn((rows, lora_cfg.rank, d_in), generator=gen,
                            dtype=torch.float32, device=device) \
                / math.sqrt(d_in) * scale
            b = torch.randn((rows, d_out, lora_cfg.rank), generator=gen,
                            dtype=torch.float32, device=device) \
                / math.sqrt(lora_cfg.rank)
            if not random_b:
                b.zero_()
            a[n_adapters] = 0.0  # the zero row: base-model passthrough
            b[n_adapters] = 0.0
            out[f"l{i}.{kind}.lora_a"] = a.to(dtype)
            out[f"l{i}.{kind}.lora_b"] = b.to(dtype)
    return out


def validate_adapter_params(params: dict, name: str = "") -> None:
    """Fail fast on a malformed adapter dict: every ``X.lora_a`` pairs
    with an ``X.lora_b`` of the same rank, and the other way round, and
    no other key is present (the reference's messages)."""
    label = f"adapter {name!r}: " if name else ""
    for k in params:
        if k.endswith(".lora_a"):
            base = k[: -len(".lora_a")]
            other = base + ".lora_b"
            if other not in params:
                raise ValueError(f"{label}{k} has no matching {other}")
            r_a = params[k].shape[-2]  # [.., r, in]
            r_b = params[other].shape[-1]  # [.., out, r]
            if r_a != r_b:
                raise ValueError(
                    f"{label}rank mismatch for {base}: lora_a rank "
                    f"{r_a} vs lora_b rank {r_b}")
        elif k.endswith(".lora_b"):
            base = k[: -len(".lora_b")]
            if base + ".lora_a" not in params:
                raise ValueError(
                    f"{label}{k} has no matching {base}.lora_a")
        else:
            raise ValueError(
                f"{label}unexpected tensor {k!r} (expected "
                "'<layer>.<kind>.lora_a/.lora_b' keys)")


def lora_delta(
    lora: dict[str, torch.Tensor] | None,
    key: str,
    x: torch.Tensor,  # [B, S, in], or packed rows [T, ..., in]
    idx: torch.Tensor | None,  # [B] adapter row per sequence
    row_seq: torch.Tensor | None = None,  # [T] sequence of each packed row
) -> torch.Tensor | None:
    """Per-sequence adapter contribution for ``x @ W[key]``, or None
    without ``lora`` or ``idx`` or when ``key`` has no adapter. A
    sequence on the base row gets an exact zero.

    Without ``row_seq``, row b of x ``[B, S, in]`` is sequence b. With
    ``row_seq``, x is a packed stream (``[T, 1, in]`` in the ragged
    prefill) whose row t belongs to sequence ``row_seq[t]``. A and B are
    gathered per sequence (``[B, r, in]``, at most ``max_batch_size``
    of them), never per packed row: ``t_all = x @ [A_0; …; A_B-1]ᵀ`` is
    ``[T, B*r]``, each row keeps its own sequence's r columns (the
    others zeroed) and multiplies ``[B_0ᵀ; …]`` laid out ``[B*r, out]``.
    Both products are plain matmuls; the extra columns cost ``B*r``
    (128 at batch 8, rank 16) per target, and no per-token copy of a
    weight is written."""
    if lora is None or idx is None:
        return None
    a = lora.get(key + ".lora_a")
    if a is None:
        return None
    b = lora.get(key + ".lora_b")
    if b is None:
        # half an adapter pair would otherwise surface as a bare
        # KeyError with no tensor name
        raise ValueError(
            f"adapter tensor {key}.lora_b missing while {key}.lora_a "
            "is present (malformed adapter dict)")
    dt = torch.promote_types(x.dtype, a.dtype)
    idx = idx.long()
    a_sel = a[idx].to(dt)  # [B, r, in]
    b_sel = b[idx].to(dt)  # [B, out, r]
    if row_seq is None:
        t = torch.matmul(x.to(dt), a_sel.transpose(1, 2))  # [B, S, r]
        return torch.matmul(t, b_sel.transpose(1, 2))  # [B, S, out]
    *lead, d_in = x.shape
    n_seq, r, _ = a_sel.shape
    xt = x.reshape(-1, d_in).to(dt)
    t_all = xt @ a_sel.reshape(n_seq * r, d_in).T  # [T, B*r]
    # the r columns of each row's own sequence
    cols = (row_seq.long()[:, None] * r
            + torch.arange(r, device=x.device)[None, :])  # [T, r]
    kept = torch.zeros_like(t_all).scatter_(1, cols,
                                            t_all.gather(1, cols))
    out = kept @ b_sel.transpose(1, 2).reshape(n_seq * r, -1)  # [T, out]
    return out.reshape(*lead, -1)
