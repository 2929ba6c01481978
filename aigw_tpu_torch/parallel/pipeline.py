"""Pipeline parallelism: GPipe-style microbatched stages (counterpart of
``aigw_tpu/parallel/pipeline.py``).

The layers split into ``pp`` contiguous stages, one per rank along the
mesh's ``pp`` axis. Stage 0 embeds each microbatch; every stage runs its
layers over it and sends the activations to the next stage
(``torch.distributed`` ``send`` / ``recv``, where the reference's SPMD
program shifts them with ``lax.ppermute``); the last stage takes the
final norm and the head, and its logits are gathered to rank 0. A stage
works microbatch by microbatch, so stage s runs microbatch m while stage
s + 1 runs m - 1: the ``M + pp - 1`` steps of the reference's schedule.

Not on the serving path, as in the reference: it scores full contexts
(prefill or batch scoring) of models too deep for one device. The
dense causal attention of each stage is ``models/llama._attention``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from aigw_tpu_torch.models import llama

_STAGE_KEYS = (
    "attn_norm", "wq", "wk", "wv", "wo", "mlp_norm",
    "w_gate", "w_up", "w_down",
)


def stack_stage_params(params: dict[str, torch.Tensor], cfg,
                       pp: int) -> dict[str, torch.Tensor]:
    """Flat per-layer dict → per-kind tensors ``[pp, layers_per_stage,
    ...]``."""
    if cfg.n_layers % pp != 0:
        raise ValueError(f"n_layers {cfg.n_layers} not divisible by pp={pp}")
    lps = cfg.n_layers // pp
    out: dict[str, torch.Tensor] = {}
    for kind in _STAGE_KEYS:
        stacked = torch.stack(
            [params[f"l{i}.{kind}"] for i in range(cfg.n_layers)])
        out[kind] = stacked.reshape(pp, lps, *stacked.shape[1:])
    return out


def _stage_forward(stage: dict[str, torch.Tensor], cfg, x: torch.Tensor,
                   positions: torch.Tensor, mask: torch.Tensor
                   ) -> torch.Tensor:
    """This stage's layers over activations ``x [mb, S, D]`` (the
    reference's ``_stage_forward``)."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    for j in range(stage["wq"].shape[0]):
        w = {k: v[j] for k, v in stage.items()}
        h = llama.rms_norm(x, w["attn_norm"], cfg.norm_eps)
        q = (h @ w["wq"]).reshape(B, S, cfg.n_heads, hd)
        k = (h @ w["wk"]).reshape(B, S, cfg.n_kv_heads, hd)
        v = (h @ w["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
        q = llama.rope(q, positions, cfg.rope_theta)
        k = llama.rope(k, positions, cfg.rope_theta)
        x = x + llama._attention(q, k, v, mask) @ w["wo"]
        h = llama.rms_norm(x, w["mlp_norm"], cfg.norm_eps)
        gate = F.silu(h @ w["w_gate"])
        x = x + (gate * (h @ w["w_up"])) @ w["w_down"]
    return x


def pipeline_logits(params: dict[str, torch.Tensor], cfg,
                    tokens: torch.Tensor, *, mesh, pp: int,
                    microbatch: int) -> torch.Tensor | None:
    """Full-context logits ``[B, S, V]`` (float32) of ``tokens [B, S]``
    through a ``pp``-stage pipeline; every rank of the ``pp`` axis calls
    it with the same arguments (the full ``params``: each keeps its
    stage). Returns the logits on rank 0 and None on the other ranks."""
    B, S = tokens.shape
    if B % microbatch != 0:
        raise ValueError(f"batch {B} not divisible by microbatch {microbatch}")
    if mesh.shape["pp"] != pp:
        raise ValueError(f"pp={pp} but the mesh's pp axis is "
                         f"{mesh.shape['pp']}")
    M = B // microbatch
    s_idx = mesh.axis_index("pp")
    ranks = mesh.axis_ranks("pp")
    stage = {k: v[s_idx] for k, v in
             stack_stage_params(params, cfg, pp).items()}
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    dev = mesh.device
    positions = torch.arange(S, device=dev)[None, :].expand(microbatch, S)
    mask = positions[:, :, None] >= positions[:, None, :]
    mb_tokens = tokens.to(dev).reshape(M, microbatch, S)
    D = params["embed"].shape[1]
    last = s_idx == pp - 1
    outs = []
    for m in range(M):
        if s_idx == 0:
            x = params["embed"][mb_tokens[m].long()]
        else:
            x = torch.empty((microbatch, S, D), dtype=params["embed"].dtype,
                            device=dev)
            dist.recv(x, src=ranks[s_idx - 1])
        y = _stage_forward(stage, cfg, x, positions, mask)
        if last:
            final = llama.rms_norm(y, params["norm_f"], cfg.norm_eps)
            outs.append((final @ head).float())
        else:
            dist.send(y.contiguous(), dst=ranks[s_idx + 1])
    if last:
        logits = torch.stack(outs).reshape(B, S, -1)
        if mesh.rank == 0:
            return logits
        dist.send(logits, dst=0)
        return None
    if mesh.rank == 0:
        logits = torch.empty((B, S, head.shape[1]), dtype=torch.float32,
                             device=dev)
        dist.recv(logits, src=ranks[-1])
        return logits
    return None
