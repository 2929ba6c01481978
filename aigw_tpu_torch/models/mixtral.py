"""Mixtral-family (sparse mixture of experts) transformer in PyTorch
(counterpart of ``aigw_tpu/models/mixtral.py``).

The attention skeleton is the llama family's (``models/llama.py``, with
its kernels); only the MLP differs, plugged into the skeleton's
``mlp=`` hook: a top-k mixture of experts with a fixed expert capacity.

    router logits (float32) → top-k → softmax over the chosen k →
    position of each (token, k) inside its expert (a cumulative count
    over the flattened token-major (t, k) order) → the capacity fence
    drops positions ≥ C → expert MLP over a static [E, C, D] buffer →
    each token's kept outputs summed with their weights (float32)

A dropped assignment leaves the token its other expert and the residual.
The reference computes dispatch and combine as dense ``[T, E, C]``
one-hot einsums; here rows are scattered into the buffer and gathered
back by index, which gives the same values (each buffer element is one
x value, each output element one sum of at most k products). The
``[E, C, D]`` buffer keeps the reference's static shape all the same:
no shape in the layer depends on the routing, so a step stays
capturable in a CUDA graph.

Expert weights are ``[E, in, out]`` stacks resolved through
``llama._w`` as in the reference: a W8A16 or W4A16 stack is dequantized
to bf16 at each call (the reference's experts do not go through its
quantized-matmul kernel either).

Entry points (``prefill_ragged``, ``prefill``, ``prefill_suffix``,
``prefill_sp``, ``prefill_sp_suffix``, ``decode_step`` on every rung,
``verify_step``) delegate to the llama skeleton; with ``moe_stats=True``
they also return an ``[L, E + 1]`` int32 leaf: per layer, the (token, k)
assignments placed on each expert, then the count the fence dropped,
over every row the call ran (padding rows included, as the reference
counts them). ``hidden_states`` keeps no tape, as in the reference.

**In a sequence-parallel prefill** each ``sp`` rank routes only its rows,
but the fence is the reference's over the whole chunk: the capacity is
computed from the global row count, and an assignment's position inside
its expert counts every assignment before it in the global token order,
so each rank adds, per sequence row and expert, the counts of the other
ranks' rows that come before its own (one all-gather of ``[B, E]``
counts per layer). The routing tape's counts are summed over ``sp``
before they are returned, so every rank returns the reference's. A rank
runs the experts over a buffer of its own rows (``min(C, T_local)`` per
expert).

**On an ``ep`` x ``tp`` mesh** (``mesh=``) the router is replicated and
each rank holds E/ep experts and F/tp of their columns
(``parallel/sharding.mixtral_param_specs``). Every rank routes every row
and runs the capacity fence on the same routing, so the routing counts
are the same on every rank; it runs the experts it holds on their
buffer rows, combines what they give in float32, and an all-reduce over
``tp`` x ``ep`` sums the ranks' partial outputs. The reference's GSPMD
turns the dispatch and combine into all-to-alls instead; the sums are
the same.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from aigw_tpu_torch.models import llama
from aigw_tpu_torch.models.llama import LlamaConfig
from aigw_tpu_torch.ops.ring_attention import gather_blocks


@dataclass(frozen=True)
class MixtralConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14336
    n_experts: int = 8
    experts_per_token: int = 2
    capacity_factor: float = 2.0
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    max_seq_len: int = 32768

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def as_llama(self) -> LlamaConfig:
        """The attention-relevant view the shared skeleton reads."""
        return LlamaConfig(
            vocab_size=self.vocab_size, dim=self.dim,
            n_layers=self.n_layers, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, ffn_dim=self.ffn_dim,
            rope_theta=self.rope_theta, norm_eps=self.norm_eps,
            max_seq_len=self.max_seq_len)


# the reference's presets: Mixtral-8x7B's published widths and the tiny
# test config
MIXTRAL_8X7B = MixtralConfig()
TINY_MOE = MixtralConfig(
    vocab_size=512, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
    ffn_dim=128, n_experts=4, experts_per_token=2, max_seq_len=512,
    rope_theta=10000.0,
)


def iter_params(seed: int, cfg: MixtralConfig, dtype=torch.bfloat16,
                device: str | torch.device = "cuda"):
    """Random weights under the reference's names and shapes, yielded as
    ``(name, tensor)`` one at a time in ``init_params``' order (a caller
    can quantize each as it is drawn: Mixtral-8x7B in bf16 does not fit
    one 80 GB card). Scales are the reference's: dense weights N(0,
    1/in), embeddings N(0, 0.02²), norms one. An expert stack is drawn
    one expert at a time, so the float32 draw never exceeds one
    expert's matrix."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def dense(shape, scale=None):
        scale = scale or 1.0 / math.sqrt(shape[-2] if len(shape) > 1
                                         else shape[0])
        w = torch.empty(shape, dtype=dtype, device=device)
        for row in w.view(-1, *shape[-2:]):
            row.copy_(torch.randn(shape[-2:], generator=gen,
                                  dtype=torch.float32, device=device)
                      * scale)
        return w

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=device)

    yield "embed", dense((cfg.vocab_size, cfg.dim), scale=0.02)
    yield "norm_f", ones(cfg.dim)
    yield "lm_head", dense((cfg.dim, cfg.vocab_size))
    hd = cfg.head_dim
    E = cfg.n_experts
    for i in range(cfg.n_layers):
        yield f"l{i}.attn_norm", ones(cfg.dim)
        yield f"l{i}.wq", dense((cfg.dim, cfg.n_heads * hd))
        yield f"l{i}.wk", dense((cfg.dim, cfg.n_kv_heads * hd))
        yield f"l{i}.wv", dense((cfg.dim, cfg.n_kv_heads * hd))
        yield f"l{i}.wo", dense((cfg.n_heads * hd, cfg.dim))
        yield f"l{i}.mlp_norm", ones(cfg.dim)
        yield f"l{i}.gate", dense((cfg.dim, E))
        yield f"l{i}.w_gate", dense((E, cfg.dim, cfg.ffn_dim))
        yield f"l{i}.w_up", dense((E, cfg.dim, cfg.ffn_dim))
        yield f"l{i}.w_down", dense((E, cfg.ffn_dim, cfg.dim))


def init_params(seed: int, cfg: MixtralConfig, dtype=torch.bfloat16,
                device: str | torch.device = "cuda"
                ) -> dict[str, torch.Tensor]:
    """Every weight of ``iter_params`` at once."""
    return dict(iter_params(seed, cfg, dtype, device))


def capacity(tokens: int, cfg: MixtralConfig) -> int:
    """Slots per expert for a call over ``tokens`` rows (the reference's
    expression): ``capacity_factor`` times the even share, at least k,
    at most every row."""
    K = cfg.experts_per_token
    C = max(K, int(math.ceil(tokens * K / cfg.n_experts
                             * cfg.capacity_factor)))
    return min(C, tokens)


def top_k(logits: torch.Tensor, k: int) -> tuple[torch.Tensor,
                                                 torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, equal
    values in ascending index order (``torch.topk`` promises no order
    for ties, and its CPU and CUDA orders differ)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_mlp(p: dict[str, torch.Tensor], i: int, x: torch.Tensor,
            cfg: MixtralConfig, stats: list | None = None,
            mesh=None, sp: bool = False) -> torch.Tensor:
    """Top-k sparse MLP of layer ``i`` over every row of x ``[..., D]``
    (T rows in all, padding included), as the reference's
    ``mixtral.moe_mlp``. With ``stats`` (a list), appends the layer's
    ``[E + 1]`` int32 routing counts: placed per expert, then
    dropped. On a mesh, this rank's experts and columns, summed over
    ``tp`` x ``ep``. ``sp``: x ``[B, S/n, D]`` is this rank's share of a
    sequence-parallel chunk, fenced as the whole chunk is (the module
    docstring); its counts are this rank's."""
    *lead, D = x.shape
    T = math.prod(lead)
    E, K = cfg.n_experts, cfg.experts_per_token
    n_sp = mesh.shape["sp"] if sp else 1
    C = capacity(T * n_sp, cfg)
    xt = x.reshape(T, D)

    logits = xt.float() @ p[f"l{i}.gate"].float()
    topv, topi = top_k(logits, K)  # [T, K]
    weights = torch.softmax(topv, dim=-1)  # over the chosen experts
    expert = topi.reshape(T * K)  # token-major (t, k) order
    choice = F.one_hot(expert, E).to(torch.int32)  # [T * K, E]
    # each (t, k)'s position inside its expert: the assignments to the
    # same expert before it
    pos = (torch.cumsum(choice, 0, dtype=torch.int32) - choice).gather(
        1, expert[:, None])[:, 0]
    # the buffer rows per expert: the fence's C, or in a sequence-
    # parallel chunk this rank's rows (a kept assignment's local
    # position is below both)
    Cb = C
    local = pos
    if n_sp > 1:
        pos = pos + _sp_offsets(choice, lead[0], expert, mesh)
        Cb = min(C, T)
    keep = pos < C  # the capacity fence
    if stats is not None:
        placed = (choice * keep[:, None]).sum(0)
        dropped = (~keep).sum()[None]
        stats.append(torch.cat([placed, dropped]).to(torch.int32))

    # dispatch: a kept (t, k) copies row t into buffer row e * Cb +
    # local; a dropped one writes the spare row E * Cb, which is cut off
    dest = torch.where(keep, expert * Cb + local,
                       torch.full_like(pos, E * Cb))
    src = torch.arange(T, device=x.device).repeat_interleave(K)
    buf = torch.zeros((E * Cb + 1, D), dtype=x.dtype, device=x.device)
    buf[dest] = xt[src]
    xe = buf[:E * Cb].view(E, Cb, D)
    if mesh is not None:
        return _moe_local(p, i, x, xe, expert, local, keep, weights,
                          Cb, mesh)
    # the expert MLP; each dequantized stack is freed before the next
    gate = F.silu(llama._mm(xe, llama._w(p, f"l{i}.w_gate")))
    h = gate * llama._mm(xe, llama._w(p, f"l{i}.w_up"))
    del gate
    ye = llama._mm(h, llama._w(p, f"l{i}.w_down"))
    del h
    # combine in float32: each token's kept outputs times their weights
    rows = ye.reshape(E * Cb, D).float()[torch.clamp(dest,
                                                     max=E * Cb - 1)]
    contrib = torch.where(keep[:, None],
                          rows * weights.reshape(T * K, 1), 0.0)
    out = contrib.view(T, K, D).sum(1)
    return out.to(x.dtype).view(*lead, D)


def _sp_offsets(choice: torch.Tensor, B: int, expert: torch.Tensor,
                mesh) -> torch.Tensor:
    """Per assignment of this rank's ``[B, S/n]`` rows, the assignments
    to its expert that the global ``[B, S]`` token order puts before it
    and this rank does not hold: every other rank's in earlier sequence
    rows, and the lower ``sp`` ranks' in its own row. ``choice`` is the
    ``[T K, E]`` one-hot of ``expert``."""
    E = choice.shape[1]
    counts = choice.view(B, -1, E).sum(1)  # [B, E] this rank's
    every = gather_blocks(counts, mesh, "sp")  # [n, B, E]
    r = mesh.axis_index("sp")
    others = every.sum(0) - counts
    before_rows = torch.cumsum(others, 0) - others
    off = before_rows + every[:r].sum(0)  # [B, E]
    row = torch.arange(B, device=choice.device).repeat_interleave(
        choice.shape[0] // B)
    return off[row, expert].to(torch.int32)


def _moe_local(p, i, x, xe, expert, pos, keep, weights, C: int, mesh):
    """The experts this rank holds over their buffer rows ``xe[e_lo:
    e_hi]``, combined in float32 and summed over ``tp`` x ``ep``."""
    *lead, D = x.shape
    T, K = weights.shape
    w = p.get(f"l{i}.w_gate.q")
    n_local = (p[f"l{i}.w_gate"] if w is None else w).shape[0]
    lo = mesh.axis_index("ep") * n_local
    xl = xe[lo:lo + n_local]
    gate = F.silu(llama._mm(xl, llama._w(p, f"l{i}.w_gate")))
    h = gate * llama._mm(xl, llama._w(p, f"l{i}.w_up"))
    del gate
    ye = llama._mm(h, llama._w(p, f"l{i}.w_down"))
    del h
    mine = keep & (expert >= lo) & (expert < lo + n_local)
    row = torch.where(mine, (expert - lo) * C + pos, torch.zeros_like(pos))
    rows = ye.reshape(n_local * C, D).float()[row]
    contrib = torch.where(mine[:, None],
                          rows * weights.reshape(T * K, 1), 0.0)
    out = mesh.all_reduce(contrib.view(T, K, D).sum(1), "tp", "ep")
    return out.to(x.dtype).view(*lead, D)


def _mlp_fn(cfg: MixtralConfig, stats: list | None, mesh=None,
            sp: bool = False):
    return lambda p, i, x, plain: moe_mlp(p, i, x, cfg, stats, mesh, sp)


def _with_moe(out, stats: list | None):
    """(logits, pool) → (logits, pool, [L, E + 1] stats) when asked."""
    if stats is None:
        return out
    logits, kv_cache = out
    return logits, kv_cache, torch.stack(stats)


# LoRA is llama-family-only, as in the reference: the entry points take
# ``lora`` and ``adapter_idx`` for interface parity and ignore them (the
# MoE layer gets no deltas, and neither do the projections).


def prefill_ragged(p, cfg: MixtralConfig, tokens, row_seq, positions,
                   last_rows, kv_cache, page_table, page_size, *,
                   plain=False, moe_stats=False, lora=None,
                   adapter_idx=None, mesh=None):
    stats: list | None = [] if moe_stats else None
    return _with_moe(llama.prefill_ragged(
        p, cfg.as_llama(), tokens, row_seq, positions, last_rows, kv_cache,
        page_table, page_size, plain=plain, mlp=_mlp_fn(cfg, stats, mesh),
        mesh=mesh), stats)


def prefill(p, cfg: MixtralConfig, tokens, seq_lens, kv_cache, page_table,
            page_size, *, plain=False, moe_stats=False, lora=None,
            adapter_idx=None, mesh=None):
    stats: list | None = [] if moe_stats else None
    return _with_moe(llama.prefill(
        p, cfg.as_llama(), tokens, seq_lens, kv_cache, page_table,
        page_size, plain=plain, mlp=_mlp_fn(cfg, stats, mesh),
        mesh=mesh), stats)


def prefill_suffix(p, cfg: MixtralConfig, tokens, prefix_lens, seq_lens,
                   kv_cache, page_table, page_size, *, plain=False,
                   moe_stats=False, lora=None, adapter_idx=None,
                   mesh=None):
    stats: list | None = [] if moe_stats else None
    return _with_moe(llama.prefill_suffix(
        p, cfg.as_llama(), tokens, prefix_lens, seq_lens, kv_cache,
        page_table, page_size, plain=plain, mlp=_mlp_fn(cfg, stats, mesh),
        mesh=mesh), stats)


def _sp_moe(out, stats: list | None, mesh):
    """``_with_moe`` with the ranks' routing counts summed over
    ``sp``."""
    out = _with_moe(out, stats)
    if stats is not None:
        mesh.all_reduce(out[2], "sp")
    return out


def prefill_sp(p, cfg: MixtralConfig, tokens, seq_lens, kv_cache,
               page_table, page_size, *, mesh, strategy="ring", plain=False,
               moe_stats=False, lora=None, adapter_idx=None):
    stats: list | None = [] if moe_stats else None
    return _sp_moe(llama.prefill_sp(
        p, cfg.as_llama(), tokens, seq_lens, kv_cache, page_table,
        page_size, mesh=mesh, strategy=strategy, plain=plain,
        mlp=_mlp_fn(cfg, stats, mesh, sp=True)), stats, mesh)


def prefill_sp_suffix(p, cfg: MixtralConfig, tokens, prefix_lens, seq_lens,
                      kv_cache, page_table, page_size, *, mesh, plain=False,
                      moe_stats=False, lora=None, adapter_idx=None):
    stats: list | None = [] if moe_stats else None
    return _sp_moe(llama.prefill_sp_suffix(
        p, cfg.as_llama(), tokens, prefix_lens, seq_lens, kv_cache,
        page_table, page_size, mesh=mesh, plain=plain,
        mlp=_mlp_fn(cfg, stats, mesh, sp=True)), stats, mesh)


def hidden_states(p, cfg: MixtralConfig, tokens, seq_lens, *, plain=False,
                  lora=None, adapter_idx=None, mesh=None):
    return llama.hidden_states(p, cfg.as_llama(), tokens, seq_lens,
                               plain=plain, mlp=_mlp_fn(cfg, None, mesh),
                               mesh=mesh)


def decode_step(p, cfg: MixtralConfig, tokens, positions, kv_cache,
                page_table, page_size, active, attn_impl="fused", *,
                plain=False, moe_stats=False, lora=None, adapter_idx=None,
                mesh=None):
    stats: list | None = [] if moe_stats else None
    return _with_moe(llama.decode_step(
        p, cfg.as_llama(), tokens, positions, kv_cache, page_table,
        page_size, active, attn_impl, plain=plain,
        mlp=_mlp_fn(cfg, stats, mesh), mesh=mesh), stats)


def verify_step(p, cfg: MixtralConfig, tokens, positions, kv_cache,
                page_table, page_size, active, limits, attn_impl="", *,
                plain=False, moe_stats=False, lora=None, adapter_idx=None,
                mesh=None):
    stats: list | None = [] if moe_stats else None
    return _with_moe(llama.verify_step(
        p, cfg.as_llama(), tokens, positions, kv_cache, page_table,
        page_size, active, limits, attn_impl, plain=plain,
        mlp=_mlp_fn(cfg, stats, mesh), mesh=mesh), stats)
