"""Partition specs and this rank's shards (counterpart of
``aigw_tpu/parallel/sharding.py``).

The specs are the reference's, over the reference's ``[in, out]``
layout and names (``models/convert.py``): column-parallel
in-projections (``wq``/``wk``/``wv``, ``w_gate``/``w_up``) shard their
output dimension over ``tp``, row-parallel out-projections (``wo``,
``w_down``) their input dimension, the embedding and the lm_head the
vocabulary, and the paged KV pool its KV heads. A spec is a tuple with
one entry per dimension: an axis name, or None (replicated). No spec
names ``sp``, as none of the reference's does: the ranks along ``sp``
hold the same weights and the same pool (each rank of a
sequence-parallel prefill scatters every K/V row of the chunk into its
own copy), so a rank's weight bytes are its ``tp``/``ep`` shard's.

Where the reference places each leaf with ``jax.device_put`` and lets
GSPMD insert the collectives, ``shard_params`` slices this rank's shard
out of the full tensor, and the rank-local model (``models/llama.py``,
``models/mixtral.py`` with ``mesh=``) issues them: one all-reduce after
``wo`` and one after ``w_down`` (over ``tp``, or ``tp`` x ``ep`` after
the experts), a masked embedding lookup summed over ``tp``, and the
vocab-sharded logits gathered over ``tp``.

Quantized leaves follow the reference's engine (``Engine.__init__``'s
``spec_for``): ``name.q`` shards like its base matrix, ``name.scale``
only on the axes where it has extent and that divide. int4 weights pack
two values a byte along the input axis, so a row-parallel split falls
on whole bytes, and it must fall on whole scale groups too: a split
inside a group (whose scale row the reference replicates and GSPMD
resolves) raises here.
"""

from __future__ import annotations

import torch

Spec = tuple  # one entry per dimension: an axis name or None


def llama_param_specs(cfg) -> dict[str, Spec]:
    specs: dict[str, Spec] = {
        # vocab-sharded embedding + head (logits gathered over tp)
        "embed": ("tp", None),
        "norm_f": (None,),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = (None, "tp")
    for i in range(cfg.n_layers):
        specs[f"l{i}.attn_norm"] = (None,)
        specs[f"l{i}.wq"] = (None, "tp")  # column parallel (heads)
        specs[f"l{i}.wk"] = (None, "tp")
        specs[f"l{i}.wv"] = (None, "tp")
        if getattr(cfg, "attn_bias", False):
            specs[f"l{i}.bq"] = ("tp",)
            specs[f"l{i}.bk"] = ("tp",)
            specs[f"l{i}.bv"] = ("tp",)
        specs[f"l{i}.wo"] = ("tp", None)  # row parallel
        specs[f"l{i}.mlp_norm"] = (None,)
        specs[f"l{i}.w_gate"] = (None, "tp")
        specs[f"l{i}.w_up"] = (None, "tp")
        specs[f"l{i}.w_down"] = ("tp", None)
    return specs


def mixtral_param_specs(cfg) -> dict[str, Spec]:
    """Expert stacks ``[E, D, F]`` shard experts over ``ep`` and the FFN
    width over ``tp``; the router is replicated."""
    specs: dict[str, Spec] = {
        "embed": ("tp", None),
        "norm_f": (None,),
        "lm_head": (None, "tp"),
    }
    for i in range(cfg.n_layers):
        specs[f"l{i}.attn_norm"] = (None,)
        specs[f"l{i}.wq"] = (None, "tp")
        specs[f"l{i}.wk"] = (None, "tp")
        specs[f"l{i}.wv"] = (None, "tp")
        specs[f"l{i}.wo"] = ("tp", None)
        specs[f"l{i}.mlp_norm"] = (None,)
        specs[f"l{i}.gate"] = (None, None)  # router: tiny, replicated
        specs[f"l{i}.w_gate"] = ("ep", None, "tp")
        specs[f"l{i}.w_up"] = ("ep", None, "tp")
        specs[f"l{i}.w_down"] = ("ep", "tp", None)
    return specs


def kv_cache_spec() -> Spec:
    """[L, 2, slots, n_kv_heads, head_dim]: KV heads over tp."""
    return (None, None, None, "tp", None)


def param_specs(cfg) -> dict[str, Spec]:
    """The family's specs (Mixtral's when the config has experts)."""
    if hasattr(cfg, "n_experts"):
        return mixtral_param_specs(cfg)
    return llama_param_specs(cfg)


def leaf_spec(key: str, value: torch.Tensor, specs: dict[str, Spec],
              shape: dict[str, int]) -> Spec:
    """The spec of one (possibly quantized) leaf: the reference engine's
    ``spec_for``. ``.q`` shards like its base; ``.scale`` keeps the
    base's axes only where it has extent and the axis divides it."""
    if key.endswith(".q"):
        return specs[key[:-2]]
    if key.endswith(".scale"):
        base = specs[key[:-len(".scale")]]
        return tuple(
            ax if (ax is not None and value.shape[i] > 1
                   and value.shape[i] % shape[ax] == 0) else None
            for i, ax in enumerate(base))
    return specs[key]


def _slice(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's shard of ``t`` under ``spec``: a copy where an axis
    cuts it (the full tensor can be freed), ``t`` itself where it is
    replicated on this mesh (the ranks along ``sp`` hold whole weights:
    a copy would double them)."""
    cut = False
    for dim, ax in enumerate(spec):
        if ax is None or mesh.shape[ax] == 1:
            continue
        n = mesh.shape[ax]
        if t.shape[dim] % n:
            raise ValueError(f"dimension {dim} ({t.shape[dim]}) does not "
                             f"divide over {ax}={n}")
        w = t.shape[dim] // n
        t = t.narrow(dim, mesh.axis_index(ax) * w, w)
        cut = True
    return t.contiguous().clone() if cut else t.contiguous()


def shard_param(key: str, value: torch.Tensor, cfg, mesh,
                params: dict[str, torch.Tensor] | None = None
                ) -> torch.Tensor:
    """One leaf's shard. ``params`` (the whole dict) lets an int4
    ``.q`` check its scale's groups."""
    specs = param_specs(cfg)
    spec = leaf_spec(key, value, specs, mesh.shape)
    if (key.endswith(".q") and value.dtype == torch.uint8
            and params is not None):
        scale = params[key[:-2] + ".scale"]
        sspec = leaf_spec(key[:-2] + ".scale", scale, specs, mesh.shape)
        ax = spec[-2]
        if ax is not None and scale.shape[-2] > 1 and sspec[-2] is None:
            raise ValueError(
                f"{key}: {scale.shape[-2]} int4 scale groups do not "
                f"divide over {ax}={mesh.shape[ax]}; a row-parallel "
                "split must fall on whole groups")
    return _slice(value, spec, mesh)


def shard_params(params: dict[str, torch.Tensor], cfg, mesh
                 ) -> dict[str, torch.Tensor]:
    """This rank's shard of every leaf (bf16, W8A16 or W4A16), copies:
    the caller's full tensors can be freed."""
    return {key: shard_param(key, value, cfg, mesh, params)
            for key, value in params.items()}


def shard_pool_heads(t: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """This rank's KV heads of a pool-layout tensor (heads at ``dim``)."""
    spec = [None] * t.ndim
    spec[dim] = "tp"
    return _slice(t, tuple(spec), mesh)


def analytical_ici_bytes_per_token(cfg, mesh, dtype_bytes: int = 2) -> int:
    """Analytical collective volume of ONE decoded token on a
    tensor-parallel mesh, in bytes per device (the reference's formula,
    ``/state``'s ``ici_bytes_per_token``): two ring all-reduces of a
    ``[dim]`` activation per layer (``2 (tp - 1) / tp`` of the buffer
    each), one gather of a ``[vocab]`` logits row (``(tp - 1) / tp``),
    and with experts a dispatch and a combine all-to-all per layer
    (``(ep - 1) / ep`` of a ``[dim]`` activation each). The port's
    experts combine by an all-reduce instead; the figure is the
    reference's, copied as it is. 0 without a mesh. On one host the
    collectives ride NVLink, not ICI; the key keeps its name."""
    if mesh is None:
        return 0
    tp = int(mesh.shape.get("tp", 1))
    ep = int(mesh.shape.get("ep", 1))
    total = 0.0
    if tp > 1:
        ring = 2.0 * (tp - 1) / tp
        total += cfg.n_layers * 2 * cfg.dim * dtype_bytes * ring
        total += cfg.vocab_size * dtype_bytes * (tp - 1) / tp
    if ep > 1 and getattr(cfg, "n_experts", 0):
        total += cfg.n_layers * 2 * cfg.dim * dtype_bytes * (ep - 1) / ep
    return int(total)

