"""Random weights from the run's seed, drawn on the device in the types
they are served in, a layer at a time in a few large calls.

Both the program and the reference read these tensors; neither derives
them from the other. A configuration file of ``portbench/configs/``
names the family (``llama`` or ``mixtral``), its widths, the served
type (``quantization``: absent for bfloat16, ``int8`` for W8A16) and,
under ``assumed``, the scales drawn here. The layout is the port's
parameter dict: matrices ``[in, out]`` (``[E, in, out]`` for an expert
stack) under the names ``embed``, ``lm_head``, ``norm_f`` and
``l{i}.wq`` ...; a W8A16 matrix is ``name.q`` (int8) with ``name.scale``
(float32, one per output channel, ``[..., 1, out]``; one per row of the
embedding, ``[V, 1]``).
"""

from __future__ import annotations

import math

import torch

#: standard deviation of int8 values drawn uniformly from [-127, 127]
_INT8_STD = math.sqrt((255 ** 2 - 1) / 12)


def dims(cfg: dict) -> dict:
    """The widths the weights need, under short names."""
    D, H, Hkv = (cfg["hidden_size"], cfg["num_attention_heads"],
                 cfg["num_key_value_heads"])
    return {"D": D, "H": H, "Hkv": Hkv, "hd": D // H,
            "F": cfg["intermediate_size"], "V": cfg["vocab_size"],
            "L": cfg["num_hidden_layers"],
            "E": cfg.get("num_local_experts", 0),
            "K": cfg.get("num_experts_per_tok", 0)}


def _matrices(cfg: dict) -> list[tuple[str, tuple[int, ...]]]:
    """One layer's matrices, (name suffix, shape)."""
    d = dims(cfg)
    D, hd, F = d["D"], d["hd"], d["F"]
    out = [("wq", (D, d["H"] * hd)), ("wk", (D, d["Hkv"] * hd)),
           ("wv", (D, d["Hkv"] * hd)), ("wo", (d["H"] * hd, D))]
    lead = (d["E"],) if cfg["family"] == "mixtral" else ()
    out += [("w_gate", (*lead, D, F)), ("w_up", (*lead, D, F)),
            ("w_down", (*lead, F, D))]
    return out


def _vectors(cfg: dict) -> list[tuple[str, int, str]]:
    """One layer's vectors: (name suffix, length, kind)."""
    d = dims(cfg)
    out = [("attn_norm", d["D"], "norm"), ("mlp_norm", d["D"], "norm")]
    if cfg.get("qkv_bias"):
        out += [("bq", d["H"] * d["hd"], "bias"),
                ("bk", d["Hkv"] * d["hd"], "bias"),
                ("bv", d["Hkv"] * d["hd"], "bias")]
    return out


def _split(flat: torch.Tensor, shapes) -> list[torch.Tensor]:
    out, o = [], 0
    for shape in shapes:
        n = math.prod(shape)
        out.append(flat[o:o + n].view(shape))
        o += n
    return out


def _bf16_dense(shape, gen, dev, scale: float) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.bfloat16, device=dev)
    return w.mul_(scale)


def _int8_scales(shape, gen, dev, std: float) -> torch.Tensor:
    """float32 scales for int8 values uniform in [-127, 127], so that
    the products have standard deviation ``std`` times U(0.75, 1.25),
    rounded to bfloat16 (exact in either type's product)."""
    s = torch.rand(shape, generator=gen, device=dev).mul_(0.5).add_(0.75)
    return (s * (std / _INT8_STD)).to(torch.bfloat16).float()


def _int8_dense(shape, gen, dev, std: float, per_row: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale float32): one scale per output channel, or per
    row when ``per_row``."""
    q = torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8,
                      device=dev)
    sshape = (shape[0], 1) if per_row else (*shape[:-2], 1, shape[-1])
    return q, _int8_scales(sshape, gen, dev, std)


def make(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The configuration's weights from ``seed`` on ``device``."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d = dims(cfg)
    int8 = cfg.get("quantization") == "int8"
    p: dict[str, torch.Tensor] = {}
    if int8:
        p["embed.q"], p["embed.scale"] = _int8_dense(
            (d["V"], d["D"]), gen, dev, 0.02, per_row=True)
        p["lm_head.q"], p["lm_head.scale"] = _int8_dense(
            (d["D"], d["V"]), gen, dev, 1 / math.sqrt(d["D"]))
    else:
        p["embed"] = _bf16_dense((d["V"], d["D"]), gen, dev, 0.02)
        p["lm_head"] = _bf16_dense((d["D"], d["V"]), gen, dev,
                                   1 / math.sqrt(d["D"]))
    p["norm_f"] = _norms(d["D"], gen, dev)
    mats = _matrices(cfg)
    vecs = _vectors(cfg)
    for i in range(d["L"]):
        if int8:
            # one draw for every int8 value of the layer, one for scales
            n = sum(math.prod(s) for _, s in mats)
            flat = torch.randint(-127, 128, (n,), generator=gen,
                                 dtype=torch.int8, device=dev)
            for (name, shape), q in zip(mats, _split(
                    flat, [s for _, s in mats])):
                p[f"l{i}.{name}.q"] = q
                p[f"l{i}.{name}.scale"] = _int8_scales(
                    (*shape[:-2], 1, shape[-1]), gen, dev,
                    1 / math.sqrt(shape[-2]))
        else:
            n = sum(math.prod(s) for _, s in mats)
            flat = torch.randn((n,), generator=gen, dtype=torch.bfloat16,
                               device=dev)
            for (name, shape), w in zip(mats, _split(
                    flat, [s for _, s in mats])):
                p[f"l{i}.{name}"] = w.mul_(1 / math.sqrt(shape[-2]))
        flat = torch.randn((sum(n for _, n, _ in vecs),), generator=gen,
                           dtype=torch.float32, device=dev)
        for (name, _n, kind), v in zip(vecs, _split(
                flat, [(n,) for _, n, _ in vecs])):
            # biases N(0, 0.05^2); norm scales U(0.8, 1.2) through the
            # normal's CDF
            v = v * 0.05 if kind == "bias" else 0.8 + 0.4 * \
                torch.special.ndtr(v)
            p[f"l{i}.{name}"] = v.to(torch.bfloat16)
        if cfg["family"] == "mixtral":
            p[f"l{i}.gate"] = _bf16_dense((d["D"], d["E"]), gen, dev,
                                          1 / math.sqrt(d["D"]))
    return p


def _norms(n: int, gen, dev) -> torch.Tensor:
    """Norm scales U(0.8, 1.2) in bfloat16."""
    u = torch.rand((n,), generator=gen, device=dev)
    return (0.8 + 0.4 * u).to(torch.bfloat16)


def nbytes(p: dict[str, torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in p.values())
