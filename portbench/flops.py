"""Operations and bytes that the served work needs, from a
configuration's widths and the requests' lengths alone, whatever
program does the work: the yardstick of the roofline and MFU metrics.

Counts follow these rules: a multiply-add is two
operations; each input byte is read once and each output byte written
once; the work is what these tokens need (the two routed experts of a
token, the keys up to its position), not what a program pads it to.
Peaks are NVIDIA's data sheet for one H100 SXM: 989 TFLOP/s dense
bf16, 3.35 TB/s of HBM.
"""

from __future__ import annotations

from weights import dims

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
BF16 = 2


def layer_matmul_params(cfg: dict) -> int:
    """Weights one token multiplies in one layer: the attention
    projections, and the dense MLP or the router and k experts."""
    d = dims(cfg)
    D, hd = d["D"], d["hd"]
    attn = D * d["H"] * hd * 2 + D * d["Hkv"] * hd * 2
    if cfg["family"] == "mixtral":
        return attn + D * d["E"] + d["K"] * 3 * D * d["F"]
    return attn + 3 * D * d["F"]


def head_flops(cfg: dict) -> float:
    d = dims(cfg)
    return 2.0 * d["D"] * d["V"]


def attn_flops(cfg: dict, p0: int, p1: int) -> float:
    """Causal attention of rows at positions ``[p0, p1)``, all layers:
    row p attends p + 1 keys, QK^T and PV each 2 operations per key and
    head dimension."""
    d = dims(cfg)
    keys = (p1 * (p1 + 1) - p0 * (p0 + 1)) // 2
    return 4.0 * d["L"] * d["H"] * d["hd"] * keys


def prefill_flops(cfg: dict, p0: int, p1: int) -> float:
    """Model operations of prefilling positions ``[p0, p1)`` over a
    cached prefix of ``p0``, with the lm_head at the last row only."""
    d = dims(cfg)
    return (2.0 * d["L"] * layer_matmul_params(cfg) * (p1 - p0)
            + attn_flops(cfg, p0, p1) + head_flops(cfg))


def decode_flops(cfg: dict, pos: int) -> float:
    """Model operations of one decode row at position ``pos``."""
    d = dims(cfg)
    return (2.0 * d["L"] * layer_matmul_params(cfg)
            + attn_flops(cfg, pos, pos + 1) + head_flops(cfg))


def k1_work(cfg: dict, p0: int, p1: int) -> tuple[float, float]:
    """(operations, bytes) of the ragged prefill attention of positions
    ``[p0, p1)``, all layers: queries read and outputs written once,
    the K/V of every position up to ``p1`` read once."""
    d = dims(cfg)
    n = p1 - p0
    per_layer = (2 * n * d["H"] * d["hd"] + 2 * p1 * d["Hkv"] * d["hd"])
    return attn_flops(cfg, p0, p1), float(d["L"] * per_layer * BF16)


def k2_bytes(cfg: dict, pos: int) -> float:
    """Bytes of the fused decode of one row at position ``pos``, all
    layers: q, the new k/v read and appended, the ``pos`` cached K/V
    rows read, the output written."""
    d = dims(cfg)
    hq, hk = d["H"] * d["hd"], d["Hkv"] * d["hd"]
    per_layer = 2 * hq + 4 * hk + 2 * pos * hk
    return float(d["L"] * per_layer * BF16)
