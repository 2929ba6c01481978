"""Weight-only quantization: int8 (W8A16) and int4 (W4A16) (counterpart
of ``aigw_tpu/models/quant.py``).

Decode reads every weight once per step, so halving (int8) or
quartering (int4) the weight bytes is the lever; activations stay bf16.

- **int8**: symmetric per output channel (one scale per column of an
  ``[in, out]`` matrix; one per row for the embedding, which is read by
  row gather).
- **int4**: symmetric group-wise along the input axis, one scale per
  ``GROUP4`` input rows per output channel. Values pack two per byte
  along the input axis in the layout of ``models/kvq.py`` (``uint8
  [in/2, out]``, even input row in the low nibble).

Quantized params replace each matrix ``name`` with ``name.q`` and
``name.scale`` under the reference's names; norms and biases pass
through. Every rule is the reference's, so the q values and scales
equal its own (``tests/test_torch_quant.py``): ``scale = max(amax,
1e-8) * (1 / qmax)`` in float32 — the reference writes ``/ qmax``, but
its compiled program multiplies by the float32 reciprocal (XLA rewrites
a division by a constant), which rounds differently in the last place
— then ``q = clip(round(w / scale), ±qmax)``, round half to even.
"""

from __future__ import annotations

import torch

from aigw_tpu_torch.models.kvq import pack_int4

#: weight-name suffixes eligible for quantization (matmul-path matrices)
_MATRIX_KINDS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")

#: int4 group size along the input axis
GROUP4 = 128

#: output channels (or embedding rows) quantized per pass: bounds the
#: float32 temporaries of one matrix to a few hundred MB on the card
_CHUNK = 8192


def _chunks(n: int):
    for lo in range(0, n, _CHUNK):
        yield slice(lo, min(n, lo + _CHUNK))


def _scale(amax: torch.Tensor, qmax: float) -> torch.Tensor:
    recip = torch.tensor(1.0 / qmax, dtype=torch.float32,
                         device=amax.device)
    return torch.clamp(amax, min=1e-8) * recip


def _round_clip(wf: torch.Tensor, scale: torch.Tensor,
                qmax: float) -> torch.Tensor:
    return torch.clamp(torch.round(wf / scale), -qmax, qmax).to(torch.int8)


def _quantize_matrix_int8_channels(w: torch.Tensor
                                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """``[in, out]`` → (q int8 ``[in, out]``, scale f32 ``[1, out]``):
    one scale per output channel, the input axis reduced."""
    n_in, n_out = w.shape
    q = torch.empty((n_in, n_out), dtype=torch.int8, device=w.device)
    scale = torch.empty((1, n_out), dtype=torch.float32, device=w.device)
    for cols in _chunks(n_out):
        wf = w[:, cols].float()
        s = _scale(wf.abs().amax(0, keepdim=True), 127.0)
        q[:, cols] = _round_clip(wf, s, 127.0)
        scale[:, cols] = s
    return q, scale


def _quantize_rows_int8(w: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The embedding ``[V, dim]`` → (q int8 ``[V, dim]``, scale f32
    ``[V, 1]``): one scale per row (the reference's
    ``_quantize_matrix(w, axis=0)``)."""
    n_rows, dim = w.shape
    q = torch.empty((n_rows, dim), dtype=torch.int8, device=w.device)
    scale = torch.empty((n_rows, 1), dtype=torch.float32, device=w.device)
    for rows in _chunks(n_rows):
        wf = w[rows].float()
        s = _scale(wf.abs().amax(1, keepdim=True), 127.0)
        q[rows] = _round_clip(wf, s, 127.0)
        scale[rows] = s
    return q, scale


def _quantize_matrix_int4(w: torch.Tensor, group: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """``[in, out]`` → (q packed ``uint8 [in/2, out]``, scale f32
    ``[in/group, out]``): group-wise along the input axis."""
    n_in, n_out = w.shape
    q = torch.empty((n_in // 2, n_out), dtype=torch.uint8, device=w.device)
    scale = torch.empty((n_in // group, n_out), dtype=torch.float32,
                        device=w.device)
    for cols in _chunks(n_out):
        g = w[:, cols].float().reshape(n_in // group, group, -1)
        s = _scale(g.abs().amax(1, keepdim=True), 7.0)
        q[:, cols] = pack_int4(_round_clip(g, s, 7.0).reshape(n_in, -1),
                               dim=0)
        scale[:, cols] = s[:, 0]
    return q, scale


def quantize_params(params: dict[str, torch.Tensor], consume: bool = False,
                    mode: str = "int8") -> dict[str, torch.Tensor]:
    """bf16 param dict → W8A16 / W4A16 dict (other leaves pass through).
    ``mode`` is "int8" or "int4".

    ``consume=True`` pops each bf16 tensor from ``params`` as soon as
    its quantized replacement exists, so the peak is the bf16 model plus
    one matrix's quantized copy and its float32 temporaries (one
    ``_CHUNK`` of columns at a time), never two full copies."""
    if mode not in ("int8", "int4"):
        raise ValueError(f"unknown quantization mode {mode!r}")
    out: dict[str, torch.Tensor] = {}
    for name in list(params):
        w = params.pop(name) if consume else params[name]
        kind = name.rsplit(".", 1)[-1]
        if (kind in _MATRIX_KINDS and w.ndim == 2) or name == "lm_head":
            if mode == "int4" and w.shape[-2] % GROUP4 == 0:
                q, scale = _quantize_matrix_int4(w, GROUP4)
            else:  # int8, or an input dim that does not group
                q, scale = _quantize_matrix_int8_channels(w)
            out[name + ".q"], out[name + ".scale"] = q, scale
        elif name == "embed":
            # read by row gather: per-row scales in either mode
            out["embed.q"], out["embed.scale"] = _quantize_rows_int8(w)
        else:
            out[name] = w
        del w
    return out


def is_quantized(params: dict[str, torch.Tensor]) -> bool:
    return any(k.endswith(".q") for k in params)
