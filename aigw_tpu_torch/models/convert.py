"""Carry weights and KV pools across from the JAX reference.

The reference keeps parameters as a flat dict (``embed``, ``l{i}.wq``,
…) of ``[in, out]`` arrays; the port keeps the same names and layout,
so conversion is a per-leaf copy through numpy. Parity tests use it to
run both implementations on the reference's ``init_params`` weights,
quantized ones included, and on its LoRA adapters
(``adapters_from_numpy``).

numpy has no int4: a reference int4 leaf arrives as an ``ml_dtypes``
int4 array, is widened with ``astype(np.int8)`` and packed two per byte
(``models/kvq.py``): weights along their input axis, pools along the
head dim. Going back, ``pool_to_numpy`` returns int4 values as int8,
which ``astype(jnp.int4)`` turns into the reference's leaf bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from aigw_tpu_torch.models import kvq

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _is_int4(arr: np.ndarray) -> bool:
    return arr.dtype.name == "int4"


def tensor_from_numpy(a, device: str | torch.device = "cuda",
                      dtype: torch.dtype | None = None) -> torch.Tensor:
    """One array (numpy, or anything ``np.asarray`` accepts, including
    ml_dtypes bfloat16) → a torch tensor on ``device``."""
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":  # numpy has no bf16: go through f32
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        if not arr.flags.writeable or not arr.flags.c_contiguous:
            arr = np.array(arr)  # torch wants its own writable buffer
        t = torch.from_numpy(arr)
    return t.to(device=torch.device(device),
                dtype=dtype if dtype is not None else t.dtype)


def params_from_numpy(flat: dict, device: str | torch.device = "cuda",
                      dtype: torch.dtype | str | None = None
                      ) -> dict[str, torch.Tensor]:
    """The reference's flat param dict (``l{i}.wq`` … as numpy or array
    leaves) → the port's. Float leaves are cast to ``dtype`` (None keeps
    each leaf's); quantized leaves (``*.q``, ``*.scale``) keep theirs,
    int4 packed along the input axis."""
    if isinstance(dtype, str):
        dtype = _DTYPES[dtype]
    out = {}
    for k, v in flat.items():
        arr = np.asarray(v)
        if _is_int4(arr):
            q = torch.from_numpy(arr.astype(np.int8))
            out[k] = kvq.pack_int4(q, dim=-2).to(torch.device(device))
        elif k.endswith((".q", ".scale")):
            out[k] = tensor_from_numpy(arr, device)
        else:
            out[k] = tensor_from_numpy(arr, device, dtype)
    return out


def adapters_from_numpy(flat: dict, dtype: torch.dtype,
                        device: str | torch.device) -> dict[str, torch.Tensor]:
    """A reference adapter dict (``l{i}.{kind}.lora_a`` / ``.lora_b``:
    the stacked ``[rows, r, in]`` / ``[rows, out, r]`` of
    ``init_lora_adapters``, or one adapter's ``[r, in]`` / ``[out, r]``)
    → tensors of ``dtype`` on ``device``, both named by the caller
    (bf16 leaves widen to float32 exactly first)."""
    return {k: tensor_from_numpy(v, device, dtype) for k, v in flat.items()}


def pool_from_numpy(pool, device: str | torch.device = "cuda"):
    """A reference KV pool → the port's: a native array ``[L, 2,
    n_slots, Hkv, D]`` → tensor; a quantized ``{"q", "scale"}`` →
    ``{"q": int8 or packed uint8, "scale": float32}``, bit for bit."""
    if not isinstance(pool, dict):
        return tensor_from_numpy(pool, device)
    q = np.asarray(pool["q"])
    qt = (kvq.pack_int4(torch.from_numpy(q.astype(np.int8)))
          if _is_int4(q) else torch.from_numpy(np.array(q)))
    return {"q": qt.to(torch.device(device)),
            "scale": tensor_from_numpy(pool["scale"], device)}


def pool_to_numpy(pool):
    """The port's pool → numpy: a native pool as float32 (bf16 widened
    exactly); a quantized one as ``{"q": int8 values [.., D], "scale":
    float32}`` (int4 unpacked)."""
    if not kvq.is_quantized(pool):
        return pool.detach().float().cpu().numpy()
    return {"q": kvq.int_values(pool["q"]).cpu().numpy(),
            "scale": pool["scale"].cpu().numpy()}
