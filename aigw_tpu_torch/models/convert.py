"""Carry weights and KV pools across from the JAX reference.

The reference keeps parameters as a flat dict (``embed``, ``l{i}.wq``,
…) of ``[in, out]`` arrays; the port keeps the same names and layout,
so conversion is a per-leaf copy through numpy. Parity tests use it to
run both implementations on the reference's ``init_params`` weights.
"""

from __future__ import annotations

import numpy as np
import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


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
    leaves) → the port's, cast to ``dtype`` (None keeps each leaf's)."""
    if isinstance(dtype, str):
        dtype = _DTYPES[dtype]
    return {k: tensor_from_numpy(v, device, dtype) for k, v in flat.items()}


def pool_from_numpy(pool, device: str | torch.device = "cuda"
                    ) -> torch.Tensor:
    """A native KV pool ``[L, 2, n_slots, Hkv, D]`` → torch."""
    return tensor_from_numpy(pool, device)


def pool_to_numpy(pool: torch.Tensor) -> np.ndarray:
    """The port's pool → numpy float32 (bf16 widened exactly)."""
    return pool.detach().float().cpu().numpy()
