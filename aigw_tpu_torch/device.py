"""Explicit device resolution (counterpart of ``ops/pallas/_compat.py``).

The JAX package decides at run time whether it is on a TPU and quietly
runs its kernels in interpret mode when it is not. The port does not
guess: the caller names the device, ``"cuda"`` is the default, and a
request for CUDA on a machine without it raises instead of carrying on
on the CPU.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` → CUDA. Accepts ``"cuda"``, ``"cuda:N"`` and ``"cpu"``;
    raises RuntimeError when CUDA is asked for and unavailable."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but CUDA is not available; "
                "pass device='cpu' to run the plain PyTorch versions")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")


def device_name(device: torch.device) -> str:
    """Human-readable name of the device a result was produced on."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"
