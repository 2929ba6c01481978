"""Native paged KV pool (counterpart of ``aigw_tpu/models/kvq.py``).

The pool is one tensor ``[L, 2, n_slots, Hkv, D]`` in ``bfloat16``
(serving) or ``float32`` (the deterministic parity rig). The engine
sizes it with one page more than the allocator hands out: the last page
is the dump page. The fused decode kernel writes inactive slots' rows
there, and every scatter sends padding rows there instead of relying on
JAX's out-of-bounds ``mode="drop"`` (a torch index write out of range
raises on the CPU and device-asserts on CUDA). No page table ever
references the dump page, so nothing reads what lands in it.

The quantized int8/int4 leaves of the reference wait for a later slice
(ROADMAP queue 1).
"""

from __future__ import annotations

import torch

#: the kv_cache_dtype values this slice implements
KV_DTYPES = ("bfloat16", "float32")
#: values the reference accepts that this slice does not implement yet
QUANT_DTYPES = ("int8", "int4")

_TORCH_DTYPE = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(kv_cache_dtype: str) -> torch.dtype:
    """torch dtype of the pool for a ``kv_cache_dtype`` string; raises
    NotImplementedError for the quantized ones, ValueError otherwise."""
    if kv_cache_dtype in QUANT_DTYPES:
        raise NotImplementedError(
            f"kv_cache_dtype={kv_cache_dtype!r}: not ported yet (ROADMAP "
            "queue 1: quantized KV with K7)")
    if kv_cache_dtype not in _TORCH_DTYPE:
        raise ValueError(f"kv_cache_dtype must be one of {KV_DTYPES} "
                         f"(got {kv_cache_dtype!r})")
    return _TORCH_DTYPE[kv_cache_dtype]


def quant_bits(kv_cache_dtype: str) -> int:
    """Bits per stored KV element (the ``kv_quant_bits`` gauge)."""
    return compute_dtype(kv_cache_dtype).itemsize * 8


def make_pool(kv_shape: tuple, kv_cache_dtype: str,
              device: torch.device) -> torch.Tensor:
    """Zero-initialized pool ``[L, 2, n_slots, Hkv, D]``."""
    return torch.zeros(kv_shape, dtype=compute_dtype(kv_cache_dtype),
                       device=device)


def n_slots(kv: torch.Tensor) -> int:
    """Row count of the pool, dump page included."""
    return kv.shape[2]


def dump_rows(kv: torch.Tensor, page_size: int) -> tuple[int, int]:
    """[first, end) slot range of the dump page (the pool's last page)."""
    end = n_slots(kv)
    return end - page_size, end


def scatter_kv(kv: torch.Tensor, layer: int, flat: torch.Tensor,
               k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Write K/V rows ``[N, Hkv, D]`` at flat slot indices ``[N]`` in
    place and return the pool. Rows the reference drops (padding,
    inactive slots) must already point into the dump page: the caller
    maps them there, see :func:`padding_slots`."""
    flat = flat.reshape(-1).long()
    Hkv, D = kv.shape[3], kv.shape[4]
    kv[layer, 0].index_copy_(0, flat, k.reshape(-1, Hkv, D).to(kv.dtype))
    kv[layer, 1].index_copy_(0, flat, v.reshape(-1, Hkv, D).to(kv.dtype))
    return kv


def padding_slots(kv: torch.Tensor, page_size: int, valid: torch.Tensor,
                  slot: torch.Tensor) -> torch.Tensor:
    """``slot`` where ``valid``, else a row of the dump page (the JAX
    ``where(valid, slot, n_slots)`` + ``mode="drop"`` idiom, made
    in-bounds). Padding rows spread over the dump page's rows; several
    may share one, which only races garbage into a page nobody reads."""
    first, _ = dump_rows(kv, page_size)
    idx = torch.arange(slot.numel(), device=slot.device).reshape(
        slot.shape)
    dump = first + idx % page_size
    return torch.where(valid, slot, dump.to(slot.dtype))


def layer_pool(kv: torch.Tensor, layer: int, which: int) -> torch.Tensor:
    """The flat per-layer pool view ``[n_slots, Hkv, D]`` the kernels
    read and update in place (so the reference's ``set_layer_pool``
    write-back has nothing to do here)."""
    return kv[layer, which]

