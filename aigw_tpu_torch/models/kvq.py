"""Paged KV pool, native and quantized (counterpart of
``aigw_tpu/models/kvq.py``).

The native pool is one tensor ``[L, 2, n_slots, Hkv, D]`` in
``bfloat16`` (serving) or ``float32`` (the deterministic parity rig).
With ``kv_cache_dtype`` in {"int8", "int4"} the pool is the reference's
two-leaf dict:

    {"q":     int8 [L, 2, n_slots, Hkv, D]
              | uint8 [L, 2, n_slots, Hkv, D/2]   (int4, packed)
     "scale": float32 [L, 2, n_slots, Hkv]}

Every token row carries one symmetric absmax scale per KV head, paged
exactly like the data (same slot axis). Quantization is symmetric
round-half-to-even in float32, bit for bit the reference's:

    scale = absmax * (1 / qmax)   (1.0 when the row is all zero)
    q     = clip(round(x / scale), -qmax, qmax)

with qmax 127 (int8) or 7 (int4), and dequantization is ``q * scale``
in float32. The reference writes ``absmax / qmax``, but every program
that serves it is compiled, and XLA rewrites the division by a constant
into a multiplication by its float32 reciprocal, which rounds
differently in the last place (and then, rarely, a q value by one); the
port follows the compiled form, so its pages equal what the reference
engine writes.

**int4 layout.** torch has no int4 arithmetic, so int4 values are
stored two per byte in ``uint8``: byte ``i`` of a packed axis holds
element ``2i`` in its low nibble and element ``2i + 1`` in its high
nibble, each as a 4-bit two's-complement value (``-7 .. 7``), and is
sign-extended on read. Pools pack along the head dim ``D``; int4
weights (``models/quant.py``) pack along their input axis. Everything
else keeps the reference's ``[.., D]`` shape: the scales, and the byte
math (``bytes_per_kv_element``, the engine's ``/state`` gauges).

The engine sizes the pool with one page more than the allocator hands
out: the last page is the dump page. The fused decode kernel writes
inactive slots' rows there, and every scatter sends padding rows there
instead of relying on JAX's out-of-bounds ``mode="drop"`` (a torch
index write out of range raises on the CPU and device-asserts on
CUDA). No page table ever references the dump page, so nothing reads
what lands in it.
"""

from __future__ import annotations

from typing import Any

import torch

#: valid EngineConfig.kv_cache_dtype values
KV_DTYPES = ("bfloat16", "float32", "int8", "int4")
QUANT_DTYPES = ("int8", "int4")

QMAX = {"int8": 127.0, "int4": 7.0}
#: float32 reciprocals of QMAX, the factor the reference's compiled
#: programs scale by
_INV_QMAX = {"int8": 1.0 / 127.0, "int4": 1.0 / 7.0}
_TORCH_DTYPE = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                "int8": torch.int8, "int4": torch.uint8}


def is_quantized_dtype(kv_cache_dtype: str) -> bool:
    return kv_cache_dtype in QUANT_DTYPES


def is_quantized(kv: Any) -> bool:
    """True when ``kv`` is the two-leaf quantized pool."""
    return isinstance(kv, dict)


def compute_dtype(kv_cache_dtype: str) -> torch.dtype:
    """torch dtype of the DATA leaf (``uint8`` for packed int4); raises
    ValueError for an unknown ``kv_cache_dtype``."""
    if kv_cache_dtype not in _TORCH_DTYPE:
        raise ValueError(f"kv_cache_dtype must be one of {KV_DTYPES} "
                         f"(got {kv_cache_dtype!r})")
    return _TORCH_DTYPE[kv_cache_dtype]


def quant_bits(kv_cache_dtype: str) -> int:
    """Bits per stored KV element (the ``kv_quant_bits`` gauge)."""
    return {"float32": 32, "bfloat16": 16, "int8": 8, "int4": 4}[
        kv_cache_dtype]


def bytes_per_kv_element(kv_cache_dtype: str) -> float:
    """Device bytes per stored element, scales excluded (the caller
    adds 4 bytes per row and head for a quantized pool)."""
    return {"float32": 4.0, "bfloat16": 2.0, "int8": 1.0,
            "int4": 0.5}[kv_cache_dtype]


# -- int4 packing ---------------------------------------------------------
def pack_int4(q: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Integer values in [-8, 7] → ``uint8`` two per byte along ``dim``
    (even element in the low nibble)."""
    q = q.to(torch.int16).movedim(dim, -1)
    if q.shape[-1] % 2:
        raise ValueError(f"int4 packing needs an even length (got "
                         f"{q.shape[-1]})")
    lo = q[..., 0::2] & 0xF
    hi = q[..., 1::2] & 0xF
    return (lo | (hi << 4)).to(torch.uint8).movedim(-1, dim).contiguous()


def unpack_int4(packed: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: ``uint8`` → sign-extended ``int8``
    values, twice as long along ``dim``."""
    p = packed.to(torch.int16).movedim(dim, -1)
    lo = ((p & 0xF) ^ 8) - 8
    hi = ((p >> 4) ^ 8) - 8
    out = torch.stack([lo, hi], dim=-1).reshape(*p.shape[:-1],
                                                 2 * p.shape[-1])
    return out.to(torch.int8).movedim(-1, dim).contiguous()


def int_values(q: torch.Tensor) -> torch.Tensor:
    """The integer values of a data leaf: int8 as is, packed int4
    unpacked along the last axis."""
    return unpack_int4(q) if q.dtype == torch.uint8 else q


# -- row quantization -----------------------------------------------------
def quantize_rows(x: torch.Tensor, kv_cache_dtype: str
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize K or V rows ``[..., Hkv, D]`` → (q in the stored layout,
    scale ``[..., Hkv]`` float32). Symmetric absmax per (row, head),
    round-half-to-even in float32 (the module docstring's recipe)."""
    qmax = QMAX[kv_cache_dtype]
    xf = x.float()
    amax = xf.abs().amax(-1)
    # made on the device (a fill, no host copy: captured programs run it)
    inv = torch.full((), _INV_QMAX[kv_cache_dtype], dtype=torch.float32,
                     device=x.device)
    scale = torch.where(amax > 0.0, amax * inv, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale[..., None]), -qmax, qmax)
    q = q.to(torch.int8)
    return (pack_int4(q) if kv_cache_dtype == "int4" else q), scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(q ``[..., Hkv, D]`` int8 or ``[..., Hkv, D/2]`` packed int4,
    scale ``[..., Hkv]``) → float32 rows ``[..., Hkv, D]``."""
    return int_values(q).float() * scale[..., None]


# -- pool -------------------------------------------------------------------
def make_pool(kv_shape: tuple, kv_cache_dtype: str,
              device: torch.device) -> Any:
    """Zero-initialized pool for ``kv_shape = [L, 2, n_slots, Hkv, D]``:
    a tensor (native) or the ``{"q", "scale"}`` dict (quantized)."""
    dt = compute_dtype(kv_cache_dtype)
    if not is_quantized_dtype(kv_cache_dtype):
        return torch.zeros(kv_shape, dtype=dt, device=device)
    *lead, D = kv_shape
    if kv_cache_dtype == "int4" and D % 2:
        raise ValueError(f"int4 pages need an even head dim (got {D})")
    q_shape = (*lead, D // 2 if kv_cache_dtype == "int4" else D)
    return {"q": torch.zeros(q_shape, dtype=dt, device=device),
            "scale": torch.zeros(tuple(lead), dtype=torch.float32,
                                 device=device)}


def n_slots(kv: Any) -> int:
    """Row count of the pool, dump page included."""
    return (kv["q"] if is_quantized(kv) else kv).shape[2]


def kv_dtype_of(kv: Any) -> str:
    """The kv_cache_dtype a live pool was built with."""
    d = (kv["q"] if is_quantized(kv) else kv).dtype
    return {torch.int8: "int8", torch.uint8: "int4",
            torch.float32: "float32"}.get(d, "bfloat16")


def dump_rows(kv: Any, page_size: int) -> tuple[int, int]:
    """[first, end) slot range of the dump page (the pool's last page)."""
    end = n_slots(kv)
    return end - page_size, end


def scatter_kv(kv: Any, layer: int, flat: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor) -> Any:
    """Write K/V rows ``[N, Hkv, D]`` at flat slot indices ``[N]`` in
    place and return the pool; a quantized pool gets the rows quantized
    and their scale rows in the same pass. Rows the reference drops
    (padding, inactive slots) must already point into the dump page:
    the caller maps them there, see :func:`padding_slots`."""
    flat = flat.reshape(-1).long()
    if not is_quantized(kv):
        Hkv, D = kv.shape[3], kv.shape[4]
        kv[layer, 0].index_copy_(0, flat, k.reshape(-1, Hkv, D).to(kv.dtype))
        kv[layer, 1].index_copy_(0, flat, v.reshape(-1, Hkv, D).to(kv.dtype))
        return kv
    dt = kv_dtype_of(kv)
    Hkv = kv["q"].shape[3]
    for which, rows in ((0, k), (1, v)):
        q, s = quantize_rows(rows.reshape(-1, Hkv, rows.shape[-1]), dt)
        kv["q"][layer, which].index_copy_(0, flat, q)
        kv["scale"][layer, which].index_copy_(0, flat, s)
    return kv


def copy_page(kv: Any, src: int, dst: int, page_size: int) -> Any:
    """Clone page ``src``'s rows into page ``dst`` in place, in every
    tensor of the pool (K and V; for a quantized pool the q rows and
    their scale rows, which page on the same slot axis) and every layer:
    the prefix cache's copy-on-write (the reference's ``_copy_page_dev``
    over the pool's leaves). It runs on the caller's stream, after
    every launch already queued there that reads ``src``."""
    s, d = src * page_size, dst * page_size
    for leaf in (kv.values() if is_quantized(kv) else (kv,)):
        leaf[:, :, d:d + page_size] = leaf[:, :, s:s + page_size]
    return kv


def padding_slots(kv: Any, page_size: int, valid: torch.Tensor,
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


def gather_kv(kv: Any, layer: int, gslot: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """K/V rows of layer ``layer`` at flat slot indices ``gslot``. A
    native pool returns its rows as they are; a quantized pool gathers
    the integer rows and their scales, dequantizes in float32 and rounds
    to bfloat16, the serving compute dtype (the reference's
    ``gather_kv``)."""
    if not is_quantized(kv):
        return kv[layer, 0][gslot], kv[layer, 1][gslot]
    k = dequantize_rows(kv["q"][layer, 0][gslot],
                        kv["scale"][layer, 0][gslot])
    v = dequantize_rows(kv["q"][layer, 1][gslot],
                        kv["scale"][layer, 1][gslot])
    return k.to(torch.bfloat16), v.to(torch.bfloat16)


def layer_pool(kv: Any, layer: int, which: int
               ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """``(rows [n_slots, Hkv, D or D/2], scale [n_slots, Hkv] | None)``:
    the flat per-layer pool views the kernels read and update in place
    (so the reference's ``set_layer_pool`` write-back has nothing to do
    here)."""
    if not is_quantized(kv):
        return kv[layer, which], None
    return kv["q"][layer, which], kv["scale"][layer, which]


# -- host pages (spill tier, fleet fetch, migration) ------------------------
# A host page is one page's rows of every layer in the pool's own layout,
# ``[L, 2, page_size, Hkv, D]``: a CPU tensor in the pool's dtype for a
# native pool, and for a quantized pool ``{"q", "scale", "dtype"}`` with
# ``scale`` float32 ``[L, 2, page_size, Hkv]``. int4 ``q`` holds one
# element per byte (``uint8``, the 4-bit two's-complement value in the
# low nibble, the high nibble zero), byte for byte the reference's
# ``ml_dtypes.int4`` host page and wire, and is packed again on import.
def gather_pages(kv: Any, pages: torch.Tensor, page_size: int) -> Any:
    """Rows of ``pages`` ([k] page ids on the pool's device), per leaf
    stacked ``[k, L, 2, page_size, ...]`` (a copy)."""
    off = torch.arange(page_size, device=pages.device)
    idx = (pages.long()[:, None] * page_size + off).reshape(-1)
    k = pages.numel()

    def one(leaf: torch.Tensor) -> torch.Tensor:
        rows = leaf.index_select(2, idx)
        rows = rows.reshape(*leaf.shape[:2], k, page_size,
                            *leaf.shape[3:])
        return rows.movedim(2, 0).contiguous()

    if is_quantized(kv):
        return {"q": one(kv["q"]), "scale": one(kv["scale"])}
    return one(kv)


def scatter_pages(kv: Any, pages: torch.Tensor, stacked: Any,
                  page_size: int) -> Any:
    """Write ``stacked`` (per leaf ``[k, L, 2, page_size, ...]`` on the
    pool's device, in the pool's layout) into ``pages`` in place: exactly
    k pages, one index copy per leaf."""
    off = torch.arange(page_size, device=pages.device)
    idx = (pages.long()[:, None] * page_size + off).reshape(-1)

    def one(leaf: torch.Tensor, rows: torch.Tensor) -> None:
        src = rows.movedim(0, 2).reshape(*leaf.shape[:2], -1,
                                         *leaf.shape[3:])
        leaf.index_copy_(2, idx, src.to(leaf.dtype))

    if is_quantized(kv):
        one(kv["q"], stacked["q"])
        one(kv["scale"], stacked["scale"])
    else:
        one(kv, stacked)
    return kv


def pages_to_host(stacked: Any, kv_cache_dtype: str) -> list:
    """``gather_pages``' output → one host page per page (a device→host
    copy that waits for the work queued before it on the stream)."""
    if not is_quantized_dtype(kv_cache_dtype):
        return list(stacked.cpu().unbind(0))
    q = stacked["q"].cpu()
    if kv_cache_dtype == "int4":
        q = (unpack_int4(q) & 0xF).to(torch.uint8)
    scale = stacked["scale"].cpu()
    return [{"q": qi, "scale": si, "dtype": kv_cache_dtype}
            for qi, si in zip(q.unbind(0), scale.unbind(0))]


def host_to_stacked(host: list, kv_cache_dtype: str,
                    device: torch.device) -> Any:
    """Host pages → per-leaf ``[k, L, 2, page_size, ...]`` tensors on
    ``device`` in the pool's layout (int4 packed again)."""
    if not is_quantized_dtype(kv_cache_dtype):
        return torch.stack([torch.as_tensor(h) for h in host]).to(
            device=device, dtype=compute_dtype(kv_cache_dtype))
    q = torch.stack([torch.as_tensor(h["q"]) for h in host])
    if kv_cache_dtype == "int4":
        q = pack_int4(q)
    scale = torch.stack([torch.as_tensor(h["scale"]) for h in host])
    return {"q": q.to(device=device, dtype=compute_dtype(kv_cache_dtype)),
            "scale": scale.to(device=device, dtype=torch.float32)}


def page_nbytes(rows: Any) -> int:
    """Bytes a host page is charged (the spill tier's budget): int4
    counts its packed size, half a byte per element, as on the device;
    a quantized page adds its scales; a byte blob its length."""
    if isinstance(rows, dict):
        q = rows["q"]
        qb = q.nbytes // 2 if rows.get("dtype") == "int4" else q.nbytes
        return int(qb + rows["scale"].nbytes)
    n = getattr(rows, "nbytes", None)
    return int(n) if n is not None else len(rows)


def page_shape_ok(rows: Any, want: tuple) -> bool:
    """An imported host page has the engine's ``(L, 2, page_size, Hkv,
    D)`` geometry (and a quantized one its scales')."""
    if isinstance(rows, dict):
        return (tuple(rows["q"].shape) == want
                and tuple(rows["scale"].shape) == want[:-1])
    return tuple(rows.shape) == want


def page_matches_dtype(rows: Any, kv_cache_dtype: str) -> bool:
    """A quantized page scatters only into a pool of its own dtype, and
    a native page only into a native pool."""
    if isinstance(rows, dict):
        return rows.get("dtype") == kv_cache_dtype
    return not is_quantized_dtype(kv_cache_dtype)
