"""W8A16 matmul (counterpart of ``aigw_tpu/ops/pallas/qmatmul.py``).

``w8a16_matmul`` (K6) computes ``x [M, K] @ dequant(q [K, N] int8,
scale [N] f32)`` for decode-sized M: the int8 weight is converted in
registers (exact for |q| <= 127), the products are summed in float32,
and the per-column scale multiplies the float32 sum before the cast to
x's dtype. Scaling after the sum commutes with the contraction, so the
weight never exists dequantized anywhere.

``supported`` gates shapes exactly as the reference does: the fallback
(``x @ _w(...)`` in ``models/llama.py``) rounds the scale into bf16
weights first and so computes slightly different numbers, and the port
must send the kernel the shapes the reference sends its Pallas kernel.

The kernel lives in ``csrc/qmatmul.cu`` (tensor cores for bf16 x, the
CUDA cores for float32 x; one launch, which folds its split-K partials
itself); ``launch_plan`` sizes its grid and scratch from the shapes, and
``w8a16_matmul_plain`` is its plain PyTorch version with the same
signature. The public function runs the plain version for CPU tensors
and the kernel for CUDA tensors, and counts its launches in
``w8a16_matmul.launches``.
"""

from __future__ import annotations

import functools

import torch

from aigw_tpu_torch.ops import _build

# the reference's int8 weight-tile byte budget per grid step; only the
# shape gate below reads it
_TILE_BYTES = 2 * 1024 * 1024
#: output columns one block of the CUDA kernels covers
BLOCK_N = 128
#: a split of K holds a multiple of this many weight rows (four of the
#: tensor-core kernel's 64-row pipeline stages: shorter splits cost more
#: in their fold than they gain in blocks)
SPLIT_ROWS = 256
#: blocks the kernel aims to put on the card when N alone gives fewer:
#: two per SM of the H100's 132
_TARGET_BLOCKS = 264


def _pick_tile_n(k: int, n: int) -> int:
    for tile in (512, 384, 256, 128):
        if n % tile == 0 and k * tile <= 2 * _TILE_BYTES:
            return tile
    return 0


def supported(m: int, k: int, n: int) -> bool:
    """Shapes the kernel takes (the reference's gate): decode-sized M,
    128-aligned K, and an N with a dividing tile within the byte
    budget."""
    return m <= 64 and k % 128 == 0 and _pick_tile_n(k, n) > 0


def k_splits(k: int, n: int) -> tuple[int, int]:
    """(splits of K across blocks, rows per split): one split where the
    column tiles fill the card, else enough splits of whole
    ``SPLIT_ROWS`` steps to give it about ``_TARGET_BLOCKS`` blocks."""
    steps = -(-k // SPLIT_ROWS)
    want = max(1, -(-_TARGET_BLOCKS // (n // BLOCK_N)))
    per = -(-steps // min(steps, want))
    return -(-steps // per), per * SPLIT_ROWS


@functools.lru_cache(maxsize=256)
def launch_plan(m: int, k: int, n: int) -> dict:
    """The launch's grid and scratch: ``tiles`` column tiles of
    ``BLOCK_N`` x ``splits`` splits of ``k_rows`` rows; split s of tile t
    covers rows ``[s * k_rows, min(k, (s + 1) * k_rows))`` of columns
    ``[t * BLOCK_N, (t + 1) * BLOCK_N)``. With more than one split, the
    float32 partials take ``part_elems`` elements and the fold one
    counter per tile (``counters``); one split needs neither."""
    splits, rows = k_splits(k, n)
    tiles = n // BLOCK_N
    return {"tiles": tiles, "splits": splits, "k_rows": rows,
            "part_elems": splits * m * n if splits > 1 else 0,
            "counters": tiles if splits > 1 else 0}


def w8a16_matmul_plain(x: torch.Tensor, q: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """Plain version of K6: ``(x @ q)`` in float32 (the int8 values and
    x are exact in float32), times the column scale, cast to x's
    dtype."""
    acc = x.float() @ q.float()
    return (acc * scale.reshape(1, -1).float()).to(x.dtype)


def w8a16_matmul(x: torch.Tensor, q: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """K6. ``x [M, K]`` (bf16 or f32), ``q [K, N]`` int8, ``scale``
    ``[1, N]`` or ``[N]`` f32 → ``[M, N]`` in x's dtype. The caller
    guarantees ``supported(M, K, N)``. CPU tensors: the plain version;
    CUDA tensors: the kernel (``aigw_w8a16_matmul``)."""
    if x.device.type == "cpu":
        return w8a16_matmul_plain(x, q, scale)
    M, K = x.shape
    K2, N = q.shape
    if K2 != K or scale.numel() != N or not supported(M, K, N) or M < 1:
        raise ValueError(f"w8a16_matmul: unsupported shapes x {tuple(x.shape)}"
                         f", q {tuple(q.shape)}, scale {tuple(scale.shape)}")
    _build.check_cuda(x, "x")
    _build.check_cuda(q, "q", torch.int8)
    _build.check_cuda(scale, "scale", torch.float32)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    plan = launch_plan(M, K, N)
    part = counters = None
    if plan["splits"] > 1:
        part = torch.empty((plan["part_elems"],), dtype=torch.float32,
                           device=x.device)
        counters = _build.counters(x.device, "w8a16_matmul",
                                   plan["counters"])
    _build.launch("aigw_w8a16_matmul", x.data_ptr(), q.data_ptr(),
                  scale.data_ptr(), _build.ptr(part), _build.ptr(counters),
                  out.data_ptr(), M, K, N, plan["splits"], plan["k_rows"],
                  _build.dtype_code(x, "x"))
    w8a16_matmul.launches += 1
    return out


w8a16_matmul.launches = 0
