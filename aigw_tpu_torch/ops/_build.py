"""Build and load the hand-written CUDA kernels.

The sources under ``aigw_tpu_torch/csrc/`` compile with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers, so the build takes seconds). Each ``.cu``
file compiles in its own ``nvcc`` process, all started together, and
one more links them. The library is built at first use — never at
import — into ``build/kernels/`` at the repository root, named by a hash
of the sources and flags, so a changed source rebuilds and an unchanged
one is reused within a checkout.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from collections.abc import Iterator
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
# No --use_fast_math: the quantizing kernels divide x / scale and round,
# and an approximate division would change the rounded integers.
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-lineinfo")

#: dtype codes of the C interface (AIGW_F32 / AIGW_BF16 / AIGW_I8 /
#: AIGW_I4 in the sources; uint8 is the packed-int4 pool)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
              torch.uint8: 3}

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C signature of every kernel entry point
SIGNATURES = {
    "aigw_ragged_prefill": [_P] * 7 + [_I] * 9 + [_P],
    "aigw_paged_decode": [_P] * 8 + [_I] * 11 + [_P],
    "aigw_paged_verify": [_P] * 8 + [_I] * 12 + [_P],
    "aigw_fused_decode": [_P] * 15 + [_I] * 11 + [_P],
    "aigw_w8a16_matmul": [_P] * 6 + [_I] * 6 + [_P],
}

#: wall seconds of the last build in this process (0.0 = reused)
last_build_s = 0.0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or PATH)")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libaigw_kernels-{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands in parallel; raise with the output of the first
    that failed, after every one has ended."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")


def build() -> Path:
    """Compile the sources if their library is not built yet; returns
    its path. Raises RuntimeError with nvcc's output on failure."""
    global last_build_s
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # aigw: lint-ok(determinism): times the nvcc build, no kernel reads it
    t0 = time.monotonic()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o"
                for src in sorted(CSRC.glob("*.cu"))]
        _run_all([[nvcc, *COMPILE_FLAGS, f"-I{CSRC}", "-c", "-o", str(obj),
                   str(src)]
                  for src, obj in zip(sorted(CSRC.glob("*.cu")), objs)])
        lib = Path(tmp) / out.name
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(lib),
                   *map(str, objs)]])
        os.replace(lib, out)
    # aigw: lint-ok(determinism): the build's seconds, no kernel reads it
    last_build_s = time.monotonic() - t0
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_cuda(t: torch.Tensor, name: str, dtype=None) -> None:
    """Validate a tensor a kernel reads through a raw pointer: on CUDA,
    contiguous, 16-byte aligned (the kernels load 16-byte vectors)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor (got {t.device})")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} (got {t.dtype})")


#: (device, kernel) -> int32 counters of the kernels' in-launch folds
_COUNTERS: dict[tuple[str, str], torch.Tensor] = {}
#: counter buffers a larger one replaced: kept alive, since a captured
#: CUDA graph may still address them
_RETIRED: list[torch.Tensor] = []


def counters(device: torch.device, kernel: str, n: int) -> torch.Tensor:
    """``n`` (or more) zeroed int32 arrival counters for ``kernel``'s
    fold of split partials on ``device``. Made once and grown as needed:
    every launch leaves the counters it used at zero, so launches of one
    kernel on one device must be ordered (one stream), as the engine's
    are. A buffer is never freed: graphs captured over it keep using
    it."""
    key = (str(device), kernel)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        if buf is not None:
            _RETIRED.append(buf)
        buf = torch.zeros((max(n, 1024),), dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf


#: this thread's launch tally while it captures a CUDA graph, else None
_capture = threading.local()


def count_launch(fn, attr: str = "launches") -> None:
    """Count one launch of ``fn``'s kernel in ``fn.<attr>``. While this
    thread captures a CUDA graph (``capture_tally``) nothing launches:
    the launch is recorded in the capture's tally instead, and every
    replay of the graph adds the tally (``tpuserve/programs.py``)."""
    tally = getattr(_capture, "tally", None)
    if tally is not None:
        tally[(fn, attr)] = tally.get((fn, attr), 0) + 1
    else:
        setattr(fn, attr, getattr(fn, attr) + 1)


@contextlib.contextmanager
def capture_tally() -> Iterator[dict]:
    """Record this thread's ``count_launch`` calls in a ``{(fn, attr):
    n}`` tally instead of the counters, for the capture of a graph."""
    tally: dict = {}
    _capture.tally = tally
    try:
        yield tally
    finally:
        _capture.tally = None


def ptr(t: torch.Tensor | None) -> int | None:
    """A tensor's data pointer, or None (a null pointer) for no tensor."""
    return None if t is None else t.data_ptr()


def check_heads(H: int, Hkv: int, D: int) -> None:
    """Head geometry the attention kernels take: whole GQA groups of at
    most 8 query heads, and a head dim D in {8, 16, 32, 64, 128, 256}
    (D / 8 lanes span a row)."""
    if H % Hkv or not 1 <= H // Hkv <= 8:
        raise ValueError(f"GQA group H/Hkv = {H}/{Hkv} must be a whole "
                         "number from 1 to 8")
    if D not in (8, 16, 32, 64, 128, 256):
        raise ValueError(f"head dim {D} must be one of 8, 16, 32, 64, "
                         "128, 256")


def dtype_code(t: torch.Tensor, name: str,
               allowed=(torch.float32, torch.bfloat16)) -> int:
    if t.dtype not in allowed:
        raise ValueError(f"{name}: unsupported dtype {t.dtype} "
                         f"(one of {', '.join(map(str, allowed))})")
    return DTYPE_CODE[t.dtype]


def launch(name: str, *args) -> None:
    """Call a C entry point on the current stream; raise if the launch
    was refused (the C side returns cudaGetLastError())."""
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(library(), name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
