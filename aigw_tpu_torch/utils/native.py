"""ctypes bindings for the C++ hot-loop helpers (the port's copy of
``aigw_tpu/utils/native.py``): SSE event boundaries and AWS event-stream
frames with their CRCs, from ``aigw_tpu_torch/native/sse_scan.cpp`` and
``eventstream_scan.cpp``.

``load()`` builds the library (``aigw_tpu_torch/native``: g++ into
``build/native/``) and loads it; the gateway's ``run`` calls it before
it serves, so no compile lands on the event loop mid-stream. Until then
``sse_scan`` and ``es_scan`` return None and the parsers run their
Python loops, which the scanners are byte-exact with.
"""

from __future__ import annotations

import ctypes
import threading

from aigw_tpu_torch import native as _build

_LIB = None
#: each thread's output buffers (the reference keeps one pair per
#: process, its parsers all on the gateway's loop thread)
_BUFS = threading.local()


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    for name in ("aigw_sse_scan", "aigw_es_scan"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_size_t),
        ]
    return lib


def load() -> ctypes.CDLL:
    """Build the library if needed and load it; returns it. Raises
    RuntimeError with the compiler's output when the build fails."""
    global _LIB
    if _LIB is None:
        _LIB = _bind(ctypes.CDLL(str(_build.build(_build.LIBRARY))))
    return _LIB


def available() -> bool:
    """The scanners are loaded in this process."""
    return _LIB is not None


_MAX_EVENTS = 4096
_MAX_FRAMES = 1024


def _buffers(name: str, width: int):
    """This thread's (out, tail) buffers for one scanner, made once."""
    bufs = getattr(_BUFS, name, None)
    if bufs is None:
        bufs = ((ctypes.c_int32 * width)(), ctypes.c_size_t(0))
        setattr(_BUFS, name, bufs)
    return bufs


def sse_scan(buf: bytes) -> tuple[list[tuple[int, int]], int, bool] | None:
    """Returns ([(event_end, sep_len), ...], tail_offset, truncated) or
    None if the library is not loaded. ``truncated`` is True when the
    event-count cap was hit and the tail may hold more events."""
    lib = _LIB
    if lib is None:
        return None
    out, tail = _buffers("sse", 2 * _MAX_EVENTS)
    n = lib.aigw_sse_scan(buf, len(buf), out, _MAX_EVENTS,
                          ctypes.byref(tail))
    return (
        [(out[2 * i], out[2 * i + 1]) for i in range(n)],
        tail.value,
        n >= _MAX_EVENTS,
    )


def es_scan(buf: bytes):
    """AWS event-stream frame scan: returns
    ([(offset, total_len, headers_len), ...], tail, truncated), None when
    the library is not loaded, or raises ValueError on a CRC or framing
    error, as ``aigw_tpu_torch/translate/eventstream.py``'s loop does."""
    lib = _LIB
    if lib is None:
        return None
    out, tail = _buffers("es", 3 * _MAX_FRAMES)
    n = lib.aigw_es_scan(buf, len(buf), out, _MAX_FRAMES,
                         ctypes.byref(tail))
    if n < 0:
        raise ValueError("event-stream CRC/framing error")
    return (
        [(out[3 * i], out[3 * i + 1], out[3 * i + 2]) for i in range(n)],
        tail.value,
        n >= _MAX_FRAMES,
    )
