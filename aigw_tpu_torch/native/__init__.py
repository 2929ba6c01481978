"""Build the port's host C++: the SSE and AWS event-stream scanners
(``sse_scan.cpp``, ``eventstream_scan.cpp`` → one shared library loaded
by ``aigw_tpu_torch/utils/native.py``) and the native proxy core
(``proxy_core.cpp`` → the ``aigw-core`` binary that ``core-config``'s
JSON drives).

Standard library only (the gateway imports no ``torch``), with the flags
of the reference's ``native/Makefile``: ``g++ -O3 -fPIC -std=c++17 -Wall``,
the library ``-shared ... -lz``, the core ``... -lpthread`` (``$CXX``
overrides the compiler). A target is built at first use, never at
import, into ``build/native/`` at the repository root, named by a hash
of its sources and flags, so a changed source rebuilds and an unchanged
one is reused within a checkout. A file lock per target makes processes
that ask at once (test workers, gateway workers) build it once.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
#: the reference's ``native/Makefile`` CXXFLAGS
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall")


@dataclass(frozen=True)
class Target:
    name: str
    sources: tuple[str, ...]
    #: flags after CXXFLAGS, and the libraries linked after the sources
    flags: tuple[str, ...]
    libs: tuple[str, ...]
    suffix: str = ""


LIBRARY = Target("libaigw_native", ("sse_scan.cpp", "eventstream_scan.cpp"),
                 ("-shared",), ("-lz",), ".so")
CORE = Target("aigw-core", ("proxy_core.cpp",), (), ("-lpthread",))

#: wall seconds of each target's last build in this process (absent: the
#: build was reused)
last_build_s: dict[str, float] = {}


def _cxx() -> str:
    cxx = os.environ.get("CXX", "g++")
    path = shutil.which(cxx)
    if path is None:
        raise RuntimeError(f"C++ compiler {cxx!r} not found (set CXX or "
                           "PATH)")
    return path


def output_path(target: Target) -> Path:
    """Where ``target`` is built: its name and a hash of its flags and
    sources."""
    h = hashlib.sha256(" ".join(
        (*CXXFLAGS, *target.flags, *target.libs)).encode())
    for name in target.sources:
        h.update(name.encode())
        h.update((SRC_DIR / name).read_bytes())
    return BUILD_DIR / f"{target.name}-{h.hexdigest()[:16]}{target.suffix}"


def build(target: Target) -> Path:
    """Compile ``target`` unless it is built; returns its path. Raises
    RuntimeError with the compiler's output when the build fails."""
    out = output_path(target)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f".{target.name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # another process built it while we waited
            return out
        t0 = time.monotonic()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_cxx(), *CXXFLAGS, *target.flags, "-o", str(tmp),
               *(str(SRC_DIR / s) for s in target.sources), *target.libs]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{target.name}: the build failed "
                               f"({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}")
        os.replace(tmp, out)
        last_build_s[target.name] = time.monotonic() - t0
    return out


def core_binary() -> Path:
    """The ``aigw-core`` binary (built on first call)."""
    return build(CORE)
