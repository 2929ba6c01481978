"""Captured programs: the port's counterpart of the reference's compiled
XLA programs (``jax.jit`` over the decode window's ``lax.scan`` and the
prefill steps in ``aigw_tpu/tpuserve/engine.py``).

A ``CapturedProgram`` is one CUDA graph of a body at one key (a window
length, a page bucket, a prefill shape). Its first call runs the body
eagerly on the engine's stream (that call's result, as ``jax.jit``'s
first call compiles and runs), then captures the body on the engine's
side stream into the memory pool all of the engine's programs share.
Every later call copies its inputs into the program's static input
buffers and replays the graph on the caller's stream, returning the
static outputs: they are overwritten by the next replay of this program,
and may be by a replay of another program of the pool, so a caller
consumes them (a host copy queued behind the replay, a read) before the
next program runs.

The body must not synchronize with the host: every value it reads from
the device has to stay there. A capture whose body does (an ``.item()``,
a ``.tolist()``, a boolean-mask index) raises, and so does a failed
replay; the program never runs its body eagerly in a graph's place, and
its pool takes no further capture (the engine loop stops on the error).

The capture runs in ``thread_local`` mode: a server thread that uses
the card while the engine thread captures (an embeddings pass, a page
export) is not an error for the capture, and its work, on its own
stream, stays out of the graph, while an unsafe call on the engine's own
thread (a body that synchronizes) raises. (``chip_smoke.rotated_ms``
captures in ``relaxed`` mode, which refuses nothing; its kernels do not
need it: a kernel's first launch in a process, the one call that sets
its shared memory size with ``cudaFuncSetAttribute``, captures under
``global`` and ``thread_local`` alike, ``tools/torch_graphs.py``'s
``capture_mode`` line.) One capture runs at a time in the process,
and the cyclic garbage collector is off while it runs: a collection
inside the body could destroy unreachable graphs of another engine, and
a graph's destruction is a CUDA call a capturing thread may not make.

Kernel launch counters (``ops/_build.count_launch``) count launches on
the device: the eager first call counts its launches, the capture
records what it would launch in a tally instead of counting, and every
replay adds that tally.

On the CPU, which only a caller asking for ``"cpu"`` gets, a program
runs its body eagerly at every call; it is keyed and registered all the
same, so the CPU tests see the same program surface as the card. So
does a pool made with ``capture=False``: an engine on a gloo mesh,
whose collectives a CUDA graph cannot hold. On an NCCL mesh the bodies'
collectives are captured with them, and every rank replays its programs
in the leader's order (``tpuserve/follower.py``).
"""

from __future__ import annotations

import gc
import threading
import time
from typing import Any, Callable

import torch

from aigw_tpu_torch.obs.graph_events import CompileTracker
from aigw_tpu_torch.ops import _build

#: one capture at a time in the process (two engines of one process
#: capture on their own threads)
_CAPTURE_LOCK = threading.Lock()

CAPTURE_MODE = "thread_local"


def clone_tree(tree: Any) -> Any:
    """A copy of every tensor of a nest of tuples, tensors and None: a
    program's outputs kept past the next replay."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, tuple):
        return tuple(clone_tree(x) for x in tree)
    return tree


class ProgramPool:
    """What one engine's programs share: the device, the compile
    tracker, and on CUDA the side stream captures run on and the graph
    memory pool."""

    def __init__(self, device: torch.device, tracker: CompileTracker,
                 capture: bool = True) -> None:
        self.device = device
        self.tracker = tracker
        # whether programs are captured: on CUDA, unless the caller
        # says its bodies cannot be
        self.capture = capture and device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.capture else None
        self.handle = (torch.cuda.graph_pool_handle() if self.capture
                       else None)

    def bytes(self) -> int:
        """Device bytes the graph pool holds (0 when nothing is
        captured): the segments the caching allocator made for it."""
        if not self.capture:
            return 0
        pool = tuple(self.handle)
        return sum(int(seg["total_size"])
                   for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)


class CapturedProgram:
    """``body(*inputs)`` at one key as a CUDA graph (see the module
    docstring). ``inputs`` are tensors (or None) whose shapes, dtypes
    and devices are the key's; the body may also read and update
    tensors that live as long as the program (the decode state, the KV
    pool, the weights) in place."""

    def __init__(self, body: Callable, pool: ProgramPool) -> None:
        self.body = body
        self.pool = pool
        self.graph: Any = None
        self.static_in: list[torch.Tensor | None] = []
        self.static_out: Any = None
        # (wrapper, counter attribute) → launches a replay makes
        self.launches: dict = {}
        self.capture_ms = 0.0
        self._built = False

    def __call__(self, *inputs: torch.Tensor | None) -> Any:
        if not self.pool.capture:
            if not self._built:
                self._built = True
                self.pool.tracker.note_compile(0.0)
            return self.body(*inputs)
        if self.graph is None:
            return self._capture(inputs)
        for buf, x in zip(self.static_in, inputs):
            if buf is not None:
                buf.copy_(x, non_blocking=True)
        self.graph.replay()
        for (fn, attr), n in self.launches.items():
            setattr(fn, attr, getattr(fn, attr) + n)
        return self.static_out

    def _capture(self, inputs: tuple) -> Any:
        """The first call: the body eagerly on the static inputs (the
        call's result), then its capture on the side stream."""
        self.static_in = [None if x is None else x.clone() for x in inputs]
        out = self.body(*self.static_in)
        side = self.pool.stream
        graph = torch.cuda.CUDAGraph()
        # the cyclic collector stays off while this thread captures: a
        # collection inside the body would run the destructors of
        # unreachable graphs (another engine's), whose CUDA calls are not
        # permitted on a capturing thread and would void the capture
        collecting = gc.isenabled()
        with _CAPTURE_LOCK:
            side.wait_stream(torch.cuda.current_stream())
            t0 = time.monotonic()
            gc.disable()
            try:
                with torch.cuda.stream(side), \
                        _build.capture_tally() as tally:
                    graph.capture_begin(pool=self.pool.handle,
                                        capture_error_mode=CAPTURE_MODE)
                    try:
                        static_out = self.body(*self.static_in)
                    except BaseException:
                        # the capture is void: end it (that raises too),
                        # then raise the body's error. The pool takes no
                        # further capture after a void one (the caching
                        # allocator keeps it recording): the engine loop
                        # stops on the error
                        try:
                            graph.capture_end()
                        except RuntimeError:
                            pass
                        raise
                    graph.capture_end()
            finally:
                if collecting:
                    gc.enable()
            torch.cuda.current_stream().wait_stream(side)
            self.capture_ms = 1e3 * (time.monotonic() - t0)
        self.graph = graph
        self.static_out = static_out
        self.launches = dict(tally)
        self.pool.tracker.note_compile(self.capture_ms)
        return out


class ProgramFamily(dict):
    """One registered family: key → ``CapturedProgram``, each built on
    first use from ``make(key)`` (a body)."""

    def __init__(self, make: Callable[[Any], Callable],
                 pool: ProgramPool) -> None:
        super().__init__()
        self.make = make
        self.pool = pool

    def program(self, key: Any) -> CapturedProgram:
        prog = self.get(key)
        if prog is None:
            prog = self[key] = CapturedProgram(self.make(key), self.pool)
        return prog
