"""The follower ranks of a multi-rank replica, and the channel that
drives them.

There is no counterpart in the reference, and this module is why: the
reference is single-controller SPMD, one process whose jitted programs
GSPMD runs on every device of the mesh at once, so its one engine
drives every device by running its programs. The port runs one process
per device (``parallel/mesh.py``). Rank 0, the leader, runs the
unchanged ``Engine`` scheduler (admission, the allocator, the prefix
cache, constraints, speculation control, metering) and the HTTP
server. Every other rank is a follower: it holds its shard of the
weights and of the KV pool, and performs on them each device operation
the leader performs, in the leader's order, so that the collectives
inside the model pair up rank by rank. Every rank computes the same full
logits and samples the same tokens from the same replicated slot state,
so the decode state moves in step on every rank with nothing sent back.
A sequence-parallel prefill is no exception: each of its chunk steps is
one operation every rank performs (each on its own rows), and so is each
boundary decode tick and each prefill of a short request admitted at a
boundary, in the order the leader's chunk loop runs them.

The leader sends each operation (``send``) before it runs it itself;
``follow`` receives them and calls the same ``Engine._op_*`` method. A
record's host values (ints, lists, numpy arrays) go pickled over the
mesh's gloo ``ctrl`` group; its tensors are broadcast from rank 0 over
the world group on the rank's device (NCCL on CUDA). Every send and
receive is issued on the leader's engine thread and a follower's main
thread, one order per rank: a collective issued from two threads is the
one way this design deadlocks. A follower that dies fails the leader's
next collective (gloo raises at once; NCCL within the group's timeout),
and the leader's engine loop then fails, loudly.

``start_replica_mesh`` starts the followers of a one-command replica
(one spawned process per rank) and makes the leader's mesh.
"""

from __future__ import annotations

import gc
import logging
import multiprocessing
import socket
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from aigw_tpu_torch.parallel.mesh import (
    DEFAULT_TIMEOUT_S,
    Mesh,
    MeshSpec,
    make_mesh,
)

logger = logging.getLogger(__name__)


class _T:
    """A tensor's place in a record: broadcast after the record, in the
    order ``_strip`` met it."""

    __slots__ = ("shape", "dtype")

    def __init__(self, t: torch.Tensor) -> None:
        self.shape = tuple(t.shape)
        self.dtype = t.dtype


def _strip(x: Any, out: list) -> Any:
    if isinstance(x, torch.Tensor):
        out.append(x)
        return _T(x)
    if isinstance(x, tuple):
        return tuple(_strip(y, out) for y in x)
    if isinstance(x, list):
        return [_strip(y, out) for y in x]
    if isinstance(x, dict):
        return {k: _strip(v, out) for k, v in x.items()}
    return x


def _fill(x: Any, mesh: Mesh) -> Any:
    if isinstance(x, _T):
        t = torch.empty(x.shape, dtype=x.dtype, device=mesh.device)
        _bcast(t, mesh)
        return t
    if isinstance(x, tuple):
        return tuple(_fill(y, mesh) for y in x)
    if isinstance(x, list):
        return [_fill(y, mesh) for y in x]
    if isinstance(x, dict):
        return {k: _fill(v, mesh) for k, v in x.items()}
    return x


def _bcast(t: torch.Tensor, mesh: Mesh) -> None:
    """Broadcast ``t`` (on the rank's device, contiguous) from rank 0 as
    bytes, so any dtype travels on any backend."""
    if t.numel():
        dist.broadcast(t.view(-1).view(torch.uint8), src=0,
                       group=mesh.world)


def send(mesh: Mesh, op: str, *args: Any) -> None:
    """The leader's half: broadcast one operation record to every
    follower."""
    tensors: list[torch.Tensor] = []
    rec = (op, _strip(args, tensors))
    dist.broadcast_object_list([rec], src=0, group=mesh.ctrl)
    for t in tensors:
        _bcast(t.to(mesh.device).contiguous(), mesh)


def recv(mesh: Mesh) -> tuple[str, tuple]:
    """A follower's half: the next record, its tensors on the rank's
    device."""
    box: list = [None]
    dist.broadcast_object_list(box, src=0, group=mesh.ctrl)
    op, args = box[0]
    return op, _fill(args, mesh)


def engine_record(eng, params: dict[str, torch.Tensor]) -> dict:
    """What a follower needs to build the leader's engine: the family,
    the configs, the full weights (each rank slices its shard), the
    adapters (the fixed stacks, or the store's zoo on the host)."""
    from aigw_tpu_torch.models.registry import family_fns

    family = next(f for f in ("llama", "mixtral")
                  if family_fns(f) == eng.fns)
    store = eng._adapter_store
    return {
        "family": family, "model_cfg": eng.model_cfg, "cfg": eng.cfg,
        "eos": eng.eos, "params": params,
        "lora_params": eng._lora_static,
        "adapter_names": tuple(sorted(eng.adapter_rows,
                                      key=eng.adapter_rows.get))
        if store is None else (),
        "store": None if store is None else {
            "n_slots": store.n_slots, "dtype": store.dtype,
            "zoo": {n: dict(h) for n, h in store._zoo.items()}},
    }


def build_engine(mesh: Mesh, rec: dict):
    """A follower's engine from the leader's ``engine_record``."""
    from aigw_tpu_torch.models.registry import family_fns
    from aigw_tpu_torch.tpuserve.adapters import AdapterStore
    from aigw_tpu_torch.tpuserve.engine import Engine

    store = None
    if rec["store"] is not None:
        s = rec["store"]
        store = AdapterStore(s["n_slots"], s["dtype"], mesh.device)
        for name, host in s["zoo"].items():
            store.register(name, {k: np.asarray(v)
                                  for k, v in host.items()})
    return Engine(rec["params"], rec["model_cfg"], rec["cfg"],
                  eos_token_ids=rec["eos"], fns=family_fns(rec["family"]),
                  device=mesh.device, lora_params=rec["lora_params"],
                  adapter_names=rec["adapter_names"], adapter_store=store,
                  mesh=mesh)


def serve(mesh: Mesh) -> None:
    """A follower's main loop: build each engine the leader announces,
    perform its operations until the leader closes it, and return when
    the leader exits. A dropped engine's memory (its weights, pool and
    the allocator's cached blocks) is released before the next record
    arrives: ranks sharing a card otherwise hold each other's."""
    while True:
        op, args = recv(mesh)
        if op == "exit":
            return
        if op != "engine":
            raise RuntimeError(f"follower {mesh.rank}: {op!r} outside an "
                               "engine")
        eng = build_engine(mesh, args[0])
        while True:
            op, args = recv(mesh)
            if op == "close":
                break
            getattr(eng, "_op_" + op)(*args)
        del eng, args
        gc.collect()  # an engine is cyclic garbage (its backends)
        if mesh.device.type == "cuda":
            torch.cuda.empty_cache()


def _follower_main(rank: int, world: int, init_method: str, spec: MeshSpec,
                   device: str, backend: str | None,
                   timeout_s: float) -> None:
    logging.basicConfig(level=logging.INFO)
    mesh = make_mesh(spec, device, backend, rank=rank, world_size=world,
                     init_method=init_method, timeout_s=timeout_s)
    try:
        serve(mesh)
    finally:
        mesh.close()


class ReplicaMesh:
    """A leader's mesh and the follower processes it started."""

    def __init__(self, mesh: Mesh, procs: list) -> None:
        self.mesh = mesh
        self.procs = procs
        self._closed = False

    def close(self, timeout_s: float = 30.0) -> None:
        """Tell the followers to exit, wait for them, leave the group."""
        if self._closed:
            return
        self._closed = True
        try:
            send(self.mesh, "exit")
        finally:
            for p in self.procs:
                p.join(timeout=timeout_s)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=5)
            self.mesh.close()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_replica_mesh(spec: MeshSpec, device: str = "cuda",
                       backend: str | None = None,
                       init_method: str | None = None,
                       timeout_s: float = DEFAULT_TIMEOUT_S) -> ReplicaMesh:
    """Spawn ranks 1..n-1 as follower processes (``serve``) and make
    rank 0's mesh in this process. ``device`` is every rank's (``cuda``:
    rank r on ``cuda:<r>``); ``init_method`` defaults to a free
    localhost port."""
    init_method = init_method or f"tcp://127.0.0.1:{free_port()}"
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_follower_main, daemon=True,
                         name=f"tpuserve-follower-{r}",
                         args=(r, spec.size, init_method, spec, str(device),
                               backend, timeout_s))
             for r in range(1, spec.size)]
    for p in procs:
        p.start()
    try:
        mesh = make_mesh(spec, device, backend, rank=0,
                         world_size=spec.size, init_method=init_method,
                         timeout_s=timeout_s)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    logger.info("mesh %s: follower pids %s", mesh, [p.pid for p in procs])
    return ReplicaMesh(mesh, procs)
