"""Process mesh over ``torch.distributed`` (counterpart of
``aigw_tpu/parallel/mesh.py``).

The reference is single-controller SPMD: one process holds a
``jax.sharding.Mesh`` of devices and GSPMD inserts the collectives. The
port runs one process per device, as Megatron and vLLM do: each rank
holds its shard and issues its collectives itself. The axes and their
order are the reference's (``dp``, ``tp``, ``sp``, ``ep``, ``pp``;
rank ``r`` sits at ``r``'s row-major coordinates in that grid, as the
reference's device ``r`` does), and so is the check that the world
holds the mesh.

The backend follows the device: NCCL on CUDA, gloo on the CPU. An
explicit ``backend=`` overrides it, and only a harness that puts two
ranks on one card passes one (NCCL refuses two ranks of a communicator
on one device). Every group gets the finite ``timeout``: ranks that
disagree on a collective, or a dead peer, fail the run instead of
hanging it.

The ``sp`` axis carries the sequence-parallel prefill
(``ops/ring_attention.py``): ``group("sp")`` holds the ranks that
differ only in their ``sp`` coordinate, and a rank's position along it
is ``axis_index("sp")``. Data parallelism is not ported here: ``dp > 1``
raises (replicas behind the gateway are the port's data parallelism).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist

from aigw_tpu_torch.device import resolve_device

AXES = ("dp", "tp", "sp", "ep", "pp")

#: the default bound on any one collective: a follower's first kernel
#: build or a capture sits between two of them
DEFAULT_TIMEOUT_S = 600.0


@dataclass(frozen=True)
class MeshSpec:
    dp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1
    pp: int = 1

    @property
    def size(self) -> int:
        return self.dp * self.tp * self.sp * self.ep * self.pp

    @property
    def axis_names(self) -> tuple[str, ...]:
        return AXES


class Mesh:
    """This rank's view of the mesh: its ``rank`` in a world of
    ``size``, ``shape`` (axis name → size, in the reference's order),
    its coordinates, its ``device``, and the process groups: one per
    axis set the port reduces over (``group("tp")``, ``group("ep")``,
    ``group("tp", "ep")``, ``group("pp")``, ``group("sp")``), ``world``
    (every rank: the tensors a leader sends its followers) and ``ctrl``
    (every rank, gloo: the control records)."""

    def __init__(self, spec: MeshSpec, rank: int, device: torch.device,
                 backend: str, timeout: timedelta) -> None:
        self.spec = spec
        self.rank = rank
        self.size = spec.size
        self.device = device
        self.backend = backend
        self.timeout = timeout
        self.shape = {a: getattr(spec, a) for a in AXES}
        self.coords = _coords(rank, spec)
        self.world = dist.group.WORLD
        self._groups: dict[tuple[str, ...], object] = {}
        # every rank creates every group in one order (new_group is
        # collective over the world)
        for axes in (("tp",), ("ep",), ("pp",), ("tp", "ep"), ("sp",)):
            self._groups[axes] = self._axis_group(axes)
        self.ctrl = dist.new_group(backend="gloo", timeout=timeout)

    def _axis_group(self, axes: tuple[str, ...]):
        """The group of ranks that differ from this one only along
        ``axes``."""
        parts: dict[tuple, list[int]] = {}
        for r in range(self.size):
            c = _coords(r, self.spec)
            key = tuple(c[a] for a in AXES if a not in axes)
            parts.setdefault(key, []).append(r)
        if len(parts) == 1:
            return self.world
        mine = None
        for ranks in parts.values():
            g = dist.new_group(ranks, timeout=self.timeout)
            if self.rank in ranks:
                mine = g
        return mine

    def group(self, *axes: str):
        return self._groups[tuple(axes)]

    def axis_size(self, *axes: str) -> int:
        return math.prod(self.shape[a] for a in axes)

    def axis_index(self, axis: str) -> int:
        return self.coords[axis]

    def axis_ranks(self, axis: str) -> list[int]:
        """Global ranks along ``axis`` through this rank, in axis
        order."""
        return [r for r in range(self.size)
                if all(_coords(r, self.spec)[a] == self.coords[a]
                       for a in AXES if a != axis)]

    def all_reduce(self, x: torch.Tensor, *axes: str) -> torch.Tensor:
        """``x`` summed over the ranks of ``group(*axes)``, in place."""
        dist.all_reduce(x, group=self.group(*axes))
        return x

    def all_gather_last(self, x: torch.Tensor, *axes: str,
                        dim: int = -1) -> torch.Tensor:
        """The shards of ``group(*axes)``, in rank order, joined along
        ``dim``."""
        x = x.contiguous()
        parts = [torch.empty_like(x)
                 for _ in range(self.axis_size(*axes))]
        dist.all_gather(parts, x, group=self.group(*axes))
        return torch.cat(parts, dim=dim)

    @property
    def is_leader(self) -> bool:
        return self.rank == 0

    def close(self) -> None:
        """Leave the process group (every rank calls it)."""
        if dist.is_initialized():
            dist.destroy_process_group()

    def __repr__(self) -> str:
        return (f"Mesh(rank={self.rank}/{self.size}, {self.shape}, "
                f"{self.device}, {self.backend})")


def _coords(rank: int, spec: MeshSpec) -> dict[str, int]:
    sizes = [getattr(spec, a) for a in AXES]
    out = {}
    for a, n in zip(reversed(AXES), reversed(sizes)):
        out[a] = rank % n
        rank //= n
    return {a: out[a] for a in AXES}


def rank_device(device: str | torch.device, rank: int) -> torch.device:
    """A rank's device: ``"cuda"`` names ``cuda:<rank>`` (one process
    per card of the host), ``"cuda:N"`` that card itself, ``"cpu"`` the
    CPU. Raises as ``resolve_device`` when CUDA is missing."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank)
    return dev


def make_mesh(spec: MeshSpec, device: str | torch.device = "cuda",
              backend: str | None = None, *, rank: int | None = None,
              world_size: int | None = None, init_method: str | None = None,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """Join (or use) the default process group and build this rank's
    ``Mesh``. Without an initialized group, ``init_method``, ``rank``
    and ``world_size`` start one. The world must hold exactly
    ``spec.size`` ranks: fewer raises the reference's message."""
    if spec.dp > 1:
        raise NotImplementedError(
            f"dp={spec.dp}: data parallelism is replicas behind the "
            "gateway; a dp mesh axis is not ported")
    if min(getattr(spec, a) for a in AXES) < 1:
        raise ValueError(f"mesh axes must be >= 1: {spec}")
    timeout = timedelta(seconds=timeout_s)
    if not dist.is_initialized():
        if rank is None or world_size is None or init_method is None:
            raise ValueError("no process group: pass init_method, rank "
                             "and world_size")
        dev = rank_device(device, rank)
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        dist.init_process_group(backend, init_method=init_method,
                                rank=rank, world_size=world_size,
                                timeout=timeout)
    rank = dist.get_rank()
    world = dist.get_world_size()
    if world < spec.size:
        raise ValueError(f"mesh {spec} needs {spec.size} devices, have "
                         f"{world}")
    if world > spec.size:
        raise ValueError(f"mesh {spec} has {spec.size} ranks, the world "
                         f"{world}: every rank must be in the mesh")
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(spec, rank, dev, dist.get_backend(), timeout)


