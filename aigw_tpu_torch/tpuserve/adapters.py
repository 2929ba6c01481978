"""Adapter serving: the model zoo's LoRA rows, hot-loaded (counterpart of
``aigw_tpu/tpuserve/adapters.py``).

``models/lora.py`` gives the model per-sequence adapter math over
stacked ``[n_slots + 1, r, d]`` device tensors; this module gives those
stacks a lifecycle. The zoo (every adapter the replica can serve) is
registered on the host; only ``n_slots`` adapters are resident on the
device at a time, each in one row of every stack. Rows follow the
discipline ``kvcache.py`` keeps for KV pages:

- **refcounted**: every live engine slot serving an adapter holds one
  reference to its row, and a referenced row is never reassigned;
- **LRU-parked**: a row whose count drops to zero stays resident (the
  next request for that adapter revives it for free) until a
  non-resident adapter needs a row; then the least recently parked row
  is evicted and rewritten;
- **hot load**: a load writes the adapter's tensors into one row of
  each stack in place (``stack[row].copy_``), so a load moves one row,
  not a stack, and the stacks keep their identity (the engine reads
  them as they are at every dispatch). On CUDA each tensor is cast on
  the host (float32 to the stack's dtype, round-to-nearest-even, as the
  reference's ``astype``) into a pinned staging row and copied from
  there without blocking, on the current stream: the engine's, where it
  queues behind every window already dispatched. Stream order thus
  stands in for the JAX data dependence the reference's donated update
  relies on: a window dispatched before a row was parked never sees the
  row rewritten under it. A staging row is rewritten only after the
  event recorded behind its previous copy has completed.

Row ``n_slots`` (the last) is the all-zeros base-model row and is never
allocated: base-model requests point there, and their output is the
base model's exactly.
"""

from __future__ import annotations

import logging
from typing import Any

import numpy as np
import torch

from aigw_tpu_torch.device import resolve_device
from aigw_tpu_torch.models.lora import validate_adapter_params

logger = logging.getLogger(__name__)


class UnknownAdapterError(KeyError):
    """Adapter name not registered in the zoo (a 404 at the server)."""


class AdapterCapacityError(Exception):
    """Every device row is pinned by a live slot: the request waits for
    a generation to finish (admission requeues it, as it does on KV page
    pressure)."""


class AdapterStore:
    """Registry and device residency of the stacked LoRA tensors.

    ``register()`` adds adapters to the zoo (host memory only);
    ``acquire()``/``release()`` manage device rows. Every registered
    adapter shares the first one's tensor keys and shapes, so one set of
    stacks serves any mix."""

    def __init__(self, n_slots: int, dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device = "cuda"):
        if n_slots < 1:
            raise ValueError("AdapterStore needs at least one row")
        self.n_slots = n_slots
        self.dtype = dtype
        self.device = resolve_device(device)
        # zoo: name → host tensors (float32 numpy, template-checked)
        self._zoo: dict[str, dict[str, np.ndarray]] = {}
        self._template: dict[str, tuple] | None = None  # key → shape
        # device residency
        self._row_of: dict[str, int] = {}
        self._name_of: dict[int, str] = {}
        self._refs: dict[int, int] = {}
        # refcount-0 resident rows, insertion-ordered = LRU
        self._parked: dict[int, str] = {}
        self._free: list[int] = list(range(n_slots - 1, -1, -1))
        #: the stacks [n_slots + 1, ...] on the device; row n_slots is
        #: zeros. Loads write rows in place: the tensors never change
        self.params: dict[str, torch.Tensor] = {}
        # CUDA loads: a pinned staging row per key, and the event
        # recorded after the last load's copies out of them
        self._stage: dict[str, torch.Tensor] = {}
        self._stage_done: Any = None
        # monotonic counters (EngineStats, /state)
        self.loads = 0
        self.evictions = 0
        # how a row is loaded: ``_load`` unless an engine on a mesh
        # routes it through its device operations (every rank loads it)
        self.loader = None

    # -- zoo ---------------------------------------------------------------
    def register(self, name: str, adapter: dict) -> None:
        """Add an adapter to the zoo (host side; no device traffic): its
        pairs and ranks checked (``models/lora.py``), its shapes against
        the adapters registered before it. The first registration
        allocates the zeroed stacks on the device."""
        validate_adapter_params(adapter, name)
        host = {k: np.array(_to_numpy(v), np.float32)  # an own copy
                for k, v in adapter.items()}
        shapes = {k: v.shape for k, v in host.items()}
        if self._template is None:
            self._template = shapes
            self.params = {
                k: torch.zeros((self.n_slots + 1, *shape), dtype=self.dtype,
                               device=self.device)
                for k, shape in shapes.items()
            }
        elif shapes != self._template:
            raise ValueError(
                f"adapter {name!r} tensors {shapes} do not match the "
                f"zoo template {self._template} (all adapters must "
                "target the same modules at the same rank)")
        self._zoo[name] = host

    def names(self) -> tuple[str, ...]:
        return tuple(self._zoo)

    def knows(self, name: str) -> bool:
        return name in self._zoo

    @property
    def base_row(self) -> int:
        return self.n_slots

    # -- telemetry ---------------------------------------------------------
    @property
    def resident_count(self) -> int:
        return len(self._row_of)

    def resident_names(self) -> list[str]:
        return sorted(self._row_of)

    def refcount(self, name: str) -> int:
        row = self._row_of.get(name)
        return self._refs.get(row, 0) if row is not None else 0

    # -- residency ---------------------------------------------------------
    def row_of(self, name: str) -> int:
        """Device row of a resident adapter (the caller holds a reference
        from ``acquire``; a non-resident name is a caller bug and raises,
        never a silent wrong row)."""
        return self._row_of[name]

    def acquire(self, name: str) -> int:
        """Pin ``name``'s row for one live slot, loading it into a free
        (or an LRU-evicted) row when it is not resident. Raises
        UnknownAdapterError or AdapterCapacityError."""
        if name not in self._zoo:
            raise UnknownAdapterError(name)
        row = self._row_of.get(name)
        if row is not None:
            self._refs[row] = self._refs.get(row, 0) + 1
            self._parked.pop(row, None)  # back in use
            return row
        row = self._pop_row()
        (self.loader or self._load)(row, name)
        self._row_of[name] = row
        self._name_of[row] = name
        self._refs[row] = 1
        return row

    def release(self, row: int) -> None:
        """Drop one slot's reference; the last one parks the row in the
        LRU pool (still resident, revivable for free)."""
        if row == self.base_row:
            return
        name = self._name_of.get(row)
        if name is None:  # a double release must not corrupt the pools
            return
        refs = self._refs.get(row, 1) - 1
        if refs > 0:
            self._refs[row] = refs
            return
        self._refs.pop(row, None)
        self._parked[row] = name

    def _pop_row(self) -> int:
        if self._free:
            return self._free.pop()
        if self._parked:
            row, name = next(iter(self._parked.items()))
            del self._parked[row]
            del self._row_of[name]
            del self._name_of[row]
            self.evictions += 1
            logger.info("adapter %r evicted from row %d", name, row)
            return row
        raise AdapterCapacityError(
            f"all {self.n_slots} adapter rows pinned by live slots")

    # -- device load -------------------------------------------------------
    def _staging(self) -> dict[str, torch.Tensor]:
        """The pinned staging rows (CUDA), allocated once."""
        if not self._stage:
            self._stage = {
                k: torch.empty(shape, dtype=self.dtype, pin_memory=True)
                for k, shape in (self._template or {}).items()}
        return self._stage

    def _load(self, row: int, name: str) -> None:
        host = self._zoo[name]
        if self.device.type == "cuda":
            if self._stage_done is not None:
                self._stage_done.synchronize()  # staging rows free again
            stage = self._staging()
            for k, v in host.items():
                stage[k].copy_(torch.from_numpy(v))  # the cast, RNE
                self.params[k][row].copy_(stage[k], non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            self._stage_done = ev
        else:
            for k, v in host.items():
                self.params[k][row].copy_(torch.from_numpy(v))
        self.loads += 1
        logger.info("adapter %r loaded into row %d", name, row)

    def warm(self) -> None:
        """Ready the store before traffic. The reference compiles its
        row-update programs here; the port has no compile to do (a load
        is a ``copy_``), and only allocates the pinned staging rows on
        CUDA, so the first hot load pays no pinned allocation."""
        if self.params and self.device.type == "cuda":
            self._staging()

    # -- invariants (property-test surface) --------------------------------
    def check_invariants(self) -> None:
        """Bookkeeping consistency: referenced rows are exactly the
        resident rows not parked, no row is in two pools, and the base
        row is never tracked."""
        resident_rows = set(self._name_of)
        assert resident_rows == set(self._row_of.values())
        assert set(self._refs) | set(self._parked) == resident_rows
        assert not (set(self._refs) & set(self._parked))
        assert not (set(self._free) & resident_rows)
        assert self.base_row not in resident_rows
        assert len(self._free) + len(resident_rows) == self.n_slots
        for row, refs in self._refs.items():
            assert refs > 0, (row, refs)


def _to_numpy(v: Any) -> np.ndarray:
    """A host copy of one adapter tensor: a torch tensor (any device or
    dtype) widened to float32, or anything ``np.asarray`` takes."""
    if isinstance(v, torch.Tensor):
        return v.detach().float().cpu().numpy()
    return np.asarray(v)
