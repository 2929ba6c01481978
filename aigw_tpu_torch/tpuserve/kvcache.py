"""Host-side paged KV bookkeeping (the port's own copy of the allocator
half of ``aigw_tpu/tpuserve/kvcache.py``).

The device side is the flat page pool (``models/kvq.py``); the
allocator owns which pages belong to which sequence. Free pages are a
LIFO stack: O(1) alloc/free, no fragmentation (pages are fixed-size).
``RefcountedAllocator`` adds shared pages for the prefix cache; the
``PrefixCache`` itself, copy-on-write and migration pins wait for the
prefix-caching slice (ROADMAP queue 1), so no page is ever registered
and a released page always returns to the free stack.
"""

from __future__ import annotations

from dataclasses import dataclass, field


class OutOfPagesError(Exception):
    """KV pool exhausted — request must wait in queue."""


@dataclass
class PageAllocator:
    num_pages: int
    page_size: int
    _free: list[int] = field(default_factory=list)
    _owned: dict[int, list[int]] = field(default_factory=dict)

    def __post_init__(self) -> None:
        self._free = list(range(self.num_pages - 1, -1, -1))

    # -- allocation -------------------------------------------------------
    def pages_for(self, n_tokens: int) -> int:
        return max(1, -(-n_tokens // self.page_size))

    def allocate(self, seq_id: int, n_tokens: int) -> list[int]:
        need = self.pages_for(n_tokens)
        if len(self._free) < need:
            raise OutOfPagesError(
                f"need {need} pages, {len(self._free)} free"
            )
        pages = [self._free.pop() for _ in range(need)]
        self._owned.setdefault(seq_id, []).extend(pages)
        return pages

    def free(self, seq_id: int) -> None:
        for page in self._owned.pop(seq_id, []):
            self._free.append(page)

    def pages(self, seq_id: int) -> list[int]:
        return self._owned.get(seq_id, [])

    # -- telemetry (the picker signal) ------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.num_pages - len(self._free)

    @property
    def occupancy(self) -> float:
        return self.used_pages / self.num_pages if self.num_pages else 1.0


class RefcountedAllocator(PageAllocator):
    """PageAllocator with shared (refcounted) pages: ``adopt`` shares
    existing pages with a new sequence, and a page returns to the free
    stack when its last reference is released."""

    def __post_init__(self) -> None:
        super().__post_init__()
        self._refs: dict[int, int] = {}

    def allocate(self, seq_id: int, n_tokens: int) -> list[int]:
        return self.allocate_extra(seq_id, self.pages_for(n_tokens))

    def allocate_extra(self, seq_id: int, n_pages: int) -> list[int]:
        """Allocate n fresh pages (suffix after shared-prefix adoption)."""
        if len(self._free) < n_pages:
            raise OutOfPagesError(
                f"need {n_pages} pages, {len(self._free)} available"
            )
        pages = [self._free.pop() for _ in range(n_pages)]
        for p in pages:
            self._refs[p] = self._refs.get(p, 0) + 1
        self._owned.setdefault(seq_id, []).extend(pages)
        return pages

    def adopt(self, seq_id: int, pages: list[int]) -> None:
        """Share existing pages with a new sequence."""
        for p in pages:
            self._refs[p] = self._refs.get(p, 0) + 1
        self._owned.setdefault(seq_id, []).extend(pages)

    def free(self, seq_id: int) -> None:
        for page in self._owned.pop(seq_id, []):
            refs = self._refs.get(page, 1) - 1
            if refs > 0:
                self._refs[page] = refs
            else:
                self._refs.pop(page, None)
                self._free.append(page)
