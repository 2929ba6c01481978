"""Host-side paged KV bookkeeping (the port's own copy of
``aigw_tpu/tpuserve/kvcache.py``).

The device side is the flat page pool (``models/kvq.py``); the
allocator owns which pages belong to which sequence. Free pages are a
LIFO stack: O(1) alloc/free, no fragmentation (pages are fixed-size).

``RefcountedAllocator`` and ``PrefixCache`` are the automatic prefix
cache: full prompt pages are registered under chained content hashes
(``page_chain_hashes``, byte for byte the reference's keys), shared
read-only between sequences by refcount, and parked in an LRU pool of
evictable pages when their last reference goes, revivable by a later hit
until a fresh allocation reclaims them. ``begin_export``/``end_export``
pin the pages of a migration export or a fleet fetch while their rows are
copied off the device, and ``PrefixCache.spill_sink`` (the engine's host
spill tier, ``tpuserve/kvhost.py``) hears each registered page the
moment it is reclaimed, before its registration drops.
"""

from __future__ import annotations

import hashlib
import logging
from dataclasses import dataclass, field

logger = logging.getLogger(__name__)


def page_chain_hashes(
    tokens: list[int], page_size: int, prev: bytes = b""
) -> list[bytes]:
    """Chained per-page content hashes over full prompt pages:
    key_i = blake2b-16(key_{i-1} ‖ token ids of page i joined by ","),
    so key_i identifies the whole token prefix through page i (a radix
    tree flattened to one lookup per page-aligned depth). ``prev``
    resumes the chain from an already-hashed prefix."""
    keys: list[bytes] = []
    for i in range(len(tokens) // page_size):
        chunk = tokens[i * page_size: (i + 1) * page_size]
        h = hashlib.blake2b(digest_size=16)
        h.update(prev)
        h.update(b",".join(str(t).encode() for t in chunk))
        prev = h.digest()
        keys.append(prev)
    return keys


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
    """PageAllocator with shared (refcounted) pages for prefix caching.

    A page whose refcount drops to zero while its content is registered
    in the prefix cache parks in an LRU *evictable* pool: a later cache
    hit revives it, or a fresh allocation reclaims it (evicting the
    cache entry). Evictable pages count as free in the telemetry, as in
    the reference, so ``kv_occupancy`` means what the picker expects.
    """

    def __post_init__(self) -> None:
        super().__post_init__()
        self._refs: dict[int, int] = {}
        # page id → cache key, insertion-ordered = LRU
        self._evictable: dict[int, object] = {}
        self._on_evict = None  # callback(cache_key)
        self._prefix_cache: PrefixCache | None = None

    def set_evict_callback(self, cb) -> None:
        self._on_evict = cb

    @property
    def available_pages(self) -> int:
        return len(self._free) + len(self._evictable)

    def _pop_page(self) -> int:
        if self._free:
            return self._free.pop()
        if self._evictable:
            page, key = next(iter(self._evictable.items()))
            del self._evictable[page]
            if self._on_evict is not None:
                self._on_evict(key)
            return page
        raise OutOfPagesError("no free or evictable pages")

    @property
    def free_pages(self) -> int:
        # evictable pages are reclaimable on demand
        return self.available_pages

    @property
    def used_pages(self) -> int:
        return self.num_pages - len(self._free) - len(self._evictable)

    def allocate(self, seq_id: int, n_tokens: int) -> list[int]:
        return self.allocate_extra(seq_id, self.pages_for(n_tokens))

    def allocate_extra(self, seq_id: int, n_pages: int) -> list[int]:
        """Allocate n fresh pages (suffix after shared-prefix adoption)."""
        if self.available_pages < n_pages:
            raise OutOfPagesError(
                f"need {n_pages} pages, {self.available_pages} available"
            )
        pages = [self._pop_page() for _ in range(n_pages)]
        for p in pages:
            self._refs[p] = self._refs.get(p, 0) + 1
        self._owned.setdefault(seq_id, []).extend(pages)
        return pages

    def adopt(self, seq_id: int, pages: list[int]) -> None:
        """Share existing (cached) pages with a new sequence."""
        for p in pages:
            self._refs[p] = self._refs.get(p, 0) + 1
            self._evictable.pop(p, None)  # back in active use
        self._owned.setdefault(seq_id, []).extend(pages)

    def free(self, seq_id: int) -> None:
        for page in self._owned.pop(seq_id, []):
            self._release_page(page)

    def _release_page(self, page: int) -> None:
        """Drop one reference; a last reference parks a cache-registered
        page in the evictable pool and returns any other page to the
        free stack."""
        refs = self._refs.get(page, 1) - 1
        if refs > 0:
            self._refs[page] = refs
            return
        self._refs.pop(page, None)
        key = self._cache_key_of(page)
        if key is not None:
            self._evictable[page] = key  # park, revivable
        else:
            self._free.append(page)

    def cow_page(self, seq_id: int, page: int) -> int:
        """Copy-on-write: replace shared ``page`` in seq_id's chain with
        a fresh private page (the caller copies the device rows). The
        shared page keeps its registration; its refcount drops by one."""
        owned = self._owned.get(seq_id, [])
        idx = owned.index(page)  # ValueError = caller bug, fail loudly
        if self.available_pages < 1:
            raise OutOfPagesError("no free or evictable pages for CoW")
        fresh = self._pop_page()
        self._refs[fresh] = 1
        owned[idx] = fresh
        self._release_page(page)
        return fresh

    def begin_export(self, pages: list[int]) -> list[int]:
        """Pin ``pages`` for an export: each gains a reference and leaves
        the evictable pool, so no free, eviction or copy-on-write hands
        one out while its rows are copied off the device (the owner may
        finish, cancel or be cut meanwhile). Returns the pin for
        :meth:`end_export`."""
        for p in pages:
            self._refs[p] = self._refs.get(p, 0) + 1
            self._evictable.pop(p, None)
        return list(pages)

    def end_export(self, pin: list[int]) -> None:
        """Release an export pin: each page drops one reference and
        rejoins the normal lifecycle (registered pages park evictable,
        others return to the free stack)."""
        for p in pin:
            self._release_page(p)

    def truncate_to(self, seq_id: int, n_tokens: int) -> list[tuple]:
        """The speculative path's write invariant: every owned page
        overlapping positions ``[n_tokens, ∞)`` must be privately
        writable before decode or verify scatters land there. A shared
        or cache-registered page there is swapped for a fresh private one
        (its registration and other references stay on the original).
        Healthy layouts need no swap, so this normally returns []. Returns
        [(old_page, fresh_page, needs_copy)]: ``needs_copy`` when the page
        straddles ``n_tokens``, so its live rows below it must be cloned
        on the device before anything writes."""
        owned = self._owned.get(seq_id, [])
        first = n_tokens // self.page_size
        swaps: list[tuple] = []
        for idx in range(first, len(owned)):
            page = owned[idx]
            shared = (self._refs.get(page, 1) > 1
                      or self._cache_key_of(page) is not None)
            if not shared:
                continue
            fresh = self._pop_page()
            self._refs[fresh] = 1
            owned[idx] = fresh
            self._release_page(page)
            swaps.append((
                page, fresh,
                idx == first and n_tokens % self.page_size != 0,
            ))
        return swaps

    def _cache_key_of(self, page: int):
        cache = self._prefix_cache
        return cache.key_of_page(page) if cache is not None else None

    @property
    def pinned_cached_pages(self) -> int:
        """Cache-registered pages referenced by live sequences: KV the
        prefix cache holds pinned (``/state``'s ``prefix_pages_pinned``;
        parked evictable pages are resident but not pinned)."""
        cache = self._prefix_cache
        if cache is None:
            return 0
        return sum(1 for p in self._refs
                   if cache.key_of_page(p) is not None)


class PrefixCache:
    """Content-addressed map of full prompt pages → pool page ids, keyed
    by ``page_chain_hashes`` (a hit on page i implies the whole prefix
    through page i matches)."""

    def __init__(self, allocator: RefcountedAllocator, page_size: int):
        self.allocator = allocator
        self.page_size = page_size
        self._by_key: dict[bytes, int] = {}
        self._key_by_page: dict[int, bytes] = {}
        # chain key → the tokens that followed that prefix when it was
        # last inserted (at most one page): speculation's lookahead draft
        # source. Evicted entries drop theirs.
        self._next_tokens: dict[bytes, list[int]] = {}
        #: entries reclaimed under pool pressure (monotonic counter)
        self.evictions = 0
        # called as sink(chain key, page id) when a registered page is
        # reclaimed, before its registration drops, while its rows are
        # still the chain's: the engine's host spill. It runs inside the
        # allocator's _pop_page, so the page reaches its new owner only
        # after the spill's copy has landed
        self.spill_sink = None
        allocator._prefix_cache = self
        allocator.set_evict_callback(self._evicted)

    def chain_keys(self, prompt: list[int]) -> list[bytes]:
        return page_chain_hashes(prompt, self.page_size)

    @property
    def resident_entries(self) -> int:
        """Prefixes (page-chain nodes) resident: pinned by live sequences
        or parked evictable."""
        return len(self._by_key)

    def probe(self, keys: list[bytes]) -> list[int]:
        """Pages of the longest cached prefix for pre-hashed chain keys.
        Probe at adoption time: an earlier admission in the same pass
        may have inserted or evicted pages."""
        pages: list[int] = []
        for key in keys:
            page = self._by_key.get(key)
            if page is None:
                break
            pages.append(page)
        return pages

    def insert(self, keys: list[bytes], page_row: list[int],
               tokens: list[int] | None = None) -> None:
        """Register fully written prompt pages. With ``tokens`` (the full
        prompt) also record, per chain key, up to one page of the tokens
        that followed that prefix; the longest continuation wins, then
        the latest."""
        for i, key in enumerate(keys):
            if i >= len(page_row):
                break
            if key not in self._by_key:
                self._by_key[key] = page_row[i]
                self._key_by_page[page_row[i]] = key
        if tokens is not None:
            ps = self.page_size
            for i, key in enumerate(keys):
                nxt = tokens[(i + 1) * ps: (i + 2) * ps]
                if nxt and len(nxt) >= len(self._next_tokens.get(key, ())):
                    self._next_tokens[key] = nxt

    def continuation(self, keys: list[bytes]
                     ) -> tuple[int, list[int]] | None:
        """Deepest chain key with a recorded continuation: (depth_pages,
        tokens), the tokens following absolute position ``depth_pages *
        page_size``; None when no key of the chain has one. A draft hint
        only: verification rejects a stale one."""
        best: tuple[int, list[int]] | None = None
        for i, key in enumerate(keys):
            nxt = self._next_tokens.get(key)
            if nxt:
                best = (i + 1, nxt)
        return best

    def key_of_page(self, page: int):
        return self._key_by_page.get(page)

    def _evicted(self, key: bytes) -> None:
        page = self._by_key.pop(key, None)
        self._next_tokens.pop(key, None)
        if page is not None:
            if self.spill_sink is not None:
                try:
                    self.spill_sink(key, page)
                except Exception:  # noqa: BLE001 — a failed spill is a
                    # plain eviction; admission must go on
                    logger.exception("KV spill failed for page %d", page)
            self._key_by_page.pop(page, None)
            self.evictions += 1
