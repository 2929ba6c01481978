"""Host-RAM KV spill tier (the port's own copy of
``aigw_tpu/tpuserve/kvhost.py``).

When the refcounted allocator reclaims a parked, cache-registered page
under pool pressure, the engine copies the page's K/V rows device→host
and parks them here, keyed by the same content chain hash the prefix
cache used. A later prefix hit on a spilled chain revives the pages
through the engine's page import instead of prefilling them again, and
``/kv/pages`` serves spilled chains to a sibling replica from host
memory without touching the device.

- **Strict tiering**: the budget holds only chains the pool does not.
  A revive removes the host copy; a re-eviction spills it again.
- **Byte for byte**: pages are stored as exported (``models/kvq.py``'s
  host page), so a revived chain equals the chain that was evicted.
- **Bounded**: ``max_bytes`` (``--kv-host-bytes``) is a hard LRU
  budget, charged by ``kvq.page_nbytes`` (the packed device size). A
  page larger than the whole budget is refused and counted evicted.
- **Thread-safe**: spills and revives run on the engine thread, while
  ``/kv/pages`` and the ``/state`` digest read from server threads;
  every operation takes the tier lock.
"""

from __future__ import annotations

import collections
import threading
from typing import Any

from aigw_tpu_torch.models.kvq import page_nbytes


class HostKVTier:
    """Bounded LRU of chain hash → one host-side KV page."""

    def __init__(self, max_bytes: int):
        if max_bytes <= 0:
            raise ValueError(f"max_bytes must be > 0 (got {max_bytes})")
        self.max_bytes = int(max_bytes)
        # chain key → host page; insertion order is the LRU order
        self._pages: "collections.OrderedDict[bytes, Any]" = (
            collections.OrderedDict())
        self._bytes = 0
        self._lock = threading.Lock()
        #: pages spilled into the tier (cumulative)
        self.spills = 0
        #: pages revived out of it by ``take`` (cumulative)
        self.revives = 0
        #: pages the budget dropped, or refused as oversized
        self.evictions = 0

    @property
    def count(self) -> int:
        with self._lock:
            return len(self._pages)

    @property
    def bytes_used(self) -> int:
        with self._lock:
            return self._bytes

    def put(self, key: bytes, rows: Any) -> bool:
        """Spill one page under its chain key; False when the page alone
        exceeds the budget (refused, counted evicted). Re-spilling a key
        replaces its entry and refreshes its LRU place; the oldest
        entries drop until the budget holds."""
        nbytes = page_nbytes(rows)
        with self._lock:
            if nbytes > self.max_bytes:
                self.evictions += 1
                return False
            old = self._pages.pop(key, None)
            if old is not None:
                self._bytes -= page_nbytes(old)
            self._pages[key] = rows
            self._bytes += nbytes
            self.spills += 1
            while self._bytes > self.max_bytes:
                _, dropped = self._pages.popitem(last=False)
                self._bytes -= page_nbytes(dropped)
                self.evictions += 1
            return True

    def contains(self, key: bytes) -> bool:
        """Presence probe; touches the entry, so a chain about to be
        revived is not the next LRU victim of an interleaved spill."""
        with self._lock:
            if key not in self._pages:
                return False
            self._pages.move_to_end(key)
            return True

    def get(self, key: bytes):
        """Peek (a sibling's fetch): the page stays in the tier."""
        with self._lock:
            rows = self._pages.get(key)
            if rows is not None:
                self._pages.move_to_end(key)
            return rows

    def take(self, key: bytes):
        """Revive: remove and return the page (None on a miss); the
        chain moves back into the pool, so the host copy goes."""
        with self._lock:
            rows = self._pages.pop(key, None)
            if rows is not None:
                self._bytes -= page_nbytes(rows)
                self.revives += 1
            return rows

    def discard(self, key: bytes) -> None:
        """Drop a stale host copy of a chain that a cold prefill just
        made resident again (possible when an earlier key of the chain
        was dropped by the budget, so no revive fired). Neither a revive
        nor an eviction: uncounted."""
        with self._lock:
            rows = self._pages.pop(key, None)
            if rows is not None:
                self._bytes -= page_nbytes(rows)

    def keys(self) -> tuple:
        """Snapshot of the spilled chain keys (the digest's host half)."""
        with self._lock:
            return tuple(self._pages.keys())
