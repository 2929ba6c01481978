"""Fleet-wide KV page index — chain hash → replicas that hold it.

The gateway half of the KV memory hierarchy: every tpuserve
replica advertises a digest of the content chain hashes it can serve KV
for (resident prefix-cache entries + host-spilled pages) on ``/state``
— the endpoint picker's existing poll loop feeds those digests in here.
The index answers one question: *which replicas already hold the KV for
this prompt chain?* Two consumers:

- the picker prices **fleet-hit locality** into its score (a bounded
  bonus toward replicas holding the request's chain — below session
  stickiness, above adapter affinity), and
- the gateway names those replicas in the ``x-aigw-kv-peers`` request
  header, so a prefix miss on the chosen replica becomes a cross-
  replica page fetch over ``POST /kv/pages`` instead of a re-prefill —
  Mooncake-style KV-centric serving.

Merge semantics are replace-per-replica: each poll swaps the replica's
advertised key set wholesale (digests are bounded snapshots, not
deltas). A replica that dies or goes stale is removed outright — a
fetch pointed at a dead sibling would only waste the fetch timeout.
Pure bookkeeping, no I/O, not thread-safe beyond the event loop it
lives on (the picker's).
"""

from __future__ import annotations


class KVIndex:
    """chain-hash (hex) → set of replica addresses."""

    #: per-replica digest bound — a misbehaving replica cannot balloon
    #: the gateway's memory. Sized for the LONG-CONTEXT geometry: the
    #: replica-side export bound is geometry-aware now (tpuserve
    #: Engine.kv_digest_max() scales with max_pages_per_seq off the
    #: KV_DIGEST_MAX=4096 floor — a single 128k chain at 128-token
    #: pages is 1024 keys, so the old flat 4096 truncated the fleet
    #: index to ~4 long chains per replica and long-prefix fleet hits
    #: silently vanished). The gateway accepts the largest digest any
    #: supported geometry exports: 8 chains × 8192 pages (1M tokens at
    #: 128-token pages). ~64 B/key ⇒ ≤4 MiB per replica, still a
    #: memory bound, not a truncation in practice.
    MAX_KEYS_PER_REPLICA = 65536

    def __init__(self) -> None:
        self._by_addr: dict[str, frozenset[str]] = {}
        self._by_key: dict[str, set[str]] = {}

    def update(self, addr: str, keys) -> None:
        """Replace ``addr``'s advertised chain set with ``keys``."""
        new = frozenset(
            str(k) for i, k in enumerate(keys)
            if i < self.MAX_KEYS_PER_REPLICA)
        old = self._by_addr.get(addr, frozenset())
        for k in old - new:
            holders = self._by_key.get(k)
            if holders is not None:
                holders.discard(addr)
                if not holders:
                    del self._by_key[k]
        for k in new - old:
            self._by_key.setdefault(k, set()).add(addr)
        if new:
            self._by_addr[addr] = new
        else:
            self._by_addr.pop(addr, None)

    def remove(self, addr: str) -> None:
        """Drop every entry for a dead/stale replica (expiry)."""
        self.update(addr, ())

    def replicas(self, key: str) -> frozenset:
        """Replicas advertising this chain hash (frozen snapshot)."""
        return frozenset(self._by_key.get(key, ()))

    @property
    def chains(self) -> int:
        """Distinct chain hashes indexed fleet-wide."""
        return len(self._by_key)

    @property
    def replicas_indexed(self) -> int:
        return len(self._by_addr)
