"""Hash-chained full-block prefix sharing for the paged KV cache.

Concurrent requests that share a leading token run — a system prompt, a
few-shot header, a common RAG template — map their leading FULL blocks
to the same physical blocks instead of storing a private copy.  The key
for block *i* chains the previous key with the block's tokens, so a hit
on block *i* implies every earlier block matched too.

The cache holds its own reference on every registered block, so a block
outlives the sequences using it and the next request with the same
prefix hits.  Eviction is LRU over entries whose only remaining
reference is the cache's (refcount 1).  Host code, copied from the JAX
package so the port imports nothing of it.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict

from .block_pool import BlockPool

_CHAIN_SEED = b"pathway-kv-prefix-v1"


def chain_hashes(token_ids, block_size: int) -> list[bytes]:
    """One chained 128-bit blake2b key per FULL block of the sequence (a
    real digest: a collision would map a request onto another prompt's
    physical blocks)."""
    keys = []
    prev = _CHAIN_SEED
    for start in range(0, (len(token_ids) // block_size) * block_size,
                       block_size):
        h = hashlib.blake2b(prev, digest_size=16)
        h.update(
            ",".join(str(t) for t in
                     token_ids[start:start + block_size]).encode()
        )
        prev = h.digest()
        keys.append(prev)
    return keys


class PrefixCache:
    """LRU table: chained block key -> physical block id."""

    def __init__(self, pool: BlockPool):
        self.pool = pool
        self._entries: OrderedDict[bytes, int] = OrderedDict()
        self._owned: dict[int, bytes] = {}  # block -> key (reverse map)
        self._lock = threading.RLock()

    def __len__(self) -> int:
        return len(self._entries)

    def external_refs(self) -> dict[int, int]:
        """The cache's own holds, for BlockPool.check_invariants."""
        with self._lock:
            return {b: 1 for b in self._owned}

    def match(self, token_ids) -> tuple[list[int], list[bytes]]:
        """Longest shared prefix: ``(shared_block_ids, keys)`` where
        ``keys`` covers every full block of ``token_ids`` (for a later
        :meth:`insert`).  Matching stops at the first miss."""
        keys = chain_hashes(token_ids, self.pool.block_size)
        shared: list[int] = []
        with self._lock:
            for key in keys:
                block = self._entries.get(key)
                if block is None:
                    break
                self._entries.move_to_end(key)
                shared.append(block)
        return shared, keys

    def insert(self, keys: list, block_ids: list[int]) -> int:
        """Register a prefilled sequence's full prompt blocks under their
        chain keys; already-registered keys are skipped (first writer
        wins).  Returns the number of newly registered blocks."""
        added = 0
        with self._lock:
            for key, block in zip(keys, block_ids):
                if key in self._entries:
                    continue
                self.pool.incref(block)
                self._entries[key] = block
                self._owned[block] = key
                added += 1
        return added

    def _evict_one(self) -> bool:
        """Drop the LRU entry whose block only the cache still references.
        Caller holds the lock."""
        for key in self._entries:  # OrderedDict iterates LRU -> MRU
            block = self._entries[key]
            if self.pool.refcount(block) == 1:
                del self._entries[key]
                del self._owned[block]
                self.pool.decref(block)
                self.pool.kv_stats.record_prefix_eviction()
                return True
        return False

    def evict(self, n_blocks: int) -> int:
        """Free up to ``n_blocks`` refcount-1 cached blocks (LRU first);
        returns how many were released."""
        freed = 0
        with self._lock:
            while freed < n_blocks and self._evict_one():
                freed += 1
        return freed

    def clear(self) -> int:
        """Release every evictable entry."""
        return self.evict(len(self._entries))
