"""Fixed-size device block pool for paged KV caching.

One K and one V tensor a shard hold the entire cache for every live
sequence: ``(n_layers, num_blocks, block_size, n_kv_heads / tp,
head_dim)`` on the shard's device (``k`` and ``v`` are the lists of
them, one tensor each at tp = 1).  Sequences address the pool through
per-sequence block tables (ordered lists of physical block ids);
attention reads blocks through the table (paged_attention.py) and writes land at
``(block, offset)`` slots.

Allocation is a free-list pop; blocks are refcounted so full prompt
blocks can be shared between sequences (prefix_cache.py) and forks are
copy-on-write: a fork shares every block of its parent, and the first
append into a shared tail block copies it first — an in-place copy of
one block across all layers, the parent's bytes never mutated.  When the
pool is exhausted the engine preempts a victim (lowest priority class
first, most recent arrival within a class).

Physical block 0 is reserved as the null block: padded block-table
entries and padded batch rows write/read there, so scatter/gather never
needs a branch for invalid rows (the results are masked out).

With a ``mesh`` (``parallel/mesh.TPMesh``) the pool is sharded on the
head axis, a shard on each of its devices, under ONE block table: a
block id means the same head-split block on every shard, so the
allocator's bookkeeping is untouched by sharding, and every tensor
operation (copy-on-write, the tier's gather/scatter) acts on every
shard.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import weakref

import numpy as np
import torch

from .._device import resolve_device
from ..obs.profiler import profiled
from ..parallel.mesh import KV_POOL_SPEC, shard_shape
from .backend import CacheBackend

# live pools by metrics name: a second concurrent pool must not share (and
# corrupt) an existing pool's stats block, so it gets a "#n" suffix; a
# discarded or retired pool frees its name, so a REBUILT pool of the same
# name keeps the monotonic counters
_LIVE_POOLS: "weakref.WeakValueDictionary[str, BlockPool]" = (
    weakref.WeakValueDictionary()
)
_LIVE_POOLS_LOCK = threading.Lock()


def _cow_copy_fn(pool, src, dst):
    """pool[:, dst] = pool[:, src], in place: one block, every layer."""
    pool[:, dst].copy_(pool[:, src])
    return pool


def _tier_gather_fn(pool, idx):
    return torch.index_select(pool, 1, idx)


def _tier_scatter_fn(pool, idx, vals):
    return pool.index_copy_(1, idx.long(), vals)


# registered in the device cost observatory like every serving-path
# program, under the reference's names
_cow_copy = profiled("pw.cow_copy", _cow_copy_fn)
_tier_gather = profiled("pw.kv_tier_suspend", _tier_gather_fn)
_tier_scatter = profiled("pw.kv_tier_resume", _tier_scatter_fn)


def unique_name(name: str, obj, live) -> str:
    """``name``, or ``name#n`` when a live object already holds it;
    registers ``obj`` under the result (caller holds ``live``'s lock)."""
    unique, n = name, 1
    while unique in live:
        unique = f"{name}#{n}"
        n += 1
    live[unique] = obj
    return unique


def _pad_width(nb: int) -> int:
    """Next power of two >= nb: the JAX store's padded gather width."""
    return 1 << max(nb - 1, 0).bit_length() if nb > 1 else 1


class PoolExhausted(RuntimeError):
    """Not enough free blocks; caller should evict prefix blocks or preempt."""

    def __init__(self, message: str = "KV block pool exhausted",
                 needed: int = 0, free: int = 0):
        super().__init__(message)
        self.needed = needed
        self.free = free


@dataclasses.dataclass
class SequenceState:
    """Host-side bookkeeping for one live sequence in the pool."""

    seq_id: int
    block_ids: list[int]
    n_tokens: int
    priority: int = 1  # lower = more urgent
    arrival: int = 0  # pool-local admission counter (preemption tie-break)

    def num_blocks(self) -> int:
        return len(self.block_ids)


class BlockPool(CacheBackend):
    """Refcounted block allocator over stacked per-layer K/V tensors."""

    cache_kind = "paged"
    supports_fork = True
    supports_prefix = True
    supports_preemption = True

    def __init__(self, *, num_blocks: int, block_size: int, n_layers: int,
                 n_heads: int, head_dim: int, dtype=torch.float32,
                 name: str = "kvcache", device="cuda", mesh=None):
        if num_blocks < 2:
            raise ValueError("num_blocks must be >= 2 (block 0 is reserved)")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.n_layers = int(n_layers)
        self.n_heads = int(n_heads)
        self.head_dim = int(head_dim)
        self.dtype = dtype
        self.mesh = mesh
        self.tp = 1 if mesh is None else mesh.size
        if self.n_heads % self.tp:
            legal = [t for t in range(1, self.n_heads + 1)
                     if self.n_heads % t == 0]
            raise ValueError(
                f"cannot shard the KV pool: n_kv_heads={self.n_heads} "
                f"% tp={self.tp} != 0. Legal tp values: {legal}")
        shape = shard_shape(
            (n_layers, num_blocks, block_size, n_heads, head_dim),
            KV_POOL_SPEC, self.tp)
        devices = ([resolve_device(device)] if mesh is None
                   else mesh.devices)
        self.device = devices[0]
        # one K and one V tensor a shard (one of each at tp = 1)
        self.k = [torch.zeros(shape, dtype=dtype, device=d) for d in devices]
        self.v = [torch.zeros(shape, dtype=dtype, device=d) for d in devices]
        # block 0 reserved: never allocated, target of padded writes
        self._free: list[int] = list(range(num_blocks - 1, 0, -1))
        self._ref = np.zeros(num_blocks, np.int32)
        self._seqs: dict[int, SequenceState] = {}
        self._arrival = itertools.count()
        self._lock = threading.RLock()
        self.n_cow = 0
        self.n_preemptions = 0
        from ..serve.metrics import kv_stats  # serve imports kvcache

        with _LIVE_POOLS_LOCK:
            self.name = unique_name(name, self, _LIVE_POOLS)
        # the stats registry is process-global and never pruned: its gauge
        # holds a weakref, so a discarded pool's tensors can be released
        wref = weakref.ref(self)

        def _in_use() -> int:
            pool = wref()
            return 0 if pool is None else pool.blocks_in_use

        self.kv_stats = kv_stats(
            self.name, blocks_in_use_fn=_in_use,
            blocks_total=self.num_blocks - 1, shards=self.tp,
            shard_hbm_bytes=self.per_shard_bytes,
        )

    def retire(self) -> None:
        """Release this pool's registry name now: a supervised restart
        builds a same-name pool while the old one may still be pinned by
        the failure's traceback, and the replacement must re-attach to
        the monotonic counters rather than take a "#1" name."""
        with _LIVE_POOLS_LOCK:
            if _LIVE_POOLS.get(self.name) is self:
                del _LIVE_POOLS[self.name]

    @property
    def blocks_in_use(self) -> int:
        return (self.num_blocks - 1) - len(self._free)

    # -- capacity ----------------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def shards(self) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """The ``(k, v)`` tensors of each shard (one pair at tp = 1)."""
        return list(zip(self.k, self.v))

    @property
    def per_shard_bytes(self) -> int:
        """K + V bytes held by EACH shard (the whole pool at tp = 1)."""
        k, v = self.shards[0]
        return (k.numel() + v.numel()) * k.element_size()

    def state_bytes_per_seq(self, n_tokens: int) -> int:
        """Device bytes of one ``n_tokens`` sequence, summed over the
        shards: its block span times one block's K + V bytes (a block id
        means the same head-split block on every shard)."""
        return (self.blocks_for(max(int(n_tokens), 1))
                * self.per_shard_bytes * self.tp // self.num_blocks)

    def blocks_for(self, n_tokens: int) -> int:
        # 0 tokens -> 0 blocks: a token-less sequence owns nothing
        return -(-n_tokens // self.block_size)

    def sequence(self, seq_id: int) -> SequenceState:
        return self._seqs[seq_id]

    def sequences(self) -> list[SequenceState]:
        return list(self._seqs.values())

    # -- allocation --------------------------------------------------------
    def _pop_free(self) -> int:
        b = self._free.pop()
        self._ref[b] = 1
        return b

    def incref(self, block_id: int) -> None:
        with self._lock:
            if self._ref[block_id] <= 0:
                raise ValueError(f"incref on free block {block_id}")
            self._ref[block_id] += 1

    def decref(self, block_id: int) -> None:
        with self._lock:
            if self._ref[block_id] <= 0:
                raise ValueError(f"double free of block {block_id}")
            self._ref[block_id] -= 1
            if self._ref[block_id] == 0:
                self._free.append(block_id)

    def refcount(self, block_id: int) -> int:
        return int(self._ref[block_id])

    def allocate(self, seq_id: int, n_tokens: int, *,
                 shared_blocks: list[int] | tuple = (),
                 priority: int = 1) -> SequenceState:
        """Register a sequence holding ``n_tokens`` tokens: leading
        ``shared_blocks`` (full blocks already resident — each gets a new
        reference) plus fresh blocks for the remainder.  Raises
        :class:`PoolExhausted` (without side effects) when the free list
        cannot cover the fresh blocks."""
        with self._lock:
            if seq_id in self._seqs:
                raise ValueError(f"sequence {seq_id} already allocated")
            total = self.blocks_for(n_tokens)
            n_shared = len(shared_blocks)
            if n_shared * self.block_size > n_tokens:
                raise ValueError(
                    f"{n_shared} shared blocks cover more than "
                    f"{n_tokens} tokens"
                )
            fresh = total - n_shared
            if fresh > len(self._free):
                raise PoolExhausted(
                    f"need {fresh} blocks, {len(self._free)} free",
                    needed=fresh, free=len(self._free),
                )
            for b in shared_blocks:
                self.incref(b)
            block_ids = list(shared_blocks) + [
                self._pop_free() for _ in range(fresh)
            ]
            state = SequenceState(
                seq_id=seq_id, block_ids=block_ids, n_tokens=n_tokens,
                priority=priority, arrival=next(self._arrival),
            )
            self._seqs[seq_id] = state
            return state

    def _cow_block(self, block_id: int) -> int:
        """Copy-on-write: a private copy of a shared block, every layer,
        copied in place into a fresh block of the same tensors."""
        new = self._pop_free()
        for k, v in self.shards:
            _cow_copy(k, block_id, new)
            _cow_copy(v, block_id, new)
        self.decref(block_id)
        self.n_cow += 1
        self.kv_stats.record_cow()
        return new

    def extend_slots(self, seq_id: int, k: int) -> list[tuple[int, int]]:
        """Pre-extend a sequence by ``k`` write slots in one call (the
        chained-decode contract: a whole chain's slots are reserved
        before dispatch).  Returns the ``(block_id, offset)`` slots in
        append order and advances ``n_tokens`` by ``k``.  ATOMIC: the
        needed block count (a COW of a shared tail + one fresh block per
        crossed boundary) is checked up front, and :class:`PoolExhausted`
        is raised with NO state change when the free list cannot cover
        it."""
        if k <= 0:
            return []
        with self._lock:
            seq = self._seqs[seq_id]
            offset0 = seq.n_tokens % self.block_size
            need = -(-(offset0 + k) // self.block_size) - (1 if offset0 else 0)
            if offset0 and self._ref[seq.block_ids[-1]] > 1:
                need += 1  # COW of the shared tail block
            if need > len(self._free):
                raise PoolExhausted(
                    f"need {need} blocks, {len(self._free)} free",
                    needed=need, free=len(self._free),
                )
            slots: list[tuple[int, int]] = []
            for _ in range(k):
                offset = seq.n_tokens % self.block_size
                if offset == 0:
                    seq.block_ids.append(self._pop_free())
                else:
                    tail = seq.block_ids[-1]
                    if self._ref[tail] > 1:
                        seq.block_ids[-1] = self._cow_block(tail)
                seq.n_tokens += 1
                slots.append((seq.block_ids[-1], offset))
            return slots

    def truncate_slots(self, seq_id: int, k: int) -> None:
        """Roll back the sequence's last ``k`` reserved slots (the inverse
        of :meth:`extend_slots`): ``n_tokens`` shrinks by ``k`` and blocks
        past the new span are released.  Stale bytes past the new end are
        harmless: every read is masked to the live positions."""
        if k <= 0:
            return
        with self._lock:
            seq = self._seqs[seq_id]
            if k > seq.n_tokens:
                raise ValueError(
                    f"cannot roll back {k} slots: sequence {seq_id} "
                    f"holds {seq.n_tokens} tokens"
                )
            seq.n_tokens -= k
            keep = self.blocks_for(seq.n_tokens)
            while len(seq.block_ids) > keep:
                self.decref(seq.block_ids.pop())

    def fork(self, parent_id: int, child_id: int, *,
             priority: int | None = None) -> SequenceState:
        """Child shares every parent block (refcounted); diverging appends
        copy-on-write, so the parent's bytes are preserved."""
        with self._lock:
            parent = self._seqs[parent_id]
            if child_id in self._seqs:
                raise ValueError(f"sequence {child_id} already allocated")
            for b in parent.block_ids:
                self.incref(b)
            child = SequenceState(
                seq_id=child_id, block_ids=list(parent.block_ids),
                n_tokens=parent.n_tokens,
                priority=parent.priority if priority is None else priority,
                arrival=next(self._arrival),
            )
            self._seqs[child_id] = child
            return child

    def free_sequence(self, seq_id: int) -> None:
        """Release the sequence's references; blocks whose refcount reaches
        0 return to the free list."""
        with self._lock:
            seq = self._seqs.pop(seq_id)
            for b in seq.block_ids:
                self.decref(b)

    # -- suspend / resume (backend contract; tiering.SessionStore) ---------
    def suspend_host(self, seq_id: int, context_tokens) -> tuple[dict | None,
                                                                 int]:
        """Gather the sequence's context blocks (those covering
        ``context_tokens``; chain pre-extension past them is not copied)
        into host memory, then free the sequence.  The block list is
        padded with the null block to the next power of two, as the JAX
        store pads it, so the byte charge — the host buffers' real size,
        padding included — equals the JAX store's for the same suspend.
        On the card the host buffers are pinned and each shard's stream is
        synchronised once, after its copies and before the free: a later
        write into the freed blocks cannot overtake the copy.  The payload
        holds one K and one V buffer a shard."""
        nb = self.blocks_for(len(context_tokens))
        if nb == 0:
            self.free_sequence(seq_id)
            return None, 0
        with self._lock:
            blocks = self._seqs[seq_id].block_ids[:nb]
        idx = torch.zeros(_pad_width(nb), dtype=torch.int32)
        idx[:nb] = torch.tensor(blocks, dtype=torch.int32)
        ks, vs = [], []
        for k, v in self.shards:
            dev = k.device
            cuda = dev.type == "cuda"
            for pool, out in ((k, ks), (v, vs)):
                rows = _tier_gather(pool, idx.to(dev))
                buf = torch.empty(rows.shape, dtype=rows.dtype,
                                  pin_memory=cuda)
                buf.copy_(rows, non_blocking=cuda)
                out.append(buf)
            if cuda:
                torch.cuda.current_stream(dev).synchronize()
        self.free_sequence(seq_id)
        return {"k": ks, "v": vs, "nb": nb}, sum(b.nbytes for b in ks + vs)

    def resume_host(self, payload: dict, slot_ids) -> None:
        """Scatter a suspended payload into freshly allocated blocks.
        Padded lanes target block 0, the null block, whose contents no
        read uses.  The host-to-device copies are stream-ordered before
        every later kernel that reads the pools."""
        nb = int(payload["nb"])
        ks, vs = payload["k"], payload["v"]
        table = torch.zeros(ks[0].shape[1], dtype=torch.int32)
        table[:nb] = torch.tensor(list(slot_ids)[:nb], dtype=torch.int32)
        for (k, v), k_rows, v_rows in zip(self.shards, ks, vs):
            dev = k.device
            cuda = dev.type == "cuda"
            idx = table.to(dev)
            _tier_scatter(k, idx, k_rows.to(dev, non_blocking=cuda))
            _tier_scatter(v, idx, v_rows.to(dev, non_blocking=cuda))

    # -- preemption --------------------------------------------------------
    def preempt(self, *, exclude: set | frozenset = frozenset()
                ) -> SequenceState | None:
        """Evict one victim: the lowest-priority class first (highest
        numeric priority), most recent arrival within the class.  Returns
        its state (for recompute re-admission), or None when every live
        sequence is excluded."""
        with self._lock:
            candidates = [
                s for s in self._seqs.values() if s.seq_id not in exclude
            ]
            if not candidates:
                return None
            victim = max(candidates, key=lambda s: (s.priority, s.arrival))
            self.free_sequence(victim.seq_id)
            self.n_preemptions += 1
            self.kv_stats.record_preemption()
            return victim

    # -- verification ------------------------------------------------------
    def check_invariants(self, external_refs: dict[int, int] | None = None
                         ) -> None:
        """Assert allocator consistency: the free list and refcounts
        exactly partition the pool, and every reference is accounted for
        by a sequence table or ``external_refs`` (the prefix cache's own
        holds)."""
        with self._lock:
            free = list(self._free)
            assert len(free) == len(set(free)), "duplicate free-list entry"
            assert 0 not in free, "reserved block 0 on the free list"
            for b in free:
                assert self._ref[b] == 0, f"free block {b} has refs"
            counted = np.zeros(self.num_blocks, np.int64)
            for seq in self._seqs.values():
                assert len(seq.block_ids) == len(set(seq.block_ids)), (
                    f"sequence {seq.seq_id} table references a block twice"
                )
                assert len(seq.block_ids) == self.blocks_for(seq.n_tokens), (
                    f"sequence {seq.seq_id} table/token-count mismatch"
                )
                for b in seq.block_ids:
                    counted[b] += 1
            for b, n in (external_refs or {}).items():
                counted[b] += n
            mismatched = [
                b for b in range(1, self.num_blocks)
                if counted[b] != self._ref[b]
            ]
            assert not mismatched, (
                f"refcount mismatch on blocks {mismatched[:8]}: "
                f"counted {[int(counted[b]) for b in mismatched[:8]]} vs "
                f"ref {[int(self._ref[b]) for b in mismatched[:8]]}"
            )
            in_use = sum(1 for b in range(1, self.num_blocks)
                         if self._ref[b] > 0)
            assert in_use + len(free) == self.num_blocks - 1, (
                "free list + in-use blocks do not partition the pool"
            )
