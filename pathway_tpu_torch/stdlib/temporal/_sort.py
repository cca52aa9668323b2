"""Table.sort — prev/next pointers per instance, maintained incrementally.

The port of ``pathway_tpu/stdlib/temporal/_sort.py``.

Reference: sort_table (dataflow.rs:2296) + prev_next.rs (895 LoC): maintains,
for each row, pointers to its predecessor/successor in (instance, key-expr)
order.  Here each instance keeps a sorted array of (orderable-key, row-key);
a delta bisects to its position (O(log n) search + C-level memmove), and
only the touched row and its adjacent neighbors are marked dirty — the
engine's diff layer then emits exactly the changed pointer rows.  Bulk
batches (cold load / backfill) skip per-event bisection and rebuild the
touched instances with one sort.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Any

from ...engine.graph import DiffOutputOperator
from ...engine.runner import register_lowering, _env_for, _compile
from ...internals import dtype as dt
from ...internals import parse_graph as pg
from ...internals.table import Table
from ...internals.value import hash_values

_BULK_THRESHOLD = 1024


class SortOperator(DiffOutputOperator):
    """Output universe = input universe; columns = (prev, next)."""

    # orders/entry are derived-but-durable: snapshot restore must bring the
    # sort index back with the row state (cf. gradual_broadcast.py)
    _STATE_ATTRS = ("state", "last_out", "orders", "entry")

    def __init__(self, env, key_fn, inst_fn, name="sort"):
        super().__init__(1, name)
        self.env = env
        self.key_fn = key_fn
        self.inst_fn = inst_fn
        # instance -> sorted list of (orderable_sort_key, row_key); emptied
        # instances are pruned so state (and snapshots) track live rows
        self.orders: dict[Any, list] = {}
        # row_key -> (item, instance) where item is the tuple in the list
        self.entry: dict[Any, tuple] = {}
        self._extra_dirty: set = set()

    def _sort_entry(self, key, row):
        env = self.env.build(key, row)
        sk = self.key_fn(env)
        inst = self.inst_fn(env) if self.inst_fn else None
        try:
            hash(inst)
        except TypeError:
            inst = hash_values(inst)
        return sk, inst

    # -- incremental structure upkeep ---------------------------------------
    def _mark_neighbors(self, lst, pos):
        if pos > 0:
            self._extra_dirty.add(lst[pos - 1][1])
        if pos < len(lst):
            self._extra_dirty.add(lst[pos][1])

    def _remove_entry(self, key):
        ent = self.entry.pop(key, None)
        if ent is None:
            return
        item, inst = ent
        lst = self.orders.get(inst)
        if lst is None:
            return
        pos = bisect.bisect_left(lst, item)
        if pos < len(lst) and lst[pos] == item:
            del lst[pos]
            # the rows now adjacent across the gap get fresh pointers
            self._mark_neighbors(lst, pos)
        if not lst:
            del self.orders[inst]

    def pre_apply(self, port, key, row, diff):
        # membership follows the POST-update Z-set multiplicity (state still
        # holds the pre-update count here): a +1 landing on a negative count
        # must not enter the index, a -1 leaving a positive count must stay
        cnt = self.state[0].data.get(key)
        new_count = (cnt[1] if cnt is not None else 0) + diff
        if new_count <= 0:
            self._remove_entry(key)
            return
        if diff < 0:
            # partial retraction: the surviving row's entry is already
            # positioned; the retracted row must NOT re-position it (a
            # same-time +new/-old pair can arrive in either order)
            return
        sk, inst = self._sort_entry(key, row)
        item = (_orderable(sk), key)
        old = self.entry.get(key)
        if old is not None:
            if old[0] == item and old[1] == inst:
                return  # multiplicity bump, position unchanged
            self._remove_entry(key)
        lst = self.orders.setdefault(inst, [])
        pos = bisect.bisect_left(lst, item)
        self._mark_neighbors(lst, pos)  # future prev and next of `key`
        lst.insert(pos, item)
        self.entry[key] = (item, inst)

    def dirty_keys_for(self, port, key):
        extra = self._extra_dirty
        self._extra_dirty = set()
        extra.add(key)
        return extra

    # -- bulk path: one sort per touched instance ---------------------------
    def process(self, port, updates, time):
        if len(updates) < _BULK_THRESHOLD:
            super().process(port, updates, time)
            return
        st = self.state[port]
        touched_keys = set()
        for key, row, diff in updates:
            st.apply(key, row, diff)
            touched_keys.add(key)
        # sync entries to the post-batch state, collecting touched instances
        touched_insts = set()
        for key in touched_keys:
            old = self.entry.get(key)
            if old is not None:
                touched_insts.add(old[1])
            row = st.get_row(key)
            if row is None:
                self.entry.pop(key, None)
            else:
                sk, inst = self._sort_entry(key, row)
                self.entry[key] = ((_orderable(sk), key), inst)
                touched_insts.add(inst)
        # rebuild ONLY from the touched instances' existing sorted lists plus
        # the touched keys' fresh entries — O(touched instance sizes), not
        # O(total rows)
        fresh: dict[Any, list] = defaultdict(list)
        for key in touched_keys:
            ent = self.entry.get(key)
            if ent is not None:
                fresh[ent[1]].append(ent[0])
        for inst in touched_insts:
            base = [
                it for it in self.orders.get(inst, ())
                if it[1] not in touched_keys
            ]
            members = base + fresh.get(inst, [])
            members.sort()
            if members:
                self.orders[inst] = members
            else:
                self.orders.pop(inst, None)
            self._dirty.update(k for _sk, k in members)
        self._dirty.update(touched_keys)

    def compute(self, key):
        if self.state[0].get_row(key) is None:
            return None
        ent = self.entry.get(key)
        if ent is None:
            return None
        item, inst = ent
        lst = self.orders.get(inst, ())
        pos = bisect.bisect_left(lst, item)
        if pos >= len(lst) or lst[pos] != item:
            return None
        # neighbors must be live output rows (a stale index entry for a
        # retracted key must never be pointed at)
        get_row = self.state[0].get_row
        i = pos - 1
        while i >= 0 and get_row(lst[i][1]) is None:
            i -= 1
        prev_k = lst[i][1] if i >= 0 else None
        j = pos + 1
        while j < len(lst) and get_row(lst[j][1]) is None:
            j += 1
        next_k = lst[j][1] if j < len(lst) else None
        return (prev_k, next_k)


def _orderable(v):
    # None sorts first; a list's comparisons raise on unorderable keys
    return (0, 0) if v is None else (1, v)


@register_lowering("sort")
def _lower_sort(node, lg):
    p = node.params
    src = node.input_tables[0]
    return SortOperator(
        _env_for(src),
        _compile(p["key_expr"]),
        _compile(p["instance_expr"]) if p.get("instance_expr") is not None else None,
    )


def sort(self: Table, key=None, instance=None, **kwargs) -> Table:
    key_e = self._desugar(key) if key is not None else self._desugar(kwargs.pop("key", None))
    inst_e = self._desugar(instance) if instance is not None else None
    node = pg.new_node("sort", [self], key_expr=key_e, instance_expr=inst_e)
    dtypes = {"prev": dt.optional(dt.POINTER), "next": dt.optional(dt.POINTER)}
    return Table(node, ["prev", "next"], dtypes, self._universe, name="sorted")
