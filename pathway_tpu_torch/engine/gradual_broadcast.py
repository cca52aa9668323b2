"""Gradual broadcast: incrementally attach a slowly-refining approximate
value to every row of a large table.

The port of ``pathway_tpu/engine/gradual_broadcast.py``.

Re-design of /root/reference/src/engine/dataflow/operators/gradual_broadcast.rs
(497 LoC): the threshold table supplies (lower, value, upper) triplets; each
row's `apx_value` is `upper` when its key is below
scale((value - lower) / (upper - lower), MAX_KEY) and `lower` otherwise.
When the triplet refines, ONLY rows whose keys sit between the old and new
scaled thresholds flip — the point of the operator: a quantile/total that
keeps tightening never forces a full recompute over the big table
(used by Louvain, reference stdlib/graphs/louvain_communities/impl.py:313).

Row state is a Z-set KeyedState (same-key replace/retract batches net
correctly); emissions stabilize per time against last_out, and a key-sorted
order (bisect) lets a threshold move touch exactly the flipped key range.
"""

from __future__ import annotations

import bisect
from typing import Any

from .graph import KeyedState, Operator
from .types import Key, Row, Time, Update, consolidate

_MAX_KEY = (1 << 128) - 1


def _threshold_key(lower, value, upper) -> int:
    if upper == lower:
        return _MAX_KEY if value >= upper else 0
    frac = (value - lower) / (upper - lower)
    frac = min(max(frac, 0.0), 1.0)
    return int(frac * _MAX_KEY)


class GradualBroadcastOperator(Operator):
    """Port 0: the big table (key-partitioned); port 1: the threshold
    triplet table (broadcast to every shard)."""

    _STATE_ATTRS = ("state", "last_out", "sorted_keys", "triplet")

    def __init__(self, lower_fn, value_fn, upper_fn, env1, name="gradual_broadcast"):
        super().__init__(name)
        self.lower_fn = lower_fn
        self.value_fn = value_fn
        self.upper_fn = upper_fn
        self.env1 = env1
        self.state = KeyedState()
        self.last_out: dict[Key, Row] = {}  # key -> emitted row (incl. apx)
        self.sorted_keys: list[Key] = []  # keys currently in last_out
        self.triplet: tuple | None = None
        self._dirty: set[Key] = set()
        self._pending: list[Update] = []

    def _apx(self, key: Key, triplet) -> Any:
        lower, value, upper = triplet
        return upper if int(key) < _threshold_key(lower, value, upper) else lower

    def process(self, port: int, updates: list[Update], time: Time) -> None:
        if port == 1:
            for _key, row, diff in updates:
                if diff > 0:
                    e = self.env1.build(_key, row)
                    self._set_triplet(
                        (self.lower_fn(e), self.value_fn(e), self.upper_fn(e))
                    )
            return
        for key, row, diff in updates:
            self.state.apply(key, row, diff)
            self._dirty.add(key)

    def _set_triplet(self, trip: tuple) -> None:
        old = self.triplet
        self.triplet = trip
        if old == trip:
            return
        if old is None:
            # first triplet: every stored row becomes emittable
            self._dirty.update(k for k, _r in self.state.items())
            return
        old_thr = _threshold_key(*old)
        new_thr = _threshold_key(*trip)
        lo, hi = min(old_thr, new_thr), max(old_thr, new_thr)
        old_lower, _ov, old_upper = old
        new_lower, _nv, new_upper = trip
        i_lo = bisect.bisect_left(self.sorted_keys, lo)
        i_hi = bisect.bisect_left(self.sorted_keys, hi)
        # only the affected emitted keys re-derive: below both thresholds
        # when `upper` changed, above both when `lower` changed, and the
        # flipped band in between
        if old_upper != new_upper:
            self._dirty.update(self.sorted_keys[:i_lo])
        if old_lower != new_lower:
            self._dirty.update(self.sorted_keys[i_hi:])
        self._dirty.update(self.sorted_keys[i_lo:i_hi])

    def flush(self, time: Time) -> None:
        if not self._dirty:
            return
        if self.triplet is None:
            return  # rows stay dirty until the first triplet arrives
        out: list[Update] = []
        for key in self._dirty:
            row = self.state.get_row(key)
            new_out = row + (self._apx(key, self.triplet),) if row is not None else None
            old_out = self.last_out.get(key)
            if new_out == old_out:
                continue
            if old_out is not None:
                out.append((key, old_out, -1))
                del self.last_out[key]
                i = bisect.bisect_left(self.sorted_keys, key)
                if i < len(self.sorted_keys) and self.sorted_keys[i] == key:
                    self.sorted_keys.pop(i)
            if new_out is not None:
                out.append((key, new_out, 1))
                self.last_out[key] = new_out
                bisect.insort(self.sorted_keys, key)
        self._dirty.clear()
        if out:
            self.emit(time, consolidate(out))