"""Input synchronization groups: the port of
``pathway_tpu/io/_synchronization.py`` (reference:
io/_synchronization.py:59 + src/connectors/synchronization.rs, 816 LoC).

Sources in a group advance through their sync column together: an event may
only be emitted when its value is within `max_difference` of what every
other active source has reached.  The gating value is the reference's
`max_possible_value`:

    per source:  max(last_reported + max_difference, next_proposed)
    group:       min over active sources, floored at max(last_reported)

A source whose next event exceeds the bound parks it (and everything behind
it, preserving order) until the laggards catch up; a finished source goes
idle and leaves the computation, so the group never deadlocks on an
exhausted input.  The engine integration is poll-based: `_SyncGate` wraps
the underlying DataSource and re-offers parked events each poll, which
replaces the reference's oneshot wakeup channels.

Under persistence the gate's offsets are the inner source's, taken after
its latest poll, plus the gate's own state under ``"__sync__"``: the events
it has parked and the last value it reported.  The inner offsets already
cover the parked events, so they travel in the journal record beside the
offsets, and ``seek`` parks them again: a restart re-offers them instead of
seeking past them.

The registered groups live with the parse graph (``G.sync_groups``), so
``G.clear()`` drops them with the tables their columns belong to.
"""

from __future__ import annotations

import threading
from typing import Any


#: the key of a gate's own state in its offsets (persistence)
SYNC_STATE_KEY = "__sync__"


class SynchronizationGroup:
    def __init__(self, max_difference: Any, name: str = "default"):
        self.max_difference = max_difference
        self.name = name
        self._lock = threading.Lock()
        self._last: dict[int, Any] = {}       # source -> last_reported_value
        self._proposed: dict[int, Any] = {}   # source -> next_proposed_value
        self._idle: dict[int, bool] = {}
        self._next_id = 0

    def register_source(self) -> int:
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            self._idle[sid] = False
            return sid

    def _max_possible(self) -> Any | None:
        actives = [s for s, idle in self._idle.items() if not idle]
        per_source = []
        for s in actives:
            vals = []
            if s in self._last:
                vals.append(self._last[s] + self.max_difference)
            if s in self._proposed:
                vals.append(self._proposed[s])
            if vals:
                per_source.append(max(vals))
            else:
                # a source that has neither proposed nor sent blocks
                # everyone (its first value could be arbitrarily small)
                return None if not self._last else max(self._last.values())
        if not per_source:
            return None  # no active info at all: everything may proceed
        bound = min(per_source)
        if self._last:
            # never contradict confirmed history
            bound = max(bound, max(self._last.values()))
        return bound

    def can_send(self, source_id: int, value: Any) -> bool:
        with self._lock:
            cur = self._proposed.get(source_id)
            if cur is None or value < cur:
                self._proposed[source_id] = value
            bound = self._max_possible()
            if bound is None:
                # only this source has data so far: it may proceed iff it IS
                # the only non-idle source with a proposal
                others = [
                    s for s, idle in self._idle.items()
                    if not idle and s != source_id
                    and s not in self._last and s not in self._proposed
                ]
                return not others
            return value <= bound

    def report(self, source_id: int, value: Any) -> None:
        with self._lock:
            last = self._last.get(source_id)
            if last is None or value > last:
                self._last[source_id] = value
            if self._proposed.get(source_id) == value:
                del self._proposed[source_id]

    def last_reported(self, source_id: int) -> Any | None:
        with self._lock:
            return self._last.get(source_id)

    def set_idle(self, source_id: int, idle: bool = True) -> None:
        with self._lock:
            self._idle[source_id] = idle
            if idle:
                self._proposed.pop(source_id, None)


class _SyncGroupSpec:
    def __init__(self, columns, max_difference, name):
        self.columns = list(columns)
        self.max_difference = max_difference
        self.name = name
        self.group = SynchronizationGroup(max_difference, name)


def register_input_synchronization_group(*columns: Any, max_difference: Any,
                                         name: str = "default") -> None:
    """Reference: pw.io.register_input_synchronization_group.  Each column
    names the sync field of one source's table; the sources' events advance
    together within max_difference of each other."""
    if len(columns) < 2:
        raise ValueError(
            "a synchronization group needs at least two source columns"
        )
    from ..internals import parse_graph as pg

    pg.G.sync_groups.append(_SyncGroupSpec(columns, max_difference, name))


def clear_groups() -> None:
    """Drop every registered group (``parse_graph.G.clear()`` drops them
    too)."""
    from ..internals import parse_graph as pg

    pg.G.sync_groups.clear()


class _SyncGate:
    """DataSource wrapper: holds events back until the group allows them."""

    def __init__(self, inner, group: SynchronizationGroup, col_pos: int):
        self._inner = inner
        self._group = group
        self._sid = group.register_source()
        self._col_pos = col_pos
        self._parked: list = []
        self._finished_inner = False
        # events the gate held back at least once (each counted once)
        self.n_parked = 0

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def is_live(self) -> bool:
        return True

    def start(self) -> None:
        if hasattr(self._inner, "start"):
            self._inner.start()

    def static_events(self) -> list:
        return []

    def poll(self):
        events = list(self._parked)
        n_held = len(events)
        self._parked = []
        if not self._finished_inner:
            if self._inner.is_live():
                more = self._inner.poll()
            else:
                more = self._inner.static_events() or None
                self._finished_inner = True
                if more is None:
                    more = []
            if more is None:
                # finished, but parked events must still gate the group:
                # idle only once the backlog drains (below)
                self._finished_inner = True
            else:
                events.extend(more)
        out = []
        blocked = False
        for i, ev in enumerate(events):
            if not blocked:
                value = ev[2][self._col_pos]
                if self._group.can_send(self._sid, value):
                    self._group.report(self._sid, value)
                    out.append(ev)
                    continue
                # order within the source must hold: park this and the rest
                blocked = True
            self._parked.append(ev)
            if i >= n_held:
                self.n_parked += 1
        if self._finished_inner and not self._parked and not out:
            self._group.set_idle(self._sid)
            return None
        return out

    def get_offsets(self) -> dict:
        fn = getattr(self._inner, "get_offsets", None)
        offsets = dict(fn()) if fn is not None else {}
        offsets[SYNC_STATE_KEY] = {
            "parked": list(self._parked),
            "last": self._group.last_reported(self._sid),
        }
        return offsets

    def seek(self, offsets: dict) -> None:
        offsets = dict(offsets)
        state = offsets.pop(SYNC_STATE_KEY, None)
        if state is not None:
            self._parked = list(state["parked"]) + self._parked
            if state["last"] is not None:
                self._group.report(self._sid, state["last"])
        fn = getattr(self._inner, "seek", None)
        if fn is not None:
            fn(offsets)


def apply_synchronization_groups() -> None:
    """Wrap grouped sources' input nodes with gates (called by pw.run before
    lowering)."""
    from ..internals import parse_graph as pg

    for spec in pg.G.sync_groups:
        if getattr(spec, "_applied", False):
            continue
        spec._applied = True
        for col in spec.columns:
            table = col._table
            node = table._node
            if node.kind != "input":
                raise ValueError(
                    f"synchronization group {spec.name!r}: column "
                    f"{col._name!r} does not belong directly to an input "
                    "table"
                )
            pos = table.column_names().index(col._name)
            node.params["source"] = _SyncGate(
                node.params["source"], spec.group, pos
            )
