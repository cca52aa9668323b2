"""Temporal-behavior operators: buffer (delay), forget, freeze, and the
forget-immediately serving idiom.

The port of ``pathway_tpu/engine/time_ops.py``.

Reference: src/engine/dataflow/operators/time_column.rs (727 LoC) and the
request/response pattern (internals/table.py:783-846, SURVEY.md §3.5).

Convention carried over from the reference's alt-neu protocol
(src/connectors/mod.rs:248): regular data flows at even logical times;
retractions produced by *forgetting* are emitted at odd times, so
`filter_out_results_of_forgetting` is simply "drop odd-time updates".
"""

from __future__ import annotations

from typing import Any

from ..internals import parse_graph as pg
from .graph import Operator
from .types import consolidate


class ForgetImmediatelyOperator(Operator):
    """Insert each row, retract it at the next (odd) time — queries become
    one-shot (reference: forget_immediately)."""

    def process(self, port, updates, time):
        self.emit(time, updates)
        even = time - (time % 2)
        retractions = [(k, row, -d) for k, row, d in updates]
        self.emit(even + 1, retractions)


class FilterOutForgettingOperator(Operator):
    """Drop updates stamped at odd (forgetting) times."""

    def process(self, port, updates, time):
        if time % 2 == 1:
            return
        self.emit(time, updates)


class BufferOperator(Operator):
    """Delay rows until the observed event-time frontier passes their
    threshold (reference: buffer / CommonBehavior.delay).

    threshold_fn/time_fn evaluate over the row; the event-time frontier is
    the max time-column value seen so far.
    """

    _STATE_ATTRS = ("pending", "frontier")

    def __init__(self, env, threshold_fn, time_fn, name="buffer"):
        super().__init__(name)
        self.env = env
        self.threshold_fn = threshold_fn
        self.time_fn = time_fn
        self.pending: list[tuple[Any, Any, int, Any]] = []  # (key,row,diff,thr)
        self.frontier = None

    def process(self, port, updates, time):
        out = []
        for key, row, diff in updates:
            e = self.env.build(key, row)
            t = self.time_fn(e)
            if t is not None and (self.frontier is None or t > self.frontier):
                self.frontier = t
            thr = self.threshold_fn(e)
            if thr is None or (self.frontier is not None and thr <= self.frontier):
                out.append((key, row, diff))
            else:
                self.pending.append((key, row, diff, thr))
        if out:
            self.emit(time, out)

    def flush(self, time):
        if self.frontier is None or not self.pending:
            return
        release, keep = [], []
        for key, row, diff, thr in self.pending:
            if thr <= self.frontier:
                release.append((key, row, diff))
            else:
                keep.append((key, row, diff, thr))
        self.pending = keep
        if release:
            self.emit(time, consolidate(release))

    def on_end(self):
        # end of input: release everything (batch-mode semantics)
        if self.pending:
            t = self.scheduler.frontier + 2 if self.scheduler else 0
            t -= t % 2
            self.emit(max(t, 0), consolidate([(k, r, d) for k, r, d, _ in self.pending]))
            self.pending = []


class ForgetOperator(Operator):
    """Retract rows once the event-time frontier passes their threshold;
    retractions flow at odd times (reference: forget)."""

    _STATE_ATTRS = ("live", "frontier")

    def __init__(self, env, threshold_fn, time_fn, mark_forgetting: bool = True,
                 name="forget"):
        super().__init__(name)
        self.env = env
        self.threshold_fn = threshold_fn
        self.time_fn = time_fn
        self.mark_forgetting = mark_forgetting
        self.live: dict[Any, tuple[Any, int, Any]] = {}  # key -> (row, diff, thr)
        self.frontier = None

    def process(self, port, updates, time):
        out = []
        for key, row, diff in updates:
            e = self.env.build(key, row)
            t = self.time_fn(e)
            if t is not None and (self.frontier is None or t > self.frontier):
                self.frontier = t
            thr = self.threshold_fn(e)
            if self.frontier is not None and thr is not None and thr <= self.frontier:
                continue  # already expired on arrival
            out.append((key, row, diff))
            cur = self.live.get(key)
            n = (cur[1] if cur else 0) + diff
            if n == 0:
                self.live.pop(key, None)
            else:
                self.live[key] = (row, n, thr)
        if out:
            self.emit(time, out)

    def flush(self, time):
        if self.frontier is None:
            return
        expired = [
            (k, row, -n)
            for k, (row, n, thr) in self.live.items()
            if thr is not None and thr <= self.frontier
        ]
        if expired:
            for k, _row, _n in expired:
                self.live.pop(k, None)
            even = time - (time % 2)
            self.emit(even + 1 if self.mark_forgetting else time, expired)


class FreezeOperator(Operator):
    """Ignore updates arriving after their threshold passed
    (reference: freeze / CommonBehavior.cutoff)."""

    _STATE_ATTRS = ("frontier",)

    def __init__(self, env, threshold_fn, time_fn, name="freeze"):
        super().__init__(name)
        self.env = env
        self.threshold_fn = threshold_fn
        self.time_fn = time_fn
        self.frontier = None

    def process(self, port, updates, time):
        out = []
        for key, row, diff in updates:
            e = self.env.build(key, row)
            t = self.time_fn(e)
            thr = self.threshold_fn(e)
            if (
                self.frontier is not None
                and thr is not None
                and thr <= self.frontier
            ):
                continue  # late: window already cut off
            out.append((key, row, diff))
            if t is not None and (self.frontier is None or t > self.frontier):
                self.frontier = t
        if out:
            self.emit(time, out)


# ---------------------------------------------------------------------------
# lowering + Table-level helpers
# ---------------------------------------------------------------------------

from .runner import _compile, _env_for, register_lowering  # noqa: E402


@register_lowering("forget_immediately")
def _lower_forget_immediately(node, lg):
    return ForgetImmediatelyOperator(name="forget_immediately")


@register_lowering("filter_out_forgetting")
def _lower_filter_out_forgetting(node, lg):
    return FilterOutForgettingOperator(name="filter_out_forgetting")


@register_lowering("buffer")
def _lower_buffer(node, lg):
    src = node.input_tables[0]
    return BufferOperator(
        _env_for(src), _compile(node.params["threshold"]), _compile(node.params["time"])
    )


@register_lowering("forget")
def _lower_forget(node, lg):
    src = node.input_tables[0]
    return ForgetOperator(
        _env_for(src),
        _compile(node.params["threshold"]),
        _compile(node.params["time"]),
        node.params.get("mark_forgetting", True),
    )


@register_lowering("freeze")
def _lower_freeze(node, lg):
    src = node.input_tables[0]
    return FreezeOperator(
        _env_for(src), _compile(node.params["threshold"]), _compile(node.params["time"])
    )


def install_table_methods() -> None:
    from ..internals.table import Table, Universe

    def _unary_time_node(self, kind: str, threshold, time_col, **extra):
        node = pg.new_node(
            kind, [self],
            threshold=self._desugar(threshold),
            time=self._desugar(time_col),
            **extra,
        )
        return Table(node, self._colnames, self._dtypes, Universe(parent=self._universe))

    def _forget(self, threshold_column, time_column, mark_forgetting_records=True):
        return _unary_time_node(
            self, "forget", threshold_column, time_column,
            mark_forgetting=mark_forgetting_records,
        )

    def _buffer(self, threshold_column, time_column):
        return _unary_time_node(self, "buffer", threshold_column, time_column)

    def _freeze(self, threshold_column, time_column):
        return _unary_time_node(self, "freeze", threshold_column, time_column)

    def _forget_immediately(self):
        node = pg.new_node("forget_immediately", [self])
        return Table(node, self._colnames, self._dtypes, Universe(parent=self._universe))

    def _filter_out_results_of_forgetting(self):
        node = pg.new_node("filter_out_forgetting", [self])
        return Table(node, self._colnames, self._dtypes, Universe(parent=self._universe))

    def ignore_late(self, threshold_column, time_column):
        return _forget(self, threshold_column, time_column, mark_forgetting_records=False)

    def forget(self, time_column, threshold, mark_forgetting_records=False):
        """Retract entries once time_column <= max(time_column) - threshold
        (reference: Table.forget, internals/table.py:671).  The engine op
        expires a row when its threshold column reaches the observed max
        time, so the public (time, interval) form maps onto
        threshold_column = time_column + threshold."""
        return _forget(self, time_column + threshold, time_column,
                       mark_forgetting_records=mark_forgetting_records)

    def buffer(self, time_column, threshold):
        """Hold entries until time_column <= max(time_column) - threshold
        (reference: Table.buffer, internals/table.py:921)."""
        return _buffer(self, time_column + threshold, time_column)

    def filter_out_results_of_forgetting(self, ensure_consistency: bool = False):
        """Public alias (reference: Table.filter_out_results_of_forgetting);
        deletions stamped at forgetting times are dropped.
        ensure_consistency is accepted for signature parity — this engine's
        forgetting marks are per-update, so no extra tracking is needed."""
        return _filter_out_results_of_forgetting(self)

    Table._forget = _forget
    Table._buffer = _buffer
    Table._freeze = _freeze
    Table._forget_immediately = _forget_immediately
    Table._filter_out_results_of_forgetting = _filter_out_results_of_forgetting
    Table.ignore_late = ignore_late
    Table.forget = forget
    Table.buffer = buffer
    Table.filter_out_results_of_forgetting = filter_out_results_of_forgetting
