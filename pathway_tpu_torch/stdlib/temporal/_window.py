"""Windows: tumbling / sliding / session / intervals_over.

The port of ``pathway_tpu/stdlib/temporal/_window.py``.

Reference: stdlib/temporal/_window.py:39-873.  TPU-first design: window
assignment is a pure rowwise expression (rows flatten into one row per
assigned window), so the whole pipeline stays incremental and the groupby
reduction benefits from the engine's batched reducers.
"""

from __future__ import annotations

import datetime

from ...internals import dtype as dt
from ...internals.desugaring import rewrite
from ...internals.expression import (
    ApplyExpression,
    ColumnExpression,
    ColumnReference,
    wrap,
)
from ...internals.table import Table
from .temporal_behavior import Behavior


def _as_number(x):
    if isinstance(x, datetime.timedelta):
        return x
    return x


class Window:
    def assign_fn(self):
        raise NotImplementedError


class TumblingWindow(Window):
    def __init__(self, duration, origin=None):
        self.duration = duration
        self.origin = origin

    def assign_fn(self):
        d = self.duration
        origin = self.origin

        def assign(t):
            if t is None:
                return ()
            o = origin
            if o is None:
                o = datetime.datetime(1970, 1, 1, tzinfo=t.tzinfo) if isinstance(
                    t, datetime.datetime
                ) else 0
            k = (t - o) // d
            start = o + k * d
            return ((start, start + d),)

        return assign


class SlidingWindow(Window):
    def __init__(self, hop, duration=None, ratio=None, origin=None):
        self.hop = hop
        self.duration = duration if duration is not None else hop * ratio
        self.origin = origin

    def assign_fn(self):
        hop, dur, origin = self.hop, self.duration, self.origin

        def assign(t):
            if t is None:
                return ()
            o = origin
            if o is None:
                o = datetime.datetime(1970, 1, 1, tzinfo=t.tzinfo) if isinstance(
                    t, datetime.datetime
                ) else 0
            # windows [s, s+dur) with s = o + k*hop, s <= t < s+dur
            first_k = (t - o - dur) // hop + 1
            out = []
            k = first_k
            while True:
                s = o + k * hop
                if s > t:
                    break
                out.append((s, s + dur))
                k += 1
            return tuple(out)

        return assign


class SessionWindow(Window):
    def __init__(self, predicate=None, max_gap=None):
        self.predicate = predicate
        self.max_gap = max_gap


_OUTER_DEFAULT = object()


class IntervalsOverWindow(Window):
    def __init__(self, at, lower_bound, upper_bound, is_outer=_OUTER_DEFAULT):
        self.at = at
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound
        self.is_outer_explicit = is_outer is not _OUTER_DEFAULT
        self.is_outer = True if is_outer is _OUTER_DEFAULT else bool(is_outer)


def tumbling(duration=None, origin=None, **kwargs) -> TumblingWindow:
    if duration is None:
        duration = kwargs.pop("length", None)
    return TumblingWindow(duration, origin)


def sliding(hop, duration=None, ratio=None, origin=None) -> SlidingWindow:
    return SlidingWindow(hop, duration, ratio, origin)


def session(*, predicate=None, max_gap=None) -> SessionWindow:
    return SessionWindow(predicate, max_gap)


def intervals_over(*, at, lower_bound, upper_bound,
                   is_outer=_OUTER_DEFAULT) -> IntervalsOverWindow:
    """Windows centered at `at` points (reference default: is_outer=True —
    points with no rows still emit a window with empty aggregates)."""
    return IntervalsOverWindow(at, lower_bound, upper_bound, is_outer)


class WindowedTable:
    """Result of windowby(); reduce() mirrors GroupedTable with the special
    _pw_window / _pw_window_start / _pw_window_end / _pw_instance columns."""

    def __init__(self, table: Table, base: Table, gb_cols: list[str],
                 outer_points: Table | None = None):
        self._source = table
        self._base = base
        self._gb_cols = gb_cols
        # intervals_over(is_outer=True): one row per at-point whose window may
        # be empty; empty windows emit reducer defaults
        self._outer_points = outer_points

    def reduce(self, *args, **kwargs) -> Table:
        base = self._base
        source = self._source

        def remap_refs(e):
            def leaf(ref: ColumnReference):
                t = ref.table
                if t is base:
                    return ref
                if ref.name in base._colnames:
                    return base[ref.name]
                return ref

            return rewrite(wrap(e), leaf)

        new_args = [remap_refs(a) for a in args]
        new_kwargs = {}
        from ...internals.table import _map_reducer_args

        for n, e in kwargs.items():
            new_kwargs[n] = _map_reducer_args(remap_refs(e), remap_refs)
        grouped = base.groupby(*[base[c] for c in self._gb_cols])
        reduced = grouped.reduce(*new_args, **new_kwargs)
        if self._outer_points is None:
            return reduced
        return self._add_empty_windows(reduced, new_args, new_kwargs)

    def _add_empty_windows(self, reduced: Table, args, kwargs) -> Table:
        """Union in rows for at-points whose window matched nothing,
        carrying each reducer's empty-state default."""
        from ...engine.reducers_impl import make_state
        from ...internals.desugaring import rewrite_nodes
        from ...internals.expression import ConstExpression, ReducerExpression

        pts = self._outer_points  # columns: _pw_instance/_pw_window/start/end
        # key the points exactly like the groupby keys its groups
        pts = pts.with_id(
            pts.pointer_from(*[pts[c] for c in self._gb_cols])
        )

        def pad_expr(e):
            """Evaluate the reduce expression over an empty group: each
            reducer node becomes its empty-state default; grouping-column
            refs resolve against the point table."""

            def node_fn(node):
                if isinstance(node, ReducerExpression):
                    # built-in reducers give their empty value (0, None);
                    # a stateful reducer's finish over the empty (None)
                    # accumulator may raise TypeError, and then the
                    # window carries None, as the JAX package's does
                    try:
                        default = make_state(
                            node._reducer, dict(node._kwargs)
                        ).value()
                    except TypeError:
                        default = None
                    return ConstExpression(default)
                if isinstance(node, ColumnReference):
                    if node.name in pts._colnames:
                        return pts[node.name]
                    return ConstExpression(None)
                return None

            return rewrite_nodes(wrap(e), node_fn)

        out_cols: dict[str, object] = {}
        for a in args:
            if isinstance(a, ColumnReference):
                out_cols[a.name] = pad_expr(a)
        for n, e in kwargs.items():
            out_cols[n] = pad_expr(e)
        pads = pts.select(**out_cols)
        missing = pads.difference(reduced)
        return reduced.concat(missing)


def windowby(
    self: Table,
    time_expr: ColumnExpression,
    *,
    window: Window,
    instance: ColumnExpression | None = None,
    behavior: Behavior | None = None,
    shard=None,
) -> WindowedTable:
    if isinstance(window, SessionWindow):
        return _session_windowby(self, time_expr, window, instance)
    if isinstance(window, IntervalsOverWindow):
        return _intervals_over_windowby(self, time_expr, window, instance)
    time_e = self._desugar(time_expr)
    inst_e = self._desugar(instance) if instance is not None else wrap(None)
    assign = window.assign_fn()
    win_expr = ApplyExpression(assign, dt.List(dt.ANY), (time_e,), {})
    cols = {n: self[n] for n in self._colnames if not n.startswith("_pw_")}
    base = self.select(
        **cols,
        _pw_window_assigned=win_expr,
        _pw_instance=inst_e,
        _pw_t=time_e,
    )
    base = base.flatten(base._pw_window_assigned)
    base = base.with_columns(
        _pw_window=base._pw_window_assigned,
        _pw_window_start=base._pw_window_assigned[0],
        _pw_window_end=base._pw_window_assigned[1],
    ).without("_pw_window_assigned")
    base = _apply_behavior(base, behavior)
    return WindowedTable(self, base, ["_pw_instance", "_pw_window", "_pw_window_start", "_pw_window_end"])


def _apply_behavior(base: Table, behavior: Behavior | None) -> Table:
    """Lower windowby behaviors onto the engine's buffer/freeze/forget ops
    (reference: temporal_behavior.py → time_column.rs)."""
    if behavior is None:
        return base
    from .temporal_behavior import CommonBehavior, ExactlyOnceBehavior

    # ORDER MATTERS: freeze (cutoff) must see the RAW stream so its
    # event-time frontier advances on every arriving row — a freeze placed
    # after the buffer only observes buffer survivors and misses the clock
    # rows still sitting in the buffer, letting late rows through
    # (reference fuses both in one operator, time_column.rs:38-50)
    if isinstance(behavior, ExactlyOnceBehavior):
        shift = behavior.shift

        def thr_of(tbl):
            return (
                tbl._pw_window_end + shift if shift is not None
                else tbl._pw_window_end
            )

        out = base._freeze(thr_of(base), base._pw_t)
        out = out._buffer(thr_of(out), out._pw_t)
        return out
    if isinstance(behavior, CommonBehavior):
        out = base
        if behavior.cutoff is not None:
            out = out._freeze(out._pw_window_end + behavior.cutoff, out._pw_t)
        if behavior.delay is not None:
            out = out._buffer(out._pw_window_start + behavior.delay, out._pw_t)
        if behavior.cutoff is not None and not behavior.keep_results:
            out = out._forget(
                out._pw_window_end + behavior.cutoff, out._pw_t,
                mark_forgetting_records=False,
            )
        return out
    return base


def _session_windowby(table: Table, time_expr, window: SessionWindow, instance):
    """Sessions need cross-row merging: per instance, sort times and merge
    adjacent rows whose gap passes the predicate.  Implemented with a
    full-group recompute reducer (correct, modest-scale; incremental engine
    operator is a planned upgrade)."""
    from ...internals import reducers as R

    time_e = table._desugar(time_expr)
    inst_e = table._desugar(instance) if instance is not None else wrap(None)
    max_gap = window.max_gap
    predicate = window.predicate
    if predicate is None:
        if max_gap is None:
            raise ValueError("session() needs predicate or max_gap")
        predicate = lambda a, b: (b - a) <= max_gap

    base0 = table.with_columns(_pw_t=time_e, _pw_instance=inst_e)

    # collect per-instance sorted times once per change, assign session ids
    per_inst = base0.groupby(base0._pw_instance).reduce(
        base0._pw_instance,
        _pw_times=R.sorted_tuple(base0._pw_t),
    )

    def session_bounds(times, t):
        # sessions are maximal runs of sorted times whose adjacent gaps pass
        # the predicate; return the run containing t
        if times is None or t is None:
            return None
        runs = []
        run = [times[0]]
        for a, b in zip(times, times[1:]):
            if predicate(a, b):
                run.append(b)
            else:
                runs.append(run)
                run = [b]
        runs.append(run)
        for run in runs:
            if run[0] <= t <= run[-1]:
                return (run[0], run[-1])
        return (t, t)

    looked = per_inst.ix(base0.pointer_from(base0._pw_instance), optional=True)
    base = base0.with_columns(
        _pw_window=ApplyExpression(
            session_bounds, dt.ANY, (looked._pw_times, base0._pw_t), {}
        ),
    )
    base = base.with_columns(
        _pw_window_start=base._pw_window[0],
        _pw_window_end=base._pw_window[1],
    ).without("_pw_t")
    return WindowedTable(table, base, ["_pw_instance", "_pw_window", "_pw_window_start", "_pw_window_end"])


def _intervals_over_windowby(table: Table, time_expr, window: IntervalsOverWindow, instance):
    """intervals_over: one window per row of `at`, containing source rows with
    t in [p+lower, p+upper]."""
    is_outer = window.is_outer
    if is_outer and instance is not None:
        if window.is_outer_explicit:
            raise NotImplementedError(
                "intervals_over(is_outer=True) with instance= is not supported"
            )
        is_outer = False  # defaulted: instance-windows stay inner
    at = window.at
    if not isinstance(at, Table):
        # column reference to the at-times
        at_tbl = at.table.select(_pw_at=at)
    else:
        raise ValueError("intervals_over at= must be a column reference")
    lower, upper = window.lower_bound, window.upper_bound
    time_e = table._desugar(time_expr)
    inst_e = table._desugar(instance) if instance is not None else wrap(None)
    base0 = table.with_columns(_pw_t=time_e, _pw_instance=inst_e)
    pts = at_tbl.groupby(at_tbl._pw_at).reduce(at_tbl._pw_at)  # distinct points

    # join every row with candidate points via an equality-free pairing:
    # bucket both sides on a constant to keep the join incremental
    b1 = base0.with_columns(_pw_one=1)
    p1 = pts.with_columns(_pw_one=1)
    jr = b1.join(p1, b1._pw_one == p1._pw_one)
    jt = jr.select(
        *[b1[n] for n in table._colnames],
        _pw_t=b1._pw_t,
        _pw_instance=b1._pw_instance,
        _pw_pt=p1._pw_at,
    )
    inside = jt.filter((jt._pw_t >= jt._pw_pt + lower) & (jt._pw_t <= jt._pw_pt + upper))
    base = inside.with_columns(
        _pw_window=ApplyExpression(
            lambda p: (p + lower, p + upper), dt.ANY, (inside._pw_pt,), {}
        ),
        _pw_window_start=inside._pw_pt + lower,
        _pw_window_end=inside._pw_pt + upper,
    ).without("_pw_t", "_pw_pt")
    outer_points = None
    if is_outer:
        outer_points = pts.select(
            _pw_instance=None,
            _pw_window=ApplyExpression(
                lambda p: (p + lower, p + upper), dt.ANY, (pts._pw_at,), {}
            ),
            _pw_window_start=pts._pw_at + lower,
            _pw_window_end=pts._pw_at + upper,
        )
    return WindowedTable(
        table, base,
        ["_pw_instance", "_pw_window", "_pw_window_start", "_pw_window_end"],
        outer_points=outer_points,
    )
