"""window_join: join rows that fall into the same window.

The port of ``pathway_tpu/stdlib/temporal/_window_join.py``.

Reference: stdlib/temporal/_window_join.py (1,217 LoC).  Both sides assign
windows (flatten), then an equi-join on (window, *on) follows — fully
incremental.
"""

from __future__ import annotations

from ...internals.desugaring import rewrite
from ...internals.expression import ColumnReference, ConstExpression, wrap
from ...internals.table import Table
from ...internals.thisclass import ThisMetaclass, base_placeholder
from ...internals.thisclass import left as left_ph
from ...internals.thisclass import right as right_ph
from ...internals.thisclass import this as this_ph
from ._interval_join import _sub_sides
from ._window import Window


class WindowJoinResult:
    def __init__(self, left: Table, right: Table, left_time, right_time,
                 window: Window, on: tuple, how: str):
        self._left, self._right, self._how = left, right, how
        from ...internals import dtype as dt
        from ...internals.expression import ApplyExpression

        assign = window.assign_fn()
        lt, rt = left, right
        lte = _sub_sides(left_time, lt, rt)
        rte = _sub_sides(right_time, lt, rt)
        lb = lt.with_columns(
            _pw_w=ApplyExpression(assign, dt.List(dt.ANY), (lte,), {})
        )
        lb = lb.flatten(lb._pw_w)
        rb = rt.with_columns(
            _pw_w=ApplyExpression(assign, dt.List(dt.ANY), (rte,), {})
        )
        rb = rb.flatten(rb._pw_w)
        self._lb, self._rb = lb, rb
        conds = [lb._pw_w == rb._pw_w]
        for cond in on:
            cond = _sub_sides(cond, lt, rt)
            conds.append(_remap(cond, lt, lb, rt, rb))
        self._jr = lb.join(rb, *conds)

    def select(self, *args, **kwargs) -> Table:
        lt, rt, lb, rb = self._left, self._right, self._lb, self._rb
        exprs = {}
        for a in args:
            if isinstance(a, ThisMetaclass):
                base = base_placeholder(a)
                src = lt if base is left_ph else rt if base is right_ph else None
                srcs = [src] if src else [lt, rt]
                for s in srcs:
                    for n in s.column_names():
                        if n not in a._pw_exclusions and n not in exprs:
                            exprs[n] = s[n]
            elif isinstance(a, ColumnReference):
                exprs[a.name] = a
            else:
                raise ValueError("positional args must be columns")
        exprs.update(kwargs)
        # pw.this._pw_window available
        mapped = {}
        for n, e in exprs.items():
            e = _sub_sides(e, lt, rt)
            e = _remap(e, lt, lb, rt, rb)
            mapped[n] = e
        inner = self._jr.select(**mapped)
        if self._how == "inner":
            return inner
        out_names = list(mapped.keys())
        parts = [inner]
        if self._how in ("left", "outer"):
            parts.append(self._pad("l", mapped, out_names))
        if self._how in ("right", "outer"):
            parts.append(self._pad("r", mapped, out_names))
        return parts[0].concat(*parts[1:]) if len(parts) > 1 else parts[0]

    def _pad(self, side, mapped, out_names):
        lt, rt, lb, rb = self._left, self._right, self._lb, self._rb
        jt = self._jr._materialize()
        own_b = lb if side == "l" else rb
        other_tbls = (rt, rb) if side == "l" else (lt, lb)
        id_col = "__left_id" if side == "l" else "__right_id"
        matched = jt.select(_pwpad_id=jt[id_col]).with_id(this_ph["_pwpad_id"])
        unmatched = own_b.difference(matched)

        def nullify(e):
            def leaf(ref: ColumnReference):
                if ref.table in other_tbls:
                    return ConstExpression(None)
                if ref.table in ((lt, lb) if side == "l" else (rt, rb)):
                    if ref.name in unmatched._colnames:
                        return unmatched[ref.name]
                return ref

            return rewrite(e, leaf)

        return unmatched.select(**{n: nullify(mapped[n]) for n in out_names})


def _remap(e, lt, lb, rt, rb):
    def leaf(ref: ColumnReference):
        if ref.table is lt and ref.name in lb._colnames:
            return lb[ref.name]
        if ref.table is rt and ref.name in rb._colnames:
            return rb[ref.name]
        return ref

    return rewrite(wrap(e), leaf)


def window_join(self: Table, other: Table, self_time, other_time, window: Window,
                *on, how: str = "inner") -> WindowJoinResult:
    return WindowJoinResult(self, other, self_time, other_time, window, on, how)


def window_join_inner(self, other, self_time, other_time, window, *on):
    return window_join(self, other, self_time, other_time, window, *on, how="inner")


def window_join_left(self, other, self_time, other_time, window, *on):
    return window_join(self, other, self_time, other_time, window, *on, how="left")


def window_join_right(self, other, self_time, other_time, window, *on):
    return window_join(self, other, self_time, other_time, window, *on, how="right")


def window_join_outer(self, other, self_time, other_time, window, *on):
    return window_join(self, other, self_time, other_time, window, *on, how="outer")
