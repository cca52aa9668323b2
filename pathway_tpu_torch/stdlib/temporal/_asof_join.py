"""asof_join: match each row with the temporally-closest row of the other side.

The port of ``pathway_tpu/stdlib/temporal/_asof_join.py``.

Reference: stdlib/temporal/_asof_join.py (1,109 LoC) + the prev_next sorted
pointer machinery (src/engine/dataflow/operators/prev_next.rs).  TPU-first
design: a dedicated incremental operator keeps per-join-key time-sorted
arrangements; affected left rows recompute on right-side changes.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Any

from ...engine.graph import DiffOutputOperator
from ...engine.runner import register_lowering, _env_for, _compile
from ...internals import dtype as dt
from ...internals import parse_graph as pg
from ...internals.desugaring import substitute
from ...internals.expression import ColumnReference, wrap
from ...internals.table import Table, Universe
from ...internals.thisclass import ThisMetaclass, base_placeholder
from ...internals.thisclass import left as left_ph
from ...internals.thisclass import right as right_ph
from ...internals.thisclass import this as this_ph
from ...internals.value import hash_values


class AsofJoinOperator(DiffOutputOperator):
    """Port 0: left (output universe), port 1: right."""

    def __init__(self, left_env, right_env, lt_fn, rt_fn, lon_fns, ron_fns,
                 how, direction, left_ncols, right_ncols, name="asof_join"):
        super().__init__(2, name)
        self.left_env, self.right_env = left_env, right_env
        self.lt_fn, self.rt_fn = lt_fn, rt_fn
        self.lon_fns, self.ron_fns = lon_fns, ron_fns
        self.how = how
        self.direction = direction
        self.left_ncols, self.right_ncols = left_ncols, right_ncols
        self.left_by_jk: dict[Any, set] = defaultdict(set)
        self.right_sorted: dict[Any, list] = defaultdict(list)  # [(t, key)]
        self.right_rows: dict[Any, tuple] = {}

    def _jk(self, side, key, row):
        env = (self.left_env if side == "l" else self.right_env).build(key, row)
        fns = self.lon_fns if side == "l" else self.ron_fns
        vals = tuple(f(env) for f in fns)
        try:
            hash(vals)
            return vals
        except TypeError:
            return ("#h", hash_values(vals))

    def pre_apply(self, port, key, row, diff):
        if port == 0:
            jk = self._jk("l", key, row)
            if diff > 0:
                self.left_by_jk[jk].add(key)
            return
        jk = self._jk("r", key, row)
        t = self.rt_fn(self.right_env.build(key, row))
        entry = (t, key)
        lst = self.right_sorted[jk]
        if diff > 0:
            bisect.insort(lst, entry)
            self.right_rows[key] = row
        else:
            i = bisect.bisect_left(lst, entry)
            if i < len(lst) and lst[i] == entry:
                lst.pop(i)
            self.right_rows.pop(key, None)

    def dirty_keys_for(self, port, key):
        if port == 0:
            return (key,)
        # right change: all left rows sharing the join key are affected
        row_entry = self.state[1].data.get(key)
        jk = None
        if row_entry is not None:
            jk = self._jk("r", key, row_entry[0])
        if jk is None:
            return ()
        return tuple(self.left_by_jk.get(jk, ()))

    def process(self, port, updates, time):
        # right deltas must mark left dirty BEFORE the index drops the entry
        st = self.state[port]
        for key, row, diff in updates:
            if port == 1:
                self._dirty.update(self.dirty_keys_for(1, key))
            self.pre_apply(port, key, row, diff)
            st.apply(key, row, diff)
            if port == 1:
                self._dirty.update(self.dirty_keys_for(1, key))
            else:
                self._dirty.add(key)

    def compute(self, lkey):
        lrow = self.state[0].get_row(lkey)
        if lrow is None:
            return None
        jk = self._jk("l", lkey, lrow)
        t = self.lt_fn(self.left_env.build(lkey, lrow))
        lst = self.right_sorted.get(jk, [])
        match_key = None
        if lst and t is not None:
            if self.direction == "backward":
                i = bisect.bisect_right(lst, (t, _MAX_KEY)) - 1
                if i >= 0:
                    match_key = lst[i][1]
            elif self.direction == "forward":
                i = bisect.bisect_left(lst, (t, -1))
                if i < len(lst):
                    match_key = lst[i][1]
            else:  # nearest
                i = bisect.bisect_right(lst, (t, _MAX_KEY))
                cands = []
                if i - 1 >= 0:
                    cands.append(lst[i - 1])
                if i < len(lst):
                    cands.append(lst[i])
                if cands:
                    match_key = min(cands, key=lambda e: (abs(e[0] - t),))[1]
        if match_key is None:
            if self.how in ("left", "outer"):
                return lrow + (None,) * self.right_ncols + (lkey, None)
            return None
        rrow = self.right_rows.get(match_key)
        if rrow is None:
            if self.how in ("left", "outer"):
                return lrow + (None,) * self.right_ncols + (lkey, None)
            return None
        return lrow + rrow + (lkey, match_key)


_MAX_KEY = 1 << 200


@register_lowering("asof_join")
def _lower_asof(node, lg):
    p = node.params
    lt, rt = node.input_tables
    return AsofJoinOperator(
        _env_for(lt), _env_for(rt),
        _compile(p["left_time"]), _compile(p["right_time"]),
        [_compile(e) for e in p["left_on"]], [_compile(e) for e in p["right_on"]],
        p["how"], p["direction"], len(lt._colnames), len(rt._colnames),
    )


class AsofJoinResult:
    def __init__(self, left: Table, right: Table, left_time, right_time, on,
                 how: str, direction: str, defaults: dict | None = None):
        self._left, self._right = left, right
        self._how = how
        self._defaults = defaults or {}
        sub = lambda e: substitute(wrap(e), {left_ph: left, right_ph: right, this_ph: left})
        lte, rte = sub(left_time), sub(right_time)
        left_on, right_on = [], []
        for cond in on:
            cond = sub(cond)
            from ...internals.expression import BinaryOpExpression

            if not (isinstance(cond, BinaryOpExpression) and cond._op == "=="):
                raise ValueError("asof_join conditions must be equalities")
            a, b = cond._left, cond._right
            a_tables = {r.table for r in a._dependencies()}
            if left in a_tables:
                left_on.append(a)
                right_on.append(b)
            else:
                left_on.append(b)
                right_on.append(a)
        node = pg.new_node(
            "asof_join", [left, right],
            left_time=lte, right_time=rte, left_on=left_on, right_on=right_on,
            how=how, direction=direction,
        )
        lcols, rcols = left.column_names(), right.column_names()
        out_names = [f"__l_{n}" for n in lcols] + [f"__r_{n}" for n in rcols] + ["__left_id", "__right_id"]
        aliases = {}
        for i, n in enumerate(lcols):
            aliases[(id(left), n)] = i
        for i, n in enumerate(rcols):
            aliases[(id(right), n)] = len(lcols) + i
        aliases[(id(left), "id")] = len(lcols) + len(rcols)
        aliases[(id(right), "id")] = len(lcols) + len(rcols) + 1
        dtypes = {}
        for n in lcols:
            dtypes[f"__l_{n}"] = left._dtype_of(n)
        for n in rcols:
            dtypes[f"__r_{n}"] = dt.optional(right._dtype_of(n))
        dtypes["__left_id"] = dt.POINTER
        dtypes["__right_id"] = dt.optional(dt.POINTER)
        self._jt = Table(node, out_names, dtypes, Universe(), name="asof_joined", aliases=aliases)

    def select(self, *args, **kwargs) -> Table:
        lt, rt = self._left, self._right
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
        mapped = {
            n: substitute(wrap(e), {left_ph: lt, right_ph: rt, this_ph: lt})
            for n, e in exprs.items()
        }
        return self._jt._rowwise(mapped, name="asof-select")


def asof_join(self: Table, other: Table, self_time, other_time, *on,
              how: str = "left", defaults: dict | None = None,
              direction: str = "backward", behavior=None) -> AsofJoinResult:
    if how == "right":
        swapped = asof_join(other, self, other_time, self_time, *on, how="left",
                            direction=direction)
        return swapped
    return AsofJoinResult(self, other, self_time, other_time, on, how, direction, defaults)


def asof_join_left(self, other, self_time, other_time, *on, **kw):
    kw.pop("how", None)
    return asof_join(self, other, self_time, other_time, *on, how="left", **kw)


def asof_join_right(self, other, self_time, other_time, *on, **kw):
    kw.pop("how", None)
    return asof_join(self, other, self_time, other_time, *on, how="right", **kw)


def asof_join_outer(self, other, self_time, other_time, *on, **kw):
    kw.pop("how", None)
    return asof_join(self, other, self_time, other_time, *on, how="outer", **kw)
