"""asof_now_join: request/response joins — answer once, never revise.

The port of ``pathway_tpu/stdlib/temporal/_asof_now_join.py``.
Reference: stdlib/temporal/_asof_now_join.py:72,157 + the forget/filter
idiom (internals/table.py:783-846, SURVEY.md §3.5).  A left (query) row is
matched against the right side's state *at arrival time*; subsequent right
updates do not retract past answers.  This is the primitive under
query_as_of_now serving.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any

from ...engine.graph import Operator
from ...engine.runner import register_lowering, _env_for, _compile
from ...engine.types import consolidate
from ...internals import dtype as dt
from ...internals import parse_graph as pg
from ...internals.desugaring import substitute
from ...internals.expression import BinaryOpExpression, ColumnReference, wrap
from ...internals.table import Table, Universe
from ...internals.thisclass import ThisMetaclass, base_placeholder
from ...internals.thisclass import left as left_ph
from ...internals.thisclass import right as right_ph
from ...internals.thisclass import is_placeholder
from ...internals.thisclass import this as this_ph
from ...internals.value import hash_values, ref_scalar


class AsofNowJoinOperator(Operator):
    def __init__(self, left_env, right_env, lon_fns, ron_fns, how,
                 left_ncols, right_ncols, id_policy: str = "both",
                 name="asof_now_join"):
        super().__init__(name)
        self.left_env, self.right_env = left_env, right_env
        self.lon_fns, self.ron_fns = lon_fns, ron_fns
        self.how = how
        self.id_policy = id_policy
        self.left_ncols, self.right_ncols = left_ncols, right_ncols
        self.right_by_jk: dict[Any, dict] = defaultdict(dict)
        self.emitted: dict[Any, list] = defaultdict(list)  # left key -> emitted rows
        self._lbuf: list[list] = []  # left batches deferred to flush

    def _jk(self, side, key, row):
        env = (self.left_env if side == "l" else self.right_env).build(key, row)
        fns = self.lon_fns if side == "l" else self.ron_fns
        vals = tuple(f(env) for f in fns)
        try:
            hash(vals)
            return vals
        except TypeError:
            return ("#h", hash_values(vals))

    def process(self, port, updates, time):
        if port == 1:
            for key, row, diff in updates:
                jk = self._jk("r", key, row)
                side = self.right_by_jk[jk]
                cur = side.get(key)
                c = (cur[1] if cur else 0) + diff
                if c == 0:
                    side.pop(key, None)
                else:
                    side[key] = (row if diff > 0 else (cur[0] if cur else row), c)
            return
        # left (query) batches buffer until flush: every right-side update
        # at this logical time must be visible to queries at this time,
        # independent of intra-time arrival order
        self._lbuf.append(list(updates))

    def flush(self, time):
        if not self._lbuf:
            return
        batches, self._lbuf = self._lbuf, []
        out = []
        for updates in batches:
            self._answer(updates, out)
        if out:
            self.emit(time, consolidate(out))

    def _answer(self, updates, out):
        for key, row, diff in updates:
            jk = self._jk("l", key, row)
            if diff > 0:
                matches = [
                    (rk, rrow) for rk, (rrow, rc) in self.right_by_jk.get(jk, {}).items()
                    if rc > 0
                ]
                if matches:
                    if self.id_policy == "left" and len(matches) > 1:
                        raise ValueError(
                            "asof_now_join with id=left.id requires at most one "
                            f"match per row; got {len(matches)}"
                        )
                    for rk, rrow in matches:
                        if self.id_policy == "left":
                            okey = key
                        elif self.id_policy == "right":
                            okey = rk
                        else:
                            okey = ref_scalar(key, rk)
                        orow = row + rrow + (key, rk)
                        out.append((okey, orow, 1))
                        self.emitted[key].append((okey, orow))
                elif self.how in ("left",):
                    okey = key if self.id_policy == "left" else ref_scalar(key, None)
                    orow = row + (None,) * self.right_ncols + (key, None)
                    out.append((okey, orow, 1))
                    self.emitted[key].append((okey, orow))
            else:
                # query retracted (forget) — retract its answers
                for okey, orow in self.emitted.pop(key, []):
                    out.append((okey, orow, -1))


@register_lowering("asof_now_join")
def _lower_asof_now(node, lg):
    p = node.params
    lt, rt = node.input_tables
    return AsofNowJoinOperator(
        _env_for(lt), _env_for(rt),
        [_compile(e) for e in p["left_on"]], [_compile(e) for e in p["right_on"]],
        p["how"], len(lt._colnames), len(rt._colnames),
        id_policy=p.get("id_policy", "both"),
    )


class AsofNowJoinResult:
    def __init__(self, left: Table, right: Table, on, how: str,
                 id_policy: str = "both"):
        self._left, self._right, self._how = left, right, how
        sub = lambda e: substitute(wrap(e), {left_ph: left, right_ph: right, this_ph: left})
        left_on, right_on = [], []
        for cond in on:
            cond = sub(cond)
            if not (isinstance(cond, BinaryOpExpression) and cond._op == "=="):
                raise ValueError("asof_now_join conditions must be equalities")
            a, b = cond._left, cond._right
            a_tables = {r.table for r in a._dependencies()}
            if left in a_tables:
                left_on.append(a)
                right_on.append(b)
            else:
                left_on.append(b)
                right_on.append(a)
        node = pg.new_node(
            "asof_now_join", [left, right],
            left_on=left_on, right_on=right_on, how=how, id_policy=id_policy,
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
        opt = how != "inner"
        for n in lcols:
            dtypes[f"__l_{n}"] = left._dtype_of(n)
        for n in rcols:
            d = right._dtype_of(n)
            dtypes[f"__r_{n}"] = dt.optional(d) if opt else d
        dtypes["__left_id"] = dt.POINTER
        dtypes["__right_id"] = dt.optional(dt.POINTER) if opt else dt.POINTER
        self._jt = Table(node, out_names, dtypes, Universe(), name="asof_now_joined", aliases=aliases)

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
        return self._jt._rowwise(mapped, name="asof-now-select")


def asof_now_join(self: Table, other: Table, *on, how: str = "inner", id=None) -> AsofNowJoinResult:
    id_policy = "both"
    if id is not None:
        if not (isinstance(id, ColumnReference) and id.name == "id"):
            raise ValueError("asof_now_join id= must be <table>.id")
        t = id.table
        if is_placeholder(t):
            base = base_placeholder(t)
            t = self if base is left_ph else other if base is right_ph else None
        if t is self:
            id_policy = "left"
        elif t is other:
            id_policy = "right"
        else:
            raise ValueError("asof_now_join id= must be left.id or right.id")
    return AsofNowJoinResult(self, other, on, how, id_policy=id_policy)


def asof_now_join_inner(self, other, *on, **kw):
    kw.pop("how", None)
    return asof_now_join(self, other, *on, how="inner", **kw)


def asof_now_join_left(self, other, *on, **kw):
    kw.pop("how", None)
    return asof_now_join(self, other, *on, how="left", **kw)
