"""The declarative Table API.

Re-design of the reference's Table (python/pathway/internals/table.py:53,
joins.py:553, groupbys.py:410): every method appends an OpNode to the global
ParseGraph; nothing executes until `pw.run()` / a debug capture lowers the
graph to the incremental engine (engine/runner.py).
"""

from __future__ import annotations

import itertools
from typing import Any, Iterable, Mapping

from . import dtype as dt
from . import parse_graph as pg
from .desugaring import expand_args, rewrite, rewrite_nodes, substitute, walk
from .expression import (
    ApplyExpression,
    ColumnExpression,
    ColumnReference,
    ConstExpression,
    FullyAsyncApplyExpression,
    PointerExpression,
    ReducerExpression,
    wrap,
)
from .schema import Schema, SchemaMetaclass, schema_from_types
from .thisclass import left as left_ph
from .thisclass import right as right_ph
from .thisclass import this as this_ph
from .type_interpreter import infer_dtype

_table_counter = itertools.count()


class Universe:
    """Key-set identity with a subset-relation solver (reference:
    internals/universe.py + universe_solver.py).

    Relations are edges in a global graph: `parent` (structural — filter,
    intersect, difference results are subsets of their source) plus
    declared edges from the set-operation algebra (every concat /
    update_rows input is a subset of the result; an intersect result is a
    subset of EVERY argument) and user promises.  `is_subset_of` answers
    by graph reachability with transitivity — the reference solver's
    query, without its LP machinery."""

    __slots__ = ("id", "parent", "_supers")

    def __init__(self, parent: "Universe | None" = None):
        self.id = next(_table_counter)
        self.parent = parent
        # edges live ON the instance (not a module-global relation store),
        # so cleared/discarded graphs free their solver state via GC
        self._supers: list["Universe"] = [parent] if parent is not None else []

    def declare_subset_of(self, other: "Universe") -> None:
        self._supers.append(other)

    def is_structural_subset_of(self, other: "Universe") -> bool:
        """Subset relation via `parent` edges ONLY (filter / intersect /
        difference chains), where the subset's rows are physically derived
        from the superset — unlike user promises, which assert key
        containment but say nothing about column values."""
        u: Universe | None = self
        while u is not None:
            if u is other:
                return True
            u = u.parent
        return False

    def is_subset_of(self, other: "Universe") -> bool:
        seen = {id(self)}
        stack = [self]
        while stack:
            u = stack.pop()
            if u is other:
                return True
            for nxt in u._supers:
                if id(nxt) not in seen:
                    seen.add(id(nxt))
                    stack.append(nxt)
        return False


def promise_universes_equal(a: "Table", b: "Table") -> None:
    a._universe.declare_subset_of(b._universe)
    b._universe.declare_subset_of(a._universe)


def _universes_compatible(a: "Table", b: "Table") -> bool:
    """May a table with universe `a` read columns of `b`?  Requires every
    key of `a` to exist in `b`: a ⊆ b (reference type-checker boundary).
    The reverse direction (b ⊂ a) is NOT sufficient — reading b's column
    at a key of a \\ b is undefined; the reference rejects it at build
    time and so do we."""
    return a._universe.is_subset_of(b._universe)


class Table:
    def __init__(
        self,
        node: pg.OpNode | None,
        colnames: list[str],
        dtypes: dict[str, dt.DType],
        universe: Universe,
        name: str | None = None,
        aliases: dict[tuple[int, str], int] | None = None,
    ):
        self._node = node
        self._colnames = list(colnames)
        self._dtypes = dict(dtypes)
        self._universe = universe
        self._name = name or f"table_{next(_table_counter)}"
        self._aliases = aliases
        if node is not None:
            node.output_table = self

    # ------------------------------------------------------------------
    # basics
    # ------------------------------------------------------------------
    def column_names(self) -> list[str]:
        return list(self._colnames)

    def _dtype_of(self, name: str) -> dt.DType:
        if name == "id":
            return dt.POINTER
        return self._dtypes.get(name, dt.ANY)

    @property
    def id(self) -> ColumnReference:
        return ColumnReference(self, "id")

    @property
    def schema(self) -> SchemaMetaclass:
        return schema_from_types(f"{self._name}_schema", **self._dtypes)

    def typehints(self) -> dict[str, Any]:
        return dict(self._dtypes)

    def keys(self):
        return list(self._colnames)

    def __getattr__(self, name: str) -> ColumnReference:
        try:
            colnames = object.__getattribute__(self, "_colnames")
        except AttributeError:
            raise AttributeError(name)
        if name == "id" or name in colnames:
            return ColumnReference(self, name)
        if name.startswith("_"):
            raise AttributeError(name)
        raise AttributeError(
            f"table {self._name!r} has no column {name!r}; columns: {colnames}"
        )

    def __getitem__(self, name) -> ColumnReference:
        if isinstance(name, ColumnReference):
            name = name.name
        if isinstance(name, (list, tuple)):
            return self.select(*[self[n] for n in name])
        if name != "id" and name not in self._colnames:
            raise KeyError(f"no column {name!r} in {self._name!r}")
        return ColumnReference(self, name)

    def __iter__(self):
        return iter(ColumnReference(self, n) for n in self._colnames)

    def __repr__(self) -> str:
        cols = ", ".join(f"{n}: {self._dtypes.get(n, dt.ANY)!r}" for n in self._colnames)
        return f"<pw.Table {self._name} ({cols})>"

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def _desugar(self, expr: Any) -> ColumnExpression:
        return substitute(wrap(expr), {this_ph: self})

    def _collect_dep_tables(self, exprs: Iterable[ColumnExpression]) -> list["Table"]:
        extras: list[Table] = []
        for e in exprs:
            for ref in e._dependencies():
                t = ref.table
                if t is self or not isinstance(t, Table):
                    continue
                if self._aliases and (id(t), ref.name) in self._aliases:
                    continue  # resolved positionally (join/asof output aliases)
                if t in extras:
                    continue
                if not _universes_compatible(self, t):
                    raise ValueError(
                        f"column {ref.name!r} of table {t._name!r} has an "
                        f"incompatible universe with {self._name!r}; use "
                        "with_universe_of / join instead"
                    )
                extras.append(t)
        return extras

    @staticmethod
    def _is_deterministic(exprs: Iterable[ColumnExpression]) -> bool:
        for e in exprs:
            for node in walk(e):
                if isinstance(node, ApplyExpression) and not node._deterministic:
                    return False
        return True

    def _rowwise(
        self,
        out_exprs: Mapping[str, ColumnExpression],
        universe: Universe | None = None,
        name: str = "select",
    ) -> "Table":
        exprs = dict(out_exprs)
        extras = self._collect_dep_tables(exprs.values())
        fully_async = any(
            isinstance(node, FullyAsyncApplyExpression)
            for e in exprs.values()
            for node in walk(e)
        )
        if fully_async:
            if extras:
                raise ValueError(
                    "fully-async expressions cannot reference other tables; "
                    "select them from a single table"
                )
            for n, e in exprs.items():
                if not isinstance(e, FullyAsyncApplyExpression) and any(
                    isinstance(node, FullyAsyncApplyExpression) for node in walk(e)
                ):
                    raise ValueError(
                        f"column {n!r}: a fully-async UDF must be the whole "
                        "column expression (select it, then compute over the "
                        "resolved column in a following select)"
                    )
        node = pg.new_node(
            "rowwise",
            [self, *extras],
            out_names=list(exprs.keys()),
            exprs=list(exprs.values()),
            deterministic=self._is_deterministic(exprs.values()) and not extras,
            fully_async=fully_async,
        )
        dtypes = {}
        for n, e in exprs.items():
            d = infer_dtype(e)
            if isinstance(e, FullyAsyncApplyExpression):
                d = dt.Future(d)
            dtypes[n] = d
        return Table(node, list(exprs.keys()), dtypes, universe or self._universe)

    # ------------------------------------------------------------------
    # projection / mapping
    # ------------------------------------------------------------------
    def select(self, *args, **kwargs) -> "Table":
        cols = expand_args(self, *args)
        cols.update(kwargs)
        exprs = {n: self._desugar(e) for n, e in cols.items()}
        return self._rowwise(exprs)

    def with_columns(self, *args, **kwargs) -> "Table":
        cols = {n: self[n] for n in self._colnames}
        new = expand_args(self, *args)
        new.update(kwargs)
        cols.update(new)
        exprs = {n: self._desugar(e) for n, e in cols.items()}
        return self._rowwise(exprs)

    def without(self, *columns) -> "Table":
        names = {c.name if isinstance(c, ColumnReference) else c for c in columns}
        return self.select(*[self[n] for n in self._colnames if n not in names])

    def rename(self, names_mapping: Mapping | None = None, **kwargs) -> "Table":
        mapping: dict[str, str] = {}
        if names_mapping:
            for k, v in names_mapping.items():
                k = k.name if isinstance(k, ColumnReference) else k
                v = v.name if isinstance(v, ColumnReference) else v
                mapping[k] = v
        for new, old in kwargs.items():
            old = old.name if isinstance(old, ColumnReference) else old
            mapping[old] = new
        cols = {}
        for n in self._colnames:
            cols[mapping.get(n, n)] = self[n]
        return self.select(**cols)

    def rename_columns(self, **kwargs) -> "Table":
        return self.rename(**kwargs)

    def rename_by_dict(self, names_mapping: Mapping) -> "Table":
        return self.rename(names_mapping)

    def with_prefix(self, prefix: str) -> "Table":
        return self.select(**{prefix + n: self[n] for n in self._colnames})

    def with_suffix(self, suffix: str) -> "Table":
        return self.select(**{n + suffix: self[n] for n in self._colnames})

    def copy(self) -> "Table":
        return self.select(*[self[n] for n in self._colnames])

    def cast_to_types(self, **kwargs) -> "Table":
        from .expression import CastExpression

        cols = {n: self[n] for n in self._colnames}
        for n, t in kwargs.items():
            cols[n] = CastExpression(t, self[n])
        return self.select(**cols)

    def update_types(self, **kwargs) -> "Table":
        out = self.copy()
        for n, t in kwargs.items():
            out._dtypes[n] = dt.wrap(t)
        return out

    # ------------------------------------------------------------------
    # filtering / set ops
    # ------------------------------------------------------------------
    def filter(self, expression) -> "Table":
        pred = self._desugar(expression)
        extras = self._collect_dep_tables([pred])
        node = pg.new_node(
            "filter",
            [self, *extras],
            predicate=pred,
            deterministic=self._is_deterministic([pred]) and not extras,
        )
        return Table(node, self._colnames, self._dtypes, Universe(parent=self._universe))

    def split(self, expression) -> tuple["Table", "Table"]:
        pos = self.filter(expression)
        neg = self.filter(~wrap(self._desugar(expression)))
        return pos, neg

    def difference(self, other: "Table") -> "Table":
        node = pg.new_node("difference", [self, other])
        return Table(node, self._colnames, self._dtypes, Universe(parent=self._universe))


    def intersect(self, *others: "Table") -> "Table":
        node = pg.new_node("intersect", [self, *others])
        u = Universe(parent=self._universe)
        for o in others:  # an intersection is a subset of EVERY argument
            u.declare_subset_of(o._universe)
        return Table(node, self._colnames, self._dtypes, u)

    def eval_type(self, expression) -> dt.DType:
        """Infer the dtype of an expression over this table (reference:
        Table.eval_type)."""
        return infer_dtype(self._desugar(expression))

    def debug(self, name: str) -> "Table":
        """Print every update passing through, tagged `name`, and pass the
        table on unchanged (reference: Table.debug / DebugOperator)."""
        from ..io import subscribe as _subscribe

        _subscribe(
            self,
            on_change=lambda key, row, time, is_addition: print(
                f"[debug:{name}] {'+' if is_addition else '-'} "
                f"key={key} time={time} {row}"
            ),
        )
        return self

    def is_append_only(self) -> bool:
        """Whether this table was marked append-only (reference:
        Table.is_append_only; here a declared property via
        assert_append_only / append-only sources, not a per-column
        inference)."""
        return bool(getattr(self, "_append_only", False))

    def assert_append_only(self) -> "Table":
        """Declare the table append-only (reference:
        Table.assert_append_only)."""
        self._append_only = True
        return self

    def update_id_type(self, id_type, *, id_append_only: bool | None = None) -> "Table":
        """Typing-level id re-declaration (reference: Table.update_id_type).
        Ids are untyped 128-bit pointers in this engine, so values are
        unchanged; the append-only declaration is honored."""
        if id_append_only is not None:
            self._append_only = bool(id_append_only)
        return self

    def restrict(self, other: "Table") -> "Table":
        return self.with_universe_of(other)

    def having(self, *indexers) -> "Table":
        """Keep rows whose indexer pointers resolve in their target table
        (reference: Table.having).  Indexers are pointer expressions — e.g.
        `target.pointer_from(self.key)` — whose target table is the
        expression's owner; a plain column reference indexes into its own
        table."""
        out = self
        for indexer in indexers:
            expr = self._desugar(indexer)
            if isinstance(expr, PointerExpression):
                target = expr._table
            elif isinstance(expr, ColumnReference):
                if expr.table is not self:
                    raise ValueError(
                        "having() with a plain column reference requires a "
                        "column of this table; use "
                        "target.pointer_from(...) to name the target table"
                    )
                target = self
            else:
                raise ValueError(
                    "having() indexers must be pointer_from(...) expressions "
                    "or column references"
                )
            marker = target.select(_pw_present=True)
            looked = marker.ix(expr, optional=True, context=self)
            out = out.filter(looked["_pw_present"].is_not_none())
        return out

    # ------------------------------------------------------------------
    # universe manipulation
    # ------------------------------------------------------------------
    def with_universe_of(self, other: "Table") -> "Table":
        node = pg.new_node(
            "ix",
            [other, self],
            ptr_expr=ColumnReference(other, "id"),
            optional=False,
        )
        return Table(node, self._colnames, self._dtypes, other._universe)

    def update_rows(self, other: "Table") -> "Table":
        if set(other._colnames) != set(self._colnames):
            raise ValueError("update_rows requires identical columns")
        other_aligned = other.select(*[other[n] for n in self._colnames])
        node = pg.new_node("update_rows", [self, other_aligned])
        dtypes = {
            n: dt.lub(self._dtypes.get(n, dt.ANY), other._dtypes.get(n, dt.ANY))
            for n in self._colnames
        }
        u = Universe()  # the union: every input is a subset of it
        self._universe.declare_subset_of(u)
        other._universe.declare_subset_of(u)
        return Table(node, self._colnames, dtypes, u)

    def update_cells(self, other: "Table") -> "Table":
        extra = set(other._colnames) - set(self._colnames)
        if extra:
            raise ValueError(f"update_cells: unknown columns {extra}")
        positions = [self._colnames.index(n) for n in other._colnames]
        node = pg.new_node("update_cells", [self, other], positions=positions)
        dtypes = dict(self._dtypes)
        for n in other._colnames:
            dtypes[n] = dt.lub(dtypes.get(n, dt.ANY), other._dtypes.get(n, dt.ANY))
        return Table(node, self._colnames, dtypes, self._universe)

    def __lshift__(self, other: "Table") -> "Table":
        return self.update_cells(other)

    def concat(self, *others: "Table") -> "Table":
        aligned = [self]
        for o in others:
            if set(o._colnames) != set(self._colnames):
                raise ValueError("concat requires identical columns")
            aligned.append(o.select(*[o[n] for n in self._colnames]))
        node = pg.new_node("concat", aligned)
        dtypes = {
            n: dt.lub(*[t._dtypes.get(n, dt.ANY) for t in [self, *others]])
            for n in self._colnames
        }
        u = Universe()  # the disjoint union: every input is a subset
        for t in [self, *others]:
            t._universe.declare_subset_of(u)
        return Table(node, self._colnames, dtypes, u)

    def concat_reindex(self, *others: "Table") -> "Table":
        parts = []
        for i, t in enumerate([self, *others]):
            parts.append(t.with_id_from(t.id, ConstExpression(i)))
        return parts[0].concat(*parts[1:])

    # ------------------------------------------------------------------
    # re-keying
    # ------------------------------------------------------------------
    def with_id(self, new_id: ColumnExpression) -> "Table":
        expr = self._desugar(new_id)
        node = pg.new_node("reindex", [self], key_expr=expr)
        return Table(node, self._colnames, self._dtypes, Universe())

    def with_id_from(self, *args, instance=None) -> "Table":
        exprs = [self._desugar(a) for a in args]
        ptr = PointerExpression(self, *exprs, instance=self._desugar(instance) if instance is not None else None)
        node = pg.new_node("reindex", [self], key_expr=ptr)
        return Table(node, self._colnames, self._dtypes, Universe())

    def pointer_from(self, *args, optional: bool = False, instance=None) -> PointerExpression:
        return PointerExpression(
            self,
            *[self._desugar(a) for a in args],
            instance=self._desugar(instance) if instance is not None else None,
            optional=optional,
        )

    # ------------------------------------------------------------------
    # pointer lookup
    # ------------------------------------------------------------------
    def ix(self, expression, *, optional: bool = False, context=None) -> "Table":
        expr = wrap(expression)
        dep_tables = [r.table for r in expr._dependencies() if isinstance(r.table, Table)]
        if context is not None:
            src = context
        elif dep_tables:
            src = dep_tables[0]
        else:
            raise ValueError(
                "ix() needs a pointer expression over some table (or context=)"
            )
        expr = substitute(expr, {this_ph: src})
        node = pg.new_node("ix", [src, self], ptr_expr=expr, optional=optional)
        dtypes = (
            {n: dt.optional(d) for n, d in self._dtypes.items()} if optional else self._dtypes
        )
        return Table(node, self._colnames, dtypes, src._universe)

    def ix_ref(self, *args, optional: bool = False, instance=None, context=None) -> "Table":
        if not args:
            raise ValueError("ix_ref needs key values")
        dep_tables = [
            r.table
            for a in args
            if isinstance(a, ColumnExpression)
            for r in a._dependencies()
            if isinstance(r.table, Table)
        ]
        src = dep_tables[0] if dep_tables else self
        ptr = PointerExpression(
            self,
            *[substitute(wrap(a), {this_ph: src}) for a in args],
            instance=instance,
            optional=optional,
        )
        return self.ix(ptr, optional=optional)

    # ------------------------------------------------------------------
    # groupby / reduce
    # ------------------------------------------------------------------
    def groupby(self, *args, id=None, instance=None, sort_by=None, **kwargs) -> "GroupedTable":
        refs = []
        for a in args:
            a = self._desugar(a)
            if not isinstance(a, ColumnReference):
                raise ValueError("groupby() arguments must be column references")
            refs.append(a)
        if id is not None:
            id = self._desugar(id)
        inst = self._desugar(instance) if instance is not None else None
        sort_by = self._desugar(sort_by) if sort_by is not None else None
        return GroupedTable(self, refs, id_expr=id, instance=inst, sort_by=sort_by)

    def reduce(self, *args, **kwargs) -> "Table":
        return self.groupby().reduce(*args, **kwargs)

    # ------------------------------------------------------------------
    # reshaping
    # ------------------------------------------------------------------
    def flatten(self, to_flatten: ColumnReference, origin_id: str | None = None) -> "Table":
        ref = self._desugar(to_flatten)
        if not isinstance(ref, ColumnReference) or ref.table is not self:
            raise ValueError("flatten() takes a column of this table")
        pos = self._colnames.index(ref.name)
        node = pg.new_node("flatten", [self], position=pos)
        dtypes = dict(self._dtypes)
        inner = dtypes.get(ref.name, dt.ANY)
        if isinstance(inner, dt.List):
            dtypes[ref.name] = inner.wrapped
        elif isinstance(inner, dt.Tuple) and inner.args:
            dtypes[ref.name] = dt.lub(*inner.args)
        elif inner == dt.STR:
            dtypes[ref.name] = dt.STR
        else:
            dtypes[ref.name] = dt.ANY
        return Table(node, self._colnames, dtypes, Universe())

    def _gradual_broadcast(
        self,
        threshold_table: "Table",
        lower_column,
        value_column,
        upper_column,
    ) -> "Table":
        """Attach `apx_value` to every row, refined incrementally as the
        threshold table's (lower, value, upper) triplet tightens — rows
        whose key is under the scaled threshold carry `upper`, the rest
        `lower`; a triplet move updates only the flipped key band.
        Reference: Table._gradual_broadcast (internals/table.py:638) over
        operators/gradual_broadcast.rs."""
        node = pg.new_node(
            "gradual_broadcast",
            [self, threshold_table],
            lower=threshold_table._desugar(lower_column),
            value=threshold_table._desugar(value_column),
            upper=threshold_table._desugar(upper_column),
        )
        from . import dtype as _dt

        return Table(
            node,
            self._colnames + ["apx_value"],
            {**self._dtypes, "apx_value": _dt.ANY},
            self._universe,
        )

    def deduplicate(
        self,
        *,
        value=None,
        instance=None,
        acceptor=None,
        persistent_id: str | None = None,
        name: str | None = None,
    ) -> "Table":
        value_expr = self._desugar(value) if value is not None else ColumnReference(self, "id")
        inst_exprs = []
        if instance is not None:
            insts = instance if isinstance(instance, (list, tuple)) else [instance]
            inst_exprs = [self._desugar(i) for i in insts]
        if acceptor is None:
            acceptor = lambda new, old: True  # keep latest
        node = pg.new_node(
            "deduplicate",
            [self],
            value_expr=value_expr,
            instance_exprs=inst_exprs,
            acceptor=acceptor,
            persistent_id=persistent_id,
        )
        return Table(node, self._colnames, self._dtypes, Universe())

    # ------------------------------------------------------------------
    # joins
    # ------------------------------------------------------------------
    def join(self, other: "Table", *on, id=None, how: str = "inner", **kwargs) -> "JoinResult":
        how_map = {"inner": "inner", "left": "left", "right": "right", "outer": "outer", "full": "outer"}
        if hasattr(how, "name"):  # JoinMode enum
            how = how.name.lower()
        return JoinResult(self, other, on, id=id, how=how_map[how])

    def join_inner(self, other: "Table", *on, id=None, **kwargs) -> "JoinResult":
        return self.join(other, *on, id=id, how="inner")

    def join_left(self, other: "Table", *on, id=None, **kwargs) -> "JoinResult":
        return self.join(other, *on, id=id, how="left")

    def join_right(self, other: "Table", *on, id=None, **kwargs) -> "JoinResult":
        return self.join(other, *on, id=id, how="right")

    def join_outer(self, other: "Table", *on, id=None, **kwargs) -> "JoinResult":
        return self.join(other, *on, id=id, how="outer")

    # ------------------------------------------------------------------
    # misc parity helpers
    # ------------------------------------------------------------------
    @staticmethod
    def from_columns(*args, **kwargs) -> "Table":
        """Build a table from same-universe column references (reference:
        Table.from_columns, internals/table.py:272)."""
        refs = list(args) + list(kwargs.values())
        if not refs:
            raise ValueError("from_columns needs at least one column")
        for r in refs:
            if not isinstance(r, ColumnReference):
                raise ValueError(
                    f"from_columns takes column references, got {r!r}"
                )
        names = [getattr(a, "_output_name", None) or a.name for a in args]
        names += list(kwargs.keys())
        if len(set(names)) != len(names):
            raise ValueError(
                f"from_columns column names must be pairwise distinct: {names}"
            )
        # select() applies the standard expansion (honoring slice renames)
        return refs[0].table.select(*args, **kwargs)

    @staticmethod
    def empty(**kwargs) -> "Table":
        """An empty table with the given column types (reference:
        Table.empty, internals/table.py:362)."""
        from .datasource import StaticDataSource

        node = pg.new_node("input", [], source=StaticDataSource([]))
        dtypes = {n: dt.wrap(t) for n, t in kwargs.items()}
        return Table(node, list(kwargs.keys()), dtypes, Universe(), name="empty")

    def remove_errors(self) -> "Table":
        """Drop rows containing Error values (reference: Table.remove_errors,
        internals/table.py:2753)."""
        from .expression import ConvertExpression
        from .value import Error as _Error

        def clean(v) -> bool:
            return not isinstance(v, _Error)

        pred = None
        for n in self._colnames:
            check = ConvertExpression(clean, self[n], dtype=dt.BOOL)
            pred = check if pred is None else pred & check
        if pred is None:
            return self
        return self.filter(pred)

    def await_futures(self) -> "Table":
        """Keep only rows whose fully-async values have resolved (reference:
        Table.await_futures filters exactly Pending): Pending placeholders
        drop; the resolved revision re-inserts the row.  Error values pass
        through untouched (remove_errors-style handling stays separate).
        Future dtypes unwrap."""
        from .expression import ConvertExpression
        from .value import Pending

        future_cols = [
            n for n, d in self._dtypes.items() if isinstance(d, dt.Future)
        ]
        if not future_cols:
            return self

        def resolved(v) -> bool:
            # ConvertExpression applies without the Error short-circuit, so
            # Error-valued rows are kept (they are resolved, just poisoned)
            return not isinstance(v, Pending)

        pred = None
        for n in future_cols:
            check = ConvertExpression(resolved, self[n], dtype=dt.BOOL)
            pred = check if pred is None else pred & check
        out = self.filter(pred)
        out._dtypes = {
            n: (d.wrapped if isinstance(d, dt.Future) else d)
            for n, d in out._dtypes.items()
        }
        return out

    def promise_universes_are_equal(self, other: "Table") -> "Table":
        promise_universes_equal(self, other)
        return self

    def promise_universe_is_subset_of(self, other: "Table") -> "Table":
        # one-way: self's keys resolve in other, NOT the reverse — a
        # bidirectional promise would let the superset read the subset's
        # columns, the exact undefined read the solver exists to reject
        self._universe.declare_subset_of(other._universe)
        return self

    def promise_universe_is_equal_to(self, other: "Table") -> "Table":
        promise_universes_equal(self, other)
        return self

    def _materialize_capture(self):
        """Attach a capture sink; returns the OpNode for the runner.

        Captures are NOT registered as pw.run() outputs — they belong to the
        explicit run_tables() invocation that created them (otherwise every
        debug/LiveTable access would leak a permanent sink into the global
        graph)."""
        return pg.new_node("capture", [self], colnames=list(self._colnames))


class GroupedTable:
    """Result of table.groupby(...) (reference: internals/groupbys.py)."""

    def __init__(self, table: Table, refs: list[ColumnReference], id_expr=None,
                 instance=None, sort_by=None):
        self._table = table
        self._refs = refs
        self._id_expr = id_expr
        self._instance = instance
        self._sort_by = sort_by

    def reduce(self, *args, **kwargs) -> Table:
        source = self._table
        cols: dict[str, ColumnExpression] = {}
        for a in args:
            a_sub = substitute(wrap(a), {this_ph: source})
            if not isinstance(a_sub, ColumnReference):
                raise ValueError("positional reduce() arguments must be column references")
            cols[a_sub.name] = a_sub
        cols.update(kwargs)

        gb_names = [r.name for r in self._refs]
        reducer_specs: list[tuple[str, list[ColumnExpression], dict]] = []
        placeholder = object()

        def extract(node):
            if isinstance(node, ReducerExpression):
                arg_exprs = [substitute(a, {this_ph: source}) for a in node._args]
                idx = len(reducer_specs)
                kw = {k: v for k, v in node._kwargs.items()}
                reducer_specs.append((node._reducer, arg_exprs, kw))
                ref = ColumnReference(placeholder, f"__r{idx}")
                ref._reducer_expr = node
                return ref
            return None

        outer_exprs: dict[str, ColumnExpression] = {}
        for name, e in cols.items():
            e = rewrite_nodes(wrap(e), extract)
            outer_exprs[name] = e

        out_names = gb_names + [f"__r{i}" for i in range(len(reducer_specs))]
        node = pg.new_node(
            "groupby",
            [source],
            gb_exprs=list(self._refs),
            instance=self._instance,
            reducers=reducer_specs,
            id_expr=self._id_expr,
            sort_by=self._sort_by,
        )
        red_dtypes: dict[str, dt.DType] = {}
        for n, r in zip(gb_names, self._refs):
            red_dtypes[n] = infer_dtype(r)
        from .reducers import reducer_return_dtype

        for i, (rid, arg_exprs, kw) in enumerate(reducer_specs):
            re = ReducerExpression(rid, *arg_exprs, **kw)
            red_dtypes[f"__r{i}"] = reducer_return_dtype(re)
        red_tbl = Table(node, out_names, red_dtypes, Universe(), name="reduced")

        # final projection: map refs to red_tbl
        def remap(ref: ColumnReference):
            t = ref.table
            if t is placeholder:
                return red_tbl[ref.name]
            if t is source or (isinstance(t, Table) and t._universe is source._universe):
                if ref.name in gb_names:
                    return red_tbl[ref.name]
                if ref.name == "id":
                    raise ValueError("cannot use input ids inside reduce()")
                raise ValueError(
                    f"column {ref.name!r} is not a grouping column; wrap it in a reducer"
                )
            if isinstance(t, Table):
                return ref  # unrelated table (e.g. ix target) - leave
            return red_tbl[ref.name]

        from .desugaring import rewrite

        final = {n: rewrite(e, remap) for n, e in outer_exprs.items()}
        return red_tbl._rowwise(final, name="reduce-project")


class JoinResult:
    """Result of table.join(...) — select/filter over the joined context
    (reference: internals/joins.py:553)."""

    def __init__(self, left: Table, right: Table, on: tuple, id=None, how: str = "inner"):
        self._left = left
        self._right = right
        self._how = how
        self._left_on: list[ColumnExpression] = []
        self._right_on: list[ColumnExpression] = []
        self._parse_on(on)
        self._id_policy = "both"
        if id is not None:
            if isinstance(id, ColumnReference) and id.name == "id":
                t = id.table
                t = left if t is left_ph else right if t is right_ph else t
                if t is left:
                    self._id_policy = "left"
                elif t is right:
                    self._id_policy = "right"
                else:
                    raise ValueError("join id= must be left.id or right.id")
            else:
                raise ValueError("join id= must be left.id or right.id")
        self._joined: Table | None = None

    def _sub_sides(self, e) -> ColumnExpression:
        return substitute(wrap(e), {left_ph: self._left, right_ph: self._right})

    def _side_of(self, e: ColumnExpression) -> str:
        tables = {r.table for r in e._dependencies()}
        in_right = any(t is self._right for t in tables)
        if self._left is self._right:
            raise ValueError("self-join requires .copy() of one side")
        if in_right and all(t is self._right for t in tables):
            return "r"
        if any(t is self._left for t in tables):
            return "l"
        # fall back on universe comparison: the join SIDE must be a subset
        # of the referenced table (side keys resolve in it), so the side
        # goes first in the asymmetric check
        for t in tables:
            if isinstance(t, Table):
                if _universes_compatible(self._left, t):
                    return "l"
                if _universes_compatible(self._right, t):
                    return "r"
        raise ValueError("cannot attribute join condition side")

    def _parse_on(self, on: tuple) -> None:
        from .expression import BinaryOpExpression

        for cond in on:
            cond = self._sub_sides(cond)
            if isinstance(cond, ColumnReference):
                # shorthand: single column name present in both tables
                self._left_on.append(self._left[cond.name])
                self._right_on.append(self._right[cond.name])
                continue
            if not (isinstance(cond, BinaryOpExpression) and cond._op == "=="):
                raise ValueError("join conditions must be `left_expr == right_expr`")
            a, b = cond._left, cond._right
            if self._side_of(a) == "l":
                self._left_on.append(self._rebind(a, self._left))
                self._right_on.append(self._rebind(b, self._right))
            else:
                self._left_on.append(self._rebind(b, self._left))
                self._right_on.append(self._rebind(a, self._right))

    def _rebind(self, e: ColumnExpression, side: "Table") -> ColumnExpression:
        """Rewrite references to SUPERSET tables of `side` onto `side`'s
        same-named columns: side keys resolve in the superset, and a
        STRUCTURAL subset (filter result) physically carries the column,
        so the per-row evaluation reads the side's own copy.

        Promise-declared subsets (promise_universe_is_subset_of between
        unrelated tables) are rejected: the promise asserts key containment
        only, so the side's same-named column may hold different data and a
        silent rebind would join on keys the user never wrote (advisor r3
        finding; the reference rejects third-table references outright)."""
        mapping: dict = {}
        for ref in e._dependencies():
            t = ref.table
            if (isinstance(t, Table) and t is not side
                    and _universes_compatible(side, t)):
                if not side._universe.is_structural_subset_of(t._universe):
                    raise ValueError(
                        f"join condition reads {ref.name!r} of a table that "
                        "is only promise-related to the join side; a "
                        "promise asserts key containment, not value "
                        "equality, so the reference cannot be rebound — "
                        "select the column onto the join side first"
                    )
                if ref.name not in side.column_names():
                    raise ValueError(
                        f"join condition reads {ref.name!r} of a superset "
                        f"table, but the join side has no such column; "
                        "select it onto the side first"
                    )
                mapping[(id(t), ref.name)] = ColumnReference(side, ref.name)
        if not mapping:
            return e

        def fn(node):
            if isinstance(node, ColumnReference):
                return mapping.get((id(node.table), node.name), node)
            return node

        return rewrite(e, fn)

    def _materialize(self) -> Table:
        if self._joined is not None:
            return self._joined
        lt, rt = self._left, self._right
        lcols, rcols = lt.column_names(), rt.column_names()
        out_names = (
            [f"__l_{n}" for n in lcols] + [f"__r_{n}" for n in rcols] + ["__left_id", "__right_id"]
        )
        node = pg.new_node(
            "join",
            [lt, rt],
            left_on=self._left_on,
            right_on=self._right_on,
            how=self._how,
            id_policy=self._id_policy,
        )
        aliases: dict[tuple[int, str], int] = {}
        for i, n in enumerate(lcols):
            aliases[(id(lt), n)] = i
        for i, n in enumerate(rcols):
            aliases[(id(rt), n)] = len(lcols) + i
        aliases[(id(lt), "id")] = len(lcols) + len(rcols)
        aliases[(id(rt), "id")] = len(lcols) + len(rcols) + 1
        dtypes: dict[str, dt.DType] = {}
        opt_left = self._how in ("right", "outer")
        opt_right = self._how in ("left", "outer")
        for n in lcols:
            d = lt._dtype_of(n)
            dtypes[f"__l_{n}"] = dt.optional(d) if opt_left else d
        for n in rcols:
            d = rt._dtype_of(n)
            dtypes[f"__r_{n}"] = dt.optional(d) if opt_right else d
        dtypes["__left_id"] = dt.optional(dt.POINTER) if opt_left else dt.POINTER
        dtypes["__right_id"] = dt.optional(dt.POINTER) if opt_right else dt.POINTER
        jt = Table(node, out_names, dtypes, Universe(), name="joined", aliases=aliases)
        # make optionality visible to refs through the original tables
        jt._join_sides = (lt, rt, opt_left, opt_right)
        self._joined = jt
        return jt

    def _this_proxy_sub(self, e) -> ColumnExpression:
        """Substitute this/left/right; `this.x` resolves to the unambiguous side."""
        lt, rt = self._left, self._right
        lcols, rcols = set(lt.column_names()), set(rt.column_names())

        class _proxy:
            @staticmethod
            def __getitem__(name):
                raise NotImplementedError

        def resolve_this(name: str) -> ColumnExpression:
            if name == "id":
                jt = self._materialize()
                return JoinIdExpression(jt)
            in_l, in_r = name in lcols, name in rcols
            if in_l and in_r:
                raise ValueError(
                    f"column {name!r} exists on both sides; use pw.left/pw.right"
                )
            if in_l:
                return lt[name]
            if in_r:
                return rt[name]
            raise ValueError(f"unknown column {name!r} in join")

        from .desugaring import rewrite
        from .thisclass import ThisMetaclass, base_placeholder

        def leaf(ref: ColumnReference):
            t = ref.table
            if isinstance(t, ThisMetaclass):
                base = base_placeholder(t)
                if base is this_ph:
                    return resolve_this(ref.name)
                if base is left_ph:
                    return lt[ref.name] if ref.name != "id" else ColumnReference(lt, "id")
                if base is right_ph:
                    return rt[ref.name] if ref.name != "id" else ColumnReference(rt, "id")
            return ref

        return rewrite(wrap(e), leaf)

    def select(self, *args, **kwargs) -> Table:
        jt = self._materialize()
        cols: dict[str, ColumnExpression] = {}
        for a in args:
            from .thisclass import ThisMetaclass, base_placeholder

            if isinstance(a, ThisMetaclass):
                base = base_placeholder(a)
                src = self._left if base is left_ph else self._right if base is right_ph else None
                if src is None:
                    # pw.this -> union of both sides' columns, unambiguous ones
                    for n in self._left.column_names():
                        if n not in a._pw_exclusions:
                            cols[n] = self._left[n]
                    for n in self._right.column_names():
                        if n in self._left.column_names():
                            continue
                        if n not in a._pw_exclusions:
                            cols[n] = self._right[n]
                else:
                    for n in src.column_names():
                        if n not in a._pw_exclusions:
                            cols[n] = src[n]
            elif isinstance(a, ColumnReference):
                cols[a.name] = a
            else:
                raise ValueError("positional join select args must be columns")
        cols.update(kwargs)
        exprs = {n: self._this_proxy_sub(e) for n, e in cols.items()}
        return jt._rowwise(exprs, name="join-select")

    def filter(self, expression) -> "JoinResult":
        # filter the joined table, then present the same JoinResult API
        jt = self._materialize()
        pred = self._this_proxy_sub(expression)
        filtered = jt.filter(pred)
        filtered._aliases = jt._aliases
        out = JoinResult.__new__(JoinResult)
        out._left, out._right = self._left, self._right
        out._how, out._id_policy = self._how, self._id_policy
        out._left_on, out._right_on = self._left_on, self._right_on
        out._joined = filtered
        return out

    def reduce(self, *args, **kwargs) -> Table:
        jt = self._materialize()
        mapped_kwargs = {}
        for n, e in kwargs.items():
            mapped_kwargs[n] = _map_reducer_args(e, self._this_proxy_sub)
        mapped_args = [self._this_proxy_sub(a) for a in args]
        return jt.groupby().reduce(*mapped_args, **mapped_kwargs)

    def groupby(self, *args, **kwargs) -> GroupedTable:
        jt = self._materialize()
        mapped = [self._this_proxy_sub(a) for a in args]
        return jt.groupby(*mapped, **kwargs)


def _map_reducer_args(e, sub):
    if isinstance(e, ReducerExpression):
        out = ReducerExpression(e._reducer, *[sub(a) for a in e._args], **e._kwargs)
        return out
    if isinstance(e, ColumnExpression):
        return rewrite_nodes(
            wrap(e),
            lambda node: (
                ReducerExpression(node._reducer, *[sub(a) for a in node._args], **node._kwargs)
                if isinstance(node, ReducerExpression)
                else None
            ),
        )
    return e


class JoinIdExpression(ColumnExpression):
    """`pw.this.id` inside a join select — the joined row's own key."""

    def __init__(self, jt: Table):
        self._jt = jt
        self._dtype = dt.POINTER

    def _dependencies(self):
        return ()

    def _eval(self, row: dict):
        return row["id"]
