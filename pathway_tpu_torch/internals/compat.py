"""Reference API-surface parity: remaining top-level names (the port of
``pathway_tpu/internals/compat.py``; reference:
python/pathway/__init__.py:1-214).

``PersistenceMode`` is the one of ``pathway_tpu_torch.persistence``,
re-exported here; pandas is imported only when a ``pandas_transformer``
runs.
"""

from __future__ import annotations

import datetime
import enum
from typing import Any, Callable

from . import dtype as dt
from . import parse_graph as pg
from .expression import ColumnReference
from .schema import SchemaMetaclass, column_definition, schema_from_columns
from .table import GroupedTable, JoinResult, Table, Universe
from ..persistence import PersistenceMode  # noqa: F401  (re-exported)

# -- type aliases ------------------------------------------------------------
DateTimeNaive = datetime.datetime
DateTimeUtc = datetime.datetime
Duration = datetime.timedelta

TableLike = Table
Joinable = Table
OuterJoinResult = JoinResult
GroupedJoinResult = GroupedTable


class Type(enum.Enum):
    """Engine value types (reference: PathwayType, src/engine/value.rs:512)."""

    ANY = "ANY"
    STRING = "STRING"
    INT = "INT"
    BOOL = "BOOL"
    FLOAT = "FLOAT"
    POINTER = "POINTER"
    DATE_TIME_NAIVE = "DATE_TIME_NAIVE"
    DATE_TIME_UTC = "DATE_TIME_UTC"
    DURATION = "DURATION"
    ARRAY = "ARRAY"
    JSON = "JSON"
    BYTES = "BYTES"
    PY_OBJECT_WRAPPER = "PY_OBJECT_WRAPPER"

    def to_dtype(self) -> dt.DType:
        return {
            "ANY": dt.ANY, "STRING": dt.STR, "INT": dt.INT, "BOOL": dt.BOOL,
            "FLOAT": dt.FLOAT, "POINTER": dt.POINTER,
            "DATE_TIME_NAIVE": dt.DATE_TIME_NAIVE,
            "DATE_TIME_UTC": dt.DATE_TIME_UTC, "DURATION": dt.DURATION,
            "ARRAY": dt.ANY_ARRAY, "JSON": dt.JSON, "BYTES": dt.BYTES,
            "PY_OBJECT_WRAPPER": dt.ANY,
        }[self.value]


class PyObjectWrapper:
    """Opaque Python object carried through the dataflow (reference:
    src/python_api.rs py_object_wrapper.rs)."""

    __slots__ = ("value",)

    def __init__(self, value: Any):
        self.value = value

    def __repr__(self) -> str:
        return f"pw.PyObjectWrapper({self.value!r})"

    def _pw_hash_repr_(self):
        # stable across processes when the payload pickles; otherwise fall
        # back to identity (documented: identity-hashed objects must not be
        # used to derive persisted keys)
        import pickle

        try:
            return ("#pyobj", pickle.dumps(self.value))
        except Exception:
            return ("#pyobj-id", id(self.value))


def wrap_py_object(value: Any) -> PyObjectWrapper:
    return PyObjectWrapper(value)


class SchemaProperties:
    def __init__(self, append_only: bool = False):
        self.append_only = append_only


# -- free-function forms of Table methods ------------------------------------
def join(left: Table, right: Table, *on, **kwargs) -> JoinResult:
    return left.join(right, *on, **kwargs)


def join_inner(left, right, *on, **kwargs):
    return left.join_inner(right, *on, **kwargs)


def join_left(left, right, *on, **kwargs):
    return left.join_left(right, *on, **kwargs)


def join_right(left, right, *on, **kwargs):
    return left.join_right(right, *on, **kwargs)


def join_outer(left, right, *on, **kwargs):
    return left.join_outer(right, *on, **kwargs)


def groupby(table: Table, *args, **kwargs) -> GroupedTable:
    return table.groupby(*args, **kwargs)


# -- schema helpers ----------------------------------------------------------
def schema_builder(columns: dict, *, name: str = "BuiltSchema",
                   properties: SchemaProperties | None = None) -> SchemaMetaclass:
    out = {}
    for n, cd in columns.items():
        out[n] = cd if not isinstance(cd, type) else column_definition(dtype=cd)
    schema = schema_from_columns(out, name=name)
    if properties is not None:
        schema.__append_only__ = properties.append_only
    return schema


def schema_from_csv(path: str, *, name: str = "CsvSchema", num_parsed_rows: int = 100,
                    **kwargs) -> SchemaMetaclass:
    import csv as _csv

    from ..debug import _parse_scalar

    with open(path, newline="", encoding="utf-8") as f:
        reader = _csv.DictReader(f)
        rows = []
        for i, r in enumerate(reader):
            if i >= num_parsed_rows:
                break
            rows.append(r)
    cols = {}
    for col in (reader.fieldnames or []):
        vals = [_parse_scalar(r[col]) for r in rows if r.get(col) not in (None, "")]
        dtypes = {dt.dtype_of_value(v) for v in vals}
        d = dt.lub(*dtypes) if dtypes else dt.ANY
        cols[col] = column_definition(dtype=d)
    return schema_from_columns(cols, name=name)


# -- custom accumulators (reference: internals/custom_reducers.py) -----------
class BaseCustomAccumulator:
    """Subclass with from_row / update / (retract) / compute_result."""

    @classmethod
    def from_row(cls, row):  # pragma: no cover - abstract
        raise NotImplementedError

    def update(self, other) -> None:
        raise NotImplementedError

    def compute_result(self):
        raise NotImplementedError

    @classmethod
    def reducer(cls, *exprs):
        from . import reducers as R

        def protocol(rows: list) -> Any:
            acc = None
            for args in rows:
                cur = cls.from_row(list(args))
                if acc is None:
                    acc = cur
                else:
                    acc.update(cur)
            return acc.compute_result() if acc is not None else None

        return R.udf_reducer(protocol, *exprs)


# -- error-log tables --------------------------------------------------------
def global_error_log() -> Table:
    """Snapshot of the global error log as a table (reference:
    pw.global_error_log; errors recorded during earlier runs in this
    process)."""
    from ..engine.telemetry import global_error_log as log

    from .datasource import StaticDataSource
    from .value import ref_scalar

    events = []
    for i, e in enumerate(log.entries):
        events.append(
            (0, ref_scalar("#err", i), (e["message"], e["operator"]), 1)
        )
    node = pg.new_node("input", [], source=StaticDataSource(events))
    return Table(
        node, ["message", "operator"],
        {"message": dt.STR, "operator": dt.STR}, Universe(), name="error_log",
    )


local_error_log = global_error_log


# -- table slice (reference: internals/table_slice.py) -----------------------
class TableSlice:
    """Column-set manipulation: t.slice.without(...)[...] etc."""

    def __init__(self, table: Table, mapping: dict[str, ColumnReference] | None = None):
        self._table = table
        self._mapping = mapping or {n: table[n] for n in table.column_names()}

    def __iter__(self):
        # yield refs labeled with their (possibly renamed) output name, so
        # `t.select(*t.slice.with_prefix("p_"))` keeps the new names
        import copy as _copy

        for name, ref in self._mapping.items():
            if name != ref.name:
                ref = _copy.copy(ref)
                ref._output_name = name
            yield ref

    def __getitem__(self, name):
        if isinstance(name, ColumnReference):
            name = name.name
        return self._mapping[name]

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            return self._mapping[name]
        except KeyError:
            raise AttributeError(name)

    def keys(self):
        return list(self._mapping.keys())

    def without(self, *cols) -> "TableSlice":
        names = {c.name if isinstance(c, ColumnReference) else c for c in cols}
        return TableSlice(
            self._table,
            {n: r for n, r in self._mapping.items() if n not in names},
        )

    def rename(self, mapping: dict) -> "TableSlice":
        ren = {
            (k.name if isinstance(k, ColumnReference) else k):
            (v.name if isinstance(v, ColumnReference) else v)
            for k, v in mapping.items()
        }
        out = {}
        for n, r in self._mapping.items():
            new = ren.get(n, n)
            if new in out:
                raise ValueError(f"slice rename collides on column {new!r}")
            out[new] = r
        return TableSlice(self._table, out)

    def with_prefix(self, prefix: str) -> "TableSlice":
        return TableSlice(
            self._table, {prefix + n: r for n, r in self._mapping.items()}
        )

    def with_suffix(self, suffix: str) -> "TableSlice":
        return TableSlice(
            self._table, {n + suffix: r for n, r in self._mapping.items()}
        )


def _table_slice(self: Table) -> TableSlice:
    return TableSlice(self)


Table.slice = property(_table_slice)


# -- pandas_transformer (reference: stdlib/utils/pandas_transformer.py) ------
def pandas_transformer(output_schema: SchemaMetaclass, output_universe: Any = None):
    """Decorator: a function over pandas DataFrames becomes a table-to-table
    transform (full recompute per logical time, like pw.iterate).

    output_universe: accepted for reference parity; output keys here always
    derive from the returned DataFrame's index."""

    def deco(fn: Callable):
        def apply_transform(*tables: Table) -> Table:
            from ..engine.graph import DiffOutputOperator
            from ..engine.runner import register_lowering
            from .value import ref_scalar

            colnames_in = [t.column_names() for t in tables]
            out_cols = output_schema.column_names()

            node = pg.new_node(
                "pandas_transformer",
                list(tables),
                fn=fn,
                colnames_in=colnames_in,
                out_cols=out_cols,
            )
            return Table(
                node, out_cols, dict(output_schema.dtypes()), Universe(),
                name=f"pandas_{fn.__name__}",
            )

        return apply_transform

    return deco


def _lower_pandas_transformer(node, lg):
    from ..engine.graph import DiffOutputOperator

    p = node.params

    class PandasTransformerOperator(DiffOutputOperator):
        def dirty_keys_for(self, port, key):
            return ()

        def process(self, port, updates, time):
            st = self.state[port]
            for key, row, diff in updates:
                st.apply(key, row, diff)
            self._dirty.add(0)

        def flush(self, time):
            if not self._dirty:
                return
            self._dirty.clear()
            import pandas as pd

            from ..engine.types import rows_equal
            from .value import ref_scalar

            dfs = []
            for i, cols in enumerate(p["colnames_in"]):
                rows = list(self.state[i].items())
                dfs.append(
                    pd.DataFrame(
                        [list(r) for _k, r in rows], columns=cols,
                        index=[k for k, _r in rows],
                    )
                )
            try:
                out_df = p["fn"](*dfs)
            except Exception:
                out_df = None
            target: dict = {}
            if out_df is not None:
                for idx, row in out_df.iterrows():
                    key = idx if isinstance(idx, int) else ref_scalar("#pdt", idx)
                    target[key] = tuple(row[c] for c in p["out_cols"])
            out = []
            for key, row in list(self.last_out.items()):
                if key not in target or not rows_equal(target[key], row):
                    out.append((key, row, -1))
                    del self.last_out[key]
            for key, row in target.items():
                if key not in self.last_out:
                    out.append((key, row, 1))
                    self.last_out[key] = row
            self.emit(time, out)

    return PandasTransformerOperator(len(node.input_tables), name="pandas_transformer")


from ..engine.runner import register_lowering  # noqa: E402

register_lowering("pandas_transformer")(_lower_pandas_transformer)


def table_transformer(fn: Callable | None = None, **kwargs):
    """Decorator marking a Table->Table function (typing aid in the
    reference; identity here)."""
    if fn is None:
        return lambda f: f
    return fn


def iterate_universe(func, **kwargs):
    """Alias of pw.iterate — this engine's iterate already supports bodies
    that change the key set per step."""
    from .iterate import iterate

    return iterate(func, **kwargs)
