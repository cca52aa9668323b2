"""`pw.reducers` namespace (reference: python/pathway/internals/reducers.py).

Each function builds a ReducerExpression; the groupby lowering maps it to an
incremental state machine in engine/reducers_impl.py.
"""

from __future__ import annotations

from typing import Any, Callable

from . import dtype as dt
from .expression import ColumnExpression, ReducerExpression
from .type_interpreter import infer_dtype


def count(*args) -> ReducerExpression:
    return ReducerExpression("count", *args)


def sum(expr) -> ReducerExpression:  # noqa: A001
    return ReducerExpression("sum", expr)


def avg(expr) -> ReducerExpression:
    return ReducerExpression("avg", expr)


def min(expr) -> ReducerExpression:  # noqa: A001
    return ReducerExpression("min", expr)


def max(expr) -> ReducerExpression:  # noqa: A001
    return ReducerExpression("max", expr)


def argmin(value, arg) -> ReducerExpression:
    return ReducerExpression("argmin", value, arg)


def argmax(value, arg) -> ReducerExpression:
    return ReducerExpression("argmax", value, arg)


def unique(expr) -> ReducerExpression:
    return ReducerExpression("unique", expr)


def any(expr) -> ReducerExpression:  # noqa: A001
    return ReducerExpression("any", expr)


def count_distinct(expr) -> ReducerExpression:
    return ReducerExpression("count_distinct", expr)


def count_distinct_approximate(expr, precision: int = 12) -> ReducerExpression:
    return ReducerExpression("count_distinct_approximate", expr, precision=precision)


def sorted_tuple(expr, *, skip_nones: bool = False) -> ReducerExpression:
    return ReducerExpression("sorted_tuple", expr, skip_nones=skip_nones)


def tuple(expr, *, skip_nones: bool = False) -> ReducerExpression:  # noqa: A001
    return ReducerExpression("tuple", expr, skip_nones=skip_nones)


def ndarray(expr, *, skip_nones: bool = False) -> ReducerExpression:
    return ReducerExpression("ndarray", expr, skip_nones=skip_nones)


def earliest(expr) -> ReducerExpression:
    return ReducerExpression("earliest", expr)


def latest(expr) -> ReducerExpression:
    return ReducerExpression("latest", expr)


def npsum(expr) -> ReducerExpression:
    return ReducerExpression("sum", expr)


def stateful_single(combine_single: Callable, *exprs,
                    finish: Callable | None = None) -> ReducerExpression:
    def combine_many(state, rows):
        for args, cnt in rows:
            for _ in range(cnt):
                state = combine_single(state, *args)
        return state

    return ReducerExpression("stateful", *exprs, combine_many=combine_many,
                             finish=finish)


def stateful_many(combine_many: Callable, *exprs,
                  finish: Callable | None = None) -> ReducerExpression:
    return ReducerExpression("stateful", *exprs, combine_many=combine_many,
                             finish=finish)


def udf_reducer(protocol: Callable[[list], Any], *exprs) -> ReducerExpression:
    """Full-recompute custom reducer: protocol receives the list of arg-tuples."""
    return ReducerExpression("udf", *exprs, protocol=protocol)


_NUMERIC_PRESERVING = {"sum", "min", "max", "unique", "any", "earliest", "latest"}


def reducer_return_dtype(e: ReducerExpression) -> dt.DType:
    rid = e._reducer
    if rid in ("count", "count_distinct", "count_distinct_approximate"):
        return dt.INT
    if rid == "avg":
        return dt.FLOAT
    if rid in _NUMERIC_PRESERVING:
        return infer_dtype(e._args[0]) if e._args else dt.ANY
    if rid in ("argmin", "argmax"):
        return infer_dtype(e._args[1]) if len(e._args) > 1 else dt.ANY
    if rid in ("sorted_tuple", "tuple"):
        inner = infer_dtype(e._args[0]) if e._args else dt.ANY
        return dt.List(inner)
    if rid == "ndarray":
        return dt.ANY_ARRAY
    return dt.ANY
