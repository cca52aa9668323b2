"""Column expression AST.

Declarative expressions over table columns (reference: python/pathway/
internals/expression.py:88-1258).  Each node carries:
  - construction helpers / operator overloads,
  - `_dependencies()` for graph wiring,
  - `_eval(row)` — interpretation over one row environment (a dict from
    (table_ref, column_name) -> value plus "id").

The engine evaluates expressions over micro-batches; numeric-only expression
trees are additionally lowered to vectorized numpy / torch computations by
`engine/vectorize.py` (the device tier).
"""

from __future__ import annotations

import math
import operator
from abc import ABC, abstractmethod
from typing import Any, Callable, Iterable

from . import dtype as dt
from .value import ERROR, Error, Json, Pointer, ref_scalar, ref_scalar_with_instance


class ColumnExpression(ABC):
    _dtype: dt.DType | None = None

    # ---- graph wiring ----------------------------------------------------
    @abstractmethod
    def _dependencies(self) -> Iterable["ColumnReference"]: ...

    @abstractmethod
    def _eval(self, row: dict) -> Any: ...

    # ---- operator overloads ---------------------------------------------
    def __add__(self, other):
        return BinaryOpExpression("+", self, wrap(other))

    def __radd__(self, other):
        return BinaryOpExpression("+", wrap(other), self)

    def __sub__(self, other):
        return BinaryOpExpression("-", self, wrap(other))

    def __rsub__(self, other):
        return BinaryOpExpression("-", wrap(other), self)

    def __mul__(self, other):
        return BinaryOpExpression("*", self, wrap(other))

    def __rmul__(self, other):
        return BinaryOpExpression("*", wrap(other), self)

    def __truediv__(self, other):
        return BinaryOpExpression("/", self, wrap(other))

    def __rtruediv__(self, other):
        return BinaryOpExpression("/", wrap(other), self)

    def __floordiv__(self, other):
        return BinaryOpExpression("//", self, wrap(other))

    def __rfloordiv__(self, other):
        return BinaryOpExpression("//", wrap(other), self)

    def __mod__(self, other):
        return BinaryOpExpression("%", self, wrap(other))

    def __rmod__(self, other):
        return BinaryOpExpression("%", wrap(other), self)

    def __pow__(self, other):
        return BinaryOpExpression("**", self, wrap(other))

    def __rpow__(self, other):
        return BinaryOpExpression("**", wrap(other), self)

    def __matmul__(self, other):
        return BinaryOpExpression("@", self, wrap(other))

    def __rmatmul__(self, other):
        return BinaryOpExpression("@", wrap(other), self)

    def __eq__(self, other):  # type: ignore[override]
        return BinaryOpExpression("==", self, wrap(other))

    def __ne__(self, other):  # type: ignore[override]
        return BinaryOpExpression("!=", self, wrap(other))

    def __lt__(self, other):
        return BinaryOpExpression("<", self, wrap(other))

    def __le__(self, other):
        return BinaryOpExpression("<=", self, wrap(other))

    def __gt__(self, other):
        return BinaryOpExpression(">", self, wrap(other))

    def __ge__(self, other):
        return BinaryOpExpression(">=", self, wrap(other))

    def __and__(self, other):
        return BinaryOpExpression("&", self, wrap(other))

    def __rand__(self, other):
        return BinaryOpExpression("&", wrap(other), self)

    def __or__(self, other):
        return BinaryOpExpression("|", self, wrap(other))

    def __ror__(self, other):
        return BinaryOpExpression("|", wrap(other), self)

    def __xor__(self, other):
        return BinaryOpExpression("^", self, wrap(other))

    def __rxor__(self, other):
        return BinaryOpExpression("^", wrap(other), self)

    def __neg__(self):
        return UnaryOpExpression("-", self)

    def __invert__(self):
        return UnaryOpExpression("~", self)

    def __abs__(self):
        return ApplyExpression(abs, dt.ANY, (self,), {})

    def __getitem__(self, item):
        return GetExpression(self, wrap(item), check_if_exists=False)

    def __hash__(self):
        return id(self)

    def __bool__(self):
        raise TypeError(
            "ColumnExpression is not a boolean; use &, |, ~ for logic and "
            "pw.if_else for conditionals"
        )

    # ---- methods ---------------------------------------------------------
    def get(self, item, default=None):
        return GetExpression(self, wrap(item), wrap(default), check_if_exists=True)

    def is_none(self):
        return IsNoneExpression(self)

    def is_not_none(self):
        return IsNotNoneExpression(self)

    def as_int(self):
        return MethodCallExpression("as_int", _json_as(int), self)

    def as_float(self):
        return MethodCallExpression("as_float", _json_as(float), self)

    def as_str(self):
        return MethodCallExpression("as_str", _json_as(str), self)

    def as_bool(self):
        return MethodCallExpression("as_bool", _json_as(bool), self)

    def to_string(self):
        return MethodCallExpression("to_string", lambda v: str(v), self, dtype=dt.STR)

    # namespaces
    @property
    def dt(self):
        from .expressions.date_time import DateTimeNamespace

        return DateTimeNamespace(self)

    @property
    def str(self):
        from .expressions.string import StringNamespace

        return StringNamespace(self)

    @property
    def num(self):
        from .expressions.numerical import NumericalNamespace

        return NumericalNamespace(self)

    @property
    def bin(self):
        from .expressions.binary import BinaryNamespace

        return BinaryNamespace(self)


def _json_as(typ):
    def fn(v):
        if isinstance(v, Json):
            v = v.value
        if typ is float and isinstance(v, (int, float)) and not isinstance(v, bool):
            return float(v)
        if typ is int and isinstance(v, int) and not isinstance(v, bool):
            return v
        if isinstance(v, typ) and not (typ is not bool and isinstance(v, bool)):
            return v
        return None

    return fn


_MISSING = object()


class ColumnReference(ColumnExpression):
    """`table.colname` / `table['colname']` / `pw.this.colname`."""

    def __init__(self, table, name: str):
        self._table = table
        self._name = name

    @property
    def table(self):
        return self._table

    @property
    def name(self) -> str:
        return self._name

    def _dependencies(self):
        yield self

    def _eval(self, row: dict) -> Any:
        v = row.get((id(self._table), self._name), _MISSING)
        if v is not _MISSING:
            return v
        if self._name == "id":
            return row["id"]
        raise KeyError(f"column {self._name!r} not available in this context")

    def __repr__(self):
        return f"<{self._table._name if hasattr(self._table, '_name') else 'table'}>.{self._name}"

    def __hash__(self):
        return hash((id(self._table), self._name))


class ConstExpression(ColumnExpression):
    def __init__(self, value: Any):
        self._value = value
        self._dtype = dt.dtype_of_value(value)

    def _dependencies(self):
        return ()

    def _eval(self, row: dict) -> Any:
        return self._value

    def __repr__(self):
        return repr(self._value)


def wrap(value: Any) -> ColumnExpression:
    if isinstance(value, ColumnExpression):
        return value
    from .thisclass import ThisMetaclass

    if isinstance(value, ThisMetaclass):
        raise TypeError("pw.this used as a value; reference a column instead")
    return ConstExpression(value)


def _is_err(v: Any) -> bool:
    return isinstance(v, Error)


def _record_error(exc: Exception, where: str) -> None:
    """Record the failing call in the engine's error log (without the
    JAX package's ``except: pass`` around it)."""
    from ..engine.telemetry import global_error_log

    global_error_log.record(f"{type(exc).__name__}: {exc}", operator=where)


def _true_div(a, b):
    if isinstance(a, int) and isinstance(b, int) and not isinstance(a, bool) and not isinstance(b, bool):
        if b == 0:
            raise ZeroDivisionError("division by zero")
        return a / b
    return operator.truediv(a, b)


_BINOPS: dict[str, Callable[[Any, Any], Any]] = {
    "+": operator.add,
    "-": operator.sub,
    "*": operator.mul,
    "/": _true_div,
    "//": operator.floordiv,
    "%": operator.mod,
    "**": operator.pow,
    "@": operator.matmul,
    "==": operator.eq,
    "!=": operator.ne,
    "<": operator.lt,
    "<=": operator.le,
    ">": operator.gt,
    ">=": operator.ge,
    "&": lambda a, b: (a and b) if isinstance(a, bool) and isinstance(b, bool) else operator.and_(a, b),
    "|": lambda a, b: (a or b) if isinstance(a, bool) and isinstance(b, bool) else operator.or_(a, b),
    "^": operator.xor,
}


class BinaryOpExpression(ColumnExpression):
    def __init__(self, op: str, left: ColumnExpression, right: ColumnExpression):
        self._op = op
        self._left = left
        self._right = right
        self._fn = _BINOPS[op]

    def _dependencies(self):
        yield from self._left._dependencies()
        yield from self._right._dependencies()

    def _eval(self, row: dict) -> Any:
        a = self._left._eval(row)
        if _is_err(a):
            return ERROR
        b = self._right._eval(row)
        if _is_err(b):
            return ERROR
        try:
            import numpy as np

            res = self._fn(a, b)
            if isinstance(res, np.generic):
                res = res.item()
            return res
        except Exception as exc:
            _record_error(exc, self._op)
            return ERROR

    def __repr__(self):
        return f"({self._left!r} {self._op} {self._right!r})"


class UnaryOpExpression(ColumnExpression):
    def __init__(self, op: str, expr: ColumnExpression):
        self._op = op
        self._expr = expr

    def _dependencies(self):
        yield from self._expr._dependencies()

    def _eval(self, row: dict) -> Any:
        v = self._expr._eval(row)
        if _is_err(v):
            return ERROR
        try:
            if self._op == "-":
                return -v
            if isinstance(v, bool):
                return not v
            return ~v
        except Exception:
            return ERROR

    def __repr__(self):
        return f"({self._op}{self._expr!r})"


class IsNoneExpression(ColumnExpression):
    def __init__(self, expr: ColumnExpression):
        self._expr = expr

    def _dependencies(self):
        yield from self._expr._dependencies()

    def _eval(self, row: dict) -> Any:
        v = self._expr._eval(row)
        if _is_err(v):
            return ERROR
        return v is None


class IsNotNoneExpression(IsNoneExpression):
    def _eval(self, row: dict) -> Any:
        v = self._expr._eval(row)
        if _is_err(v):
            return ERROR
        return v is not None


class IfElseExpression(ColumnExpression):
    def __init__(self, cond, then, else_):
        self._cond = wrap(cond)
        self._then = wrap(then)
        self._else = wrap(else_)

    def _dependencies(self):
        yield from self._cond._dependencies()
        yield from self._then._dependencies()
        yield from self._else._dependencies()

    def _eval(self, row: dict) -> Any:
        c = self._cond._eval(row)
        if _is_err(c):
            return ERROR
        return self._then._eval(row) if c else self._else._eval(row)


class CoalesceExpression(ColumnExpression):
    def __init__(self, *args):
        self._args = [wrap(a) for a in args]

    def _dependencies(self):
        for a in self._args:
            yield from a._dependencies()

    def _eval(self, row: dict) -> Any:
        for a in self._args:
            v = a._eval(row)
            if _is_err(v):
                return ERROR
            if v is not None:
                return v
        return None


class RequireExpression(ColumnExpression):
    """pw.require(val, *deps) — val if all deps non-None else None."""

    def __init__(self, val, *args):
        self._val = wrap(val)
        self._args = [wrap(a) for a in args]

    def _dependencies(self):
        yield from self._val._dependencies()
        for a in self._args:
            yield from a._dependencies()

    def _eval(self, row: dict) -> Any:
        for a in self._args:
            v = a._eval(row)
            if _is_err(v):
                return ERROR
            if v is None:
                return None
        return self._val._eval(row)


class ApplyExpression(ColumnExpression):
    """pw.apply / @pw.udf call site."""

    def __init__(
        self,
        fun: Callable,
        return_type: Any,
        args: tuple,
        kwargs: dict,
        *,
        propagate_none: bool = False,
        deterministic: bool = True,
        max_batch_size: int | None = None,
        batch_fn: Callable | None = None,
    ):
        self._fun = fun
        self._dtype = dt.wrap(return_type)
        self._args = [wrap(a) for a in args]
        self._kwargs = {k: wrap(v) for k, v in kwargs.items()}
        self._propagate_none = propagate_none
        self._deterministic = deterministic
        self._max_batch_size = max_batch_size
        # batch_fn([v0, v1, ...]) -> [r0, r1, ...]: one call per micro-batch
        # (the device-UDF hook)
        self._batch_fn = batch_fn

    def _dependencies(self):
        for a in self._args:
            yield from a._dependencies()
        for a in self._kwargs.values():
            yield from a._dependencies()

    def _eval(self, row: dict) -> Any:
        args = []
        for a in self._args:
            v = a._eval(row)
            if _is_err(v):
                return ERROR
            if v is None and self._propagate_none:
                return None
            args.append(v)
        kwargs = {}
        for k, a in self._kwargs.items():
            v = a._eval(row)
            if _is_err(v):
                return ERROR
            if v is None and self._propagate_none:
                return None
            kwargs[k] = v
        try:
            return self._fun(*args, **kwargs)
        except Exception as exc:
            _record_error(exc, getattr(self._fun, "__name__", "apply"))
            return ERROR


class FullyAsyncApplyExpression(ApplyExpression):
    """Fully-async UDF: emits Pending first, result arrives as a later update."""


class CastExpression(ColumnExpression):
    def __init__(self, target: Any, expr: ColumnExpression):
        self._target = dt.wrap(target)
        self._expr = wrap(expr)
        self._dtype = self._target

    def _dependencies(self):
        yield from self._expr._dependencies()

    def _eval(self, row: dict) -> Any:
        v = self._expr._eval(row)
        if _is_err(v) or v is None:
            return v
        t = self._target.strip_optional()
        try:
            if t == dt.INT:
                return int(v)
            if t == dt.FLOAT:
                return float(v)
            if t == dt.BOOL:
                return bool(v)
            if t == dt.STR:
                return str(v)
            return v
        except Exception:
            return ERROR


class ConvertExpression(ColumnExpression):
    """pw.unwrap / fill_error / JSON conversions."""

    def __init__(self, fn: Callable, expr: ColumnExpression, dtype: dt.DType = dt.ANY):
        self._fn = fn
        self._expr = wrap(expr)
        self._dtype = dtype

    def _dependencies(self):
        yield from self._expr._dependencies()

    def _eval(self, row: dict) -> Any:
        return self._fn(self._expr._eval(row))


class FillErrorExpression(ColumnExpression):
    def __init__(self, expr, replacement):
        self._expr = wrap(expr)
        self._replacement = wrap(replacement)

    def _dependencies(self):
        yield from self._expr._dependencies()
        yield from self._replacement._dependencies()

    def _eval(self, row: dict) -> Any:
        v = self._expr._eval(row)
        if _is_err(v):
            return self._replacement._eval(row)
        return v


class MakeTupleExpression(ColumnExpression):
    def __init__(self, *args):
        self._args = [wrap(a) for a in args]

    def _dependencies(self):
        for a in self._args:
            yield from a._dependencies()

    def _eval(self, row: dict) -> Any:
        out = []
        for a in self._args:
            v = a._eval(row)
            if _is_err(v):
                return ERROR
            out.append(v)
        return tuple(out)


class GetExpression(ColumnExpression):
    def __init__(self, obj, index, default=None, *, check_if_exists: bool):
        self._obj = wrap(obj)
        self._index = wrap(index)
        self._default = wrap(default)
        self._check = check_if_exists

    def _dependencies(self):
        yield from self._obj._dependencies()
        yield from self._index._dependencies()
        yield from self._default._dependencies()

    def _eval(self, row: dict) -> Any:
        o = self._obj._eval(row)
        i = self._index._eval(row)
        if _is_err(o) or _is_err(i):
            return ERROR
        try:
            if isinstance(o, Json):
                if self._check:
                    return o.get(i, self._default._eval(row))
                return o[i]
            return o[i]
        except Exception:
            if self._check:
                return self._default._eval(row)
            return ERROR


class MethodCallExpression(ColumnExpression):
    """Namespace method call (.dt.year(), .str.upper(), ...)."""

    def __init__(self, name: str, fn: Callable, *args, dtype: dt.DType = dt.ANY,
                 propagate_none: bool = True):
        self._method_name = name
        self._fn = fn
        self._args = [wrap(a) for a in args]
        self._dtype = dtype
        self._propagate_none = propagate_none

    def _dependencies(self):
        for a in self._args:
            yield from a._dependencies()

    def _eval(self, row: dict) -> Any:
        vals = []
        for a in self._args:
            v = a._eval(row)
            if _is_err(v):
                return ERROR
            vals.append(v)
        if self._propagate_none and vals and vals[0] is None:
            return None
        try:
            return self._fn(*vals)
        except Exception:
            return ERROR


class PointerExpression(ColumnExpression):
    """table.pointer_from(*args, instance=..., optional=...)."""

    def __init__(self, table, *args, instance=None, optional: bool = False):
        self._table = table
        self._args = [wrap(a) for a in args]
        self._instance = wrap(instance) if instance is not None else None
        self._optional = optional
        self._dtype = dt.optional(dt.POINTER) if optional else dt.POINTER

    def _dependencies(self):
        for a in self._args:
            yield from a._dependencies()
        if self._instance is not None:
            yield from self._instance._dependencies()

    def _eval(self, row: dict) -> Any:
        vals = []
        for a in self._args:
            v = a._eval(row)
            if _is_err(v):
                return ERROR
            vals.append(v)
        if self._optional and any(v is None for v in vals):
            return None
        if self._instance is not None:
            inst = self._instance._eval(row)
            return ref_scalar_with_instance(vals, inst)
        return ref_scalar(*vals)


class ReducerExpression(ColumnExpression):
    """Aggregation call site — only valid inside groupby().reduce()."""

    def __init__(self, reducer, *args, **kwargs):
        self._reducer = reducer  # engine.reducers_impl.Reducer subclass name
        self._args = [wrap(a) for a in args]
        self._kwargs = kwargs

    def _dependencies(self):
        for a in self._args:
            yield from a._dependencies()

    def _eval(self, row: dict) -> Any:
        raise RuntimeError(
            f"reducer {self._reducer} used outside groupby().reduce()"
        )


class UnwrapError(Exception):
    pass


def unwrap_value(v):
    if v is None:
        raise UnwrapError("unwrap() on None")
    return v


def smart_name(expr: ColumnExpression) -> str | None:
    if isinstance(expr, ColumnReference):
        return expr.name
    return None
