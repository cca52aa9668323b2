"""Dtype lattice for the declarative layer.

Lean re-design of the reference's type system (python/pathway/internals/
dtype.py, 1,087 LoC; src/engine/value.rs:512 `Type`): a small set of singleton
dtypes plus parametric Optional/Tuple/List/Array/Callable/Pointer wrappers,
with lub (least upper bound) used by the type interpreter.
"""

from __future__ import annotations

import datetime
import typing
from typing import Any

import numpy as np

from .value import Error, Json, Pending, Pointer


class DType:
    name: str = "DType"

    def __repr__(self) -> str:
        return self.name

    def is_optional(self) -> bool:
        return False

    def strip_optional(self) -> "DType":
        return self

    def is_hashable(self) -> bool:
        return True

    def to_numpy(self):
        """numpy dtype for columnar encoding, or object."""
        return np.dtype(object)

    def __eq__(self, other: Any) -> bool:
        return type(self) is type(other) and repr(self) == repr(other)

    def __hash__(self) -> int:
        return hash(repr(self))


class _Simple(DType):
    def __init__(self, name: str, np_dtype=None, py_types: tuple = ()):
        self.name = name
        self._np = np.dtype(np_dtype) if np_dtype is not None else np.dtype(object)
        self.py_types = py_types

    def to_numpy(self):
        return self._np


INT = _Simple("INT", np.int64, (int,))
FLOAT = _Simple("FLOAT", np.float64, (float,))
BOOL = _Simple("BOOL", np.bool_, (bool,))
STR = _Simple("STR", None, (str,))
BYTES = _Simple("BYTES", None, (bytes,))
ANY = _Simple("ANY", None, ())
NONE = _Simple("NONE", None, (type(None),))
JSON = _Simple("JSON", None, (Json,))
DATE_TIME_NAIVE = _Simple("DATE_TIME_NAIVE", None, ())
DATE_TIME_UTC = _Simple("DATE_TIME_UTC", None, ())
DURATION = _Simple("DURATION", None, ())
ERROR_TYPE = _Simple("ERROR", None, (Error,))
PENDING_TYPE = _Simple("PENDING", None, (Pending,))
FUTURE_ANY = ANY


class Optional(DType):
    def __init__(self, wrapped: DType):
        while isinstance(wrapped, Optional):
            wrapped = wrapped.wrapped
        self.wrapped = wrapped
        self.name = f"Optional({wrapped!r})"

    def is_optional(self) -> bool:
        return True

    def strip_optional(self) -> DType:
        return self.wrapped


def optional(dt: DType) -> DType:
    if dt in (ANY, NONE) or isinstance(dt, Optional):
        return dt
    return Optional(dt)


class PointerDType(DType):
    def __init__(self, *args):
        self.name = "POINTER"


POINTER = PointerDType()


class Tuple(DType):
    def __init__(self, *args: DType):
        self.args = tuple(args)
        self.name = f"Tuple({', '.join(map(repr, args))})"


class List(DType):
    def __init__(self, wrapped: DType = ANY):
        self.wrapped = wrapped
        self.name = f"List({wrapped!r})"


class Array(DType):
    """N-dim numeric array column (reference: IntArray/FloatArray)."""

    def __init__(self, n_dim: int | None = None, wrapped: DType = FLOAT):
        self.n_dim = n_dim
        self.wrapped = wrapped
        self.name = f"Array({n_dim}, {wrapped!r})"

    def to_numpy(self):
        return np.dtype(object)


ANY_ARRAY = Array(None, ANY)
INT_ARRAY = Array(None, INT)
FLOAT_ARRAY = Array(None, FLOAT)


class Callable(DType):
    def __init__(self, arg_types=..., return_type: DType = ANY):
        self.arg_types = arg_types
        self.return_type = return_type
        self.name = f"Callable(..., {return_type!r})"


class Future(DType):
    """Column that may still contain Pending values (fully-async UDFs)."""

    def __init__(self, wrapped: DType):
        while isinstance(wrapped, Future):
            wrapped = wrapped.wrapped
        self.wrapped = wrapped
        self.name = f"Future({wrapped!r})"


_PY_MAP: dict[Any, DType] = {
    int: INT,
    float: FLOAT,
    bool: BOOL,
    str: STR,
    bytes: BYTES,
    type(None): NONE,
    Any: ANY,
    Pointer: POINTER,
    Json: JSON,
    datetime.datetime: DATE_TIME_NAIVE,
    datetime.timedelta: DURATION,
    np.ndarray: ANY_ARRAY,
    list: List(ANY),
    tuple: Tuple(),
    dict: JSON,
}


def wrap(input_type: Any) -> DType:
    """Coerce a python type annotation / DType into a DType."""
    if isinstance(input_type, DType):
        return input_type
    if input_type in _PY_MAP:
        return _PY_MAP[input_type]
    origin = typing.get_origin(input_type)
    args = typing.get_args(input_type)
    if origin is typing.Union:
        non_none = [a for a in args if a is not type(None)]
        has_none = len(non_none) != len(args)
        if len(non_none) == 1:
            inner = wrap(non_none[0])
            return optional(inner) if has_none else inner
        return ANY
    if origin in (list, typing.List):
        return List(wrap(args[0]) if args else ANY)
    if origin in (tuple, typing.Tuple):
        if args and args[-1] is Ellipsis:
            return List(wrap(args[0]))
        return Tuple(*[wrap(a) for a in args])
    if origin in (dict, typing.Dict):
        return JSON
    if input_type is np.ndarray:
        return ANY_ARRAY
    if isinstance(input_type, type) and issubclass(input_type, Pointer):
        return POINTER
    return ANY


def dtype_of_value(value: Any) -> DType:
    if value is None:
        return NONE
    if isinstance(value, Pointer):
        return POINTER
    if isinstance(value, bool):
        return BOOL
    if isinstance(value, int):
        return INT
    if isinstance(value, float):
        return FLOAT
    if isinstance(value, str):
        return STR
    if isinstance(value, bytes):
        return BYTES
    if isinstance(value, Json):
        return JSON
    if isinstance(value, Error):
        return ERROR_TYPE
    if isinstance(value, Pending):
        return PENDING_TYPE
    if isinstance(value, datetime.timedelta):
        return DURATION
    if isinstance(value, datetime.datetime):
        return DATE_TIME_UTC if value.tzinfo is not None else DATE_TIME_NAIVE
    if isinstance(value, np.ndarray):
        base = INT if np.issubdtype(value.dtype, np.integer) else FLOAT
        return Array(value.ndim, base)
    if isinstance(value, np.generic):
        return dtype_of_value(value.item())
    if isinstance(value, tuple):
        return Tuple(*[dtype_of_value(v) for v in value])
    if isinstance(value, list):
        return List(lub(*[dtype_of_value(v) for v in value]) if value else ANY)
    if isinstance(value, dict):
        return JSON
    if callable(value):
        return Callable(..., ANY)
    return ANY


def lub(*dts: DType) -> DType:
    """Least upper bound over the small lattice."""
    dts = tuple(d for d in dts)
    if not dts:
        return ANY
    result = dts[0]
    for dt in dts[1:]:
        result = _lub2(result, dt)
    return result


def _lub2(a: DType, b: DType) -> DType:
    if a == b:
        return a
    if a == NONE:
        return optional(b)
    if b == NONE:
        return optional(a)
    if a == ERROR_TYPE:
        return b
    if b == ERROR_TYPE:
        return a
    if isinstance(a, Optional) or isinstance(b, Optional):
        inner = _lub2(a.strip_optional(), b.strip_optional())
        return optional(inner)
    if {a, b} == {INT, FLOAT}:
        return FLOAT
    if isinstance(a, Tuple) and isinstance(b, Tuple):
        if len(a.args) == len(b.args):
            return Tuple(*[_lub2(x, y) for x, y in zip(a.args, b.args)])
        return List(ANY)
    if isinstance(a, Array) and isinstance(b, Array):
        n = a.n_dim if a.n_dim == b.n_dim else None
        return Array(n, _lub2(a.wrapped, b.wrapped))
    return ANY


def is_compatible(value_dtype: DType, target: DType) -> bool:
    """Can a column of value_dtype be used where target is expected?"""
    if target == ANY or value_dtype == ANY:
        return True
    if value_dtype == target:
        return True
    if value_dtype == ERROR_TYPE:
        return True
    if isinstance(target, Optional):
        if value_dtype == NONE:
            return True
        return is_compatible(value_dtype.strip_optional(), target.wrapped)
    if isinstance(value_dtype, Optional):
        return False
    if value_dtype == INT and target == FLOAT:
        return True
    if isinstance(value_dtype, Array) and isinstance(target, Array):
        return True
    if isinstance(value_dtype, (Tuple, List)) and isinstance(target, (Tuple, List)):
        return True
    if isinstance(value_dtype, PointerDType) and isinstance(target, PointerDType):
        return True
    return False


def check_value(value: Any, dt: DType) -> bool:
    return is_compatible(dtype_of_value(value), dt)
