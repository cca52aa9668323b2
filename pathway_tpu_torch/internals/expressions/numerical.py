"""`.num` expression namespace (reference: internals/expressions/numerical.py)."""

from __future__ import annotations

import math

from .. import dtype as dt
from ..expression import ColumnExpression, MethodCallExpression, wrap


def _m(name, fn, *args, dtype=dt.ANY):
    return MethodCallExpression(name, fn, *args, dtype=dtype)


class NumericalNamespace:
    def __init__(self, expr: ColumnExpression):
        self._e = expr

    def abs(self):
        return _m("num.abs", abs, self._e, dtype=dt.FLOAT)

    def round(self, decimals=0):
        return _m("num.round", lambda v, d: round(v, d), self._e, wrap(decimals))

    def floor(self):
        return _m("num.floor", math.floor, self._e)

    def ceil(self):
        return _m("num.ceil", math.ceil, self._e)

    def trunc(self):
        return _m("num.trunc", math.trunc, self._e)

    def sqrt(self):
        return _m("num.sqrt", math.sqrt, self._e, dtype=dt.FLOAT)

    def log(self, base=math.e):
        return _m("num.log", lambda v, b: math.log(v, b), self._e, wrap(base), dtype=dt.FLOAT)

    def exp(self):
        return _m("num.exp", math.exp, self._e, dtype=dt.FLOAT)

    def sin(self):
        return _m("num.sin", math.sin, self._e, dtype=dt.FLOAT)

    def cos(self):
        return _m("num.cos", math.cos, self._e, dtype=dt.FLOAT)

    def tan(self):
        return _m("num.tan", math.tan, self._e, dtype=dt.FLOAT)

    def fill_na(self, default_value):
        def fn(v, d):
            if v is None:
                return d
            if isinstance(v, float) and math.isnan(v):
                return d
            return v

        out = MethodCallExpression("num.fill_na", fn, self._e, wrap(default_value),
                                   propagate_none=False)
        return out
