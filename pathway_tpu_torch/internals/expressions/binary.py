"""`.bin` expression namespace — bytes helpers."""

from __future__ import annotations

import base64

from .. import dtype as dt
from ..expression import ColumnExpression, MethodCallExpression, wrap


def _m(name, fn, *args, dtype=dt.ANY):
    return MethodCallExpression(name, fn, *args, dtype=dtype)


class BinaryNamespace:
    def __init__(self, expr: ColumnExpression):
        self._e = expr

    def decode(self, encoding="utf-8"):
        return _m("bin.decode", lambda b, e: b.decode(e), self._e, wrap(encoding), dtype=dt.STR)

    def len(self):
        return _m("bin.len", len, self._e, dtype=dt.INT)

    def base64_encode(self):
        return _m("bin.base64_encode", lambda b: base64.b64encode(b), self._e, dtype=dt.BYTES)

    def base64_decode(self):
        return _m("bin.base64_decode", lambda b: base64.b64decode(b), self._e, dtype=dt.BYTES)
