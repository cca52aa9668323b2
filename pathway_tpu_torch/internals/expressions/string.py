"""`.str` expression namespace (reference: internals/expressions/string.py, 931 LoC)."""

from __future__ import annotations

from .. import dtype as dt
from ..expression import ColumnExpression, MethodCallExpression, wrap


def _m(name, fn, *args, dtype=dt.ANY):
    return MethodCallExpression(name, fn, *args, dtype=dtype)


class StringNamespace:
    def __init__(self, expr: ColumnExpression):
        self._e = expr

    def lower(self):
        return _m("str.lower", lambda s: s.lower(), self._e, dtype=dt.STR)

    def upper(self):
        return _m("str.upper", lambda s: s.upper(), self._e, dtype=dt.STR)

    def reversed(self):
        return _m("str.reversed", lambda s: s[::-1], self._e, dtype=dt.STR)

    def len(self):
        return _m("str.len", lambda s: len(s), self._e, dtype=dt.INT)

    def strip(self, chars=None):
        return _m("str.strip", lambda s, c: s.strip(c), self._e, wrap(chars), dtype=dt.STR)

    def lstrip(self, chars=None):
        return _m("str.lstrip", lambda s, c: s.lstrip(c), self._e, wrap(chars), dtype=dt.STR)

    def rstrip(self, chars=None):
        return _m("str.rstrip", lambda s, c: s.rstrip(c), self._e, wrap(chars), dtype=dt.STR)

    def startswith(self, prefix):
        return _m("str.startswith", lambda s, p: s.startswith(p), self._e, wrap(prefix), dtype=dt.BOOL)

    def endswith(self, suffix):
        return _m("str.endswith", lambda s, p: s.endswith(p), self._e, wrap(suffix), dtype=dt.BOOL)

    def swapcase(self):
        return _m("str.swapcase", lambda s: s.swapcase(), self._e, dtype=dt.STR)

    def title(self):
        return _m("str.title", lambda s: s.title(), self._e, dtype=dt.STR)

    def count(self, sub, start=None, end=None):
        return _m(
            "str.count",
            lambda s, x, a, b: s.count(x, a if a is not None else 0, b if b is not None else len(s)),
            self._e, wrap(sub), wrap(start), wrap(end), dtype=dt.INT,
        )

    def find(self, sub, start=None, end=None):
        return _m(
            "str.find",
            lambda s, x, a, b: s.find(x, a if a is not None else 0, b if b is not None else len(s)),
            self._e, wrap(sub), wrap(start), wrap(end), dtype=dt.INT,
        )

    def rfind(self, sub, start=None, end=None):
        return _m(
            "str.rfind",
            lambda s, x, a, b: s.rfind(x, a if a is not None else 0, b if b is not None else len(s)),
            self._e, wrap(sub), wrap(start), wrap(end), dtype=dt.INT,
        )

    def removeprefix(self, prefix):
        return _m("str.removeprefix", lambda s, p: s.removeprefix(p), self._e, wrap(prefix), dtype=dt.STR)

    def removesuffix(self, suffix):
        return _m("str.removesuffix", lambda s, p: s.removesuffix(p), self._e, wrap(suffix), dtype=dt.STR)

    def replace(self, old, new, count=-1):
        return _m("str.replace", lambda s, o, n, c: s.replace(o, n, c),
                  self._e, wrap(old), wrap(new), wrap(count), dtype=dt.STR)

    def split(self, sep=None, maxsplit=-1):
        return _m("str.split", lambda s, x, m: tuple(s.split(x, m)),
                  self._e, wrap(sep), wrap(maxsplit), dtype=dt.List(dt.STR))

    def slice(self, start, end):
        return _m("str.slice", lambda s, a, b: s[a:b], self._e, wrap(start), wrap(end), dtype=dt.STR)

    def parse_int(self, optional: bool = False):
        def fn(s):
            try:
                return int(s.strip())
            except (ValueError, AttributeError):
                if optional:
                    return None
                raise

        return _m("str.parse_int", fn, self._e, dtype=dt.optional(dt.INT) if optional else dt.INT)

    def parse_float(self, optional: bool = False):
        def fn(s):
            try:
                return float(s.strip())
            except (ValueError, AttributeError):
                if optional:
                    return None
                raise

        return _m("str.parse_float", fn, self._e, dtype=dt.optional(dt.FLOAT) if optional else dt.FLOAT)

    def parse_bool(self, true_values=("on", "true", "yes", "1"),
                   false_values=("off", "false", "no", "0"), optional: bool = False):
        def fn(s):
            low = s.strip().lower()
            if low in true_values:
                return True
            if low in false_values:
                return False
            if optional:
                return None
            raise ValueError(f"cannot parse {s!r} as bool")

        return _m("str.parse_bool", fn, self._e, dtype=dt.BOOL)

    def to_bytes(self, encoding="utf-8"):
        return _m("str.to_bytes", lambda s, e: s.encode(e), self._e, wrap(encoding), dtype=dt.BYTES)
