"""`pw.this` / `pw.left` / `pw.right` placeholders.

Reference: python/pathway/internals/thisclass.py.  A placeholder behaves like a
table for the purpose of building ColumnReferences; desugaring substitutes the
actual table at operation-build time.
"""

from __future__ import annotations

from .expression import ColumnReference


class ThisMetaclass(type):
    _pw_exclusions: tuple[str, ...] = ()
    _pw_base = None

    def __getattr__(cls, name: str) -> ColumnReference:
        if name.startswith("__"):
            raise AttributeError(name)
        return ColumnReference(cls, name)

    def __getitem__(cls, name) -> ColumnReference:
        if isinstance(name, ColumnReference):
            name = name.name
        return ColumnReference(cls, name)

    def __iter__(cls):
        # `select(*pw.this)` expands to "all columns" via expand_args
        yield cls

    def without(cls, *columns) -> "ThisMetaclass":
        names = tuple(c.name if isinstance(c, ColumnReference) else c for c in columns)

        class _without(cls):  # type: ignore[misc, valid-type]
            pass

        _without._pw_exclusions = cls._pw_exclusions + names
        _without._pw_base = cls._pw_base or cls
        return _without

    def __repr__(cls) -> str:
        return f"<{(cls._pw_base or cls).__name__}>"


class this(metaclass=ThisMetaclass):
    """Placeholder for 'the table this operation applies to'."""


class left(metaclass=ThisMetaclass):
    """Placeholder for the left side of a join."""


class right(metaclass=ThisMetaclass):
    """Placeholder for the right side of a join."""


def base_placeholder(cls) -> type:
    return cls._pw_base or cls


def is_placeholder(obj) -> bool:
    return isinstance(obj, ThisMetaclass)
