"""Desugaring: substitute pw.this/left/right with concrete tables.

Reference: python/pathway/internals/desugaring.py.  Implemented as a generic
expression-tree rewrite: nodes are shallow-copied with ColumnExpression
attributes recursively rewritten.
"""

from __future__ import annotations

import copy
from typing import Any, Callable

from .expression import ColumnExpression, ColumnReference
from .thisclass import ThisMetaclass, base_placeholder, this, left, right


def rewrite(expr: ColumnExpression, fn: Callable[[ColumnReference], ColumnExpression]) -> ColumnExpression:
    """Rewrite every ColumnReference leaf via fn; rebuild interior nodes."""
    if isinstance(expr, ColumnReference):
        return fn(expr)
    clone = copy.copy(expr)
    for attr, value in vars(expr).items():
        new_value = _rewrite_value(value, fn)
        if new_value is not value:
            setattr(clone, attr, new_value)
    return clone


def _rewrite_value(value: Any, fn, node_fn=None):
    if isinstance(value, ColumnExpression):
        if node_fn is not None:
            return rewrite_nodes(value, node_fn)
        return rewrite(value, fn)
    if isinstance(value, list):
        new = [_rewrite_value(v, fn, node_fn) for v in value]
        return new if any(a is not b for a, b in zip(new, value)) else value
    if isinstance(value, tuple):
        new = tuple(_rewrite_value(v, fn, node_fn) for v in value)
        return new if any(a is not b for a, b in zip(new, value)) else value
    if isinstance(value, dict):
        new = {k: _rewrite_value(v, fn, node_fn) for k, v in value.items()}
        return new if any(new[k] is not value[k] for k in value) else value
    return value


def walk(expr: ColumnExpression):
    """Yield every node in the expression tree (pre-order)."""
    yield expr
    for value in vars(expr).values():
        yield from _walk_value(value)


def _walk_value(value: Any):
    if isinstance(value, ColumnExpression):
        yield from walk(value)
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _walk_value(v)
    elif isinstance(value, dict):
        for v in value.values():
            yield from _walk_value(v)


def rewrite_nodes(
    expr: ColumnExpression, node_fn: Callable[[ColumnExpression], ColumnExpression | None]
) -> ColumnExpression:
    """Apply node_fn to every node top-down; a non-None result replaces the
    node (no further recursion into it)."""
    replacement = node_fn(expr)
    if replacement is not None:
        return replacement
    if isinstance(expr, ColumnReference):
        return expr
    clone = copy.copy(expr)
    for attr, value in vars(expr).items():
        new_value = _rewrite_value(value, None, node_fn=node_fn)
        if new_value is not value:
            setattr(clone, attr, new_value)
    return clone


def substitute(expr: ColumnExpression, mapping: dict[type, Any]) -> ColumnExpression:
    """Replace placeholder tables (this/left/right) with concrete tables."""

    def fn(ref: ColumnReference) -> ColumnExpression:
        table = ref.table
        if isinstance(table, ThisMetaclass):
            base = base_placeholder(table)
            if base not in mapping:
                raise ValueError(f"placeholder {base.__name__} has no substitution here")
            return mapping[base][ref.name]
        return ref

    return rewrite(expr, fn)


def substitute_this(expr: ColumnExpression, table) -> ColumnExpression:
    return substitute(expr, {this: table})


def expand_args(table, *args) -> dict[str, ColumnExpression]:
    """Expand positional select/reduce args: ColumnReference, pw.this,
    pw.this.without(...), or whole tables -> name->expression mapping."""
    out: dict[str, ColumnExpression] = {}
    for arg in args:
        if isinstance(arg, ThisMetaclass):
            base = base_placeholder(arg)
            src = table if base is this else None
            if src is None:
                raise ValueError("cannot expand placeholder here")
            for name in src.column_names():
                if name not in arg._pw_exclusions:
                    out[name] = src[name]
        elif isinstance(arg, ColumnReference):
            out[getattr(arg, "_output_name", None) or arg.name] = arg
        elif hasattr(arg, "_mapping"):  # TableSlice: keeps its renames
            for name, ref in arg._mapping.items():
                out[name] = ref
        elif hasattr(arg, "column_names") and hasattr(arg, "__getitem__"):
            for name in arg.column_names():
                out[name] = arg[name]
        else:
            raise ValueError(
                f"positional argument {arg!r} must be a column reference; "
                "use keyword arguments for computed expressions"
            )
    return out
