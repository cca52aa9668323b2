"""stdlib.utils: column helpers and the async transformer (the port of
``pathway_tpu/stdlib/utils``; its viz hooks are not ported)."""

from __future__ import annotations

from ...internals.table import Table
from . import col
from .async_transformer import AsyncTransformer


def unpack_col(column, *unpacked_columns, schema=None) -> Table:
    return col.unpack_col(column, *unpacked_columns, schema=schema)


__all__ = ["col", "unpack_col", "AsyncTransformer"]
