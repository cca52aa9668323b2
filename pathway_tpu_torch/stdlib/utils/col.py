"""Column utilities (reference: stdlib/utils/col.py).

The port of ``pathway_tpu/stdlib/utils/col.py``.
"""

from __future__ import annotations

from ...internals.expression import ColumnReference
from ...internals.table import Table


def unpack_col(column: ColumnReference, *unpacked_columns, schema=None) -> Table:
    """Expand a tuple-valued column into separate columns."""
    table = column.table
    if schema is not None:
        names = schema.column_names()
    else:
        names = [c.name if isinstance(c, ColumnReference) else c for c in unpacked_columns]
    return table.select(**{n: column[i] for i, n in enumerate(names)})


def flatten_column(column: ColumnReference, origin_id: str | None = None) -> Table:
    return column.table.flatten(column)


def apply_all_rows(*cols, fun, result_col):  # pragma: no cover - parity stub
    raise NotImplementedError("apply_all_rows: use pw.reducers.tuple + flatten")
