"""Ordered ops: Table.diff (reference: stdlib/ordered/diff.py).

The port of ``pathway_tpu/stdlib/ordered/__init__.py``.
"""

from __future__ import annotations

from ...internals.table import Table
from ...internals.expression import ColumnReference


def diff(
    self: Table,
    timestamp: ColumnReference,
    *values: ColumnReference,
    instance: ColumnReference | None = None,
) -> Table:
    """For each row, subtract the previous row's value (ordered by timestamp,
    optionally per instance).  First row per instance gets None."""
    ts = self._desugar(timestamp)
    sorted_ptrs = self.sort(key=ts, instance=instance)
    prev_rows = self.ix(sorted_ptrs.prev, optional=True)
    out = {}
    for v in values:
        ref = self._desugar(v)
        name = f"diff_{ref.name}" if len(values) > 1 else f"diff_{ref.name}"
        from ... import if_else

        out[name] = if_else(
            prev_rows[ref.name].is_none(), None, ref - prev_rows[ref.name]
        )
    return self.with_columns(**out)
