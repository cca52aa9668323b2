"""Statistical ops: interpolate (reference: stdlib/statistical/_interpolate.py).

The port of ``pathway_tpu/stdlib/statistical/__init__.py``.
"""

from __future__ import annotations

import enum

from ...internals.table import Table
from ...internals.expression import ApplyExpression, ColumnReference
from ...internals import dtype as dt


class InterpolateMode(enum.Enum):
    LINEAR = 0


def interpolate(
    self: Table,
    timestamp: ColumnReference,
    *values: ColumnReference,
    mode: InterpolateMode = InterpolateMode.LINEAR,
) -> Table:
    """Linearly interpolate missing (None) values along the timestamp order."""
    ts = self._desugar(timestamp)
    sorted_ptrs = self.sort(key=ts)
    prev_rows = self.ix(sorted_ptrs.prev, optional=True)
    next_rows = self.ix(sorted_ptrs.next, optional=True)

    out = {}
    for v in values:
        ref = self._desugar(v)

        def interp(t, x, pt, px, nt, nx):
            if x is not None:
                return x
            if px is not None and nx is not None and pt is not None and nt is not None and nt != pt:
                w = (t - pt) / (nt - pt)
                return px + (nx - px) * w
            if px is not None:
                return px
            return nx

        out[ref.name] = ApplyExpression(
            interp, dt.optional(dt.FLOAT),
            (ts, ref, prev_rows[ts.name] if isinstance(ts, ColumnReference) else prev_rows[timestamp.name],
             prev_rows[ref.name],
             next_rows[ts.name] if isinstance(ts, ColumnReference) else next_rows[timestamp.name],
             next_rows[ref.name]),
            {}, propagate_none=False,
        )
    return self.with_columns(**out)
