"""stdlib.utils: column helpers, the async transformer and the viz hooks
(the port of ``pathway_tpu/stdlib/utils``)."""

from __future__ import annotations

from ...internals.table import Table
from . import col
from .async_transformer import AsyncTransformer


def unpack_col(column, *unpacked_columns, schema=None) -> Table:
    return col.unpack_col(column, *unpacked_columns, schema=schema)


def viz_show(table: Table, *args, device="cuda", **kwargs):
    """Table.show — console fallback for the Bokeh/Panel live viz; the
    table is computed on ``device``."""
    from ...debug import compute_and_print

    compute_and_print(table, device=device)


def viz_plot(table: Table, plotting_function=None, sorting_col=None, *,
             device="cuda", **kwargs):
    try:
        import pandas as pd  # noqa: F401
        from ...debug import table_to_pandas

        df = table_to_pandas(table, device=device)
        if plotting_function is not None:
            return plotting_function(df)
        return df.plot()
    except Exception as exc:  # pragma: no cover
        raise RuntimeError(f"plotting unavailable: {exc}")


__all__ = ["col", "unpack_col", "AsyncTransformer", "viz_show", "viz_plot"]
