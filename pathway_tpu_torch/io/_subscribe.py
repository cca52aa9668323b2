"""pw.io.subscribe (reference: io/_subscribe.py:17)."""

from __future__ import annotations

from typing import Any, Callable

from ..internals import parse_graph as pg
from ..internals.table import Table


def subscribe(
    table: Table,
    on_change: Callable[..., Any] | None = None,
    on_end: Callable[[], Any] | None = None,
    on_time_end: Callable[[int], Any] | None = None,
    *,
    skip_persisted_batch: bool = True,
    name: str | None = None,
):
    return pg.new_output_node(
        "subscribe",
        [table],
        colnames=table.column_names(),
        on_change=on_change,
        on_end=on_end,
        on_time_end=on_time_end,
    )
