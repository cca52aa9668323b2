"""Interactive mode: LiveTable (the port of ``pathway_tpu``'s; reference:
internals/interactive.py).

`pw.enable_interactive_mode()` then `t.live()` gives a view that recomputes
on access — notebook-friendly (`_repr_html_`) with a console fallback.  A
view runs its table on the data plane's ``device`` (default ``"cuda"``:
pass ``device="cpu"`` without a card).
"""

from __future__ import annotations

from typing import Any

from .table import Table

_interactive = False


def enable_interactive_mode() -> None:
    global _interactive
    _interactive = True
    Table.live = live  # type: ignore[attr-defined]


def is_interactive() -> bool:
    return _interactive


class LiveTable:
    def __init__(self, table: Table, device: Any = "cuda"):
        self._table = table
        self._device = device

    def snapshot(self):
        from ..engine.runner import run_tables

        [cap] = run_tables(self._table, device=self._device)
        return cap

    def to_pandas(self):
        from ..debug import table_to_pandas

        return table_to_pandas(self._table, device=self._device)

    def _repr_html_(self) -> str:
        try:
            return self.to_pandas().to_html()
        except Exception as exc:
            return f"<pre>LiveTable unavailable: {exc}</pre>"

    def __repr__(self) -> str:
        cap = self.snapshot()
        state = cap.squash()
        lines = [" | ".join(cap.column_names)]
        for _k, row in sorted(state.items()):
            lines.append(" | ".join(str(v) for v in row))
        return "\n".join(lines)


def live(self: Table, device: Any = "cuda") -> LiveTable:
    return LiveTable(self, device=device)
