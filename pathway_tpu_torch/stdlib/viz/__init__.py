"""Visualization (reference: stdlib/viz — Bokeh/Panel live plots,
Table.show/plot).

Three tiers, all dependency-free beyond what this image ships:
- `live_show(table)` — the streaming-widget model (reference Panel
  parity): an HTTP-served page that re-renders the keyed table state and
  per-column sparklines on every commit; displays as an iframe under
  IPython (`live.py`).
- `plot()` — matplotlib live plots: batch draws once, streaming
  re-renders per commit to a file (headless/CI) or a pyplot window.
- `show()` — console table print (batch debugging).

The port of ``pathway_tpu/stdlib/viz``: matplotlib and pandas are imported
only when a plot renders.
"""

from __future__ import annotations

from typing import Any, Callable

from ...internals.table import Table
from ..utils import viz_show as show
from .live import live_show


class LivePlotter:
    """Subscriber-driven matplotlib renderer: one redraw per commit."""

    def __init__(self, table: Table, x: str | None, y: str | list[str] | None,
                 kind: str, output_file: str | None,
                 plotting_function: Callable | None):
        self.colnames = table.column_names()
        self.x = x
        self.y = [y] if isinstance(y, str) else y
        for c in [x, *(self.y or [])]:
            if c is not None and c not in self.colnames:
                raise KeyError(
                    f"plot column {c!r} not in table columns {self.colnames}"
                )
        self.kind = kind
        self.output_file = output_file
        self.plotting_function = plotting_function
        self.rows: dict[Any, dict] = {}
        self._fig = None

    def on_change(self, key, row, time, is_addition):
        if is_addition:
            self.rows[key] = row
        else:
            self.rows.pop(key, None)

    def on_time_end(self, time):
        self._rendered = True
        self.render()

    def on_end(self):
        # only useful when no commit ever fired (empty static run)
        if not getattr(self, "_rendered", False):
            self.render()

    def render(self):
        import pandas as pd

        df = pd.DataFrame(list(self.rows.values()), columns=self.colnames)
        if self._fig is None:
            if self.output_file:
                # Agg path: plain Figure avoids pyplot's global figure
                # registry (no leak across repeated plot() calls)
                from matplotlib.backends.backend_agg import FigureCanvasAgg
                from matplotlib.figure import Figure

                self._fig = Figure()
                FigureCanvasAgg(self._fig)
            else:  # pragma: no cover - interactive
                import matplotlib.pyplot as plt

                self._fig = plt.figure()
        self._fig.clf()
        ax = self._fig.add_subplot(111)
        if self.plotting_function is not None:
            try:
                self.plotting_function(ax, df)
            except TypeError:
                # legacy Table.plot contract: plotting_function(df)
                self.plotting_function(df)
        elif not df.empty:
            ys = self.y or [
                c for c in self.colnames
                if c != self.x and df[c].dtype.kind in "if"
            ]
            if self.x is not None:
                df = df.sort_values(self.x)
            for c in ys:
                if self.kind == "scatter" and self.x is not None:
                    ax.scatter(df[self.x], df[c], label=c, s=8)
                elif self.x is not None:
                    ax.plot(df[self.x], df[c], label=c)
                else:
                    ax.plot(df[c].to_numpy(), label=c)
            if ys:
                ax.legend(loc="best", fontsize=8)
        ax.set_title(f"{len(df)} rows")
        if self.output_file:
            self._fig.savefig(self.output_file, dpi=96)
        else:  # pragma: no cover - interactive
            import matplotlib.pyplot as plt

            self._fig.canvas.draw_idle()
            plt.pause(0.001)


def plot(
    table: Table,
    plotting_function: Callable | None = None,
    *,
    x: str | None = None,
    y: str | list[str] | None = None,
    kind: str = "line",
    output_file: str | None = None,
    **kwargs,
):
    """Live plot of a table (reference: Table.plot over Bokeh).

    Streaming: registers a subscriber that re-renders every commit; call
    before pw.run().  Returns the LivePlotter (its .render() can be
    invoked manually; runs render once per commit and at end)."""
    if kwargs:
        import warnings

        warnings.warn(
            f"pw viz.plot: ignoring unsupported keyword(s) {sorted(kwargs)}",
            stacklevel=2,
        )
    from ...io._subscribe import subscribe

    plotter = LivePlotter(table, x, y, kind, output_file, plotting_function)
    subscribe(
        table,
        on_change=plotter.on_change,
        on_time_end=plotter.on_time_end,
        on_end=plotter.on_end,
    )
    return plotter


__all__ = ["show", "plot", "LivePlotter", "live_show"]
