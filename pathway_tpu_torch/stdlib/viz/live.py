"""Live streaming-widget viz (reference: stdlib/viz/table_viz.py show +
plotting.py plot over Bokeh/Panel).

The reference renders a Panel widget in notebooks that re-renders on every
commit.  The equivalent here is dependency-free: `live_show(table)`
starts a tiny HTTP server whose page polls the table state and re-renders
in the browser — a live-updating table plus per-numeric-column sparklines.
The widget survives row updates and deletions (state is keyed, diffs
applied), exactly like the reference's `stream_updates` callback wiring.

In a Jupyter kernel (IPython importable) the URL is additionally displayed
as an iframe, matching the reference's notebook-first UX.

The port of ``pathway_tpu/stdlib/viz/live.py``; the page it serves is the
JAX module's, byte for byte.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

from ...internals.table import Table

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>pathway_tpu live table</title>
<style>
 body { font-family: ui-monospace, monospace; margin: 1.2em; }
 h3 { margin: 0 0 .3em 0; }
 #meta { color: #666; font-size: .85em; margin-bottom: .8em; }
 table { border-collapse: collapse; }
 th, td { border: 1px solid #ccc; padding: .25em .6em; font-size: .9em; }
 th { background: #f2f2f2; }
 canvas { border: 1px solid #eee; margin: .2em .6em .2em 0; }
</style></head><body>
<h3 id="title"></h3><div id="meta"></div>
<div id="sparks"></div>
<table id="tbl"><thead></thead><tbody></tbody></table>
<script>
const hist = {};
async function tick() {
  try {
    const r = await fetch('data'); const d = await r.json();
    document.getElementById('title').textContent = d.name;
    document.getElementById('meta').textContent =
      d.rows.length + ' rows \\u00b7 commit ' + d.time +
      ' \\u00b7 ' + d.updates + ' updates';
    const thead = document.querySelector('#tbl thead');
    thead.innerHTML = '<tr>' +
      d.columns.map((c, i) => '<th data-i="' + i + '"' +
        (d.sortable ? ' style="cursor:pointer" title="click to sort"' : '') +
        '>' + c + '</th>').join('') + '</tr>';
    if (d.sortable) {
      thead.querySelectorAll('th').forEach(th => th.onclick = () => {
        window._sortCol = (window._sortCol === +th.dataset.i)
          ? null : +th.dataset.i;
      });
      if (window._sortCol != null) {
        const i = window._sortCol;
        d.rows.sort((a, b) => {
          const x = parseFloat(a[i]), y = parseFloat(b[i]);
          return (isNaN(x) || isNaN(y))
            ? String(a[i]).localeCompare(String(b[i])) : x - y;
        });
      }
    }
    const tbody = document.querySelector('#tbl tbody');
    tbody.innerHTML = d.rows.map(row => '<tr>' +
      row.map(v => '<td>' + v + '</td>').join('') + '</tr>').join('');
    const sparks = document.getElementById('sparks');
    for (const [col, series] of Object.entries(d.numeric)) {
      if (!hist[col]) {
        const c = document.createElement('canvas');
        c.width = 220; c.height = 48; c.title = col; c.id = 'sp_' + col;
        sparks.appendChild(c); hist[col] = [];
      }
      hist[col].push(series.length ?
        series.reduce((a, b) => a + b, 0) / series.length : 0);
      if (hist[col].length > 110) hist[col].shift();
      const c = document.getElementById('sp_' + col);
      const ctx = c.getContext('2d');
      ctx.clearRect(0, 0, c.width, c.height);
      const h = hist[col];
      const mn = Math.min(...h), mx = Math.max(...h), rg = (mx - mn) || 1;
      ctx.beginPath();
      h.forEach((v, i) => {
        const x = i * 2, y = 44 - 40 * (v - mn) / rg;
        i ? ctx.lineTo(x, y) : ctx.moveTo(x, y);
      });
      ctx.strokeStyle = '#2a6'; ctx.stroke();
      ctx.fillStyle = '#666'; ctx.font = '10px monospace';
      ctx.fillText(col + ': ' + h[h.length - 1].toFixed(3), 4, 10);
    }
  } catch (e) {}
  setTimeout(tick, 500);
}
tick();
</script></body></html>"""


class _LiveTableState:
    """Keyed snapshot of the table, maintained from the diff stream."""

    def __init__(self, name: str, colnames: list[str],
                 sortable: bool = False):
        self.name = name
        self.colnames = colnames
        self.sortable = sortable
        self.rows: dict[Any, tuple] = {}
        self.time = 0
        self.updates = 0
        self.lock = threading.Lock()

    def on_change(self, key, row, time, is_addition):
        with self.lock:
            self.updates += 1
            self.time = max(self.time, time)
            if is_addition:
                self.rows[key] = tuple(row.get(c) for c in self.colnames)
            else:
                self.rows.pop(key, None)

    def payload(self) -> bytes:
        with self.lock:
            rows = [
                [_fmt(v) for v in r]
                for _k, r in sorted(self.rows.items(), key=lambda kv: str(kv[0]))
            ]
            numeric: dict[str, list] = {}
            for i, c in enumerate(self.colnames):
                vals = [
                    r[i] for r in self.rows.values()
                    if isinstance(r[i], (int, float))
                    and not isinstance(r[i], bool)
                ]
                if vals:
                    numeric[c] = vals[:512]
            return json.dumps({
                "name": _fmt(self.name),
                "columns": [_fmt(c) for c in self.colnames], "rows": rows,
                "numeric": numeric, "time": self.time,
                "updates": self.updates, "sortable": self.sortable,
            }).encode()


def _fmt(v) -> str:
    """Render + HTML-escape one cell: values are injected into innerHTML
    client-side, so untrusted strings flowing through the pipeline must
    never reach the page unescaped (XSS)."""
    if isinstance(v, float):
        return f"{v:.6g}"
    s = str(v)
    if len(s) > 120:
        s = s[:117] + "..."
    return (s.replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;").replace('"', "&quot;"))


class _Handler(BaseHTTPRequestHandler):
    state: _LiveTableState  # set per-server subclass

    def do_GET(self):  # noqa: N802
        if self.path.rstrip("/") in ("", "/index.html", "/live"):
            body, ctype = _PAGE.encode(), "text/html; charset=utf-8"
        elif self.path.lstrip("/") == "data":
            body, ctype = self.state.payload(), "application/json"
        else:
            self.send_response(404)
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # quiet
        pass


def live_show(table: Table, *, name: str | None = None, host: str = "127.0.0.1",
              port: int = 0, sorting_enabled: bool = False):
    """Serve a live-updating widget of `table`; returns the server handle
    (`.url`, `.state`, `.close()`).  Call before pw.run().
    `sorting_enabled` adds click-to-sort column headers (reference show()
    parity)."""
    from ...io._subscribe import subscribe

    colnames = table.column_names()
    state = _LiveTableState(name or "live table", colnames,
                            sortable=sorting_enabled)
    handler = type("BoundHandler", (_Handler,), {"state": state})
    server = ThreadingHTTPServer((host, port), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    subscribe(table, on_change=lambda key, row, time, is_addition:
              state.on_change(key, row, time, is_addition))

    class _Widget:
        url = f"http://{host}:{server.server_address[1]}/"

        def __init__(self):
            self.state = state

        def close(self):
            server.shutdown()

        def _repr_html_(self):  # notebook display (reference parity)
            return (f'<iframe src="{self.url}" width="100%" height="420" '
                    f'style="border:1px solid #ccc"></iframe>')

    widget = _Widget()
    try:  # display inline when running under IPython
        from IPython.display import display  # type: ignore

        display(widget)
    except Exception:
        pass
    return widget
