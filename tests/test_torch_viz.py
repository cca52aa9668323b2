"""The port's ``pw.viz`` held to the JAX package's: ``live_show`` (the
HTTP-served widget re-rendered from the diff stream), ``plot`` (a
matplotlib chart rendered per commit) and the ``Table.show`` / ``plot`` /
``live_show`` hooks.  Each test runs one program in both packages (the
port's with ``device="cpu"``) and compares what they serve, hold and
print.  The reference's optional behaviours are kept and tested: unknown
``plot`` keywords are warned about and ignored, and the widget displays
itself only under IPython.
"""

from __future__ import annotations

import json
import sys
import threading
import time
import types
import urllib.request

import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu_torch.internals import parse_graph as tpg

from .test_torch_io_databases import PKGS, both, run


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as r:
        return r.read()


def test_the_viz_surface_is_the_jax_packages():
    from pathway_tpu.stdlib import viz as jviz

    assert tpw.viz.__all__ == jviz.__all__
    assert all(hasattr(tpw.viz, n) for n in jviz.__all__)
    assert tpw.Table.show is tpw.stdlib.utils.viz_show
    assert tpw.Table.plot is tpw.viz.plot
    assert tpw.Table.live_show is tpw.viz.live_show
    assert tpw.stdlib.utils.__all__ == jpw.stdlib.utils.__all__


def test_live_show_serves_the_streaming_state_as_the_jax_package():
    """Rows arrive one commit at a time; the page and the final ``data``
    payload equal the JAX package's."""

    def build(pw):
        class Subject(pw.io.python.ConnectorSubject):
            def run(self):
                for name, age in (("alice", 30), ("bob", 41)):
                    self.next(name=name, age=age)
                    time.sleep(0.1)

        class S(pw.Schema):
            name: str = pw.column_definition(primary_key=True)
            age: int

        t = pw.io.python.read(Subject(), schema=S)
        widget = pw.Table.live_show(t)
        seen: list = []

        def poll():
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                d = json.loads(_get(widget.url + "data"))
                if len(d["rows"]) == 2:
                    return
                seen.append(len(d["rows"]))
                time.sleep(0.05)

        th = threading.Thread(target=poll)
        th.start()
        return widget, th, seen

    out = {}
    for pkg in ("torch", "jax"):
        widget, th, seen = run(pkg, build, timeout_s=10.0, idle_stop_s=0.5,
                               autocommit_duration_ms=20)
        th.join(15)
        assert not th.is_alive()
        out[pkg] = (_get(widget.url), json.loads(_get(widget.url + "data")),
                    seen)
        widget.close()
    (page, data, seen), (jpage, jdata, _js) = out["torch"], out["jax"]
    assert page == jpage and b"live table" in page
    assert {k: v for k, v in data.items() if k != "time"} == {
        k: v for k, v in jdata.items() if k != "time"}
    assert data["columns"] == ["name", "age"]
    assert sorted(r[0] for r in data["rows"]) == ["alice", "bob"]
    assert data["numeric"]["age"] and data["updates"] >= 2


@pytest.mark.parametrize("case", ["deletions", "escapes_html"])
def test_live_show_payload_equals_the_jax_packages(case):
    """A deletion leaves the widget's state; untrusted strings reach the
    page HTML-escaped (no XSS through ``innerHTML``)."""

    def build(pw):
        if case == "deletions":
            t = pw.debug.table_from_markdown("""
            id | name | age | __time__ | __diff__
            1 | alice | 30 | 2 | 1
            1 | alice | 30 | 4 | -1
            2 | bob | 41 | 4 | 1
            """)
            return pw.Table.live_show(t, name="deltas")
        t = pw.debug.table_from_markdown("""
        payload
        <script>alert(1)</script>
        """)
        return pw.Table.live_show(t, sorting_enabled=True)

    raw = {}
    for pkg in ("torch", "jax"):
        widget = run(pkg, build)
        raw[pkg] = _get(widget.url + "data").decode()
        assert widget._repr_html_().startswith("<iframe")
        widget.close()
    assert raw["torch"] == raw["jax"]
    d = json.loads(raw["torch"])
    if case == "deletions":
        assert [r[0] for r in d["rows"]] == ["bob"] and d["name"] == "deltas"
    else:
        assert "<script>" not in raw["torch"]
        assert "&lt;script&gt;" in raw["torch"] and d["sortable"] is True


def test_viz_plot_renders_a_png_as_the_jax_package(tmp_path):
    """``tests/test_monitoring.py``'s case: a chart of 20 points rendered
    to a PNG per commit, from the same rows."""

    def build(pw):
        class S(pw.Schema):
            x: int
            y: float

        t = pw.debug.table_from_rows(S, [(i, i * 0.5) for i in range(20)])
        out = tmp_path / f"{pw.__name__}.png"
        return out, pw.viz.plot(t, x="x", y="y", output_file=str(out))

    (png, plotter), (jpng, jplotter) = both(build)
    assert png.stat().st_size > 1000 and jpng.stat().st_size > 1000
    rows = sorted((r["x"], r["y"]) for r in plotter.rows.values())
    assert rows == sorted((r["x"], r["y"]) for r in jplotter.rows.values())
    assert rows == [(i, i * 0.5) for i in range(20)]


def test_plot_warns_about_unknown_keywords_and_checks_columns(tmp_path):
    for pw, pg in PKGS.values():
        pg.G.clear()
        t = pw.debug.table_from_markdown("x | y\n1 | 2\n")
        with pytest.warns(UserWarning, match="ignoring unsupported"):
            pw.viz.plot(t, x="x", output_file=str(tmp_path / "p.png"),
                        bokeh_theme="dark")
        with pytest.raises(KeyError, match="not in table columns"):
            pw.viz.plot(t, x="nope")
        pg.G.clear()


def test_live_show_displays_itself_only_under_ipython(monkeypatch):
    shown: list = []
    ipython = types.ModuleType("IPython")
    display = types.ModuleType("IPython.display")
    display.display = shown.append
    monkeypatch.setitem(sys.modules, "IPython", ipython)
    monkeypatch.setitem(sys.modules, "IPython.display", display)
    tpg.G.clear()
    widget = tpw.Table.live_show(tpw.debug.table_from_markdown("a\n1\n"))
    tpg.G.clear()
    widget.close()
    assert shown == [widget]
    monkeypatch.setitem(sys.modules, "IPython.display", None)
    widget = tpw.Table.live_show(tpw.debug.table_from_markdown("a\n1\n"))
    tpg.G.clear()
    widget.close()
    assert shown == [shown[0]]


def test_table_show_prints_as_the_jax_package(capsys):
    out = {}
    for pkg, (pw, pg) in PKGS.items():
        pg.G.clear()
        t = pw.debug.table_from_markdown("name | age\nalice | 30\nbob | 41\n")
        kw = {"device": "cpu"} if pkg == "torch" else {}
        t.show(**kw)
        pg.G.clear()
        out[pkg] = capsys.readouterr().out
    assert out["torch"] == out["jax"] and "alice" in out["torch"]
