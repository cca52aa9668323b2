"""The port's SQLite connector held to the JAX package's
(``tests/test_sqlite.py``): a static read, a streaming read whose
updates and deletes flow through as retract + insert pairs, and a write
roundtrip give the same rows under the same keys and the same written
table in both packages.  Rows are drawn from a seed with numpy.
"""

import sqlite3
import threading
import time

import numpy as np

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals import parse_graph as jpg
from pathway_tpu_torch.internals import parse_graph as tpg

PKGS = {"jax": (jpw, jpg), "torch": (tpw, tpg)}


def _make_db(path, rows):
    con = sqlite3.connect(path)
    con.execute("CREATE TABLE IF NOT EXISTS items (k TEXT, v INTEGER)")
    con.execute("DELETE FROM items")
    con.executemany("INSERT INTO items VALUES (?, ?)", rows)
    con.commit()
    con.close()


def _schema(pw, pk=True):
    if pk:
        class ItemSchema(pw.Schema):
            k: str = pw.column_definition(primary_key=True)
            v: int
    else:
        class ItemSchema(pw.Schema):
            k: str
            v: int
    return ItemSchema


def _rows(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    return [(f"k{i}", int(v)) for i, v in enumerate(rng.integers(0, 999, n))]


def _static(pkg: str, db: str, pk: bool) -> dict:
    pw, pg = PKGS[pkg]
    pg.G.clear()
    try:
        t = pw.io.sqlite.read(db, "items", _schema(pw, pk), mode="static")
        kw = {"device": "cpu"} if pkg == "torch" else {}
        keys, cols = pw.debug.table_to_dicts(
            t.select(t.k, doubled=t.v * 2), **kw)
    finally:
        pg.G.clear()
    return {k: (cols["k"][k], cols["doubled"][k]) for k in keys}


def test_sqlite_static_read(tmp_path):
    db = str(tmp_path / "a.db")
    rows = _rows(0, 12) + [("k0", 5)]  # a duplicated primary key
    _make_db(db, rows)
    for pk in (True, False):
        got = _static("torch", db, pk)
        assert got == _static("jax", db, pk)
        assert len(got) == (12 if pk else 13)


def _streaming(pkg: str, db: str) -> list:
    pw, pg = PKGS[pkg]
    _make_db(db, [("x", 1), ("y", 2)])
    pg.G.clear()
    seen = []
    t = pw.io.sqlite.read(db, "items", _schema(pw), mode="streaming",
                          autocommit_duration_ms=30)
    pw.io.subscribe(t, on_change=lambda key, row, time, is_addition:
                    seen.append((key, row["k"], row["v"], is_addition)))

    def mutate():
        for sql in (["UPDATE items SET v = 5 WHERE k = 'x'",
                     "INSERT INTO items VALUES ('z', 9)"],
                    ["DELETE FROM items WHERE k = 'z'"]):
            time.sleep(0.3)
            con = sqlite3.connect(db)
            for stmt in sql:
                con.execute(stmt)
            con.commit()
            con.close()

    th = threading.Thread(target=mutate, daemon=True)
    th.start()
    kw = dict(timeout_s=8.0, idle_stop_s=1.5, autocommit_duration_ms=30,
              monitoring_level=pw.MonitoringLevel.NONE)
    if pkg == "torch":
        kw["device"] = "cpu"
    try:
        pw.run(**kw)
    finally:
        pg.G.clear()
    th.join()
    return seen


def test_sqlite_streaming_cdc(tmp_path):
    """Updates and deletes in the database flow through as Z-set deltas,
    the same in both packages."""
    got = _streaming("torch", str(tmp_path / "t.db"))
    want = _streaming("jax", str(tmp_path / "j.db"))
    assert sorted(got) == sorted(want)
    flat = {(k, v, add) for _key, k, v, add in got}
    assert ("x", 1, True) in flat
    assert ("x", 1, False) in flat and ("x", 5, True) in flat  # update
    assert ("z", 9, True) in flat and ("z", 9, False) in flat  # insert+delete


def test_sqlite_write_roundtrip(tmp_path):
    out = {}
    for pkg in ("torch", "jax"):
        pw, pg = PKGS[pkg]
        db_in = str(tmp_path / f"in-{pkg}.db")
        db_out = str(tmp_path / f"out-{pkg}.db")
        _make_db(db_in, _rows(1, 8))
        pg.G.clear()
        t = pw.io.sqlite.read(db_in, "items", _schema(pw), mode="static")
        pw.io.sqlite.write(t.select(t.k, big=t.v * 100), db_out, "results")
        kw = {"device": "cpu"} if pkg == "torch" else {}
        try:
            pw.run(monitoring_level=pw.MonitoringLevel.NONE, **kw)
        finally:
            pg.G.clear()
        con = sqlite3.connect(db_out)
        out[pkg] = sorted(con.execute(
            "SELECT k, big, __pw_time, __pw_diff FROM results").fetchall())
        con.close()
    assert out["torch"] == out["jax"]
    assert [(k, big, d) for k, big, _t, d in out["torch"]] == sorted(
        (k, v * 100, 1) for k, v in _rows(1, 8))
