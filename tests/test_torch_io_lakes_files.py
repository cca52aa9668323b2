"""The port's lake and file connectors held to the JAX package's: Delta
Lake and Iceberg (their table formats, natively, over parquet), DuckDB
(over an injected ``sqlite3`` connection, which shares its dialect) and
PyFilesystem (over ``tests/torch_doc_fakes.MemFS``).  Each test runs one
program through the JAX connector and through the port's
(``device="cpu"``) on fresh copies of the same inputs: the tables, logs
and statements written are equal (the parquet parts decode to the same
rows; their bytes differ by the uuids in their names), and so are the
rows a source reads, keys included.  Each package's Iceberg write and
read run in an interpreter of their own, as the parquet roundtrip of
``tests/test_torch_core_compat.py`` does (pyarrow has crashed pytest
workers under load, never alone).  The tests of the port's decisions on
the JAX package's quiet fallbacks come last.

``pyarrow.parquet`` is imported with this module, before any test runs:
imported for the first time after both packages have run a program in
the process, its first read of a part crashes the interpreter.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import sqlite3

import pyarrow.parquet as pq
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals import parse_graph as jpg
from pathway_tpu_torch.internals import parse_graph as tpg

from . import torch_doc_fakes as fakes
from .test_torch_io_databases import PKGS, both, run

LIVE = dict(idle_stop_s=0.5, timeout_s=20.0, autocommit_duration_ms=20)

TWO_ROWS = """
name | age
alice | 30
bob | 41
"""


def pk_schema(pw):
    class S(pw.Schema):
        name: str = pw.column_definition(primary_key=True)
        age: int

    return S


def modules(name: str) -> dict:
    import importlib

    return {pkg: importlib.import_module(f"{root}.io.{name}")
            for pkg, root in (("torch", "pathway_tpu_torch"),
                              ("jax", "pathway_tpu"))}


# -- Delta Lake -----------------------------------------------------------------


def _delta_rows(lake: str) -> list:
    """The rows of every ``add``'s parquet part, with each version's
    action kinds."""
    kinds, rows = [], []
    for p in sorted(glob.glob(os.path.join(lake, "_delta_log", "*.json"))):
        acts = [json.loads(x) for x in open(p)]
        kinds.append([next(iter(a)) for a in acts])
        for a in acts:
            if "add" in a:
                rows += pq.read_table(os.path.join(
                    lake, a["add"]["path"])).to_pylist()
    return [kinds, sorted((r["name"], r["age"], r["diff"]) for r in rows)]


def test_delta_write_log_structure_equals_the_jax_packages(tmp_path):
    def build(pw):
        lake = str(tmp_path / pw.__name__)
        pw.io.deltalake.write(pw.debug.table_from_markdown(TWO_ROWS), lake)
        return lake

    got, want = both(build)
    assert _delta_rows(got) == _delta_rows(want)
    assert _delta_rows(got)[1] == [("alice", 30, 1), ("bob", 41, 1)]
    first = [[json.loads(x) for x in open(os.path.join(
        lake, "_delta_log", f"{0:020d}.json"))] for lake in (got, want)]
    assert first[0][0] == first[1][0] == {
        "protocol": {"minReaderVersion": 1, "minWriterVersion": 2}}
    schema = json.loads(first[0][1]["metaData"]["schemaString"])
    assert schema == json.loads(first[1][1]["metaData"]["schemaString"])
    assert {f["name"]: f["type"] for f in schema["fields"]} == {
        "name": "string", "age": "long", "time": "long", "diff": "long"}


def test_delta_static_read_equals_the_jax_packages(tmp_path):
    """Each package reads the lake the JAX package wrote, and its own."""
    lakes = {}
    for pkg in ("torch", "jax"):
        lakes[pkg] = str(tmp_path / pkg)
        run(pkg, lambda pw: pw.io.deltalake.write(
            pw.debug.table_from_markdown(TWO_ROWS), lakes[pkg]))
    reads = {}
    for pkg, (pw, pg) in PKGS.items():
        for lake in ("jax", pkg):
            pg.G.clear()
            back = pw.io.deltalake.read(lakes[lake], pk_schema(pw),
                                        mode="static")
            kw = {"device": "cpu"} if pkg == "torch" else {}
            keys, cols = pw.debug.table_to_dicts(back, **kw)
            pg.G.clear()
            reads[(pkg, lake)] = {k: (cols["name"][k], cols["age"][k])
                                  for k in keys}
    assert reads[("torch", "jax")] == reads[("jax", "jax")]
    assert reads[("torch", "torch")] == reads[("jax", "jax")]
    assert sorted(reads[("jax", "jax")].values()) == [("alice", 30),
                                                      ("bob", 41)]


def test_delta_streaming_tail_and_remove_equal_the_jax_packages(tmp_path):
    """The reader follows new commits; a ``remove`` action retracts the
    file's rows."""
    mods = modules("deltalake")

    def build(pw):
        from pathway_tpu.internals import dtype as jdt
        from pathway_tpu_torch.internals import dtype as tdt

        mod = mods["torch" if pw is tpw else "jax"]
        dt = tdt if pw is tpw else jdt
        lake = str(tmp_path / pw.__name__)
        w = mod.DeltaWriter(lake, ["name", "age"],
                            {"name": dt.STR, "age": dt.INT})
        w.write_batch(2, ["name", "age"], [(None, ("alice", 30), 1)])
        seen: list = []
        t = pw.io.deltalake.read(lake, pk_schema(pw), mode="streaming",
                                 poll_interval_s=0.02)

        def mutate():
            w.write_batch(4, ["name", "age"], [(None, ("bob", 41), 1)])
            first = json.loads(open(mod._log_path(lake, 1)).readline())
            w._append_commit([{"remove": {"path": first["add"]["path"],
                                          "dataChange": True}}])

        def on_change(key, row, time, is_addition):
            seen.append((key, row["name"], row["age"], is_addition))
            if len(seen) == 1:
                mutate()

        pw.io.subscribe(t, on_change=on_change)
        return seen

    got, want = both(build, **LIVE)
    assert sorted(got) == sorted(want)
    assert sorted((n, a, add) for _k, n, a, add in got) == [
        ("alice", 30, False), ("alice", 30, True), ("bob", 41, True)]


def _writer(mod, dt, lake):
    return mod.DeltaWriter(lake, ["name", "age"],
                           {"name": dt.STR, "age": dt.INT})


def _dtypes():
    from pathway_tpu.internals import dtype as jdt
    from pathway_tpu_torch.internals import dtype as tdt

    return {"torch": tdt, "jax": jdt}


def test_delta_resume_offsets_equal_the_jax_packages(tmp_path):
    """After a resume only the new commit's rows appear."""
    mods, dts = modules("deltalake"), _dtypes()
    out = {}
    for pkg, (pw, _pg) in PKGS.items():
        lake = str(tmp_path / pkg)
        w = _writer(mods[pkg], dts[pkg], lake)
        w.write_batch(2, ["name", "age"], [(None, ("alice", 30), 1)])
        src = mods[pkg].DeltaSource(lake, pk_schema(pw), "streaming",
                                    poll_interval_s=0.0)
        first = src.poll()
        offs = src.get_offsets()
        w.write_batch(4, ["name", "age"], [(None, ("bob", 41), 1)])
        src2 = mods[pkg].DeltaSource(lake, pk_schema(pw), "streaming",
                                     poll_interval_s=0.0)
        src2.seek(offs)
        out[pkg] = (offs, first, src2.poll())
    assert out["torch"] == out["jax"]
    offs, first, second = out["torch"]
    assert len(first) == 1 and [e[2][0] for e in second] == ["bob"]


# -- Iceberg, each package in an interpreter of its own -------------------------

ICEBERG = r"""
import json, os, sys, threading
pkg, root = sys.argv[1], sys.argv[2]
import pyarrow.parquet as pq
if pkg == "torch":
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals import dtype as dt, parse_graph as pg
    from pathway_tpu_torch.io.iceberg import IcebergSource, IcebergWriter
    kw = {"device": "cpu"}
else:
    import pathway_tpu as pw
    from pathway_tpu.internals import dtype as dt, parse_graph as pg
    from pathway_tpu.io.iceberg import IcebergSource, IcebergWriter
    kw = {}
pw.set_license_key("demo-license-key-no-telemetry")
run = dict(kw, monitoring_level=pw.MonitoringLevel.NONE)

class S(pw.Schema):
    name: str
    age: int

out = {}
lake = os.path.join(root, "warehouse", "db", "tbl")
pw.io.iceberg.write(pw.debug.table_from_markdown(
    "name | age\nalice | 30\nbob | 41\n"), lake)
pw.run(**run)
meta = json.load(open(os.path.join(lake, "metadata", "v1.metadata.json")))
out["layout"] = [
    os.path.exists(os.path.join(lake, "metadata", "version-hint.text")),
    meta["format-version"],
    meta["current-snapshot-id"] == meta["snapshots"][-1]["snapshot-id"],
    meta["schema"]]
files = sorted(glob for glob in os.listdir(os.path.join(lake, "data")))
out["parquet"] = sorted(tuple(sorted(r.items())) for f in files
                        for r in pq.read_table(
                            os.path.join(lake, "data", f)).to_pylist())
pg.G.clear()
keys, cols = pw.debug.table_to_dicts(
    pw.io.iceberg.read(lake, schema=S, mode="static"), **kw)
out["static"] = sorted((int(k), cols["name"][k], cols["age"][k])
                       for k in keys)

pg.G.clear()
seen = []
t = pw.io.iceberg.read(lake, schema=S, poll_interval_s=0.02)

def on_change(key, row, time, is_addition):
    seen.append((int(key), row["name"], row["age"], is_addition))
    if len(seen) == 1:
        IcebergWriter(lake, ["name", "age"], {"name": dt.STR, "age": dt.INT}
                      ).write_batch(4, ["name", "age"],
                                    [(None, ("carol", 22), 1)])

pw.io.subscribe(t, on_change=on_change)
pw.run(idle_stop_s=0.5, timeout_s=20.0, autocommit_duration_ms=20, **run)
out["tail"] = sorted(seen)

t2 = os.path.join(root, "t")
w = IcebergWriter(t2, ["name", "age"], {"name": dt.STR, "age": dt.INT})
w.write_batch(2, ["name", "age"], [(None, ("alice", 30), 1)])
src = IcebergSource(t2, S, "streaming", poll_interval_s=0.0)
first = src.poll()
offs = src.get_offsets()
w.write_batch(4, ["name", "age"], [(None, ("bob", 41), 1)])
src2 = IcebergSource(t2, S, "streaming", poll_interval_s=0.0)
src2.seek(offs)
out["resume"] = [[(int(k), list(r), d) for _t, k, r, d in evs]
                 for evs in (first, src2.poll())]

if pkg == "torch":
    # a poll that fails (metadata that does not parse) is counted and
    # retried: the next poll reads the snapshot
    src3 = IcebergSource(lake, S, "streaming", poll_interval_s=0.0)
    mpath = os.path.join(lake, "metadata", "v2.metadata.json")
    good = open(mpath).read()
    open(mpath, "w").write("{not json")
    out["failed_poll"] = [src3.poll(), src3.n_failed_polls]
    open(mpath, "w").write(good)
    out["retried"] = sorted(r[2][0] for r in src3.poll())
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def iceberg_runs(tmp_path_factory):
    import signal
    import subprocess
    import sys
    from pathlib import Path

    root = str(Path(tpw.__file__).resolve().parent.parent)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [root, os.environ.get("PYTHONPATH", "")]))
    got = {}
    for pkg in ("torch", "jax"):
        proc = subprocess.run(
            [sys.executable, "-X", "faulthandler", "-c", ICEBERG, pkg,
             str(tmp_path_factory.mktemp(f"iceberg_{pkg}"))],
            capture_output=True, text=True, env=env, timeout=300)
        how = (f"killed by {signal.Signals(-proc.returncode).name}"
               if proc.returncode < 0 else f"exit {proc.returncode}")
        assert proc.returncode == 0, f"{pkg}: {how}\n{proc.stderr[-4000:]}"
        got[pkg] = json.loads(proc.stdout.strip().splitlines()[-1])
    return got


def test_iceberg_write_read_roundtrip_and_tail_equal_the_jax_packages(
        iceberg_runs):
    got, want = iceberg_runs["torch"], iceberg_runs["jax"]
    for part in ("layout", "parquet", "static", "tail"):
        assert got[part] == want[part], part
    assert got["layout"][:3] == [True, 1, True]
    assert sorted((n, a) for _k, n, a in got["static"]) == [
        ("alice", 30), ("bob", 41)]
    assert {(n, a, add) for _k, n, a, add in got["tail"]} == {
        ("alice", 30, True), ("bob", 41, True), ("carol", 22, True)}


def test_iceberg_resume_offsets_equal_the_jax_packages(iceberg_runs):
    got = iceberg_runs["torch"]["resume"]
    assert got == iceberg_runs["jax"]["resume"]
    assert len(got[0]) == 1 and [r[1][0] for r in got[1]] == ["bob"]


def test_iceberg_a_failed_poll_is_counted_and_retried(iceberg_runs):
    """The reference's log-once-and-retry, counted in ``n_failed_polls``."""
    got = iceberg_runs["torch"]
    assert got["failed_poll"] == [[], 1]
    assert got["retried"] == ["alice", "bob", "carol"]


# -- DuckDB ---------------------------------------------------------------------


def _sqlite():
    return sqlite3.connect(":memory:", check_same_thread=False)


class Traced:
    """A ``sqlite3`` connection whose statements are recorded."""

    def __init__(self):
        self.con = _sqlite()
        self.statements: list = []
        self.con.set_trace_callback(self.statements.append)

    def __getattr__(self, name):
        return getattr(self.con, name)


STREAM_ROWS = [("a", 1, 0, 1), ("b", 2, 0, 1), ("a", 1, 2, -1),
               ("a", 5, 2, 1), ("b", 2, 4, -1)]


@pytest.mark.parametrize("mode", ["stream_of_changes", "snapshot"])
def test_duckdb_writes_equal_the_jax_packages(mode):
    def build(pw):
        conn = Traced()

        class KV(pw.Schema):
            k: str = pw.column_definition(primary_key=True)
            v: int

        t = pw.debug.table_from_rows(KV, STREAM_ROWS, is_stream=True)
        kw = (dict(output_table_type="snapshot", primary_key=[t.k])
              if mode == "snapshot" else {})
        pw.io.duckdb.write(t, table_name="out", database=":memory:",
                           init_mode="create_if_not_exists",
                           max_batch_size=1, _connection=conn, **kw)
        return conn

    got, want = both(build)
    assert got.statements == want.statements
    cols = "k, v" if mode == "snapshot" else "k, v, diff"
    # an int column is created VARCHAR by both packages' writers
    rows = [[(k, int(v), *d) for k, v, *d in c.execute(
        f"SELECT {cols} FROM out ORDER BY k, v").fetchall()]
        for c in (got, want)]
    assert rows[0] == rows[1]
    if mode == "snapshot":
        assert rows[0] == [("a", 5)]
    else:
        assert sorted(rows[0]) == [("a", 1, -1), ("a", 1, 1), ("a", 5, 1),
                                   ("b", 2, -1), ("b", 2, 1)]


@pytest.mark.parametrize("kw,match", [
    (dict(output_table_type="snapshot"), "requires\\s+primary_key"),
    (dict(primary_key=["name"]), "only valid"),
    (dict(output_table_type="bogus"), "unknown output_table_type"),
])
def test_duckdb_validation_equals_the_jax_packages(kw, match):
    for pkg, (pw, pg) in PKGS.items():
        pg.G.clear()
        t = pw.debug.table_from_markdown(TWO_ROWS)
        kw2 = dict(kw)
        if kw2.get("primary_key"):
            kw2["primary_key"] = [t.name]
        with pytest.raises(ValueError, match=match):
            pw.io.duckdb.write(t, table_name="x", database=":memory:",
                               _connection=_sqlite(), **kw2)
        pg.G.clear()


class _Closing:
    """A connection whose ``close`` fails."""

    def __init__(self):
        self.con = _sqlite()
        self.closes = 0

    def __getattr__(self, name):
        return getattr(self.con, name)

    def close(self):
        self.closes += 1
        raise OSError("close failed")


@pytest.mark.parametrize("detach", [False, True])
def test_duckdb_a_failed_close_fails_the_run(monkeypatch, detach):
    """The JAX writer swallows a failed ``close`` of a connection it
    opened; the port's raises.  Injected connections stay open in both."""
    mods = modules("duckdb")
    conns = {}
    for pkg in ("torch", "jax"):
        conns[pkg] = _Closing()
        monkeypatch.setattr(
            mods[pkg], "_connect",
            lambda database, injected=None, c=conns[pkg]: injected or c)

    def build(pw):
        pw.io.duckdb.write(pw.debug.table_from_markdown(TWO_ROWS),
                           table_name="t", database="x.db",
                           init_mode="create_if_not_exists",
                           detach_between_batches=detach)

    run("jax", build)
    assert conns["jax"].closes >= 1
    with pytest.raises(Exception, match="close failed"):
        run("torch", build)
    injected = Traced()
    run("torch", lambda pw: pw.io.duckdb.write(
        pw.debug.table_from_markdown(TWO_ROWS), table_name="t",
        database="x.db", init_mode="create_if_not_exists",
        detach_between_batches=detach, _connection=injected))
    assert injected.execute("SELECT count(*) FROM t").fetchone() == (2,)


# -- PyFilesystem ---------------------------------------------------------------


def _meta(m: dict) -> dict:
    """A metadata row less ``seen_at``, the wall clock of the scan."""
    return {k: v for k, v in m.items() if k != "seen_at"}


@pytest.mark.parametrize("fmt", ["binary", "only_metadata"])
def test_pyfilesystem_static_read_equals_the_jax_packages(fmt):
    def build(pw):
        fs = fakes.MemFS()
        fs.put("/docs/a.txt", b"alpha")
        fs.put("/docs/sub/b.txt", b"beta")
        fs.put("/x.dat", b"12345")
        t = pw.io.pyfilesystem.read(fs, path="", mode="static", format=fmt,
                                    with_metadata=True)
        seen: list = []

        def on_change(key, row, time, is_addition):
            data = bytes(row["data"]) if fmt == "binary" else None
            seen.append((key, data, _meta(row["_metadata"].value),
                         is_addition))

        pw.io.subscribe(t, on_change=on_change)
        return fs, t.column_names(), seen

    (fst, tcols, got), (fsj, jcols, want) = both(build)
    assert sorted(got, key=repr) == sorted(want, key=repr)
    assert tcols == jcols
    assert fst.reads == fsj.reads
    if fmt == "binary":
        assert sorted((d, m["name"]) for _k, d, m, _a in got) == [
            (b"12345", "x.dat"), (b"alpha", "a.txt"), (b"beta", "b.txt")]
    else:
        assert "data" not in tcols and not fst.reads
        assert {m["name"]: (m["size"], m["owner"]) for _k, _d, m, _a in got
                }["x.dat"] == (5, "tester")


def test_pyfilesystem_streaming_equals_the_jax_packages():
    """A modification retracts and re-adds, an addition adds, a deletion
    retracts."""

    def build(pw):
        fs = fakes.MemFS()
        fs.put("/a.bin", b"v1")
        fs.put("/c.bin", b"same")
        t = pw.io.pyfilesystem.read(fs, refresh_interval=0.02)
        seen: list = []

        def mutate():
            fs.put("/a.bin", b"v2")
            fs.put("/b.bin", b"new")
            fs.remove("/c.bin")

        def on_change(key, row, time, is_addition):
            seen.append((key, bytes(row["data"]), is_addition))
            if len(seen) == 1:
                mutate()

        pw.io.subscribe(t, on_change=on_change)
        return fs, seen

    (fst, got), (fsj, want) = both(build, **LIVE)
    assert sorted(got) == sorted(want)
    assert fst.reads == fsj.reads
    assert sorted((d, a) for _k, d, a in got) == [
        (b"new", True), (b"same", False), (b"same", True), (b"v1", False),
        (b"v1", True), (b"v2", True)]


@pytest.mark.parametrize("fault", ["unreachable", "vanished"])
def test_pyfilesystem_a_failed_scan_loses_nothing_and_is_counted(caplog,
                                                                 fault):
    """A transient error mid-scan does not swallow an already-diffed
    modification (the reference's policy, kept); the port counts the
    failed scan in ``n_failed_polls``.  A file removed between a scan's
    listing and its stat fails that scan too, as in the reference (kept:
    a scan is all or nothing), and the next scan retracts it."""
    mods = modules("pyfilesystem")
    events = {}
    for pkg, mod in mods.items():
        fs = fakes.MemFS()
        fs.put("/a.bin", b"v1")
        fs.put("/b.bin", b"x")
        src = mod.PyFilesystemSource(fs, "", format="binary",
                                     with_metadata=False,
                                     refresh_interval_s=0.0, mode="streaming")
        assert len(src.poll()) == 2
        fs.put("/a.bin", b"v2")
        if fault == "unreachable":
            fs.fail_info.add("/b.bin")
        else:
            listdir = fs.listdir

            def listdir_then_remove(p, listdir=listdir, fs=fs):
                out = listdir(p)
                fs.listdir = listdir
                fs.remove("/b.bin")
                return out

            fs.listdir = listdir_then_remove
        with caplog.at_level(logging.WARNING):
            assert src.poll() == []
        fs.fail_info.clear()
        events[pkg] = src.poll()
        if pkg == "torch":
            assert src.n_failed_polls == 1
    assert events["torch"] == events["jax"]
    assert sorted((bytes(r[0]), d) for _t, _k, r, d in events["torch"]) == [
        (b"v1", -1), (b"v2", 1)] + ([(b"x", -1)] if fault == "vanished"
                                    else [])
    assert "scan failed" in caplog.text


def test_delta_a_vacuumed_part_is_counted_and_not_retracted(tmp_path,
                                                            caplog):
    """A part loaded before a resume and vacuumed since cannot be
    retracted: the JAX source warns; the port's warns and counts it in
    ``n_unretracted_parts``."""
    mods, dts = modules("deltalake"), _dtypes()
    polled = {}
    for pkg, (pw, _pg) in PKGS.items():
        lake = str(tmp_path / pkg)
        w = _writer(mods[pkg], dts[pkg], lake)
        w.write_batch(2, ["name", "age"], [(None, ("alice", 30), 1)])
        src = mods[pkg].DeltaSource(lake, pk_schema(pw), "streaming",
                                    poll_interval_s=0.0)
        src.poll()
        offs = src.get_offsets()
        part = json.loads(open(mods[pkg]._log_path(lake, 1)).readline())[
            "add"]["path"]
        os.remove(os.path.join(lake, part))   # vacuumed
        w._append_commit([{"remove": {"path": part, "dataChange": True}}])
        resumed = mods[pkg].DeltaSource(lake, pk_schema(pw), "streaming",
                                        poll_interval_s=0.0)
        resumed.seek(offs)
        with caplog.at_level(logging.WARNING):
            polled[pkg] = (resumed.poll(), resumed)
    assert polled["torch"][0] == polled["jax"][0] == []
    assert polled["torch"][1].n_unretracted_parts == 1
    assert caplog.text.count("already vacuumed") == 2


@pytest.mark.parametrize("call", ["deltalake.write", "deltalake.read",
                                  "iceberg.write", "iceberg.read",
                                  "duckdb.write"])
def test_the_lakes_are_gated_on_the_license(call, monkeypatch, tmp_path):
    from pathway_tpu.internals.config import pathway_config as jconf
    from pathway_tpu.internals.licensing import MissingLicenseError as JMiss
    from pathway_tpu_torch.internals.config import pathway_config as tconf
    from pathway_tpu_torch.internals.licensing import (
        MissingLicenseError as TMiss)

    mod, fn = call.split(".")
    for pw, conf, err in ((tpw, tconf, TMiss), (jpw, jconf, JMiss)):
        monkeypatch.setattr(conf, "license_key", None)
        f = getattr(getattr(pw.io, mod), fn)
        with pytest.raises(err):
            if fn == "read":
                f(str(tmp_path), schema=pk_schema(pw))
            elif mod == "duckdb":
                f(None, table_name="t", database=":memory:")
            else:
                f(None, str(tmp_path))
