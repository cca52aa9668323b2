"""``pw.io.csv`` and ``pw.io.jsonlines`` of the port against the JAX
package's: static reads, streaming reads in ``pw.run``, both writers and
``io.fs.read(format="csv"|"json")``, and the README quickstart.

Static reads give the JAX package's captures key for key, with a primary
key (a row's key hashes its coerced key values) and without one (a row's
key is the native ``hash_rows`` of its file, index and content, in both
packages).  The writers' files are compared line for line, as
multisets.  The streaming cases wait on events their subscribers set,
with bounded waits, and end by their idle window.
"""

import collections
import json
import threading

import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.engine import runner as jrunner
from pathway_tpu.internals import parse_graph as jpg
from pathway_tpu_torch.engine import runner as trunner
from pathway_tpu_torch.internals import parse_graph as tpg

from .torch_parity import fresh_port  # noqa: F401

PKGS = {"jax": (jpw, jrunner, jpg), "torch": (tpw, trunner, tpg)}


@pytest.fixture(autouse=True)
def _fresh(fresh_port):  # noqa: F811
    yield


def _schema(pw, pk: bool):
    if pk:
        class S(pw.Schema):
            k: int = pw.column_definition(primary_key=True)
            word: str
            x: float
    else:
        class S(pw.Schema):
            k: int
            word: str
            x: float
    return S


ROWS = [(1, "alpha", 0.5), (2, "beta", -1.25), (3, "gamma, quoted", 2.0),
        (4, "alpha", 3.5)]


@pytest.fixture
def inputs(tmp_path):
    d = tmp_path / "in"
    (d / "csv").mkdir(parents=True)
    (d / "json").mkdir()
    (d / "csv" / "a.csv").write_text(
        "k,word,x\n" + "".join(f'{k},"{w}",{x}\n' for k, w, x in ROWS[:2]))
    (d / "csv" / "b.csv").write_text(
        "k,word,x\n" + "".join(f'{k},"{w}",{x}\n' for k, w, x in ROWS[2:]))
    (d / "json" / "a.jsonl").write_text("".join(
        json.dumps({"k": k, "word": w, "x": x}) + "\n" for k, w, x in ROWS))
    return d


def _read(pkg, fmt, path, pk, via_fs=False, **kw):
    pw, runner, pg = PKGS[pkg]
    pg.G.clear()
    try:
        S = _schema(pw, pk)
        if via_fs:
            t = pw.io.fs.read(str(path), format=fmt, schema=S, mode="static")
        elif fmt == "csv":
            t = pw.io.csv.read(str(path), schema=S, mode="static", **kw)
        else:
            t = pw.io.jsonlines.read(str(path), schema=S, mode="static")
        out = t.select(t.k, t.word, y=t.x * 2)
        run_kw = {"device": "cpu"} if pkg == "torch" else {}
        [cap] = runner.run_tables(out, **run_kw)
        return cap.squash()
    finally:
        pg.G.clear()


@pytest.mark.parametrize("via_fs", [False, True])
@pytest.mark.parametrize("pk", [True, False])
@pytest.mark.parametrize("fmt", ["csv", "json"])
def test_static_read_gives_the_jax_rows(inputs, fmt, pk, via_fs):
    path = inputs / fmt
    want = _read("jax", fmt, path, pk, via_fs)
    got = _read("torch", fmt, path, pk, via_fs)
    assert len(got) == len(ROWS)
    assert got == want


def test_csv_settings_give_the_jax_rows(tmp_path):
    p = tmp_path / "semi.csv"
    p.write_text("k;word;x\n# a comment\n7;'a;b';1.5\n8;c;2.5\n")
    settings = dict(delimiter=";", quote="'", comment_character="#")
    want = _read("jax", "csv", p, True,
                 csv_settings=jpw.io.CsvParserSettings(**settings))
    got = _read("torch", "csv", p, True,
                csv_settings=tpw.io.CsvParserSettings(**settings))
    assert got == want
    assert sorted(r[1] for r in got.values()) == ["a;b", "c"]


def _write_lines(pkg, fmt, src, out_path) -> list:
    pw, _runner, pg = PKGS[pkg]
    pg.G.clear()
    try:
        S = _schema(pw, True)
        t = pw.io.jsonlines.read(str(src), schema=S, mode="static")
        t = t.filter(t.x > 0).select(t.word, y=t.x * 2)
        counts = t.groupby(t.word).reduce(t.word, n=pw.reducers.count(),
                                          s=pw.reducers.sum(t.y))
        if fmt == "csv":
            pw.io.csv.write(counts, str(out_path))
        else:
            pw.io.jsonlines.write(counts, str(out_path))
        pw.run(**({"device": "cpu"} if pkg == "torch" else {}))
    finally:
        pg.G.clear()
    return out_path.read_text().splitlines()


@pytest.mark.parametrize("fmt", ["csv", "json"])
def test_writers_give_the_jax_file(inputs, tmp_path, fmt):
    want = _write_lines("jax", fmt, inputs / "json", tmp_path / "j.out")
    got = _write_lines("torch", fmt, inputs / "json", tmp_path / "t.out")
    if fmt == "csv":
        assert got[0] == want[0] == "word,n,s,time,diff"
        got, want = got[1:], want[1:]
    assert collections.Counter(got) == collections.Counter(want)
    # one static batch: a line for each group (alpha of two rows, gamma)
    assert len(got) == 2


def _quickstart(pkg, words_dir, out_path, mode):
    """The README quickstart, as written there, in package ``pkg``."""
    pw, _runner, pg = PKGS[pkg]
    pg.G.clear()
    try:
        class InputSchema(pw.Schema):
            word: str

        words = pw.io.csv.read(str(words_dir), schema=InputSchema, mode=mode)
        counts = words.groupby(words.word).reduce(words.word,
                                                  count=pw.reducers.count())
        pw.io.jsonlines.write(counts, str(out_path))
        kw = {"device": "cpu"} if pkg == "torch" else {}
        if mode == "streaming":
            kw.update(timeout_s=20.0, idle_stop_s=2.0)
        pw.run(**kw)
    finally:
        pg.G.clear()
    return out_path.read_text().splitlines()


def _words(tmp_path):
    d = tmp_path / "words"
    d.mkdir()
    (d / "1.csv").write_text("word\nhello\nworld\nhello\n")
    (d / "2.csv").write_text("word\nlive\nhello\ndata\n")
    return d


def test_readme_quickstart_gives_the_jax_output_file(tmp_path):
    d = _words(tmp_path)
    want = _quickstart("jax", d, tmp_path / "j.jsonl", "static")
    got = _quickstart("torch", d, tmp_path / "t.jsonl", "static")
    assert collections.Counter(got) == collections.Counter(want)
    final = {json.loads(ln)["word"]: json.loads(ln)["count"] for ln in got}
    assert final == {"hello": 3, "world": 1, "live": 1, "data": 1}


def _net(lines) -> dict:
    """The state a jsonlines output describes: rows with their diffs
    summed, times dropped."""
    net = collections.Counter()
    for ln in lines:
        obj = json.loads(ln)
        diff = obj.pop("diff")
        obj.pop("time")
        net[json.dumps(obj, sort_keys=True)] += diff
    return {k: v for k, v in net.items() if v}


def test_readme_quickstart_streaming_nets_to_the_jax_output(tmp_path):
    d = _words(tmp_path)
    want = _quickstart("jax", d, tmp_path / "j.jsonl", "streaming")
    got = _quickstart("torch", d, tmp_path / "t.jsonl", "streaming")
    assert _net(got) == _net(want)
    assert all(v == 1 for v in _net(got).values())


def test_streaming_jsonlines_read_sees_an_appended_file(tmp_path):
    root = tmp_path / "live"
    root.mkdir()
    (root / "a.jsonl").write_text('{"k": 1, "word": "a", "x": 1.0}\n')
    tpg.G.clear()
    seen: list = []
    got_first, got_second = threading.Event(), threading.Event()

    def on_change(key, row, time, is_addition):
        seen.append((row["k"], row["word"], is_addition))
        (got_second if row["k"] == 2 else got_first).set()

    t = tpw.io.jsonlines.read(str(root), schema=_schema(tpw, True),
                              mode="streaming")
    tpw.io.subscribe(t, on_change=on_change)

    def writer():
        assert got_first.wait(10)
        (root / "b.jsonl").write_text('{"k": 2, "word": "b", "x": 2.0}\n')

    th = threading.Thread(target=writer, daemon=True)
    th.start()
    tpw.run(device="cpu", timeout_s=10.0, idle_stop_s=2.0)
    th.join(timeout=10)
    tpg.G.clear()
    assert got_second.is_set()
    assert seen == [(1, "a", True), (2, "b", True)]


# -- rows without a primary key: the JAX package's keys ------------------------

def test_no_key_jsonlines_read_gives_the_jax_packages_keys(inputs):
    """Each row's key is ``hash_rows([index, file, content])`` in both
    packages (``io/_utils._auto_keys``), so the captures are equal key
    for key, not only by value."""
    want = _read("jax", "json", inputs / "json", pk=False)
    got = _read("torch", "json", inputs / "json", pk=False)
    assert set(got) == set(want) and len(got) == len(ROWS)
    assert got == want


def _stream_keys(pkg, path, store=None) -> dict:
    """A streaming no-key jsonlines read of ``path`` (under persistence
    in ``store`` when given): the net (key -> row) its subscriber saw."""
    pw, _runner, pg = PKGS[pkg]
    pg.G.clear()
    net: dict = {}

    def on_change(key, row, time, is_addition):
        if is_addition:
            net[key] = (row["k"], row["word"], row["x"])
        else:
            net.pop(key, None)

    t = pw.io.jsonlines.read(str(path), schema=_schema(pw, False),
                             mode="streaming")
    pw.io.subscribe(t, on_change=on_change)
    kw = dict(idle_stop_s=1.0, timeout_s=20.0,
              monitoring_level=pw.MonitoringLevel.NONE)
    if store is not None:
        kw["persistence_config"] = pw.persistence.Config(
            pw.persistence.Backend.filesystem(str(store)))
    if pkg == "torch":
        kw["device"] = "cpu"
    try:
        pw.run(**kw)
    finally:
        pg.G.clear()
    return net


def test_a_jax_journal_over_no_key_files_replays_in_the_port_key_for_key(
        tmp_path):
    """The JAX package journals a no-key read; the port restarts over the
    same storage after the file grew: the journal's rows come back with
    the JAX package's keys, and the new rows get the keys the JAX package
    gives them at their index."""
    src = tmp_path / "events.jsonl"
    store = tmp_path / "store"

    def lines(rows):
        return "".join(json.dumps({"k": k, "word": w, "x": x}) + "\n"
                       for k, w, x in rows)

    src.write_text(lines(ROWS[:3]))
    first = _stream_keys("jax", src, store)
    assert len(first) == 3
    with open(src, "a") as f:
        f.write(lines(ROWS[3:] + [(5, "alpha", 0.5)]))
    restarted = _stream_keys("torch", src, store)
    fresh = _stream_keys("jax", src)
    assert len(fresh) == 5
    assert restarted == fresh
    assert {k: restarted[k] for k in first} == first
