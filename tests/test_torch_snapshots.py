"""Operator snapshots of the port against the JAX package's: a restart
folds the snapshot and replays only the journal's tail, file sinks keep
each row once, every operator with durable state restores to the
uninterrupted run's output, the external index is rebuilt on restore,
and each error the JAX module swallows is decided here.

``_split`` is a snapshot and restore without files: one lowering takes
the updates up to a time, its operators' states are pickled, a fresh
lowering of the same program restores them and takes the rest, and its
output must equal the uninterrupted run's after that time.  The Kafka
and cluster cases of ``tests/test_snapshots.py`` wait for those
connectors and the cluster.
"""

import collections
import json
import logging
import pickle

import numpy as np
import pytest

import pathway_tpu_torch as tpw
from pathway_tpu_torch.engine import runner as trunner

from .torch_parity import capture, fresh_port, named  # noqa: F401
from .torch_persist import (PKGS, backend, both, journal_events, run,
                            squash_jsonl)


@pytest.fixture(autouse=True)
def _fresh(fresh_port):  # noqa: F811
    yield


# -- the wordcount of tests/test_snapshots.py --------------------------------

def _wordcount(pkg, src, out, be, interval_ms=300, idle_stop_s=1.0,
               mode="persisting"):
    pw, pg = PKGS[pkg]
    pg.G.clear()

    class S(pw.Schema):
        word: str

    t = pw.io.csv.read(str(src), schema=S, mode="streaming")
    counts = t.groupby(t.word).reduce(t.word, c=pw.reducers.count())
    pw.io.jsonlines.write(counts, str(out))
    run(pkg, persistence_config=pw.persistence.Config(
        be, snapshot_interval_ms=interval_ms, persistence_mode=mode),
        idle_stop_s=idle_stop_s, autocommit_duration_ms=20)


def _net(out) -> dict:
    return {w: c for (w, c) in squash_jsonl(out, ("word", "c"))}


def test_snapshot_restart_skips_folded_journal(tmp_path):
    def scenario(pkg, root):
        root.mkdir()
        src, out = root / "w.csv", root / "o.jsonl"
        be = backend(pkg, root / "ps")
        src.write_text("word\n" + "\n".join(["a"] * 5 + ["b"] * 3) + "\n")
        _wordcount(pkg, src, out, be)
        assert be.get_metadata("opsnapshot_p0"), "no snapshot written"
        with open(src, "a") as f:
            f.write("a\nc\n")
        _wordcount(pkg, src, out, backend(pkg, root / "ps"))
        records = sum(len(be.read_all(s)) for s in be.list_streams("input_"))
        # the first run's folded records are trimmed: a tail-only journal
        assert records <= 4, records
        return _net(out), journal_events(be)

    out = both(scenario, tmp_path)
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == {"a": 6, "b": 3, "c": 1}


def test_snapshot_exactly_once_output(tmp_path):
    def scenario(pkg, root):
        root.mkdir()
        src, out = root / "w.csv", root / "o.jsonl"
        be = backend(pkg, root / "ps")
        src.write_text("word\nx\nx\ny\n")
        _wordcount(pkg, src, out, be, interval_ms=200)
        first = _net(out)
        with open(src, "a") as f:
            f.write("y\n")
        _wordcount(pkg, src, out, be, interval_ms=200)
        lines = [json.loads(ln) for ln in out.read_text().splitlines()]
        return first, _net(out), len(lines)

    out = both(scenario, tmp_path)
    assert out["torch"] == out["jax"]
    assert out["torch"][:2] == ({"x": 2, "y": 1}, {"x": 2, "y": 2})


def test_journal_seq_no_regress_after_trim(tmp_path):
    """After a trim the sequence numbers continue past the snapshot's
    watermark: a stale watermark must not swallow new records."""
    from pathway_tpu_torch.persistence import (Backend, Config,
                                               _stream_name,
                                               attach_persistence)

    class FakeSource:
        path = "x"

        def __init__(self):
            self._events = [(0, 1, ("a",), 1)]

        def is_live(self):
            return False

        def static_events(self):
            return list(self._events)

        def poll(self):
            return None

    class FakeRunner:
        pass

    be = Backend.filesystem(str(tmp_path))
    src = FakeSource()
    stream = _stream_name(0, src)
    for seq in range(6):
        be.append(stream, pickle.dumps((seq, [(0, seq + 10, ("x",), 1)], None)))
    be.put_metadata("journal_format", b"2")
    be.put_metadata("opsnapshot_p0", pickle.dumps({
        "shape": (1, 1), "frontier": 10, "ops": {}, "offsets": {},
        "journal_seqs": {stream: 5}}))
    r = FakeRunner()
    r.lg = type("LG", (), {
        "input_ops": [(None, src)], "writers": [],
        "scheduler": type("Sch", (), {"frontier": -1,
                                      "topo_order": staticmethod(list)})(),
    })()
    attach_persistence(r, Config(be, snapshot_interval_ms=100))
    src.static_events()  # journals the fresh event
    recs = be.read_all(stream)
    assert recs, "fresh event not journaled"
    assert pickle.loads(recs[-1])[0] > 5
    assert be.get_metadata("journal_trimmed") == b"1"


# -- the sinks' resume --------------------------------------------------------

def _writer(pkg, kind, path):
    mod = (__import__("pathway_tpu.io._utils", fromlist=["x"]) if pkg == "jax"
           else __import__("pathway_tpu_torch.io._utils", fromlist=["x"]))
    return getattr(mod, kind)(str(path))


@pytest.mark.parametrize("pkg", list(PKGS))
def test_csv_writer_resume_multiline_fields(tmp_path, pkg):
    """Quoted newlines in sink rows survive the resume trim."""
    import csv

    p = tmp_path / "o.csv"
    w = _writer(pkg, "CsvWriter", p)
    w.write_batch(0, ["s", "v"], [(1, ("line1\nline2", 5), 1)])
    w.write_batch(4, ["s", "v"], [(2, ("later", 6), 1)])
    w.close()
    w2 = _writer(pkg, "CsvWriter", p)
    w2.resume(keep_le_time=2)
    w2.write_batch(6, ["s", "v"], [(3, ("fresh", 7), 1)])
    w2.close()
    with open(p, newline="") as f:
        rows = list(csv.reader(f))
    assert rows == [["s", "v", "time", "diff"], ["line1\nline2", "5", "0", "1"],
                    ["fresh", "7", "6", "1"]]


@pytest.mark.parametrize("kind", ["JsonlinesWriter", "CsvWriter"])
def test_resume_drops_a_torn_last_entry(tmp_path, kind, caplog):
    """A crash mid-write leaves a torn last entry (of a time past the
    snapshot): resume drops it and keeps the rest."""
    p = tmp_path / "o.out"
    w = _writer("torch", kind, p)
    w.write_batch(0, ["s"], [(1, ("a",), 1)])
    w.write_batch(2, ["s"], [(2, ("b",), 1)])
    w.close()
    text = p.read_text()
    p.write_text(text[: len(text) - 5])  # the last entry, torn
    w2 = _writer("torch", kind, p)
    with caplog.at_level(logging.WARNING):
        w2.resume(keep_le_time=4)
    assert "torn last" in caplog.text
    w2.write_batch(6, ["s"], [(3, ("c",), 1)])
    w2.close()
    body = p.read_text()
    assert "a" in body and "c" in body and "b" not in body.replace("by", "")


@pytest.mark.parametrize("kind", ["JsonlinesWriter", "CsvWriter"])
def test_resume_raises_on_a_bad_entry_before_the_last(tmp_path, kind):
    """Only the last entry can be torn; an unparseable one before it means
    the file is not this sink's, and resume raises (the JAX writer skips
    every line that does not parse)."""
    p = tmp_path / "o.out"
    w = _writer("torch", kind, p)
    w.write_batch(0, ["s"], [(1, ("a",), 1)])
    w.write_batch(2, ["s"], [(2, ("b",), 1)])
    w.close()
    lines = p.read_text().splitlines(keepends=True)
    lines.insert(len(lines) - 1, "garbage\n")
    p.write_text("".join(lines))
    with pytest.raises(ValueError, match="does not parse"):
        _writer("torch", kind, p).resume(keep_le_time=4)


# -- each operator's state, restored ------------------------------------------

def _md(pw, text):
    return pw.debug.table_from_markdown(text)


WORDS = """
    | w | v | __time__ | __diff__
  1 | a | 1 | 2        | 1
  2 | b | 2 | 2        | 1
  3 | a | 3 | 4        | 1
  1 | a | 1 | 6        | -1
  4 | c | 4 | 6        | 1
  5 | b | 5 | 8        | 1
"""
RIGHT = """
    | w | x | __time__
 11 | a | 10 | 2
 12 | b | 20 | 6
 13 | c | 30 | 8
"""


def _nondet(pw):
    @pw.udf(deterministic=False)
    def odd(v: int) -> bool:
        return v % 2 == 1

    return odd


def b_groupby(pw):
    t = _md(pw, WORDS)
    return t.groupby(t.w).reduce(t.w, c=pw.reducers.count(),
                                 s=pw.reducers.sum(t.v))


def b_join(pw):
    t, r = _md(pw, WORDS), _md(pw, RIGHT)
    return t.join(r, t.w == r.w).select(v=t.v, x=r.x)


def b_deduplicate(pw):
    t = _md(pw, WORDS)
    return t.deduplicate(value=t.v, instance=t.w,
                         acceptor=lambda new, old: new > old)


def b_difference_intersect(pw):
    t = _md(pw, WORDS)
    small = t.filter(t.v < 3)
    return t.difference(small), t.intersect(small)


def b_ix(pw):
    t, r = _md(pw, WORDS), _md(pw, RIGHT)
    keyed = r.with_id_from(r.w)
    return t.select(v=t.v, x=keyed.ix(keyed.pointer_from(t.w),
                                      optional=True).x)


def b_stateful_filter_and_rowwise(pw):
    t = _md(pw, WORDS)
    odd = _nondet(pw)
    return t.filter(odd(t.v)), t.select(w=t.w, o=odd(t.v))


def b_update_rows_cells(pw):
    t = _md(pw, WORDS)
    over = _md(pw, """
        | w  | v  | __time__ | __diff__
      2 | bb | 20 | 4        | 1
      6 | dd | 60 | 8        | 1
    """)
    cells = _md(pw, """
        | v  | __time__
      1 | 11 | 4
      3 | 33 | 8
    """)
    return t.update_rows(over), t.update_cells(cells)


def b_stream_to_table(pw):
    t = _md(pw, """
        id | age | __time__ | __diff__
         1 | 10  |    2     |    1
         2 | 9   |    2     |    1
         1 | 10  |    6     |   -1
         1 | 11  |    6     |    1
         2 | 9   |    8     |   -1
    """)
    return t.to_stream().stream_to_table(is_upsert=pw.this.is_upsert)


def b_unpack_snapshots(pw):
    return _md(pw, """
        id | data | __time__ | __diff__
         1 | a    |    2     |    1
         2 | b    |    4     |    1
         2 | b    |    6     |   -1
         3 | d    |    6     |    1
    """).unpack_snapshots()


def b_time_ops(pw):
    t = _md(pw, """
        | v | thr | now | __time__
        | 1 | 5   | 1   | 2
        | 2 | 2   | 3   | 4
        | 3 | 9   | 6   | 6
        | 4 | 7   | 8   | 8
    """)
    return (t._buffer(t.thr, t.now), t._freeze(t.thr, t.now),
            t._forget(t.thr, t.now, mark_forgetting_records=False))


def b_iterate(pw):
    start = _md(pw, """
        | a  | __time__
      1 | 7  | 2
      2 | 12 | 6
    """)
    return pw.iterate(lambda t: t.select(a=pw.if_else(
        t.a == 1, 1, pw.if_else(t.a % 2 == 0, t.a // 2, 3 * t.a + 1))),
        t=start)


def b_asof_join(pw):
    trades = _md(pw, """
        | t  | sym | price | __time__
      1 | 5  | A   | 100   | 2
      2 | 15 | A   | 110   | 6
    """)
    quotes = _md(pw, """
        | t  | sym | bid | __time__
      5 | 3  | A   | 99  | 2
      6 | 10 | A   | 105 | 6
    """)
    return trades.asof_join(quotes, trades.t, quotes.t,
                            trades.sym == quotes.sym).select(
        price=trades.price, bid=quotes.bid)


def b_sort(pw):
    t = _md(pw, WORDS)
    return t.sort(key=t.v)


def b_gradual_broadcast(pw):
    t = _md(pw, """
        | v | __time__
      1 | 1 | 2
      2 | 2 | 2
      3 | 3 | 6
    """)
    thr = _md(pw, """
        | lower | value | upper | __time__
      9 | 0.1   | 0.3   | 0.6   | 2
      9 | 0.1   | 0.3   | 0.6   | 6
    """)
    return t._gradual_broadcast(thr, thr.lower, thr.value, thr.upper)


def _vec(pw):
    return pw.apply(lambda x, y: np.array([x, y], np.float32), pw.this.x,
                    pw.this.y)


def b_external_index(pw, as_of_now=False):
    docs = _md(pw, """
        | name | x    | y    | __time__
      1 | d1   | 1.0  | 0.0  | 2
      2 | d2   | 0.0  | 1.0  | 2
      3 | d3   | 0.7  | 0.7  | 6
    """)
    qs = _md(pw, """
        | x   | y   | __time__
      7 | 0.9 | 0.1 | 2
      8 | 0.1 | 0.9 | 6
    """)
    docs = docs.select(name=docs.name, vec=_vec(pw))
    qs = qs.select(vec=_vec(pw))
    kw = {"device": "cpu"} if pw is tpw else {}
    index = pw.indexing.BruteForceKnnFactory(
        dimensions=2, **kw).build_index(docs.vec, docs)
    query = index.query_as_of_now if as_of_now else index.query
    return query(qs.vec, number_of_matches=2).select(
        names=pw.this.name)


def b_external_index_as_of_now(pw):
    return b_external_index(pw, as_of_now=True)


ROUND_TRIPS = {
    "GroupbyOperator": (b_groupby, 4),
    "JoinOperator": (b_join, 4),
    "DeduplicateOperator": (b_deduplicate, 4),
    "DifferenceOperator": (b_difference_intersect, 4),
    "IntersectOperator": (b_difference_intersect, 4),
    "IxOperator": (b_ix, 4),
    "StatefulFilter": (b_stateful_filter_and_rowwise, 4),
    "StatefulRowwise": (b_stateful_filter_and_rowwise, 4),
    "UpdateRowsOperator": (b_update_rows_cells, 4),
    "UpdateCellsOperator": (b_update_rows_cells, 4),
    "StreamToTableOperator": (b_stream_to_table, 4),
    "UnpackSnapshotsOperator": (b_unpack_snapshots, 4),
    "BufferOperator": (b_time_ops, 4),
    "FreezeOperator": (b_time_ops, 4),
    "ForgetOperator": (b_time_ops, 4),
    "IterateOperator": (b_iterate, 4),
    "AsofJoinOperator": (b_asof_join, 4),
    "SortOperator": (b_sort, 4),
    "GradualBroadcastOperator": (b_gradual_broadcast, 4),
    "ExternalIndexOperator": (b_external_index, 4),
    "ExternalIndexOperator_as_of_now": (b_external_index_as_of_now, 4),
}


def _lowered(pkg, build):
    pw, pg = PKGS[pkg]
    pg.G.clear()
    out = build(pw)
    outs = out if isinstance(out, tuple) else (out,)
    sinks = [t._materialize_capture() for t in outs]
    kw = {"device": "cpu"} if pkg == "torch" else {}
    if pkg == "torch":
        runner = trunner.GraphRunner(sinks, **kw)
    else:
        from pathway_tpu.engine import runner as jrunner

        runner = jrunner.GraphRunner(sinks)
    return runner, sinks


def _feed(runner, keep) -> None:
    sched = runner.lg.scheduler
    by_t = collections.defaultdict(list)
    for op, src in runner.lg.input_ops:
        events = collections.defaultdict(list)
        for t, key, row, diff in src.static_events():
            if keep(t):
                events[t].append((key, row, diff))
        for t, ups in events.items():
            by_t[t].append((op, ups))
    for t in sorted(by_t):
        for op, ups in by_t[t]:
            sched.push_input(op, t, ups)


def _streams(runner, sinks, after=None) -> list:
    out = []
    for s in sinks:
        cap = runner.lg.captures[s.id]
        out.append(collections.Counter(
            (k, named(tuple(r)), t, d) for k, r, t, d in cap.as_list()
            if after is None or t > after))
    return out


def _split(pkg, build, t_split):
    """(uninterrupted output after ``t_split``, the restored run's
    output, the stateful operators' class names)."""
    runner, sinks = _lowered(pkg, build)
    _feed(runner, lambda t: True)
    runner.lg.scheduler.finish()
    want = _streams(runner, sinks, after=t_split)
    first, _ = _lowered(pkg, build)
    _feed(first, lambda t: t <= t_split)
    first.lg.scheduler.run_until_idle()
    states = {pos: pickle.dumps(op.snapshot_state())
              for pos, op in enumerate(first.lg.scheduler.topo_order())
              if op.snapshot_state() is not None}
    names = {type(op).__name__ for op in first.lg.scheduler.operators
             if op.snapshot_state() is not None}
    second, sinks2 = _lowered(pkg, build)
    for pos, op in enumerate(second.lg.scheduler.topo_order()):
        if pos in states:
            op.restore_state(pickle.loads(states[pos]))
    second.lg.scheduler.frontier = first.lg.scheduler.frontier
    _feed(second, lambda t: t > t_split)
    second.lg.scheduler.finish()
    return want, _streams(second, sinks2), names


@pytest.mark.parametrize("name", list(ROUND_TRIPS))
def test_each_stateful_operator_restores_to_the_uninterrupted_output(name):
    build, t_split = ROUND_TRIPS[name]
    want, got, names = _split("torch", build, t_split)
    assert name.split("_")[0] in names, names
    assert got == want
    assert any(want), "nothing after the split: the test is vacuous"
    # and the uninterrupted port run is the JAX package's
    assert capture("torch", build, stream=True) == capture(
        "jax", build, stream=True)


def test_the_jax_external_index_restores_empty():
    """The finding behind the port's ``restore_state``: the JAX operator's
    durable state leaves its InnerIndex out, so after a restore only the
    journal tail's documents are searchable (the query at time 6 finds
    d3 alone, where the uninterrupted run finds d2 and d3)."""
    want, got, _names = _split("jax", b_external_index, 4)
    [want], [got] = want, got
    fresh = [r for (_k, r, t, d) in got if t == 6 and d > 0]
    uninterrupted = [r for (_k, r, t, d) in want if t == 6 and d > 0]
    assert sorted(len(r[0]) for r in uninterrupted) == [2, 2]
    assert ("d3",) in [r[0] for r in fresh]
    assert got != want
    port_want, port_got, _ = _split("torch", b_external_index, 4)
    assert port_got == port_want


def test_a_restored_device_resident_index_answers_as_the_uninterrupted(
        tmp_path, monkeypatch):
    """Rows of a device-resident embedder are ``DeviceVec``s, which pickle
    to numpy: the restore adds them back to the index (on its device) in
    one ``add_batch``, and the answers (keys and scores) equal the run
    that was never stopped."""
    from pathway_tpu_torch.models.encoder import EncoderConfig
    from pathway_tpu_torch.ops.device_store import DeviceVec
    from pathway_tpu_torch.stdlib.indexing.inner_index import BruteForceKnn
    from pathway_tpu_torch.xpacks.llm.embedders import (
        SentenceTransformerEmbedder)

    monkeypatch.setenv("PW_COSTDB_PATH", str(tmp_path / "costdb.json"))
    emb = SentenceTransformerEmbedder(
        config=EncoderConfig(vocab_size=512, d_model=32, n_layers=1,
                             n_heads=4, d_ff=64, max_len=32),
        seed=3, device="cpu", device_resident=True)
    batches = []
    real_add_batch = BruteForceKnn.add_batch

    def add_batch(self, keys, items, metas):
        batches.append((len(keys), all(isinstance(i, np.ndarray)
                                       for i in items)))
        return real_add_batch(self, keys, items, metas)

    monkeypatch.setattr(BruteForceKnn, "add_batch", add_batch)

    def build(pw):
        docs = _md(pw, """
            | text                    | __time__
          1 | alpha stream engines    | 2
          2 | beta batch engines      | 2
          3 | gamma vector indexes    | 2
          4 | delta stream processors | 6
        """)
        qs = _md(pw, """
            | q                   | __time__
          7 | stream engines      | 2
          8 | vector processors   | 6
        """)
        index = pw.indexing.BruteForceKnnFactory(
            dimensions=emb.get_embedding_dimension(), embedder=emb,
            device="cpu").build_index(docs.text, docs)
        return index.query(qs.q, number_of_matches=3).select(
            ids=pw.this._pw_index_reply_id,
            scores=pw.this._pw_index_reply_score, text=pw.this.text)

    runner, _ = _lowered("torch", build)
    _feed(runner, lambda t: t <= 4)
    runner.lg.scheduler.run_until_idle()
    [op] = [op for op in runner.lg.scheduler.operators
            if type(op).__name__ == "ExternalIndexOperator"]
    assert any(isinstance(v, DeviceVec) for row, _c in op.state[1].data.values()
               for v in row)
    want, got, _names = _split("torch", build, 4)
    assert batches[-1] == (3, True)
    [want], [got] = want, got
    assert got == want and any(want)


# -- the swallows of snapshots.py, decided ------------------------------------

def _snap_run(root, mode="operator_persisting", idle_stop_s=0.8, src_rows=3):
    src, out = root / "w.csv", root / "o.jsonl"
    if not src.exists():
        src.write_text("word\n" + "a\n" * src_rows)
    _wordcount("torch", src, out, backend("torch", root / "ps"),
               interval_ms=250, idle_stop_s=idle_stop_s, mode=mode)
    return _net(out)


def test_a_state_that_does_not_pickle_fails_the_run(tmp_path):
    """The JAX manager turns snapshots off for the run; the caller asked
    for them, so the port raises, naming the operator."""
    pw, pg = PKGS["torch"]
    src = tmp_path / "w.csv"
    src.write_text("word\na\n")
    pg.G.clear()

    class S(pw.Schema):
        word: str

    t = pw.io.csv.read(str(src), schema=S, mode="streaming")
    counts = t.groupby(t.word).reduce(t.word, c=pw.reducers.count())
    pw.io.subscribe(counts, on_change=lambda **kw: None)
    from pathway_tpu_torch.engine.operators import GroupbyOperator

    real = GroupbyOperator.snapshot_state
    try:
        GroupbyOperator.snapshot_state = lambda self: {"f": lambda: None}
        with pytest.raises(Exception, match="cannot be pickled"):
            run("torch", persistence_config=pw.persistence.Config(
                backend("torch", tmp_path / "ps"),
                persistence_mode="operator_persisting",
                snapshot_interval_ms=250), idle_stop_s=1.0,
                autocommit_duration_ms=20)
    finally:
        GroupbyOperator.snapshot_state = real


@pytest.mark.parametrize("trimmed", [False, True])
def test_an_unreadable_snapshot(tmp_path, caplog, trimmed):
    """Unreadable: the whole journal replays (a log line) while no restart
    has trimmed it; after a trim the trimmed records live only in that
    snapshot, so the run raises (the JAX package replays the rest)."""
    root = tmp_path
    assert _snap_run(root) == {"a": 3}
    be = backend("torch", root / "ps")
    assert be.get_metadata("opsnapshot_p0")
    if trimmed:
        _snap_run(root)  # a restart folds the snapshot: the journal is trimmed
        assert be.get_metadata("journal_trimmed") == b"1"
    be.put_metadata("opsnapshot_p0", b"\x00not a pickle")
    (root / "o.jsonl").unlink()
    if trimmed:
        with pytest.raises(RuntimeError, match="trimmed the journal"):
            _snap_run(root)
        return
    with caplog.at_level(logging.WARNING):
        assert _snap_run(root) == {"a": 3}
    assert "unreadable operator snapshot" in caplog.text


def test_a_snapshot_of_another_graph_replays_the_journal(tmp_path, caplog):
    """A program whose operators changed restores nothing (the JAX
    manager restores the operators it finds before one is missing, then
    replays the journal over them); the whole journal replays."""
    root = tmp_path
    assert _snap_run(root) == {"a": 3}
    be = backend("torch", root / "ps")
    snap = pickle.loads(be.get_metadata("opsnapshot_p0"))
    snap["names"] = {ident: "SomeOtherOperator" for ident in snap["names"]}
    be.put_metadata("opsnapshot_p0", pickle.dumps(snap))
    (root / "o.jsonl").unlink()
    with caplog.at_level(logging.WARNING):
        assert _snap_run(root) == {"a": 3}
    assert "another graph" in caplog.text


def test_a_failing_restore_fails_the_run(tmp_path, monkeypatch):
    root = tmp_path
    assert _snap_run(root) == {"a": 3}
    from pathway_tpu_torch.engine.operators import GroupbyOperator

    def broken(self, st):
        raise ValueError("restore broke")

    monkeypatch.setattr(GroupbyOperator, "restore_state", broken)
    with pytest.raises(ValueError, match="restore broke"):
        _snap_run(root)


def test_a_failing_sink_trim_fails_the_run(tmp_path, monkeypatch):
    """Appending to an untrimmed sink would write the tail's rows twice:
    the run raises (the JAX package logs and goes on)."""
    root = tmp_path
    assert _snap_run(root) == {"a": 3}
    from pathway_tpu_torch.io._utils import JsonlinesWriter

    def broken(self, path, keep_le_time):
        raise OSError("disk gone")

    monkeypatch.setattr(JsonlinesWriter, "_filter_lines", broken)
    with pytest.raises(OSError, match="disk gone"):
        _snap_run(root)


def test_snapshot_restart_is_exactly_once_under_operator_persisting(tmp_path):
    """The same wordcount restarted three times, growing between runs:
    each restart folds the last snapshot, and the sink holds each count
    once; equal to the JAX package's."""
    def scenario(pkg, root):
        root.mkdir()
        src, out = root / "w.csv", root / "o.jsonl"
        be = backend(pkg, root / "ps")
        src.write_text("word\na\nb\n")
        states = []
        for extra in ("a\n", "c\nc\n", ""):
            _wordcount(pkg, src, out, be, interval_ms=250, idle_stop_s=0.8,
                       mode="operator_persisting")
            states.append(_net(out))
            with open(src, "a") as f:
                f.write(extra)
        lines = collections.Counter(
            (e["word"], e["c"], e["diff"]) for e in
            map(json.loads, out.read_text().splitlines()))
        return states, lines

    out = both(scenario, tmp_path)
    assert out["torch"] == out["jax"]
    assert out["torch"][0][-1] == {"a": 2, "b": 1, "c": 2}
    assert all(n == 1 for n in out["torch"][1].values())
