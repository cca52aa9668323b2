"""``pw.persistence`` of the port against the JAX package's: the seven
modes of ``PersistenceMode`` (journal replay preserving or collapsing
commit times, paced replay, selective persisting, UDF caching, operator
snapshots), offsetless and broker-style subjects, a static table's
journal, and the backends.

Each scenario runs once in each package, each against its own storage
under ``tmp_path``: the replayed rows, their commit structure and the
journals' event multisets must be equal.  Times are each run's own
(wall-clock commits), so only their structure is compared.
"""

import collections
import threading
import time

import pytest

from .torch_parity import fresh_port  # noqa: F401
from .torch_persist import PKGS, backend, both, journal_events, run


@pytest.fixture(autouse=True)
def _fresh(fresh_port):  # noqa: F811
    yield


def _schema(pw):
    class S(pw.Schema):
        word: str

    return S


def _record_run(pkg, src, be, n_phases=3, gap_s=0.25):
    """Stream a csv in ``n_phases`` appends, so the journal holds records
    at distinct logical times and wall-clock stamps."""
    pw, pg = PKGS[pkg]
    src.write_text("word\nw0\n")
    got = []
    pg.G.clear()
    t = pw.io.csv.read(str(src), schema=_schema(pw), mode="streaming")
    pw.io.subscribe(t, on_change=lambda key, row, time, is_addition:
                    got.append(row["word"]))

    def appender():
        for i in range(1, n_phases):
            time.sleep(gap_s)
            with open(src, "a") as f:
                f.write(f"w{i}\n")

    th = threading.Thread(target=appender)
    th.start()
    run(pkg, persistence_config=pw.persistence.Config(be),
        idle_stop_s=gap_s + 0.6, autocommit_duration_ms=20)
    th.join(5)
    assert sorted(got) == [f"w{i}" for i in range(n_phases)]


def _replay(pkg, src, be, mode, **run_kw):
    """Restart: (seconds since start, logical time, word) a replayed row."""
    pw, pg = PKGS[pkg]
    pg.G.clear()
    t = pw.io.csv.read(str(src), schema=_schema(pw), mode="streaming")
    seen = []
    t0 = time.monotonic()
    pw.io.subscribe(t, on_change=lambda key, row, time, is_addition:
                    seen.append((__import__("time").monotonic() - t0, time,
                                 row["word"])))
    run_kw.setdefault("idle_stop_s", 0.5)
    run(pkg, persistence_config=pw.persistence.Config(
        be, persistence_mode=mode), autocommit_duration_ms=20, **run_kw)
    return seen


def _records_with_events(be) -> int:
    import pickle

    return sum(1 for s in be.list_streams("input_") for rec in be.read_all(s)
               if pickle.loads(rec)[1])


def test_speedrun_replay_preserves_commit_times(tmp_path):
    def scenario(pkg, root):
        root.mkdir()
        src, be = root / "w.csv", backend(pkg, root / "p")
        _record_run(pkg, src, be, gap_s=0.5)
        n_commits = _records_with_events(be)
        assert n_commits > 1, "one commit recorded: the test is vacuous"
        seen = _replay(pkg, src, be, "speedrun_replay")
        assert sorted(w for _s, _t, w in seen) == ["w0", "w1", "w2"]
        # every recorded commit replays as its own commit, at once
        assert len({t for _s, t, _w in seen}) == n_commits
        assert max(s for s, _t, _w in seen) < 0.3
        # the default mode collapses the backfill onto one commit
        seen2 = _replay(pkg, src, be, "persisting")
        assert sorted(w for _s, _t, w in seen2) == ["w0", "w1", "w2"]
        assert len({t for _s, t, _w in seen2}) == 1
        return journal_events(be)

    out = both(scenario, tmp_path)
    assert out["torch"] == out["jax"]


def test_batch_replay_collapses_times(tmp_path):
    def scenario(pkg, root):
        root.mkdir()
        src, be = root / "w.csv", backend(pkg, root / "p")
        _record_run(pkg, src, be)
        seen = _replay(pkg, src, be, "batch")
        assert sorted(w for _s, _t, w in seen) == ["w0", "w1", "w2"]
        assert len({t for _s, t, _w in seen}) == 1  # one logical time
        return journal_events(be)

    out = both(scenario, tmp_path)
    assert out["torch"] == out["jax"]


def test_realtime_replay_paces_by_recorded_gaps(tmp_path):
    def scenario(pkg, root):
        root.mkdir()
        src, be = root / "w.csv", backend(pkg, root / "p")
        _record_run(pkg, src, be, n_phases=2, gap_s=0.6)
        seen = _replay(pkg, src, be, "realtime_replay")
        assert sorted(w for _s, _t, w in seen) == ["w0", "w1"]
        by_word = {w: s for s, _t, w in seen}
        # w1 was recorded ~0.6 s after w0: the replay keeps the gap
        assert by_word["w1"] - by_word["w0"] >= 0.35, by_word
        return sorted(by_word)

    out = both(scenario, tmp_path)
    assert out["torch"] == out["jax"]


def test_realtime_replay_not_truncated_by_idle_stop(tmp_path):
    """Waiting out a recorded gap is activity: an ``idle_stop_s`` shorter
    than the gap does not cut the backfill short."""
    def scenario(pkg, root):
        root.mkdir()
        src, be = root / "w.csv", backend(pkg, root / "p")
        _record_run(pkg, src, be, n_phases=2, gap_s=0.9)
        seen = _replay(pkg, src, be, "realtime_replay", idle_stop_s=0.4)
        return sorted(w for _s, _t, w in seen)

    out = both(scenario, tmp_path)
    assert out["torch"] == out["jax"] == ["w0", "w1"]


def test_selective_persisting_only_named_sources(tmp_path):
    def scenario(pkg, root):
        root.mkdir()
        pw, pg = PKGS[pkg]
        be = backend(pkg, root / "p")
        a, b = root / "a.csv", root / "b.csv"
        a.write_text("word\nkeep\n")
        b.write_text("word\ndrop\n")

        def run_once():
            pg.G.clear()
            ta = pw.io.csv.read(str(a), schema=_schema(pw), mode="streaming",
                                persistent_id="keep_src")
            tb = pw.io.csv.read(str(b), schema=_schema(pw), mode="streaming")
            got = []

            def cb(key, row, time, is_addition):
                got.append(row["word"])

            pw.io.subscribe(ta, on_change=cb)
            pw.io.subscribe(tb, on_change=cb)
            run(pkg, persistence_config=pw.persistence.Config(
                be, persistence_mode="selective_persisting"),
                idle_stop_s=0.7, autocommit_duration_ms=20)
            return got

        first = run_once()
        streams = be.list_streams("input_")
        assert streams and all("keep_src" in s for s in streams), streams
        # the source files vanish: only the named source's rows replay
        a.unlink()
        b.unlink()
        return sorted(first), run_once(), journal_events(be)

    out = both(scenario, tmp_path)
    assert out["torch"] == out["jax"]
    assert out["torch"][:2] == (["drop", "keep"], ["keep"])


def test_udf_caching_mode_skips_journaling(tmp_path):
    def scenario(pkg, root):
        root.mkdir()
        pw, pg = PKGS[pkg]
        be = backend(pkg, root / "p")
        src = root / "w.csv"
        src.write_text("word\nx\n")
        pg.G.clear()
        t = pw.io.csv.read(str(src), schema=_schema(pw), mode="streaming")
        pw.io.subscribe(t, on_change=lambda *a, **k: None)
        run(pkg, persistence_config=pw.persistence.Config(
            be, persistence_mode="udf_caching"),
            idle_stop_s=0.6, autocommit_duration_ms=20)
        return be.list_streams("input_")

    out = both(scenario, tmp_path)
    assert out["torch"] == out["jax"] == []


def test_selective_persisting_disables_operator_snapshots(tmp_path):
    """Snapshots would fold the unnamed source's events into restored
    state while it replays from scratch: selective mode takes none."""
    def scenario(pkg, root):
        root.mkdir()
        pw, pg = PKGS[pkg]
        be = backend(pkg, root / "p")
        a, b = root / "a.csv", root / "b.csv"
        a.write_text("word\nkeep\n")
        b.write_text("word\nother\n")

        def run_once():
            pg.G.clear()
            ta = pw.io.csv.read(str(a), schema=_schema(pw), mode="streaming",
                                persistent_id="sel")
            tb = pw.io.csv.read(str(b), schema=_schema(pw), mode="streaming")
            both = ta.concat_reindex(tb)
            counts = both.groupby(both.word).reduce(
                both.word, c=pw.reducers.count())
            state = {}
            pw.io.subscribe(counts, on_change=lambda key, row, time,
                            is_addition: state.__setitem__(
                                row["word"], row["c"]) if is_addition else None)
            run(pkg, persistence_config=pw.persistence.Config(
                be, persistence_mode="selective_persisting",
                snapshot_interval_ms=50),
                idle_stop_s=0.7, autocommit_duration_ms=20)
            return state

        return run_once(), run_once(), be.get_metadata("opsnapshot_p0")

    out = both(scenario, tmp_path)
    assert out["torch"] == out["jax"]
    assert out["torch"] == ({"keep": 1, "other": 1},) * 2 + (None,)


@pytest.mark.parametrize("pkg", list(PKGS))
def test_unknown_mode_rejected(pkg):
    pw, _pg = PKGS[pkg]
    with pytest.raises(ValueError, match="unknown persistence_mode"):
        pw.persistence.Config(pw.persistence.Backend.mock(),
                              persistence_mode="nope")


@pytest.mark.parametrize("mode", ["REALTIME_REPLAY", "SPEEDRUN_REPLAY",
                                  "BATCH", "PERSISTING",
                                  "SELECTIVE_PERSISTING", "UDF_CACHING",
                                  "OPERATOR_PERSISTING"])
def test_persistence_mode_enum_accepted(tmp_path, mode):
    got = {}
    for pkg, (pw, _pg) in PKGS.items():
        cfg = pw.persistence.Config(backend(pkg, tmp_path / pkg),
                                    persistence_mode=pw.PersistenceMode[mode])
        got[pkg] = cfg.persistence_mode
    assert got["torch"] == got["jax"] == mode.lower()
    assert [m.value for m in PKGS["torch"][0].PersistenceMode] == [
        m.value for m in PKGS["jax"][0].PersistenceMode]


def _subject_runs(pkg, be, runs, deterministic):
    """One run a list of values through a python subject; each run's
    sorted rows."""
    pw, pg = PKGS[pkg]

    class VS(pw.Schema):
        v: int

    out = []
    for values in runs:
        class Sub(pw.io.python.ConnectorSubject):
            deterministic_rerun = deterministic

            def run(self, values=values):
                for i in values:
                    self.next(v=i)

        pg.G.clear()
        t = pw.io.python.read(Sub(), schema=VS)
        got = []
        pw.io.subscribe(t, on_change=lambda key, row, time, is_addition:
                        got.append(row["v"]))
        run(pkg, idle_stop_s=1.0, autocommit_duration_ms=20,
            persistence_config=pw.persistence.Config(be))
        out.append(sorted(got))
    return out


def test_offsetless_subject_source_exactly_once_on_restart(tmp_path):
    """A subject without seek re-emits its whole stream on a restart: the
    journaled prefix is skipped, new events past it arrive once."""
    runs = [[0, 1, 2], [0, 1, 2], [0, 1, 2, 3], [0, 1, 2, 3]]
    out = {pkg: _subject_runs(pkg, backend(pkg, tmp_path / pkg), runs, True)
           for pkg in PKGS}
    assert out["torch"] == out["jax"] == [
        [0, 1, 2], [0, 1, 2], [0, 1, 2, 3], [0, 1, 2, 3]]


def test_broker_style_subject_not_prefix_skipped(tmp_path):
    """A subject that delivers only new events after a restart keeps all
    of them, though its auto-keys restart at 0."""
    out = {pkg: _subject_runs(pkg, backend(pkg, tmp_path / pkg),
                              [[0, 1, 2], [3, 4]], False) for pkg in PKGS}
    assert out["torch"] == out["jax"] == [[0, 1, 2], [0, 1, 2, 3, 4]]


def test_http_read_deterministic_rerun_is_replays_from_scratch():
    """``io.http.read(deterministic_rerun=)`` reaches the source's
    ``replays_from_scratch``, which picks the prefix skip."""
    pw, pg = PKGS["torch"]
    got = {}
    for flag in (True, False):
        pg.G.clear()
        t = pw.io.http.read("http://127.0.0.1:1/x", deterministic_rerun=flag)
        got[flag] = t._node.params["source"].replays_from_scratch
    pg.G.clear()
    assert got == {True: True, False: False}


def test_static_table_journal_replays_once(tmp_path):
    """A static table under persistence: its journal replays on a
    restart and the rows arrive once (``tests/test_streaming.py``)."""
    def scenario(pkg, root):
        pw, pg = PKGS[pkg]
        be = backend(pkg, root)

        def run_once():
            pg.G.clear()
            t = pw.debug.table_from_markdown("""
                | v
              1 | 10
              2 | 20
                """)
            got = []
            pw.io.subscribe(t, on_change=lambda key, row, time, is_addition:
                            got.append(row["v"]))
            run(pkg, persistence_config=pw.persistence.Config(be))
            return sorted(got)

        return run_once(), run_once(), journal_events(be)

    out = both(scenario, tmp_path)
    assert out["torch"] == out["jax"]
    assert out["torch"][:2] == ([10, 20], [10, 20])
    assert out["torch"][2] == collections.Counter({((10,), 1): 1,
                                                   ((20,), 1): 1})


def test_object_store_backends_wait_for_io_s3():
    """The object-store backends came with ``io.s3``: both build over its
    client seam and keep a journal record an object
    (``tests/test_torch_io_cloud.py`` holds them to the JAX package's)."""
    import chip_smoke
    from pathway_tpu_torch.persistence import AzureBackend, S3Backend

    pw, _pg = PKGS["torch"]
    client = chip_smoke.MemS3()
    settings = pw.io.s3.AwsS3Settings(_client=client)
    s3 = pw.persistence.Backend.s3("s3://bucket/main", settings)
    azure = pw.persistence.Backend.azure("s3://bucket/az", settings)
    assert type(s3) is S3Backend and type(azure) is AzureBackend
    for be in (s3, azure):
        be.append("input_0", b"r0")
        assert be.read_all("input_0") == [b"r0"]
    assert sorted(k for _b, k in client.objects) == [
        "az/streams/input_0/000000000000",
        "main/streams/input_0/000000000000"]


def test_an_unreadable_journal_stamp_raises(tmp_path):
    """The stamp is written atomically: one that does not parse means
    storage of another program, and the run raises before replaying it
    (the JAX package reads it as a torn write and guesses)."""
    pw, pg = PKGS["torch"]
    be = backend("torch", tmp_path)
    be.put_metadata("journal_format", b"not-a-version")
    pg.G.clear()
    t = pw.debug.table_from_markdown("""
        | v
      1 | 10
        """)
    pw.io.subscribe(t, on_change=lambda **kw: None)
    with pytest.raises(RuntimeError, match="journal format stamp"):
        run("torch", persistence_config=pw.persistence.Config(be))


def test_monitoring_none_runs_and_other_levels_raise():
    pw, pg = PKGS["torch"]
    pg.G.clear()
    t = pw.debug.table_from_markdown("""
        | v
      1 | 10
        """)
    got = []
    pw.io.subscribe(t, on_change=lambda key, row, time, is_addition:
                    got.append(row["v"]))
    pw.run(device="cpu", monitoring_level=pw.MonitoringLevel.NONE)
    pw.run(device="cpu", monitoring_level=None)
    assert got == [10, 10]
    for level in pw.MonitoringLevel:
        if level is not pw.MonitoringLevel.NONE:
            with pytest.raises(NotImplementedError, match="monitoring"):
                pw.run(device="cpu", monitoring_level=level)
