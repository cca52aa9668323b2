"""``pw.Table`` programs of the port against the JAX package's.

Each case builds the same program in both packages from the same rows
(markdown streams with ``__time__``/``__diff__`` retractions, or rows
drawn with numpy from a seed), captures ``run_tables(...)[i].squash()``
and asserts the captures are EQUAL, keys included.  The port runs on the
CPU (``device="cpu"``); the columnar cases run it on its numpy tier, its
device tier (the crossovers pinned low) and its row path.  Also: one
hypothesis property over random rows, ``pw.run`` with ``io.subscribe``
over a live subject, the debug printers, gradual broadcast and a
fully-async select.
"""

import io
import os
import contextlib

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.engine import runner as jrunner
from pathway_tpu.internals import parse_graph as jpg
from pathway_tpu_torch.engine import runner as trunner
from pathway_tpu_torch.engine import vectorize as tvec
from pathway_tpu_torch.internals import parse_graph as tpg
from pathway_tpu_torch.internals.datasource import SubjectDataSource
from pathway_tpu_torch.internals.table import Table, Universe
from pathway_tpu_torch.internals.trace import EngineErrorWithTrace
from pathway_tpu_torch.obs import costdb, planner
from pathway_tpu_torch.parallel import cluster as tcluster
from pathway_tpu_torch.parallel import mapreduce as tmr

PACKAGES = {"jax": (jpw, jrunner, jpg), "torch": (tpw, trunner, tpg)}


@pytest.fixture(autouse=True)
def _fresh_port(tmp_path, monkeypatch):
    monkeypatch.setenv("PW_COSTDB_PATH", str(tmp_path / "costdb.json"))
    costdb.shutdown()
    planner.invalidate_cache()
    tpg.G.clear()
    yield
    tpg.G.clear()
    costdb.shutdown()
    planner.invalidate_cache()


def _named(state):
    return {
        k: tuple("<Error>" if type(v).__name__ == "Error" else v for v in row)
        for k, row in state.items()
    }


def _capture(pkg, build, tier="numpy", monkeypatch=None):
    pw, runner, pg = PACKAGES[pkg]
    kw = {}
    with contextlib.ExitStack() as stack:
        if pkg == "torch":
            kw["device"] = "cpu"
            m = stack.enter_context(monkeypatch.context())
            low = 64 if tier == "device" else 1 << 40
            m.setattr(tvec, "DEVICE_THRESHOLD", low)
            m.setattr(tmr, "_JIT_MIN_ELEMENTS", low)
            if tier == "row":
                m.setattr(tvec, "compile_plan", lambda *a, **k: None)
                m.setattr(runner, "_groupby_simple_spec",
                          lambda *a, **k: None)
                m.setattr(runner, "_join_simple_spec", lambda *a, **k: None)
        pg.G.clear()
        out = build(pw)
        outs = out if isinstance(out, tuple) else (out,)
        n_threads = int(os.environ.get("PATHWAY_THREADS", "1"))
        if pkg == "torch" and n_threads > 1:
            # the matrix leg (tests/test_torch_matrix.py): the port's
            # sharded data plane against the JAX package's single shard
            caps = tcluster.run_tables_sharded(*outs, n_shards=n_threads,
                                               **kw)
        else:
            caps = runner.run_tables(*outs, **kw)
        pg.G.clear()
    return [_named(c.squash()) for c in caps]


def _equal_to_jax(build, monkeypatch, tiers=("numpy", "device", "row")):
    expected = _capture("jax", build)
    for tier in tiers:
        assert _capture("torch", build, tier, monkeypatch) == expected, tier
    return expected


# -- markdown streams with retractions --------------------------------------

LEFT = """
    | k | g | v  | __time__ | __diff__
  1 | 1 | a | 10 | 2        | 1
  2 | 2 | b | 20 | 2        | 1
  3 | 3 | a | 30 | 4        | 1
  1 | 1 | a | 10 | 6        | -1
  4 | 4 | b | 5  | 6        | 1
  5 | 2 | c | 7  | 8        | 1
"""

RIGHT = """
    | k | w   | __time__ | __diff__
  7 | 1 | one | 2        | 1
  8 | 2 | two | 4        | 1
  9 | 5 | six | 4        | 1
  8 | 2 | two | 8        | -1
 10 | 3 | tri | 8        | 1
"""


def _md(pw, text):
    return pw.debug.table_from_markdown(text)


def test_select_filter_groupby_over_a_stream(monkeypatch):
    def build(pw):
        t = _md(pw, LEFT)
        s = t.select(t.g, x=t.v * 3 - t.k, y=t.v * 0.5)
        f = s.filter(s.x > 10)
        return f.groupby(f.g).reduce(
            f.g, n=pw.reducers.count(), s=pw.reducers.sum(f.x),
            mn=pw.reducers.min(f.y), mx=pw.reducers.max(f.x),
            av=pw.reducers.avg(f.x))

    got = _equal_to_jax(build, monkeypatch)
    assert {r[0] for r in got[0].values()} == {"a", "b", "c"}


@pytest.mark.parametrize("how", ["inner", "left", "right", "outer"])
def test_join_over_streams(how, monkeypatch):
    def build(pw):
        lt, rt = _md(pw, LEFT), _md(pw, RIGHT)
        return lt.join(rt, lt.k == rt.k, how=how).select(
            k=pw.left.k, v=pw.left.v, w=pw.right.w)

    _equal_to_jax(build, monkeypatch)


def test_concat_reindex_and_concat(monkeypatch):
    def build(pw):
        lt, rt = _md(pw, LEFT), _md(pw, RIGHT)
        a = lt.select(k=lt.k, s=lt.g)
        b = rt.select(k=rt.k, s=rt.w)
        return a.concat_reindex(b), a.filter(a.k < 3).concat(
            a.filter(a.k >= 3))

    _equal_to_jax(build, monkeypatch)


def test_ix_and_having(monkeypatch):
    def build(pw):
        lt, rt = _md(pw, LEFT), _md(pw, RIGHT)
        keyed = rt.with_id_from(rt.k)
        looked = keyed.ix(keyed.pointer_from(lt.k), optional=True)
        return (lt.select(v=lt.v, w=looked.w),
                lt.having(keyed.pointer_from(lt.k)))

    _equal_to_jax(build, monkeypatch)


def test_update_rows_and_cells(monkeypatch):
    base_md = """
        | a | b
      1 | 1 | x
      2 | 2 | y
      3 | 3 | z
    """
    over_md = """
        | a  | b  | __time__ | __diff__
      2 | 20 | yy | 2        | 1
      4 | 40 | ww | 2        | 1
      2 | 20 | yy | 4        | -1
    """
    cells_md = """
        | b  | __time__
      1 | xx | 2
      3 | zz | 4
    """

    def build(pw):
        base, over = _md(pw, base_md), _md(pw, over_md)
        cells = _md(pw, cells_md)
        return base.update_rows(over), base.update_cells(cells)

    _equal_to_jax(build, monkeypatch)


def test_deduplicate_and_flatten(monkeypatch):
    md = """
        | g | v | __time__
      1 | a | 1 | 2
      2 | a | 5 | 4
      3 | b | 2 | 4
      4 | a | 3 | 6
      5 | b | 9 | 8
    """

    def build(pw):
        t = _md(pw, md)
        dd = t.deduplicate(value=t.v, instance=t.g,
                           acceptor=lambda new, old: new > old)
        seqs = t.select(g=t.g, xs=pw.apply(lambda v: list(range(v)), t.v))
        return dd, seqs.flatten(seqs.xs)

    _equal_to_jax(build, monkeypatch)


def test_difference_intersect_and_reindex(monkeypatch):
    def build(pw):
        t = _md(pw, LEFT)
        small = t.filter(t.v < 15)
        rekeyed = t.with_id_from(t.g, t.k)
        return (t.difference(small), t.intersect(small),
                rekeyed.select(rekeyed.v))

    _equal_to_jax(build, monkeypatch)


def test_errors_poison_identically(monkeypatch):
    md = """
        | a | b
      1 | 4 | 2
      2 | 3 | 0
      3 | 9 | 3
    """

    def build(pw):
        t = _md(pw, md)
        return t.select(q=t.a // t.b, f=pw.fill_error(t.a // t.b, -1),
                        m=t.a % t.b)

    got = _equal_to_jax(build, monkeypatch)
    assert sorted(r[1] for r in got[0].values()) == [-1, 2, 3]


# -- columnar tables: the device tier and the join membership ---------------

def _big(pw, seed, n, keys, time=None):
    """``n`` seeded rows over ``keys`` int keys: one columnar batch, or
    (with ``time``) a stream whose rows all arrive at that time."""
    rng = np.random.default_rng(seed)

    class S(pw.Schema):
        k: int
        g: str
        v: float

    rows = [(int(k), f"g{int(g)}", float(v)) for k, g, v in zip(
        rng.integers(0, keys, n), rng.integers(0, 9, n), rng.random(n))]
    if time is None:
        return pw.debug.table_from_rows(S, rows)
    return pw.debug.table_from_rows(S, [r + (time, 1) for r in rows],
                                    is_stream=True)


def test_columnar_join_runs_the_device_membership(monkeypatch):
    """An inner join of a 3,000-row batch against a 200-key table: the
    membership pre-filter runs on the device tier and the output equals
    the JAX package's (whose own membership takes numpy here)."""

    def build(pw):
        dim = _big(pw, 1, 200, 400).groupby(pw.this.k).reduce(
            pw.this.k, c=pw.reducers.count())
        # the facts arrive after the dimension: their batch probes a
        # filled arrangement
        fact = _big(pw, 2, 3000, 1000, time=2)
        j = fact.join(dim, fact.k == dim.k).select(
            k=pw.left.k, v=pw.left.v, c=pw.right.c)
        return j.groupby(j.k).reduce(j.k, s=pw.reducers.sum(j.c),
                                     n=pw.reducers.count())

    before = tmr.STATS["member_device"]
    _equal_to_jax(build, monkeypatch)
    assert tmr.STATS["member_device"] > before


def test_run_tables_device_tier_ran(monkeypatch):
    def build(pw):
        t = _big(pw, 3, 2000, 50)
        s = t.select(k=t.k * 2 + 1, g=t.g, v=t.v * 0.25)
        f = s.filter(s.v > 0.1)
        return f.groupby(f.g).reduce(
            f.g, s=pw.reducers.sum(f.k), m=pw.reducers.max(f.v))

    tvec.STATS.update(device_batches=0)
    _equal_to_jax(build, monkeypatch, tiers=("device",))
    assert tvec.STATS["device_batches"] >= 2


# -- one property over random rows ------------------------------------------

_row = st.tuples(st.sampled_from(["a", "b", "c", "d"]),
                 st.integers(-1000, 1000),
                 st.floats(-100, 100, allow_nan=False),
                 st.integers(0, 3), st.sampled_from([1, 1, 1, -1]))


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(rows=st.lists(_row, min_size=1, max_size=60))
def test_random_streams_equal_the_jax_package(rows, monkeypatch):
    # a retraction only retracts a row inserted at an earlier time
    live: list = []
    stream = []
    for g, a, b, t, d in rows:
        if d < 0 and live:
            row = live.pop(0)
            stream.append(row[:3] + (2 * t + 2, -1))
        else:
            live.append((g, a, b))
            stream.append((g, a, b, 2 * t, 1))
    stream.sort(key=lambda r: r[3])
    seen: set = set()
    ordered = []
    for r in stream:  # drop a retraction sorted before its insertion
        if r[4] < 0 and r[:3] not in seen:
            continue
        seen.add(r[:3])
        ordered.append(r)

    def build(pw):
        class S(pw.Schema):
            g: str
            a: int
            b: float

        t = pw.debug.table_from_rows(S, ordered, is_stream=True)
        s = t.select(g=t.g, x=t.a * 3 - 7, y=t.b * 0.5, z=t.a < t.b)
        return s.groupby(s.g).reduce(
            s.g, n=pw.reducers.count(), sx=pw.reducers.sum(s.x),
            mx=pw.reducers.max(s.y), mn=pw.reducers.min(s.x))

    assert _capture("torch", build, "numpy", monkeypatch) == \
        _capture("jax", build)


# -- pw.run, subscribe, debug printers --------------------------------------

class _Subject:
    """A live source: pushes its rows from a thread, then closes."""

    def __init__(self, rows):
        self.rows = rows

    def _run(self, source):
        for row, diff in self.rows:
            source.push(row, diff)


def _live_table(rows):
    src = SubjectDataSource(_Subject(rows), ["g", "v"], primary_key_positions=[0])
    node = tpg.new_node("input", [], source=src)
    from pathway_tpu_torch.internals import dtype as dt

    return Table(node, ["g", "v"], {"g": dt.STR, "v": dt.INT}, Universe())


def test_pw_run_streams_a_live_subject_through_subscribe():
    t = _live_table([(("a", 1), 1), (("b", 2), 1), (("a", 1), -1),
                     (("a", 5), 1)])
    out = t.groupby(t.g).reduce(t.g, s=tpw.reducers.sum(t.v))
    changes, ended = [], []
    tpw.io.subscribe(out, on_change=lambda key, row, time, is_addition:
                     changes.append((row["g"], row["s"], is_addition)),
                     on_end=lambda: ended.append(True))
    tpw.run(device="cpu", idle_stop_s=2.0, timeout_s=30.0,
            autocommit_duration_ms=5)
    final: dict = {}
    for g, s, add in changes:
        if add:
            final[g] = s
        elif final.get(g) == s:
            del final[g]
    assert final == {"a": 5, "b": 2}
    assert ended == [True]


def _subscribed_rows(pw, **run_kw):
    t = pw.debug.table_from_markdown(LEFT)
    rows = []
    pw.io.subscribe(t, on_change=lambda key, row, time, is_addition:
                    rows.append((key, row["k"], row["v"], time, is_addition)))
    pw.run(**run_kw)
    return sorted(rows)


def test_pw_run_batch_and_the_refused_options(monkeypatch):
    """``pw.run`` in batch, and with the options the port once refused —
    the metrics server and monitoring — each giving the JAX package's
    subscribed rows; an option ``pw.run`` does not know still raises."""
    from pathway_tpu_torch.engine import telemetry

    jpg.G.clear()
    want = _subscribed_rows(jpw)
    jpg.G.clear()
    assert sorted(k for _key, k, _v, _t, add in want if add) == [1, 2, 2, 3, 4]
    assert [k for _key, k, _v, _t, add in want if not add] == [1]
    sock = __import__("socket").socket()
    sock.bind(("127.0.0.1", 0))
    monkeypatch.setattr(telemetry, "METRICS_PORT", sock.getsockname()[1])
    sock.close()
    for kw in ({}, {"with_http_server": True}, {"monitoring_level": "ALL"},
               {"monitoring_level": tpw.MonitoringLevel.IN_OUT}):
        tpg.G.clear()
        assert _subscribed_rows(tpw, device="cpu", **kw) == want, kw
    tpg.G.clear()
    tpw.debug.table_from_markdown(LEFT)
    with pytest.raises(TypeError, match="no_such_option"):
        tpw.run(device="cpu", no_such_option=1)


def test_pw_run_refuses_several_processes(tmp_path):
    """``PATHWAY_PROCESSES=2`` under ``spawn``: the two processes' sink,
    written once by process 0, equals the JAX package's single-process
    run of the same program."""
    from .torch_cluster import run_in_process, spawn_cluster, squash_jsonl

    script = tmp_path / "app.py"

    def make(out):
        script.write_text(
            "import pathway_tpu_torch as pw\n"
            f"t = pw.debug.table_from_markdown({LEFT!r})\n"
            "g = t.groupby(t.g).reduce(t.g, s=pw.reducers.sum(t.v))\n"
            f"pw.io.jsonlines.write(g, {str(out)!r})\n"
            "pw.run(device='cpu')\n")
        return script

    ref = tmp_path / "ref.jsonl"
    run_in_process(make(ref), "jax")
    out = tmp_path / "out.jsonl"
    spawn_cluster(make(out), processes=2)
    want = squash_jsonl(ref, ("g", "s"))
    assert want and squash_jsonl(out, ("g", "s")) == want


def test_debug_printers_equal_the_jax_package():
    outs = []
    for pw, pg in ((jpw, jpg), (tpw, tpg)):
        pg.G.clear()
        kw = {"device": "cpu"} if pw is tpw else {}
        t = pw.debug.table_from_markdown(LEFT)
        s = t.select(t.g, x=t.v * 2)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            pw.debug.compute_and_print(s, **kw)
            pw.debug.compute_and_print_update_stream(s, **kw)
        keys, cols = pw.debug.table_to_dicts(s, **kw)
        df = pw.debug.table_to_pandas(s, **kw)
        outs.append((buf.getvalue(), sorted(keys), cols, df.to_dict()))
        pg.G.clear()
    assert outs[0] == outs[1]


def test_table_from_pandas_equals_the_jax_package():
    import pandas as pd

    df = pd.DataFrame({"a": [3, 1, 2], "b": ["x", None, "z"],
                       "c": [0.5, float("nan"), 1.5]})
    caps = []
    for pw, pg in ((jpw, jpg), (tpw, tpg)):
        pg.G.clear()
        kw = {"device": "cpu"} if pw is tpw else {}
        t = pw.debug.table_from_pandas(df)
        caps.append(pw.debug.table_to_dicts(t.select(t.a, t.b, t.c), **kw))
        pg.G.clear()
    assert caps[0] == caps[1]


@pytest.mark.parametrize("kind", ["gradual_broadcast", "async"])
def test_a_kind_the_port_does_not_lower_raises_naming_it(kind, monkeypatch):
    """Named for what it checked before gradual broadcast and the async
    operators were ported (that lowering raised, naming the kind): each
    kind now runs and gives the JAX package's captures — the threshold
    rule's approximate values, and a fully-async select's resolved
    rows."""
    def build(pw):
        t = _md(pw, LEFT)
        if kind == "gradual_broadcast":
            thr = pw.debug.table_from_markdown("lo | va | up\n1 | 2 | 3")
            return t._gradual_broadcast(thr, thr.lo, thr.va, thr.up)
        async def triple(v):
            return v * 3

        return t.select(t.k, x=pw.udf(
            triple, executor=pw.udfs.fully_async_executor())(t.v))

    [got] = _equal_to_jax(build, monkeypatch, tiers=("numpy",))
    if kind == "gradual_broadcast":
        assert {r[-1] for r in got.values()} <= {1, 3}
    else:
        assert sorted(got.values()) == [(2, 21), (2, 60), (3, 90), (4, 15)]


def test_a_failing_udf_poisons_and_logs_to_the_port_error_log():
    from pathway_tpu_torch.engine.telemetry import global_error_log

    global_error_log.clear()
    t = tpw.debug.table_from_markdown(LEFT)
    out = t.select(x=tpw.apply(lambda v: 1 // (v - 20), t.v))
    [cap] = trunner.run_tables(out, device="cpu")
    vals = [r[0] for r in cap.squash().values()]
    assert any(type(v).__name__ == "Error" for v in vals)
    assert global_error_log.entries
    assert "ZeroDivisionError" in global_error_log.entries[0]["message"]
    with pytest.raises(EngineErrorWithTrace, match="terminate_on_error"):
        trunner.run_tables(t.select(x=tpw.apply(lambda v: 1 // (v - 20),
                                                t.v)),
                           device="cpu", terminate_on_error=True)
