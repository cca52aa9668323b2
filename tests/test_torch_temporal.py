"""The port's windows, temporal joins, sort, diff and ``intervals_over``
against the JAX package's.

One parametrised case for each case of ``tests/test_temporal.py`` and
``tests/test_temporal_edges.py``: the same program (markdown streams
with ``__time__``/``__diff__``) built in both packages; the captured
update streams must be equal as multisets of (key, row, time, diff),
keys and times included.  The port runs on the CPU.  A seeded stream of
2,000 rows drives windows and joins on the port's numpy and device
tiers.
"""

import numpy as np
import pytest

from .torch_parity import equal_to_jax, fresh_port  # noqa: F401


@pytest.fixture(autouse=True)
def _fresh(fresh_port):  # noqa: F811
    yield


def _md(pw, text):
    return pw.debug.table_from_markdown(text)


# -- tests/test_temporal.py -------------------------------------------------

def tumbling_window(pw):
    t = _md(pw, """
        | t  | v
      1 | 1  | 10
      2 | 3  | 20
      3 | 12 | 30
    """)
    return t.windowby(t.t, window=pw.temporal.tumbling(duration=10)).reduce(
        start=pw.this._pw_window_start, s=pw.reducers.sum(t.v),
        c=pw.reducers.count())


def sliding_window(pw):
    t = _md(pw, """
        | t | v
      1 | 5 | 1
    """)
    return t.windowby(t.t, window=pw.temporal.sliding(hop=5, duration=10)
                      ).reduce(start=pw.this._pw_window_start,
                               c=pw.reducers.count())


def session_window(pw):
    t = _md(pw, """
        | t  | v
      1 | 1  | 1
      2 | 2  | 1
      3 | 10 | 1
    """)
    return t.windowby(t.t, window=pw.temporal.session(max_gap=3)).reduce(
        start=pw.this._pw_window_start, end=pw.this._pw_window_end,
        c=pw.reducers.count())


def _interval_sides(pw, right_rows):
    left = _md(pw, """
        | t | a
      1 | 0 | l0
      2 | 10 | l10
    """)
    return left, _md(pw, right_rows)


def interval_join_inner(pw):
    left, right = _interval_sides(pw, """
        | t | b
      5 | 1 | r1
      6 | 20 | r20
    """)
    return left.interval_join(right, left.t, right.t,
                              pw.temporal.interval(-2, 2)).select(
        a=left.a, b=right.b)


def interval_join_left(pw):
    left, right = _interval_sides(pw, """
        | t | b
      5 | 1 | r1
    """)
    return left.interval_join_left(right, left.t, right.t,
                                   pw.temporal.interval(-2, 2)).select(
        a=left.a, b=right.b)


def window_join(pw):
    left = _md(pw, """
        | t | a
      1 | 1 | x
    """)
    right = _md(pw, """
        | t | b
      5 | 2 | y
      6 | 11 | z
    """)
    return left.window_join(right, left.t, right.t,
                            pw.temporal.tumbling(duration=10)).select(
        a=left.a, b=right.b)


def asof_join(pw):
    trades = _md(pw, """
        | t  | sym | price
      1 | 5  | A   | 100
      2 | 15 | A   | 110
    """)
    quotes = _md(pw, """
        | t  | sym | bid
      5 | 3  | A   | 99
      6 | 10 | A   | 105
    """)
    return trades.asof_join(quotes, trades.t, quotes.t,
                            trades.sym == quotes.sym).select(
        price=trades.price, bid=quotes.bid)


def asof_join_no_match_left(pw):
    trades = _md(pw, """
        | t | sym | price
      1 | 1 | A   | 100
    """)
    quotes = _md(pw, """
        | t | sym | bid
      5 | 5 | A   | 99
    """)
    return trades.asof_join(quotes, trades.t, quotes.t,
                            trades.sym == quotes.sym, how="left").select(
        price=trades.price, bid=quotes.bid)


def asof_now_join_answers_once(pw):
    data = _md(pw, """
        | k | v | __time__
      1 | a | 1 | 0
      2 | a | 9 | 4
    """)
    queries = _md(pw, """
        | k | __time__
      5 | a | 2
    """)
    return queries.asof_now_join(data, queries.k == data.k).select(v=data.v)


def sort_prev_next(pw):
    t = _md(pw, """
        | v
      1 | 30
      2 | 10
      3 | 20
    """)
    ptrs = t.sort(key=t.v)
    prev_row = t.ix(ptrs.prev, optional=True)
    return t.select(v=t.v, prev_v=prev_row.v), ptrs


def diff(pw):
    t = _md(pw, """
        | t | v
      1 | 1 | 10
      2 | 2 | 15
      3 | 3 | 25
    """)
    return t.diff(t.t, t.v)


def intervals_over_outer_emits_empty_windows(pw):
    t = _md(pw, """
        | t | v
      1 | 1 | 1
    """)
    probes = _md(pw, """
        | pt
      7 | 2
      8 | 10
    """)
    return t.windowby(t.t, window=pw.temporal.intervals_over(
        at=probes.pt, lower_bound=-2, upper_bound=0, is_outer=True)).reduce(
        end=pw.this._pw_window_end, c=pw.reducers.count())


def intervals_over(pw):
    t = _md(pw, """
        | t | v
      1 | 1 | 1
      2 | 2 | 1
      3 | 5 | 1
    """)
    probes = _md(pw, """
        | pt
      7 | 2
      8 | 6
    """)
    return t.windowby(t.t, window=pw.temporal.intervals_over(
        at=probes.pt, lower_bound=-2, upper_bound=0)).reduce(
        end=pw.this._pw_window_end, c=pw.reducers.count())


# -- tests/test_temporal_edges.py -------------------------------------------

def tumbling_window_late_row_updates_closed_window(pw):
    t = _md(pw, """
        | t  | v | __time__
        | 1  | 1 | 0
        | 3  | 1 | 0
        | 12 | 1 | 2
        | 2  | 1 | 4
    """)
    return t.windowby(t.t, window=pw.temporal.tumbling(duration=10)).reduce(
        start=pw.this._pw_window_start, c=pw.reducers.count())


def tumbling_window_exactly_once_behavior_drops_late(pw):
    t = _md(pw, """
        | t  | v | __time__
        | 1  | 1 | 0
        | 3  | 1 | 0
        | 22 | 1 | 2
        | 2  | 1 | 4
    """)
    return t.windowby(
        t.t, window=pw.temporal.tumbling(duration=10),
        behavior=pw.temporal.exactly_once_behavior(),
    ).reduce(start=pw.this._pw_window_start, c=pw.reducers.count())


def interval_join_late_left_row(pw):
    left = _md(pw, """
        | t | a | __time__
        | 1 | x | 0
        | 9 | y | 4
    """)
    right = _md(pw, """
        | t | b | __time__
        | 2 | p | 0
        | 8 | q | 2
    """)
    return left.interval_join(right, left.t, right.t,
                              pw.temporal.interval(-2, 2)).select(
        a=left.a, b=right.b)


def asof_join_with_updates_stream_consistent(pw):
    left = _md(pw, """
          | t | a | __time__ | __diff__
        1 | 5 | x | 0        | 1
        1 | 5 | x | 2        | -1
        1 | 6 | x | 2        | 1
    """)
    right = _md(pw, """
        | t | r | __time__
        | 4 | A | 0
        | 6 | B | 2
    """)
    return left.asof_join(right, left.t, right.t, how=pw.JoinMode.LEFT
                          ).select(a=left.a, r=right.r)


def session_window_merge_on_late_row(pw):
    t = _md(pw, """
        | t  | __time__
        | 1  | 0
        | 10 | 0
        | 5  | 2
    """)
    return t.windowby(t.t, window=pw.temporal.session(max_gap=6)).reduce(
        c=pw.reducers.count())


def stream_equal_utility_wordcount(pw):
    t = _md(pw, """
        | w | __time__
        | a | 0
        | a | 2
    """)
    return t.groupby(t.w).reduce(w=t.w, c=pw.reducers.count())


def deduplicate_ignores_upstream_retractions_documented(pw):
    t = _md(pw, """
        | v | __time__ | __diff__
        | 1 | 0        | 1
        | 5 | 2        | 1
        | 5 | 4        | -1
    """)
    return t.deduplicate(value=t.v, acceptor=lambda new, old: new > old)


def windowby_sliding_late_data_consistency(pw):
    t = _md(pw, """
        | t | __time__
        | 0 | 0
        | 4 | 0
        | 2 | 4
    """)
    return t.windowby(t.t, window=pw.temporal.sliding(hop=2, duration=4)
                      ).reduce(start=pw.this._pw_window_start,
                               c=pw.reducers.count())


_FORGET_ROWS = """
        | v | ts | __time__
    1   | a | 0  | 2
    2   | b | 10 | 4
"""


def public_forget_buffer_and_eval_type(pw):
    t = _md(pw, _FORGET_ROWS)
    t2 = _md(pw, _FORGET_ROWS)
    t4 = _md(pw, _FORGET_ROWS)
    kept = t4.forget(t4.ts, 2, mark_forgetting_records=True) \
             .filter_out_results_of_forgetting()
    return t.forget(t.ts, 2), t2.buffer(t2.ts, 2), kept


CASES = {f.__name__: f for f in (
    tumbling_window, sliding_window, session_window, interval_join_inner,
    interval_join_left, window_join, asof_join, asof_join_no_match_left,
    asof_now_join_answers_once, sort_prev_next, diff,
    intervals_over_outer_emits_empty_windows, intervals_over,
    tumbling_window_late_row_updates_closed_window,
    tumbling_window_exactly_once_behavior_drops_late,
    interval_join_late_left_row, asof_join_with_updates_stream_consistent,
    session_window_merge_on_late_row, stream_equal_utility_wordcount,
    deduplicate_ignores_upstream_retractions_documented,
    windowby_sliding_late_data_consistency,
    public_forget_buffer_and_eval_type,
)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_case_gives_the_jax_stream(case):
    got = equal_to_jax(CASES[case], stream=True)
    assert all(got), "every output emits"


def test_eval_type_is_the_jax_packages():
    import pathway_tpu as jpw
    import pathway_tpu_torch as tpw

    for pw in (jpw, tpw):
        t = _md(pw, """
            a | b
            1 | 2.5
        """)
        assert str(t.eval_type(t.a + 1)) == "INT"
        assert str(t.eval_type(t.b * 2)) == "FLOAT"


# -- a seeded stream on both tiers --------------------------------------------

def _seeded_rows(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    ts = rng.integers(0, 1000, n)
    vs = rng.integers(0, 100, n)
    ks = rng.integers(0, 16, n)
    times = 2 * (1 + np.arange(n) * 4 // n)  # four __time__ batches
    return [(int(i), int(t), int(v), int(k), int(tm))
            for i, (t, v, k, tm) in enumerate(zip(ts, vs, ks, times))]


def _seeded_tables(pw, rows):
    class Ev(pw.Schema):
        i: int = pw.column_definition(primary_key=True)
        t: int
        v: int
        k: int

    left = pw.debug.table_from_rows(
        Ev, [r[:4] + (r[4], 1) for r in rows], is_stream=True)
    right = pw.debug.table_from_rows(
        Ev, [r[:4] + (r[4], 1) for r in rows[::7]], is_stream=True)
    return left, right


@pytest.mark.parametrize("tier", ["numpy", "device"])
def test_seeded_windows_and_joins_on_both_tiers(tier, monkeypatch):
    rows = _seeded_rows(3, 2000)

    def build(pw):
        left, right = _seeded_tables(pw, rows)
        tumble = left.windowby(
            left.t, window=pw.temporal.tumbling(duration=50),
            instance=left.k,
            behavior=pw.temporal.common_behavior(cutoff=100),
        ).reduce(start=pw.this._pw_window_start, inst=pw.this._pw_instance,
                 n=pw.reducers.count(), s=pw.reducers.sum(pw.this.v),
                 mx=pw.reducers.max(pw.this.v))
        slide = left.windowby(
            left.t, window=pw.temporal.sliding(hop=20, duration=60),
        ).reduce(start=pw.this._pw_window_start, n=pw.reducers.count(),
                 mn=pw.reducers.min(pw.this.v))
        ij = left.interval_join(right, left.t, right.t,
                                pw.temporal.interval(-5, 5),
                                left.k == right.k).select(
            li=left.i, ri=right.i)
        wj = left.window_join(right, left.t, right.t,
                              pw.temporal.tumbling(duration=100),
                              left.k == right.k).select(li=left.i,
                                                        ri=right.i)
        aj = left.asof_join(right, left.t, right.t, left.k == right.k
                            ).select(li=left.i, rv=right.v)
        df = left.diff(left.t, left.v, instance=left.k)
        return tumble, slide, ij, wj, aj, df

    got = equal_to_jax(build, monkeypatch, tiers=(tier,))
    assert all(len(g) > 10 for g in got)
