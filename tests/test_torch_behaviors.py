"""The port's temporal behaviors (buffer, freeze, forget, the
forget-immediately idiom, window cutoffs) against the JAX package's, and
the state bounds of ``tests/test_temporal_stress.py`` held on the port.

The behavior cases mirror ``tests/test_behaviors.py``: the captured
update streams of both packages must be equal as multisets of (key, row,
time, diff).  The stress cases run at N = 2,000 rows a side: the port's
captures must equal the JAX package's, each operator kind's summed
``state_size()`` must equal the JAX package's, and stay within the bound
that ``tests/test_temporal_stress.py`` states.
"""

import random

import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.engine.runner import GraphRunner as JRunner
from pathway_tpu.internals import parse_graph as jpg
from pathway_tpu_torch.engine.runner import GraphRunner as TRunner
from pathway_tpu_torch.internals import parse_graph as tpg

from .torch_parity import equal_to_jax, fresh_port  # noqa: F401

N = 2000


@pytest.fixture(autouse=True)
def _fresh(fresh_port):  # noqa: F811
    yield


def _md(pw, text):
    return pw.debug.table_from_markdown(text)


# -- tests/test_behaviors.py ------------------------------------------------

def forget_immediately_and_filter(pw):
    queries = _md(pw, """
        | q | __time__
        | a | 0
        | b | 2
    """)
    one_shot = queries._forget_immediately()
    upper = one_shot.select(q=pw.this.q.str.upper())
    return upper._filter_out_results_of_forgetting(), upper


def buffer_delays_until_frontier(pw):
    t = _md(pw, """
        | v | thr | now | __time__
        | 1 | 5   | 1   | 0
        | 2 | 2   | 3   | 2
        | 3 | 3   | 6   | 4
    """)
    return t._buffer(t.thr, t.now)


def freeze_drops_late_rows(pw):
    t = _md(pw, """
        | v | thr | now | __time__
        | 1 | 10  | 4   | 0
        | 2 | 3   | 5   | 2
    """)
    return t._freeze(t.thr, t.now)


def forget_retracts_expired(pw):
    t = _md(pw, """
        | v | thr | now | __time__
        | 1 | 3   | 1   | 0
        | 2 | 99  | 5   | 2
    """)
    return (t._forget(t.thr, t.now, mark_forgetting_records=False),
            t._forget(t.thr, t.now))


def windowby_cutoff_behavior(pw):
    t = _md(pw, """
        | t | v | __time__
        | 1 | 1 | 0
        | 2 | 1 | 2
        | 25 | 1 | 4
        | 3 | 1 | 6
    """)
    return t.windowby(
        t.t, window=pw.temporal.tumbling(duration=10),
        behavior=pw.temporal.common_behavior(cutoff=0),
    ).reduce(start=pw.this._pw_window_start, c=pw.reducers.count())


def windowby_keep_results_false(pw):
    t = _md(pw, """
        | t | v | __time__
        | 1 | 1 | 0
        | 25 | 1 | 2
    """)
    return t.windowby(
        t.t, window=pw.temporal.tumbling(duration=10),
        behavior=pw.temporal.common_behavior(cutoff=0, keep_results=False),
    ).reduce(start=pw.this._pw_window_start, c=pw.reducers.count())


def windowby_delay_behavior(pw):
    t = _md(pw, """
        | t  | v | __time__
        | 1  | 1 | 0
        | 4  | 2 | 2
        | 13 | 3 | 4
        | 30 | 4 | 6
    """)
    return t.windowby(
        t.t, window=pw.temporal.tumbling(duration=10),
        behavior=pw.temporal.common_behavior(delay=5, cutoff=20),
    ).reduce(start=pw.this._pw_window_start, s=pw.reducers.sum(pw.this.v))


CASES = {f.__name__: f for f in (
    forget_immediately_and_filter, buffer_delays_until_frontier,
    freeze_drops_late_rows, forget_retracts_expired,
    windowby_cutoff_behavior, windowby_keep_results_false,
    windowby_delay_behavior,
)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_behavior_gives_the_jax_stream(case):
    equal_to_jax(CASES[case], stream=True)


# -- tests/test_temporal_stress.py at N = 2,000 ------------------------------

def _schema(pw):
    class S(pw.Schema):
        t: int
        v: int

    return S


def _rows_uniform(seed):
    rng = random.Random(seed)
    return [(rng.randrange(N), i) for i in range(N)]


def interval_join_arrangement(pw):
    S = _schema(pw)
    L = pw.debug.table_from_rows(S, _rows_uniform(0))
    R = pw.debug.table_from_rows(S, _rows_uniform(1))
    return L.interval_join(R, L.t, R.t, pw.temporal.interval(-2, 2)).select(
        a=L.v, b=R.v)


def _monotone(pw, n, behavior, interval=(-2, 2)):
    S = _schema(pw)
    L = pw.debug.table_from_rows(S, [(i, i, 2 * i, 1) for i in range(n)],
                                 is_stream=True)
    R = pw.debug.table_from_rows(
        S, [(i, 10_000 + i, 2 * i, 1) for i in range(n)], is_stream=True)
    return L.interval_join(R, L.t, R.t, pw.temporal.interval(*interval),
                           behavior=behavior(pw)).select(a=L.v, b=R.v)


def interval_join_forgetting(pw):
    return _monotone(pw, N, lambda pw: pw.temporal.common_behavior(
        cutoff=16, keep_results=False))


def interval_join_keep_results(pw):
    return _monotone(pw, N, lambda pw: pw.temporal.common_behavior(cutoff=16))


def interval_join_negative_interval(pw):
    return _monotone(pw, 200, lambda pw: pw.temporal.common_behavior(
        cutoff=3), interval=(-10, -5))


def sliding_window_state(pw):
    # 160 windows of 100 rows: a window state that kept history would
    # hold ~16,000 entries against the bound's 2,000
    S = _schema(pw)
    n = 4 * N
    t = pw.debug.table_from_rows(
        S, [(i, i % 7, 2 * i, 1) for i in range(n)], is_stream=True)
    return t.windowby(
        t.t, window=pw.temporal.sliding(duration=100, hop=50),
        behavior=pw.temporal.common_behavior(cutoff=100, keep_results=False),
    ).reduce(start=pw.this._pw_window_start, c=pw.reducers.count())


# (program, operator class name, bound on its summed state_size(),
#  bound on the captured rows) — the bounds of tests/test_temporal_stress.py
STRESS = {
    "interval_join_arrangement": (interval_join_arrangement, "JoinOperator",
                                  10 * N, None),
    "interval_join_forgetting": (interval_join_forgetting, "JoinOperator",
                                 600, None),
    "interval_join_keep_results": (interval_join_keep_results,
                                   "JoinOperator", 600, None),
    "interval_join_negative_interval": (interval_join_negative_interval,
                                        "JoinOperator", None, None),
    "sliding_window_state": (sliding_window_state, "GroupbyOperator", 2000,
                             10),
}


def _run(pw, runner_cls, pg, build, **kw):
    pg.G.clear()
    try:
        sink = build(pw)._materialize_capture()
        runner = runner_cls([sink], **kw)
        [cap] = list(runner.run_batch().values())
        return cap.squash(), runner.lg.scheduler.operators
    finally:
        pg.G.clear()


@pytest.mark.parametrize("case", sorted(STRESS))
def test_state_stays_within_the_stress_bound(case):
    build, op_name, state_bound, live_bound = STRESS[case]
    want, jops = _run(jpw, JRunner, jpg, build)
    got, tops = _run(tpw, TRunner, tpg, build, device="cpu")
    assert got == want

    def size(ops):
        picked = [op for op in ops if type(op).__name__ == op_name]
        assert picked, op_name
        return sum(op.state_size() for op in picked)

    assert size(tops) == size(jops)
    if state_bound is not None:
        assert size(tops) <= state_bound, (case, size(tops))
    if live_bound is not None:
        assert len(got) <= live_bound
    if case == "interval_join_arrangement":
        assert len(got) < 8 * N
        emitted = sum(op.rows_out for op in tops
                      if type(op).__name__ == op_name)
        assert emitted <= 25 * N
    if case == "interval_join_keep_results":
        assert len(got) >= 5 * (N - 20) * 0.9
    if case == "interval_join_negative_interval":
        assert len(got) >= 5 * (200 - 30)
