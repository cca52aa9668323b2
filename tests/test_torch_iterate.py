"""The port's ``pw.iterate``, ``iteration_limit`` and gradual broadcast
against the JAX package's.

``iterate`` runs ``tests/test_common.py::test_iterate_collatz``'s
program, min-label propagation over a seeded graph (its fixed point
equals a union-find's components), a body with two fed-back tables, and
an ``iteration_limit`` that stops before the fixed point.  Gradual
broadcast runs ``tests/test_gradual_broadcast.py``'s single-process
cases: the port's update streams equal the JAX package's, and the
approximate values equal the threshold rule.
"""

import numpy as np
import pytest

import chip_smoke as cs
from pathway_tpu_torch.engine.gradual_broadcast import _threshold_key

from .torch_parity import equal_to_jax, fresh_port  # noqa: F401


@pytest.fixture(autouse=True)
def _fresh(fresh_port):  # noqa: F811
    yield


def collatz(pw):
    def collatz_step(t):
        return t.select(a=pw.if_else(
            t.a == 1, 1, pw.if_else(t.a % 2 == 0, t.a // 2, 3 * t.a + 1)))

    start = pw.debug.table_from_markdown("""
        | a
      1 | 7
      2 | 12
      3 | 1
    """)
    return pw.iterate(lambda t: collatz_step(t), t=start)


def test_iterate_collatz_gives_the_jax_rows():
    [state] = equal_to_jax(collatz, stream=True)
    assert sorted(r for (_k, r, _t, _d) in state) == [(1,), (1,), (1,)]


def test_iteration_limit_stops_before_the_fixed_point():
    def build(pw):
        def halve(t):
            return t.select(a=pw.if_else(t.a > 1, t.a // 2, t.a))

        start = pw.debug.table_from_markdown("""
            | a
          1 | 64
          2 | 5
        """)
        return pw.iterate(halve, iteration_limit=pw.iteration_limit(3),
                          t=start)

    [state] = equal_to_jax(build)
    assert sorted(state.values()) == [(1,), (8,)]


def _edges(seed: int, n_nodes: int, n_edges: int) -> list:
    rng = np.random.default_rng(seed)
    a = rng.integers(0, n_nodes, n_edges)
    b = rng.integers(0, n_nodes, n_edges)
    return [(int(x), int(y)) for x, y in zip(a, b)]


def test_min_label_propagation_equals_union_find():
    edges = _edges(0, 200, 150)
    # the program phase 4k of chip_smoke.py runs, and its union-find
    [state] = equal_to_jax(lambda pw: cs.min_label_components(pw, edges))
    comp = cs.union_find(edges)
    # a component's least vertex is its union-find root
    assert {n: lab for n, lab in state.values()} == comp


def test_iterate_with_two_fed_back_tables():
    def build(pw):
        def body(a, b):
            na = a.select(x=pw.if_else(a.x < 10, a.x + 1, a.x))
            nb = b.select(y=pw.if_else(b.y > 0, b.y - 2, b.y))
            return {"a": na, "b": nb}

        a = pw.debug.table_from_markdown("""
            | x
          1 | 3
          2 | 8
        """)
        b = pw.debug.table_from_markdown("""
            | y
          1 | 7
        """)
        res = pw.iterate(body, a=a, b=b)
        return res["a"], res["b"]

    got_a, got_b = equal_to_jax(build)
    assert sorted(got_a.values()) == [(10,), (10,)]
    assert list(got_b.values()) == [(-1,)]


# -- gradual broadcast ---------------------------------------------------------

def _bcast(pw, rows, thr_rows, pk=False):
    class S(pw.Schema):
        v: int

    class SP(pw.Schema):
        v: int = pw.column_definition(primary_key=True)

    class T(pw.Schema):
        lower: float
        value: float
        upper: float

    t = (pw.debug.table_from_rows(SP, rows, is_stream=True) if pk
         else pw.debug.table_from_rows(S, rows))
    thr = pw.debug.table_from_rows(T, thr_rows, is_stream=True)
    return t._gradual_broadcast(thr, thr.lower, thr.value, thr.upper)


def _rule(state, triplet):
    lower, value, upper = triplet
    thr = _threshold_key(lower, value, upper)
    return all(row[-1] == (upper if int(k) < thr else lower)
               for k, row in state.items())


def test_gradual_broadcast_matches_full_recompute():
    rows = [(i,) for i in range(500)]
    build = lambda pw: _bcast(pw, rows, [(0.0, 5.0, 10.0, 0, 1)])  # noqa: E731
    [stream] = equal_to_jax(build, stream=True)
    [state] = equal_to_jax(build)
    assert _rule(state, (0.0, 5.0, 10.0))
    assert {row[1] for row in state.values()} == {0.0, 10.0}


def test_gradual_broadcast_incremental_no_full_recompute():
    n = 400
    rows = [(i,) for i in range(n)]
    thr_rows = [(0.0, 5.0, 10.0, 0, 1), (0.0, 5.0, 10.0, 2, -1),
                (0.0, 5.5, 10.0, 2, 1)]
    build = lambda pw: _bcast(pw, rows, thr_rows)  # noqa: E731
    [stream] = equal_to_jax(build, stream=True)
    [state] = equal_to_jax(build)
    assert _rule(state, (0.0, 5.5, 10.0))
    later = sum(n_ for (_k, _r, t, _d), n_ in stream.items() if t >= 2)
    assert 0 < later < n


def test_gradual_broadcast_row_churn():
    rows = [(i, 0, 1) for i in range(50)] + [(99, 4, 1)] + [(0, 6, -1)]
    build = lambda pw: _bcast(  # noqa: E731
        pw, rows, [(0.0, 3.0, 10.0, 2, 1)], pk=True)
    [stream] = equal_to_jax(build, stream=True)
    [state] = equal_to_jax(build)
    assert len(state) == 50
    assert _rule(state, (0.0, 3.0, 10.0))
