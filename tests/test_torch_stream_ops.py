"""The port's change-stream operators (``to_stream``, ``stream_to_table``,
``from_streams``, ``unpack_snapshots``, ``Table.to``) against the JAX
package's, mirroring ``tests/test_streaming.py``'s cases: the captured
update streams of both packages must be equal as multisets of (key, row,
time, diff), keys included (events carry ids derived from the source
key and time, the same in both packages)."""

import pytest

import pathway_tpu_torch as tpw
from pathway_tpu_torch.internals import parse_graph as tpg

from .torch_parity import equal_to_jax, fresh_port  # noqa: F401


@pytest.fixture(autouse=True)
def _fresh(fresh_port):  # noqa: F811
    yield


OWNERS = """
    id | age | owner | __time__ | __diff__
     1 | 10  | Alice |     2    |     1
     2 | 9   | Bob   |     2    |     1
     1 | 10  | Alice |     4    |    -1
     1 | 11  | Alice |     4    |     1
     2 | 9   | Bob   |     6    |    -1
"""


def test_to_stream_gives_the_jax_events():
    def build(pw):
        s = pw.debug.table_from_markdown(OWNERS).to_stream()
        assert s.is_append_only()
        return s

    [events] = equal_to_jax(build, stream=True)
    assert all(d > 0 for (_k, _r, _t, d) in events)
    assert sorted((t, r[:2] + r[3:]) for (_k, r, t, _d) in events) == [
        (2, (9, "Bob", True)), (2, (10, "Alice", True)),
        (4, (11, "Alice", True)), (6, (9, "Bob", False))]


def test_stream_to_table_restores_the_source_ids():
    def build(pw):
        t = pw.debug.table_from_markdown(OWNERS)
        return t, t.to_stream().stream_to_table(is_upsert=pw.this.is_upsert)

    src, back = equal_to_jax(build, stream=True)
    assert sorted(r for (_k, r, _t, _d), n in back.items()) == sorted(
        r for (_k, r, _t, _d), n in src.items())
    [state] = equal_to_jax(
        lambda pw: pw.debug.table_from_markdown(OWNERS).to_stream()
        .stream_to_table(is_upsert=pw.this.is_upsert))
    assert sorted(state.values()) == [(11, "Alice")]


def test_from_streams_merges_two_streams():
    def build(pw):
        a = pw.debug.table_from_markdown("""
            id | v | is_upsert | __time__
             1 | x | True      | 2
             2 | z | True      | 2
        """)
        b = pw.debug.table_from_markdown("""
            id | v | is_upsert | __time__
             2 | y | True      | 4
             1 | x | False     | 6
        """)
        return pw.Table.from_streams(a, b, is_upsert=pw.this.is_upsert)

    [stream] = equal_to_jax(build, stream=True)
    [state] = equal_to_jax(build)
    # the same id in both streams: y replaces z, then x is deleted
    assert sorted(state.values()) == [("y",)]
    assert sum(stream.values()) == 5


def test_unpack_snapshots_gives_the_jax_snapshots():
    def build(pw):
        return pw.debug.table_from_markdown("""
            id | data | __time__ | __diff__
             1 | a    |    2     |    1
             2 | b    |    4     |    1
             2 | b    |    6     |   -1
             3 | d    |    6     |    1
        """).unpack_snapshots()

    [snaps] = equal_to_jax(build, stream=True)
    by_time: dict = {}
    for (_k, r, t, d), n in snaps.items():
        assert d > 0
        by_time.setdefault(t, []).extend([r[0]] * n)
    assert {t: sorted(v) for t, v in by_time.items()} == {
        2: ["a"], 4: ["a", "b"], 6: ["a", "d"]}


def test_table_to_a_writer_and_a_callable():
    t = tpw.debug.table_from_markdown("""
        a
        1
        2
    """)
    got = []

    class W:
        def write_batch(self, time_, colnames, updates):
            got.extend(updates)

        def close(self):
            pass

    t.to(W())
    tpw.run(device="cpu")
    assert sorted(r for _k, r, _d in got) == [(1,), (2,)]
    tpg.G.clear()
    t3 = tpw.debug.table_from_markdown("""
        a
        5
    """)
    seen = []
    t3.to(lambda table: seen.append(table))
    assert seen == [t3]
    with pytest.raises(TypeError, match="unsupported sink"):
        t3.to(object())
