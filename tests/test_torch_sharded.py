"""The port's sharded data plane (``parallel/sharded.py`` and
``parallel/cluster.py``'s single-process walk) against the JAX package:
``tests/test_sharded.py``'s cases, each built in both packages from the
same rows; the JAX package runs them single-shard (``run_tables``) and
the port sharded (``run_tables_sharded``), and the squashed captures,
keys included, must be equal.  Plus the routers: on the same graph a
row lands on the same shard in both packages."""

import time

import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.engine.runner import run_tables as jrun_tables
from pathway_tpu.internals import parse_graph as jpg
from pathway_tpu.parallel import cluster as jcluster
from pathway_tpu_torch.internals import parse_graph as tpg
from pathway_tpu_torch.parallel import cluster as tcluster

from .torch_parity import fresh_port, named  # noqa: F401


@pytest.fixture(autouse=True)
def _fresh(fresh_port):  # noqa: F811
    yield


def _squash(cap):
    return {k: named(tuple(r)) for k, r in cap.squash().items()}


def _assert_same(build, n_shards=4):
    jpg.G.clear()
    [single] = jrun_tables(build(jpw))
    jpg.G.clear()
    tpg.G.clear()
    [sharded] = tcluster.run_tables_sharded(build(tpw), n_shards=n_shards,
                                            device="cpu")
    tpg.G.clear()
    assert _squash(single) == _squash(sharded)
    assert _squash(single)


def test_sharded_select_filter():
    def build(pw):
        t = pw.debug.table_from_rows(pw.schema_from_types(a=int),
                                     [(i,) for i in range(100)])
        return t.filter(t.a % 3 == 0).select(b=t.a * 2)

    _assert_same(build)


def test_sharded_groupby():
    def build(pw):
        t = pw.debug.table_from_rows(
            pw.schema_from_types(g=str, v=int),
            [(f"g{i % 7}", i) for i in range(200)])
        return t.groupby(t.g).reduce(t.g, s=pw.reducers.sum(t.v),
                                     c=pw.reducers.count())

    _assert_same(build)


def test_sharded_join():
    def build(pw):
        left = pw.debug.table_from_rows(
            pw.schema_from_types(k=str, x=int),
            [(f"k{i % 11}", i) for i in range(60)])
        right = pw.debug.table_from_rows(
            pw.schema_from_types(k=str, y=int),
            [(f"k{i % 13}", i * 10) for i in range(40)])
        return left.join(right, left.k == right.k).select(
            k=left.k, x=pw.left.x, y=pw.right.y)

    _assert_same(build)


def test_sharded_stream_with_retractions():
    def build(pw):
        t = pw.debug.table_from_markdown(
            """
            | g | v | __time__ | __diff__
            | a | 1 | 0        | 1
            | b | 2 | 0        | 1
            | a | 3 | 2        | 1
            | a | 1 | 4        | -1
            """
        )
        return t.groupby(t.g).reduce(t.g, s=pw.reducers.sum(t.v))

    _assert_same(build, n_shards=3)


def test_sharded_streaming_via_threads(monkeypatch):
    """PATHWAY_THREADS>1 with a live source runs the port's sharded
    streaming loop through ``pw.run``; the final counts equal the JAX
    package's single-process run of the same subject."""
    from pathway_tpu_torch.internals.config import pathway_config

    def final_counts(pw, **run_kw):
        class Subject(pw.io.python.ConnectorSubject):
            def run(self):
                for i in range(60):
                    self.next(word=f"w{i % 5}")
                    if i % 20 == 0:
                        time.sleep(0.02)

        t = pw.io.python.read(Subject(),
                              schema=pw.schema_from_types(word=str))
        counts = t.groupby(t.word).reduce(t.word, c=pw.reducers.count())
        final = {}
        pw.io.subscribe(
            counts,
            on_change=lambda key, row, time, is_addition: final.__setitem__(
                row["word"], row["c"]) if is_addition else None,
        )
        pw.run(idle_stop_s=0.8, autocommit_duration_ms=20, **run_kw)
        return final

    jpg.G.clear()
    want = final_counts(jpw)
    jpg.G.clear()
    monkeypatch.setattr(pathway_config, "threads", 3)
    tpg.G.clear()
    got = final_counts(tpw, device="cpu")
    assert got == want
    assert sum(got.values()) == 60 and len(got) == 5, got


def test_sharded_chain():
    def build(pw):
        t = pw.debug.table_from_rows(
            pw.schema_from_types(g=str, v=int),
            [(f"g{i % 5}", i) for i in range(100)])
        red = t.groupby(t.g).reduce(t.g, s=pw.reducers.sum(t.v))
        return red.filter(red.s > 500).select(gg=red.g, s2=red.s + 1)

    _assert_same(build)


# -- the routers ---------------------------------------------------------


def _router_shards(pw, cluster, runner_kw):
    """Every router of a groupby / join / deduplicate graph applied to the
    input rows, in the package ``pw``: ``{(kind, port): [shard, ...]}``."""
    rows = [(f"k{i % 13}", i % 7, i) for i in range(120)]
    schema = pw.schema_from_types(k=str, g=int, v=int)
    left = pw.debug.table_from_rows(schema, rows)
    right = pw.debug.table_from_rows(schema, rows[::3])
    gb = left.groupby(left.k, left.g).reduce(left.k, s=pw.reducers.sum(left.v))
    j = left.join(right, left.k == right.k, left.g == right.g).select(
        k=left.k, v=right.v)
    dd = left.deduplicate(value=left.v, instance=left.g,
                          acceptor=lambda new, old: new > old)
    sinks = [t._materialize_capture() for t in (gb, j, dd)]
    runner = cluster.ClusterRunner(sinks, n_local_shards=5, **runner_kw)
    events = {
        tbl._node.id: [(k, r, d) for _t, k, r, d in
                       tbl._node.params["source"].static_events()]
        for tbl in (left, right)
    }
    out = {"input": [runner.input_router.shard_of(u)
                     for u in events[left._node.id]]}
    for (pos, port), router in sorted(runner.routers.items()):
        node = runner.nodes[pos]
        if node.kind not in ("groupby", "join", "deduplicate"):
            continue
        src = node.input_tables[port]._node.id
        if src not in events:
            continue
        out[(node.kind, port)] = [router.shard_of(u) for u in events[src]]
    return out


def test_routers_shard_rows_as_the_jax_routers_do():
    jpg.G.clear()
    want = _router_shards(jpw, jcluster, {})
    jpg.G.clear()
    tpg.G.clear()
    got = _router_shards(tpw, tcluster, {"device": "cpu"})
    tpg.G.clear()
    assert set(want) == {"input", ("groupby", 0), ("join", 0), ("join", 1),
                         ("deduplicate", 0)}
    assert got == want
    # the routes spread the rows over the shards
    assert all(len(set(v)) > 1 for v in want.values())
