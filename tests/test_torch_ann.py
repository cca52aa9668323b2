"""The port's approximate index tiers against the JAX package's.

``IvfKnn`` (k-means coarse quantizer over a cluster-major matrix,
overflow tails, tombstones, the retrain rule) and ``LshKnn``
(random-hyperplane buckets) are host numpy in both packages with the
same seeded draws: every ``search`` must give the same keys and the same
float scores, bit for bit (no tolerance).  Their factories, the LSH
branch of ``HybridIndexFactory``, ``default_lsh_knn_document_index``,
``KNNIndex`` and the kNN LSH classifier run through each package's own
dataflow (``tests/torch_parity.py``) with equal captures.
"""

import numpy as np
import pytest

from pathway_tpu.stdlib.indexing import inner_index as jii
from pathway_tpu_torch.stdlib.indexing import inner_index as tii

from .torch_parity import equal_to_jax, fresh_port  # noqa: F401


def _pair(cls_name, *args, **kwargs):
    return (getattr(jii, cls_name)(*args, **kwargs),
            getattr(tii, cls_name)(*args, **kwargs))


def _same(indexes, q, k, metadata_filter=None):
    j, t = (ix.search(q, k, metadata_filter) for ix in indexes)
    assert t == j
    return j


def _clustered(seed, n, d, n_centers=16, scale=5.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_centers, d)).astype(np.float32) * scale
    assign = rng.integers(0, n_centers, n)
    data = centers[assign] + rng.normal(size=(n, d)).astype(np.float32)
    queries = centers[rng.integers(0, n_centers, 12)] + rng.normal(
        size=(12, d)).astype(np.float32)
    return data, queries


@pytest.mark.parametrize("metric", ["cos", "dot", "l2sq"])
def test_ivf_matches_jax_through_its_life(metric):
    """Untrained exact scan, the first training, growth past 4x (retrain),
    tombstones past 25% (compaction), re-adds and a metadata filter: the
    same keys and scores as the JAX index at every stage."""
    data, queries = _clustered(1, 3000, 12)
    pair = _pair("IvfKnn", 12, n_clusters=16, nprobe=4, metric=metric,
                 train_min=200, reserved_space=64)
    meta = [{"grp": "a" if i % 7 == 0 else "b", "i": i} for i in range(3000)]

    def add(lo, hi):
        for i in range(lo, hi):
            for ix in pair:
                ix.add(i, data[i], meta[i])

    add(0, 150)  # below train_min: the exact scan
    assert all(ix.centroids is None for ix in pair)
    for q in queries[:4]:
        _same(pair, q, 5)
    add(150, 250)  # trains at 200
    assert pair[1].centroids is not None
    assert pair[1]._trained_at == pair[0]._trained_at == 200
    for q in queries:
        _same(pair, q, 10)
    add(250, 1200)  # past 4x the training set: retrains
    assert pair[1]._trained_at == pair[0]._trained_at > 200
    for q in queries:
        _same(pair, q, 10)
        _same(pair, q, 7, "grp == 'a'")
    for i in range(0, 1200, 3):  # a third tombstoned, then one add
        for ix in pair:
            ix.remove(i)
    add(1200, 1201)
    np.testing.assert_array_equal(pair[1].block_bounds, pair[0].block_bounds)
    assert pair[1].keys == pair[0].keys
    for q in queries:
        _same(pair, q, 10)
    for i in range(0, 90, 3):  # re-add removed keys: overflow tails
        for ix in pair:
            ix.add(i, data[i] * 0.5, meta[i])
    assert pair[1].overflow == pair[0].overflow
    for q in list(queries) + [data[3], data[6]]:
        _same(pair, q, 10)
        _same(pair, q, 4, "grp == 'a'")


def test_ivf_clustered_recall_matches_jax():
    """``tests/test_indexing.py``'s 30,000 x 64 clustered case: the port's
    IVF reaches recall@10 >= 0.95 against the port's brute force, and
    answers exactly as the JAX IVF; removals and a re-add stay
    incremental."""
    rng = np.random.default_rng(0)
    d, n_centers, n = 64, 32, 30_000
    centers = rng.normal(size=(n_centers, d)).astype(np.float32) * 5
    assign = rng.integers(0, n_centers, n)
    data = centers[assign] + rng.normal(size=(n, d)).astype(np.float32)

    bf = tii.BruteForceKnn(d, reserved_space=n, device="cpu")
    pair = _pair("IvfKnn", d, n_clusters=64, nprobe=8, train_min=2048,
                 reserved_space=n)
    for i in range(n):
        bf.add(i, data[i])
        for ix in pair:
            ix.add(i, data[i])
    assert pair[1].centroids is not None

    queries = centers[rng.integers(0, n_centers, 50)] + rng.normal(
        size=(50, d)).astype(np.float32)
    hits = 0
    for q in queries:
        truth = {k for k, _s in bf.search(q, 10, tier="cpu")}
        got = {k for k, _s in _same(pair, q, 10)}
        hits += len(truth & got)
    assert hits / (10 * len(queries)) >= 0.95

    for i in range(2000):
        for ix in pair:
            ix.remove(i)
    assert pair[1].n == n - 2000
    got = [k for k, _s in _same(pair, data[2500], 5)]
    assert 2500 in got and all(k >= 2000 for k in got)
    for ix in pair:
        ix.add(1, data[1])
    assert 1 in [k for k, _s in _same(pair, data[1], 3)]


def test_ivf_l2sq_ranks_by_true_distance():
    rng = np.random.default_rng(5)
    data = rng.normal(size=(5000, 8)).astype(np.float32)
    data[0] = [0.1] * 8
    data[1] = [100.0] * 8
    pair = _pair("IvfKnn", 8, metric="l2sq", n_clusters=16, nprobe=16,
                 train_min=1000)
    for i in range(len(data)):
        for ix in pair:
            ix.add(i, data[i])
    got = _same(pair, np.zeros(8, np.float32), 1)
    assert got[0][0] == int(np.argmin(np.sum(data ** 2, axis=1)))


def test_ivf_rejects_an_unknown_metric():
    for mod in (jii, tii):
        with pytest.raises(ValueError, match="metric"):
            mod.IvfKnn(4, metric="hamming")


@pytest.mark.parametrize("metric", ["cos", "l2sq"])
def test_lsh_matches_jax(metric):
    """Bucket candidates (the same seeded planes), the all-rows fallback
    when no bucket matches, removals, replacement and a filter."""
    data, queries = _clustered(2, 600, 10, n_centers=6, scale=3.0)
    pair = _pair("LshKnn", 10, n_or=6, n_and=4, metric=metric)
    for i in range(600):
        for ix in pair:
            ix.add(i, data[i], {"odd": i % 2 == 1})
    np.testing.assert_array_equal(pair[1].planes, pair[0].planes)
    for q in list(queries) + [data[5], -data[5] * 40]:
        _same(pair, q, 8)
        _same(pair, q, 5, "odd == `true`")
    for i in range(0, 600, 4):
        for ix in pair:
            ix.remove(i)
    for i in range(1, 40, 4):  # replace: the old buckets are dropped
        for ix in pair:
            ix.add(i, data[i] + 1.0, {"odd": True})
    assert [dict(b) for b in pair[1].buckets] == [dict(b) for b in pair[0].buckets]
    for q in queries:
        _same(pair, q, 8)


def test_lsh_empty_and_unset_dimensions():
    pair = _pair("LshKnn")
    assert _same(pair, np.ones(3, np.float32), 2) == []
    for ix in pair:
        ix.add(1, [1.0, 0.0, 0.0])
    assert _same(pair, np.array([0.9, 0.1, 0.0], np.float32), 2)[0][0] == 1


# -- through each package's dataflow ----------------------------------------

_VECS = np.random.default_rng(3).normal(size=(300, 8)).astype(np.float32)
_QUERIES = [_VECS[7], _VECS[100] * 2.0, -_VECS[5], _VECS[250] + 0.1]


def _doc_rows():
    return [(f"doc {i}", _VECS[i], {"tag": "even" if i % 2 == 0 else "odd"})
            for i in range(len(_VECS))]


def _docs_and_queries(pw, with_times=False):
    class D(pw.Schema):
        text: str
        vec: object
        meta: pw.Json

    class Q(pw.Schema):
        qv: object
        k: int

    rows = [(t, v, pw.Json(m)) for t, v, m in _doc_rows()]
    if with_times:
        # half the documents at time 2, the rest at 4, one retracted at 6
        rows = ([r + (2, 1) for r in rows[:150]]
                + [r + (4, 1) for r in rows[150:]] + [rows[3] + (6, -1)])
        docs = pw.debug.table_from_rows(D, rows, is_stream=True)
    else:
        docs = pw.debug.table_from_rows(D, rows)
    queries = pw.debug.table_from_rows(
        Q, [(q, 3 + i) for i, q in enumerate(_QUERIES)])
    return docs, queries


def _reply(reply):
    return reply.select(ids=reply._pw_index_reply_id,
                        scores=reply._pw_index_reply_score, texts=reply.text)


@pytest.mark.parametrize("as_of_now", [False, True])
@pytest.mark.parametrize("factory", ["ivf", "lsh"])
def test_ann_factories_match_jax(factory, as_of_now, monkeypatch,
                                 fresh_port):  # noqa: F811
    def build(pw):
        docs, queries = _docs_and_queries(pw, with_times=not as_of_now)
        idx = pw.indexing
        if factory == "ivf":
            f = idx.IvfKnnFactory(dimensions=8, n_clusters=8, nprobe=2,
                                  train_min=64)
        else:
            f = idx.LshKnnFactory(dimensions=8, n_or=4, n_and=3)
        index = f.build_index(docs.vec, docs, metadata_column=docs.meta)
        ask = index.query_as_of_now if as_of_now else index.query
        plain = _reply(ask(queries.qv, number_of_matches=queries.k))
        filtered = _reply(ask(queries.qv, number_of_matches=2,
                              metadata_filter="tag == 'odd'"))
        return plain, filtered

    plain, filtered = equal_to_jax(build, monkeypatch, stream=True,
                                   tiers=("numpy", "device"))
    assert sum(d for (_k, _r, _t, d) in plain.elements()) == len(_QUERIES)
    assert any(r[0] for (_k, r, _t, _d) in filtered.elements())


def test_hybrid_with_an_lsh_sub_index_matches_jax(monkeypatch,
                                                  fresh_port):  # noqa: F811
    def build(pw):
        class D(pw.Schema):
            text: str
            vec: object

        class Q(pw.Schema):
            text: str
            qv: object

        docs = pw.debug.table_from_rows(
            D, [(f"word{i % 9} doc {i}", _VECS[i]) for i in range(120)])
        queries = pw.debug.table_from_rows(
            Q, [("word3 doc", _VECS[3]), ("word8", _VECS[44])])
        idx = pw.indexing
        hybrid = idx.HybridIndexFactory(retriever_factories=[
            idx.LshKnnFactory(dimensions=8, n_or=4, n_and=3),
            idx.TantivyBM25Factory()])
        index = hybrid.build_index(
            pw.make_tuple(docs.vec, docs.text), docs)
        return _reply(index.query_as_of_now(
            pw.make_tuple(queries.qv, queries.text), number_of_matches=4))

    [got] = equal_to_jax(build, monkeypatch)
    assert all(len(r[0]) == 4 for r in got.values())


def test_default_lsh_document_index_matches_jax(monkeypatch,
                                                fresh_port):  # noqa: F811
    def build(pw):
        docs, queries = _docs_and_queries(pw)
        index = pw.indexing.default_lsh_knn_document_index(
            docs.vec, docs, dimensions=8, metadata_column=docs.meta)
        return _reply(index.query(queries.qv, number_of_matches=3))

    [got] = equal_to_jax(build, monkeypatch)
    assert len(got) == len(_QUERIES)


# -- stdlib.ml: KNNIndex and the kNN LSH classifier -------------------------

def _ml(pw):
    return pw.stdlib.ml


@pytest.mark.parametrize("use_lsh", [False, True])
def test_knn_index_matches_jax(use_lsh, monkeypatch, fresh_port):  # noqa: F811
    """``tests/test_ml.py``'s streaming case: late rows revise earlier
    answers, and a metadata filter forces the worse-scoring row."""

    def build(pw):
        docs = pw.debug.table_from_markdown("""
        id | x | y | topic | __time__ | __diff__
        1 | 0.0 | 1.0 | news | 2 | 1
        2 | 1.0 | 0.0 | sport | 2 | 1
        3 | 0.0 | 0.9 | news | 4 | 1
        """)
        docs = docs.select(
            data=pw.apply(lambda x, y: [x, y], pw.this.x, pw.this.y),
            meta=pw.apply(lambda t: {"topic": t}, pw.this.topic),
            topic=pw.this.topic)
        kw = {} if pw.__name__ == "pathway_tpu" else {"device": "cpu"}
        index = _ml(pw).KNNIndex(docs.data, docs, n_dimensions=2,
                                 metadata=docs.meta, use_lsh=use_lsh, **kw)
        q = pw.debug.table_from_markdown("""
        qx | qy
        0.0 | 1.0
        """)
        q = q.select(
            data=pw.apply(lambda x, y: [x, y], pw.this.qx, pw.this.qy),
            flt=pw.apply_with_type(lambda x: "topic == 'sport'", str,
                                   pw.this.qx))
        near = index.get_nearest_items(q.data, k=1, with_distances=True)
        forced = index.get_nearest_items(q.data, k=1, metadata_filter=q.flt)
        asof = index.get_nearest_items_asof_now(q.data, k=2)
        return (near.select(hit=pw.this.topic, dist=pw.this.dist),
                forced.select(hit=pw.this.topic),
                asof.select(hit=pw.this.topic))

    near, forced, _asof = equal_to_jax(build, monkeypatch, stream=True)

    def final(stream):
        net = {}
        for (_k, r, _t, d) in stream.elements():
            net[r] = net.get(r, 0) + d
        return [r for r, m in net.items() if m]

    assert len(final(near)) == 1
    if not use_lsh:  # exact search: the filter forces the sport row
        assert final(near)[0][0] == ("news",)
        assert final(forced) == [(("sport",),)]


def test_knn_lsh_classifier_matches_jax(monkeypatch, fresh_port):  # noqa: F811
    """``tests/test_ml.py``'s majority-vote case through both packages."""

    def build(pw):
        train = pw.debug.table_from_markdown("""
        id | x | y
        1 | 0.0 | 0.1
        2 | 0.1 | 0.0
        3 | 0.05 | 0.05
        4 | 5.0 | 5.1
        5 | 5.1 | 5.0
        6 | 5.05 | 5.05
        """)
        train = train.select(
            data=pw.apply(lambda x, y: [x, y], pw.this.x, pw.this.y))
        labels = train.select(label=pw.apply_with_type(
            lambda v: "low" if v[0] < 1 else "high", str, pw.this.data))
        queries = pw.debug.table_from_markdown("""
        qx | qy
        0.02 | 0.03
        5.02 | 5.03
        """)
        queries = queries.select(
            data=pw.apply(lambda x, y: [x, y], pw.this.qx, pw.this.qy))
        classify = _ml(pw).classifiers.knn_lsh_classifier_train(
            train, L=12, M=4)
        return classify(labels, queries)

    [got] = equal_to_jax(build, monkeypatch)
    assert sorted(r[0] for r in got.values()) == ["high", "low"]
