"""The port's RAG pipeline in its own dataflow, against the JAX package's.

Each case builds the same program in both packages from the same rows
(streams with ``__time__``/``__diff__`` retractions) and the same
encoder weights (one numpy tree): the JAX ``SentenceTransformerEmbedder``
and the port's (``device="cpu"``, ``device_resident=True``, so the
port's index holds ``DeviceVec`` rows).  Each package runs its own
engine.  Tolerances: retrieved keys and texts equal, in order; f32
scores within ``atol=1e-5``; BM25 and hybrid (RRF) scores within 1e-12.

- ``DocumentStore``: ``retrieve_query`` with a per-row ``k`` and a
  ``metadata_filter``, ``statistics_query``, ``inputs_query``;
- ``DataIndex.query`` (revised as the data changes) and
  ``query_as_of_now`` (answered once, never revised);
- the as-of-now routing rule: five queries at one time take one
  ``search_batch``, and their answers equal the per-query route's; a
  ``search_batch`` that raises fails the run;
- the BM25, hybrid and usearch factories.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.engine import runner as jrunner
from pathway_tpu.internals import parse_graph as jpg
from pathway_tpu.models import encoder as jenc
from pathway_tpu.stdlib import indexing as jidx
from pathway_tpu.xpacks.llm import document_store as jds
from pathway_tpu.xpacks.llm import embedders as jemb
from pathway_tpu_torch.engine import runner as trunner
from pathway_tpu_torch.internals import parse_graph as tpg
from pathway_tpu_torch.internals.trace import EngineErrorWithTrace
from pathway_tpu_torch.internals.value import ref_scalar
from pathway_tpu_torch.models import encoder as tenc
from pathway_tpu_torch.models.convert import encoder_params_from_numpy
from pathway_tpu_torch.obs import costdb, planner
from pathway_tpu_torch.stdlib import indexing as tidx
from pathway_tpu_torch.stdlib.indexing.inner_index import BruteForceKnn
from pathway_tpu_torch.xpacks.llm import document_store as tds
from pathway_tpu_torch.xpacks.llm import embedders as temb

from .test_torch_encoder import _configs, _np_params

TEXTS = [
    "the quick brown fox jumps over the lazy dog",
    "pathway is a stream processing framework for live data",
    "tpus have a systolic array called the mxu",
    "a paged kv cache holds the keys and values of every request",
    "the index answers nearest neighbour queries over embeddings",
    "hopper cards run warpgroup matrix multiplies on tensor cores",
    "live data flows through the stream processing engine",
    "the fox and the dog are friends",
]
QUESTIONS = [
    "systolic array mxu", "fox and dog", "stream processing of live data",
    "keys and values of a request", "tensor cores on hopper",
]


@pytest.fixture(autouse=True)
def _fresh(tmp_path, monkeypatch):
    monkeypatch.setenv("PW_COSTDB_PATH", str(tmp_path / "costdb.json"))
    costdb.shutdown()
    planner.invalidate_cache()
    jpg.G.clear()
    tpg.G.clear()
    yield
    jpg.G.clear()
    tpg.G.clear()
    costdb.shutdown()
    planner.invalidate_cache()


@pytest.fixture(scope="module")
def weights():
    cfg_j, cfg_t = _configs("pre")
    return cfg_j, cfg_t, _np_params(11, post_ln=False)


def _embedder(pkg, weights):
    cfg_j, cfg_t, tree = weights
    if pkg == "jax":
        emb = jemb.SentenceTransformerEmbedder(config=cfg_j)
        emb._enc = jenc.JaxEncoder(
            cfg_j, params=jax.tree_util.tree_map(jnp.asarray, tree))
        return emb
    emb = temb.SentenceTransformerEmbedder(config=cfg_t, device="cpu",
                                           device_resident=True)
    emb._enc = tenc.TorchEncoder(cfg_t, params=encoder_params_from_numpy(
        tree, cfg_t, device="cpu"), device="cpu")
    return emb


PKG = {"jax": (jpw, jrunner, jidx, jds), "torch": (tpw, trunner, tidx, tds)}


def _docs(pkg):
    """Six documents at time 2; at time 4 document 3 is retracted and
    documents 7 and 8 arrive.  Each carries ``{"lang", "n"}`` metadata."""
    pw = PKG[pkg][0]

    class Docs(pw.Schema):
        doc_id: int = pw.column_definition(primary_key=True)
        data: str
        _metadata: object

    rows = [(i + 1, t, pw.Json({"lang": "en" if i % 2 else "de", "n": i}),
             2, 1) for i, t in enumerate(TEXTS[:6])]
    rows.append((3, TEXTS[2], pw.Json({"lang": "de", "n": 2}), 4, -1))
    rows += [(i + 1, TEXTS[i], pw.Json({"lang": "en", "n": i}), 4, 1)
             for i in (6, 7)]
    return pw.debug.table_from_rows(Docs, rows, is_stream=True)


def _queries(pkg, rows, with_filter=False):
    """(question, k[, filter], time) rows, keyed by their position."""
    pw = PKG[pkg][0]
    if with_filter:
        class Q(pw.Schema):
            qid: int = pw.column_definition(primary_key=True)
            query: str
            k: int
            metadata_filter: str | None
    else:
        class Q(pw.Schema):
            qid: int = pw.column_definition(primary_key=True)
            query: str
            k: int
    return pw.debug.table_from_rows(
        Q, [(i,) + tuple(r) + (1,) for i, r in enumerate(rows)],
        is_stream=True)


def _run(pkg, table):
    runner = PKG[pkg][1]
    kw = {"device": "cpu"} if pkg == "torch" else {}
    [cap] = runner.run_tables(table, **kw)
    return cap


def _store(pkg, weights, factory=None, **kw):
    pw, _runner, idx, ds = PKG[pkg]
    if factory is None:
        emb = _embedder(pkg, weights)
        fkw = {"device": "cpu"} if pkg == "torch" else {}
        factory = idx.BruteForceKnnFactory(
            dimensions=emb.get_embedding_dimension(), embedder=emb, **fkw)
    return ds.DocumentStore(_docs(pkg), retriever_factory=factory, **kw)


def _results(cap) -> list:
    """Each query's JSON result, in the order of the queries' ``qid``
    (their primary key, hashed alike by both packages)."""
    state = cap.squash()
    order = [ref_scalar(i) for i in range(len(state))]
    assert sorted(order) == sorted(state)
    return [state[k][0].value for k in order]


def _single(cap):
    """The JSON result of a one-row query table."""
    [(result,)] = cap.squash().values()
    return result.value


def _assert_same_results(got, want, atol=1e-5):
    assert [[(d["text"], d["metadata"]) for d in r] for r in got] == \
        [[(d["text"], d["metadata"]) for d in r] for r in want]
    np.testing.assert_allclose([d["score"] for r in got for d in r],
                               [d["score"] for r in want for d in r],
                               atol=atol, rtol=0)


def test_retrieve_query_with_per_row_k_and_metadata_filter(weights):
    rows = [(q, k, f, 6) for q, k, f in zip(
        QUESTIONS, (2, 3, 1, 4, 2),
        (None, "lang == `en`", None, "n > `2`", "lang == `de`"))]
    out = {}
    for pkg in PKG:
        store = _store(pkg, weights)
        out[pkg] = _results(_run(pkg, store.retrieve_query(
            _queries(pkg, rows, with_filter=True))))
    assert [len(r) for r in out["torch"]] == [2, 3, 1, 4, 2]
    assert all(d["metadata"]["lang"] == "en" for d in out["torch"][1])
    assert TEXTS[2] not in [d["text"] for r in out["torch"] for d in r]
    _assert_same_results(out["torch"], out["jax"])


def test_statistics_and_inputs_queries(weights):
    out = {}
    for pkg in PKG:
        pw = PKG[pkg][0]
        store = _store(pkg, weights)
        q = pw.debug.table_from_markdown("""
            | __time__
          1 | 6
          """)
        stats = _single(_run(pkg, store.statistics_query(q)))
        pkg_g = tpg if pkg == "torch" else jpg
        pkg_g.G.clear()
        store = _store(pkg, weights)
        q = pw.debug.table_from_markdown("""
            | __time__
          1 | 6
          """)
        inputs = _single(_run(pkg, store.inputs_query(q)))
        out[pkg] = (stats, inputs)
    (t_stats, t_inputs), (j_stats, j_inputs) = out["torch"], out["jax"]
    assert t_stats == j_stats == {"file_count": 7, "chunk_count": 7}
    key = lambda m: m["n"]  # noqa: E731 - the tuple reducer's order
    assert sorted(t_inputs, key=key) == sorted(j_inputs, key=key)
    assert sorted(m["n"] for m in t_inputs) == [0, 1, 3, 4, 5, 6, 7]


def _index(pkg, weights, docs, factory_kw=None):
    idx = PKG[pkg][2]
    emb = _embedder(pkg, weights)
    kw = {"device": "cpu"} if pkg == "torch" else {}
    kw.update(factory_kw or {})
    return idx.BruteForceKnnFactory(
        dimensions=emb.get_embedding_dimension(), embedder=emb,
        **kw).build_index(docs.data, docs)


def _stream(cap) -> list:
    """The update stream as (time, key, ids, texts, scores, diff)."""
    return sorted((t, k, tuple(row[0]), tuple(row[2]), tuple(row[1]), d)
                  for k, row, t, d in cap.as_list())


def _assert_same_stream(got, want):
    assert [(t, k, ids, texts, d) for t, k, ids, texts, _s, d in got] == \
        [(t, k, ids, texts, d) for t, k, ids, texts, _s, d in want]
    np.testing.assert_allclose([s for r in got for s in r[4]],
                               [s for r in want for s in r[4]], atol=1e-5)


@pytest.mark.parametrize("as_of_now", [False, True])
def test_query_revises_and_query_as_of_now_answers_once(weights, as_of_now):
    # queries at time 2 (with the first documents) and at time 6
    rows = [(QUESTIONS[0], 2, 2), (QUESTIONS[1], 3, 2), (QUESTIONS[2], 2, 6)]
    out = {}
    for pkg in PKG:
        docs = _docs(pkg)
        index = _index(pkg, weights, docs)
        queries = _queries(pkg, rows)
        ask = index.query_as_of_now if as_of_now else index.query
        out[pkg] = _stream(_run(pkg, ask(queries.query,
                                         number_of_matches=queries.k)))
    _assert_same_stream(out["torch"], out["jax"])
    retractions = [r for r in out["torch"] if r[5] < 0]
    if as_of_now:
        # one answer per query, never revised
        assert not retractions and len(out["torch"]) == 3
    else:
        # the time-2 queries are revised at time 4 (document 3 left,
        # documents 7 and 8 came)
        assert {r[0] for r in retractions} == {4}


class _Recording(BruteForceKnn):
    """The port's index, counting its search calls."""

    calls: list = []
    built: list = []

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        _Recording.built.append(self)

    def search(self, *a, **kw):
        _Recording.calls.append("search")
        return super().search(*a, **kw)

    def search_batch(self, queries, k):
        _Recording.calls.append(("search_batch", len(queries)))
        return super().search_batch(queries, k)


class _RecordingFactory(tidx.BruteForceKnnFactory):
    _index_cls = _Recording


def _as_of_now_answers(weights, times) -> list:
    docs = _docs("torch")
    index = _index("torch", weights, docs)
    index.index_factory = _RecordingFactory(
        dimensions=index.embedder.get_embedding_dimension(),
        device="cpu")._inner()
    queries = _queries("torch", [(q, 3, t) for q, t in zip(QUESTIONS, times)])
    reply = index.query_as_of_now(queries.query, number_of_matches=queries.k)
    state = _run("torch", reply).squash()
    return [state[k] for k in sorted(state)]


def test_five_queries_at_one_time_take_search_batch(weights):
    _Recording.calls, _Recording.built = [], []
    batched = _as_of_now_answers(weights, [6] * 5)
    assert _Recording.calls == [("search_batch", 5)]
    _Recording.calls, _Recording.built = [], []
    single = _as_of_now_answers(weights, [6, 8, 10, 12, 14])
    assert _Recording.calls == ["search"] * 5
    assert [(r[0], r[2]) for r in batched] == [(r[0], r[2]) for r in single]
    np.testing.assert_allclose([s for r in batched for s in r[1]],
                               [s for r in single for s in r[1]], atol=1e-5)
    # the data rows reached the index as device-resident handles
    [index] = _Recording.built
    assert index.n == 7 and len(index._dev_refs) == 7


class _Failing(BruteForceKnn):
    def search_batch(self, queries, k):
        raise RuntimeError("search_batch failed on purpose")


class _FailingFactory(tidx.BruteForceKnnFactory):
    _index_cls = _Failing


def test_a_failing_search_batch_fails_the_run(weights):
    emb = _embedder("torch", weights)
    store = tds.DocumentStore(_docs("torch"), retriever_factory=_FailingFactory(
        dimensions=emb.get_embedding_dimension(), embedder=emb, device="cpu"))
    queries = _queries("torch", [(q, 2, 6) for q in QUESTIONS])
    with pytest.raises(EngineErrorWithTrace, match="failed on purpose"):
        _run("torch", store.retrieve_query(queries))


def _factory(pkg, kind, weights):
    idx = PKG[pkg][2]
    kw = {"device": "cpu"} if pkg == "torch" else {}
    if kind == "bm25":
        return idx.TantivyBM25Factory()
    emb = _embedder(pkg, weights)
    knn = dict(dimensions=emb.get_embedding_dimension(), embedder=emb, **kw)
    if kind == "usearch":
        return idx.UsearchKnnFactory(**knn)
    return idx.HybridIndexFactory(
        retriever_factories=[idx.BruteForceKnnFactory(**knn),
                             idx.TantivyBM25Factory()],
        weights=[1.0, 0.5])


@pytest.mark.parametrize("kind", ["bm25", "hybrid", "usearch"])
def test_factories_retrieve_as_the_jax_ones(weights, kind):
    rows = [(q, k, 6) for q, k in zip(QUESTIONS, (2, 3, 1, 4, 2))]
    out = {}
    for pkg in PKG:
        store = _store(pkg, weights, factory=_factory(pkg, kind, weights))
        out[pkg] = _results(_run(pkg, store.retrieve_query(
            _queries(pkg, rows))))
    assert any(out["torch"])
    _assert_same_results(out["torch"], out["jax"],
                         atol=1e-5 if kind == "usearch" else 1e-12)
