"""The rest of the port's LLM xpack against the JAX package's: rerankers,
the vector store, the MCP server and retrieval evaluation.

- ``EncoderReranker`` / ``CrossEncoderReranker`` over the port's
  embedder and the JAX one on the same numpy weights: scores within
  1e-5; ``LLMReranker`` over a stub chat: the same prompts and scores;
  ``FlashRankReranker`` raises in both; ``rerank_topk_filter`` keeps the
  stable-sorted top k through each package's dataflow;
- ``VectorStoreServer.run_server(threaded=True)`` on 127.0.0.1:
  ``VectorStoreClient.query`` = ``DocumentStoreClient.retrieve`` = the
  JAX store's ``retrieve_query`` (texts equal, scores within 1e-5), and
  ``from_langchain_components`` with stub components the same; a run
  that fails surfaces from the thread's ``join``;
- MCP ``initialize``, ``tools/list``, ``tools/call``, an unknown tool and
  an unknown method: the same JSON as the JAX server's, in process and
  over HTTP while ``McpServer.run`` serves a vector store;
- ``evaluate``: the metrics, ``synthetic_beir_corpus``, ``pydoc_corpus``
  and its split, ``torch_reference_embedder`` and
  ``train_contrastive_torch`` equal the JAX package's;
  ``evaluate_retrieval`` over the port's encoder and index equals it over
  the JAX ones within 1e-4 on ``tests/test_retrieval_quality.py``'s
  corpus.
"""

import json
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.engine import runner as jrunner
from pathway_tpu.internals import parse_graph as jpg
from pathway_tpu.models import encoder as jenc
from pathway_tpu.xpacks.llm import embedders as jemb
from pathway_tpu.xpacks.llm import evaluate as jeval
from pathway_tpu.xpacks.llm import mcp_server as jmcp
from pathway_tpu.xpacks.llm import rerankers as jrr
from pathway_tpu.xpacks.llm import vector_store as jvs
from pathway_tpu_torch.internals import parse_graph as tpg
from pathway_tpu_torch.models import encoder as tenc
from pathway_tpu_torch.models.convert import encoder_params_from_numpy
from pathway_tpu_torch.xpacks.llm import embedders as temb
from pathway_tpu_torch.xpacks.llm import evaluate as teval
from pathway_tpu_torch.xpacks.llm import mcp_server as tmcp
from pathway_tpu_torch.xpacks.llm import rerankers as trr
from pathway_tpu_torch.xpacks.llm import vector_store as tvs
from pathway_tpu_torch.xpacks.llm.document_store import DocumentStoreClient

from .test_torch_encoder import _configs, _np_params
from .torch_parity import equal_to_jax, fresh_port  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)

TEXTS = [
    "the quick brown fox jumps over the lazy dog",
    "pathway is a stream processing framework for live data",
    "tpus have a systolic array called the mxu",
    "a paged kv cache holds the keys and values of every request",
    "the index answers nearest neighbour queries over embeddings",
    "hopper cards run warpgroup matrix multiplies on tensor cores",
]
QUERIES = ["systolic array", "fox and dog", "live stream processing",
           "keys and values"]


@pytest.fixture(scope="module")
def embedders():
    """(JAX embedder, port embedder) on one numpy encoder tree."""
    cfg_j, cfg_t = _configs("pre")
    tree = _np_params(11, post_ln=False)
    j = jemb.SentenceTransformerEmbedder(config=cfg_j)
    j._enc = jenc.JaxEncoder(cfg_j,
                             params=jax.tree_util.tree_map(jnp.asarray, tree))
    t = temb.SentenceTransformerEmbedder(config=cfg_t, device="cpu")
    t._enc = tenc.TorchEncoder(cfg_t, params=encoder_params_from_numpy(
        tree, cfg_t, device="cpu"), device="cpu")
    return j, t


# -- rerankers ---------------------------------------------------------------

@pytest.mark.parametrize("kind", ["EncoderReranker", "CrossEncoderReranker"])
def test_encoder_rerankers_match_jax(kind, embedders):
    j, t = embedders
    jr = getattr(jrr, kind)(embedder=j)
    tr = getattr(trr, kind)(embedder=t)
    for q in QUERIES:
        for d in TEXTS:
            np.testing.assert_allclose(tr(d, q), jr(d, q), **TOL)
    if kind == "EncoderReranker":  # the cosine of the embedder's rows
        dv, qv = t._embed(TEXTS[0]), t._embed(QUERIES[0])
        np.testing.assert_allclose(
            tr(TEXTS[0], QUERIES[0]),
            dv @ qv / (np.linalg.norm(dv) * np.linalg.norm(qv)), **TOL)


def test_encoder_reranker_builds_its_embedder_on_the_device(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trr.EncoderReranker()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trr.CrossEncoderReranker()


def test_llm_reranker_matches_jax():
    prompts = []

    def chat(messages):
        prompts.append(messages)
        return f"Relevance: {len(messages[0]['content']) % 5 + 0.5} of 5"

    for tmpl in (None, "Q={query} D={doc} score?"):
        prompts.clear()
        want = [jrr.LLMReranker(chat, prompt_template=tmpl)(d, q)
                for q in QUERIES for d in TEXTS]
        jp, prompts[:] = list(prompts), []
        got = [trr.LLMReranker(chat, prompt_template=tmpl)(d, q)
               for q in QUERIES for d in TEXTS]
        assert got == want and prompts == jp
    for mod in (jrr, trr):
        assert mod.LLMReranker(lambda m: "no digits here")("d", "q") == 0.0
        with pytest.raises(ImportError, match="flashrank"):
            mod.FlashRankReranker()("d", "q")


def test_rerankers_on_columns_and_topk_filter_match_jax(monkeypatch,
                                                        fresh_port):  # noqa: F811
    """A reranker on columns scores each (doc, query) row; the filter keeps
    the stable-sorted top k (ties in input order)."""

    def build(pw):
        llm = __import__(pw.__name__ + ".xpacks.llm.rerankers",
                         fromlist=["_"])

        class R(pw.Schema):
            docs: object
            scores: object

        rows = pw.debug.table_from_rows(R, [
            (("a", "b", "c", "d", "e", "f", "g"),
             (0.5, 0.9, 0.5, 0.1, 0.9, 0.7, 0.5)),
            (("x", "y"), (1.0, 2.0)),
        ])
        top = rows.select(kept=llm.rerank_topk_filter(rows.docs, rows.scores,
                                                      k=5))

        class P(pw.Schema):
            doc: str
            query: str

        pairs = pw.debug.table_from_rows(P, [("alpha beta", "beta"),
                                             ("gamma", "delta epsilon")])
        scored = pairs.select(s=llm.LLMReranker(
            lambda m: str(len(m[0]["content"])))(pairs.doc, pairs.query))
        return top, scored

    top, scored = equal_to_jax(build, monkeypatch)
    kept = sorted(r[0] for r in top.values())
    assert kept == [(("b", "e", "f", "a", "c"), (0.9, 0.9, 0.7, 0.5, 0.5)),
                    (("y", "x"), (2.0, 1.0))]
    assert len(scored) == 2


# -- the vector store ---------------------------------------------------------

def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_listening(port: int, deadline_s: float = 30.0) -> None:
    import socket

    end = time.monotonic() + deadline_s
    while True:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            return
        except OSError:
            assert time.monotonic() < end, f"nothing listens on {port}"
            time.sleep(0.02)


def _doc_table(pw, texts):
    class D(pw.Schema):
        data: str
        _metadata: object

    return pw.debug.table_from_rows(
        D, [(t, pw.Json({"path": f"doc{i}.txt"})) for i, t in enumerate(texts)])


def _jax_retrieve(make_store, k=2):
    """The JAX store's static ``retrieve_query`` answers, by query."""
    jpg.G.clear()
    try:
        store = make_store()

        class Q(jpw.Schema):
            query: str
            k: int

        q = jpw.debug.table_from_rows(Q, [(x, k) for x in QUERIES])
        qcap, rcap = jrunner.run_tables(q, store.retrieve_query(q))
        texts = {key: row[0] for key, row in qcap.squash().items()}
        return {texts[key]: row[0].value
                for key, row in rcap.squash().items()}
    finally:
        jpg.G.clear()


def _same_results(got, want):
    assert [d["text"] for d in got] == [d["text"] for d in want]
    assert [d["metadata"] for d in got] == [d["metadata"] for d in want]
    np.testing.assert_allclose([d["score"] for d in got],
                               [d["score"] for d in want], **TOL)


def _serve_and_query(vs, queries, k=2, extra=None):
    """Run ``vs`` on a thread, query it over HTTP; (client answers,
    extra(port) or None)."""
    port = _free_port()
    th = vs.run_server("127.0.0.1", port, threaded=True, device="cpu",
                       timeout_s=60.0, idle_stop_s=1.0)
    try:
        _wait_listening(port)
        vc = tvs.VectorStoreClient("127.0.0.1", port)
        dc = DocumentStoreClient("127.0.0.1", port)
        got = {}
        for q in queries:
            a = vc.query(q, k=k)
            assert a == dc.retrieve(q, k=k)
            got[q] = a
        out = extra(port) if extra is not None else None
    finally:
        th.join(90.0)
    assert not th.is_alive()
    return got, out


def test_vector_store_server_matches_jax(embedders, fresh_port):  # noqa: F811
    j, t = embedders
    want = _jax_retrieve(lambda: jvs.VectorStoreServer(
        _doc_table(jpw, TEXTS), embedder=j).document_store)
    tpg.G.clear()
    vs = tvs.VectorStoreServer(_doc_table(tpw, TEXTS), embedder=t,
                               device="cpu")
    got, _ = _serve_and_query(vs, QUERIES)
    for q in QUERIES:
        _same_results(got[q], want[q])


class _StubLcEmbedder:
    """LangChain's embedder interface: ``embed_query(text)``."""

    def embed_query(self, text):
        v = np.zeros(8)
        for w in text.split():
            v[sum(map(ord, w)) % 8] += 1.0
        return list(v)


class _StubLcSplitter:
    def split_text(self, text):
        return [p for p in text.split(" the ") if p]


def test_vector_store_from_langchain_components_matches_jax(
        fresh_port):  # noqa: F811
    want = _jax_retrieve(lambda: jvs.VectorStoreServer.from_langchain_components(
        _doc_table(jpw, TEXTS), embedder=_StubLcEmbedder(),
        splitter=_StubLcSplitter()).document_store, k=3)
    tpg.G.clear()
    vs = tvs.VectorStoreServer.from_langchain_components(
        _doc_table(tpw, TEXTS), embedder=_StubLcEmbedder(),
        splitter=_StubLcSplitter(), device="cpu")
    got, _ = _serve_and_query(vs, QUERIES, k=3)
    for q in QUERIES:
        _same_results(got[q], want[q])


class _ConstEmbedder(temb.BaseEmbedder):
    def _embed(self, text):
        return np.ones(8, np.float32)


def test_threaded_vector_store_run_raises_from_join(fresh_port):  # noqa: F811
    vs = tvs.VectorStoreServer(_doc_table(tpw, TEXTS[:2]),
                               embedder=_ConstEmbedder(), device="cpu")
    assert vs.embedder.get_embedding_dimension() == 8
    th = vs.run_server("127.0.0.1", _free_port(), threaded=True,
                       device="cpu", not_a_run_option=True)
    with pytest.raises(TypeError, match="not_a_run_option"):
        th.join(30.0)


# -- MCP ----------------------------------------------------------------------

REQUESTS = [
    {"jsonrpc": "2.0", "id": 1, "method": "initialize"},
    {"jsonrpc": "2.0", "id": 2, "method": "tools/list"},
    {"jsonrpc": "2.0", "id": 3, "method": "tools/call",
     "params": {"name": "echo", "arguments": {"x": 1, "y": [1, 2]}}},
    {"jsonrpc": "2.0", "id": 4, "method": "tools/call",
     "params": {"name": "missing"}},
    {"jsonrpc": "2.0", "id": 5, "method": "resources/list"},
]


def _mcp(mod, pw):
    server = mod.McpServer(mod.McpConfig(host="127.0.0.1", port=0))
    server.tool("echo", request_handler=lambda args: {"echo": args})
    server.tool("typed", request_handler=lambda args: args,
                schema=pw.schema_from_types(query=str, k=int))
    server.tool("untyped", request_handler=lambda args: args,
                schema={"not": "a schema"})
    return server


def test_mcp_protocol_matches_jax():
    js, ts = _mcp(jmcp, jpw), _mcp(tmcp, tpw)
    for req in REQUESTS:
        assert ts._handle(req) == js._handle(req)
    tools = ts._handle(REQUESTS[1])["result"]["tools"]
    assert [t["name"] for t in tools] == ["echo", "typed", "untyped"]
    assert tools[1]["inputSchema"]["properties"] == {
        "query": {"type": "string"}, "k": {"type": "string"}}
    assert tools[2]["inputSchema"] == {"type": "object"}
    assert "error" in ts._handle(REQUESTS[4])


def test_mcp_schema_errors_surface():
    """Only a schema without ``column_names`` maps to no input schema; a
    schema whose ``column_names`` fails raises (the JAX package swallows
    any error there)."""

    class Broken:
        def column_names(self):
            raise KeyError("broken schema")

    server = tmcp.McpServer(tmcp.McpConfig(port=0))
    with pytest.raises(KeyError, match="broken"):
        server.tool("t", request_handler=lambda a: a, schema=Broken())
    assert jmcp._schema_to_json(Broken()) is None


def test_mcp_requires_its_entitlement(monkeypatch):
    from pathway_tpu_torch.internals import config, licensing

    monkeypatch.setattr(config.pathway_config, "license_key", None)
    with pytest.raises(licensing.MissingLicenseError, match="xpack-llm-mcp"):
        tmcp.McpServer(tmcp.McpConfig(port=0))


def test_mcp_over_http_beside_a_vector_store(embedders,
                                             fresh_port):  # noqa: F811
    """``McpServer.run`` serves ``/mcp`` for as long as its run: a
    ``retrieve`` tool over ``VectorStoreClient`` returns the client's
    JSON, and every request's answer equals the JAX server's."""
    _j, t = embedders
    vs_port, mcp_port = _free_port(), _free_port()
    vs = tvs.VectorStoreServer(_doc_table(tpw, TEXTS), embedder=t,
                               device="cpu")
    from pathway_tpu_torch.xpacks.llm.servers import DocumentStoreServer

    DocumentStoreServer("127.0.0.1", vs_port, vs.document_store)
    client = tvs.VectorStoreClient("127.0.0.1", vs_port)
    server = tmcp.McpServer(tmcp.McpConfig(host="127.0.0.1", port=mcp_port))
    server.tool("retrieve", request_handler=lambda a: client.query(
        a["query"], k=a.get("k", 2)))
    server.tool("echo", request_handler=lambda args: {"echo": args})
    js = jmcp.McpServer(jmcp.McpConfig(port=0))
    js.tool("echo", request_handler=lambda args: {"echo": args})
    errors = []

    def serve():
        try:
            server.run(device="cpu", timeout_s=60.0, idle_stop_s=1.0)
        except BaseException as exc:  # noqa: BLE001 - raised below
            errors.append(exc)

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    try:
        _wait_listening(mcp_port)
        _wait_listening(vs_port)

        def post(payload):
            req = urllib.request.Request(
                f"http://127.0.0.1:{mcp_port}/mcp", json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as r:
                return json.loads(r.read())

        call = post({"jsonrpc": "2.0", "id": 7, "method": "tools/call",
                     "params": {"name": "retrieve",
                                "arguments": {"query": QUERIES[0], "k": 2}}})
        direct = client.query(QUERIES[0], k=2)
        assert json.loads(call["result"]["content"][0]["text"]) == direct
        for req in (REQUESTS[0], REQUESTS[2], REQUESTS[3], REQUESTS[4]):
            assert post(req) == js._handle(req)
    finally:
        th.join(90.0)
    assert not th.is_alive() and not errors
    with pytest.raises(OSError):  # the webserver ended with the run
        urllib.request.urlopen(f"http://127.0.0.1:{mcp_port}/mcp", timeout=2)


# -- evaluation ---------------------------------------------------------------

def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(50):
        docs = [f"d{i}" for i in rng.permutation(12)[:rng.integers(0, 12)]]
        rel = {f"d{i}" for i in rng.integers(0, 14, rng.integers(0, 4))}
        k = int(rng.integers(1, 11))
        assert teval.recall_at_k(docs, rel, k) == jeval.recall_at_k(docs, rel, k)
        assert teval.ndcg_at_k(docs, rel, k) == jeval.ndcg_at_k(docs, rel, k)
        assert teval.mrr(docs, rel) == jeval.mrr(docs, rel)
    assert teval.recall_at_k(["a", "b", "c"], {"a", "z"}, 2) == 0.5
    assert teval.ndcg_at_k(["x", "a"], {"a"}, 10) == pytest.approx(
        1 / np.log2(3))
    search = lambda text, k: sorted(text.split())[:k]  # noqa: E731
    queries = {"q1": "b a c", "q2": "z y", "q3": ""}
    qrels = {"q1": ["a"], "q2": ["x"]}
    assert (teval.evaluate_retrieval(search, queries, qrels, k=2)
            == jeval.evaluate_retrieval(search, queries, qrels, k=2))
    assert teval.evaluate_retrieval(search, {}, {}) == jeval.evaluate_retrieval(
        search, {}, {})


@pytest.mark.parametrize("kw", [{}, dict(n_topics=7, docs_per_topic=3,
                                         n_queries_per_topic=4, seed=9)])
def test_synthetic_beir_corpus_matches_jax(kw):
    assert teval.synthetic_beir_corpus(**kw) == jeval.synthetic_beir_corpus(**kw)


def test_pydoc_corpus_and_split_match_jax():
    items = teval.pydoc_corpus()
    assert items == jeval.pydoc_corpus() and len(items) > 500
    assert (teval.pydoc_retrieval_split(n_eval_docs=80, n_queries=20,
                                        n_train=30, seed=2)
            == jeval.pydoc_retrieval_split(n_eval_docs=80, n_queries=20,
                                           n_train=30, seed=2))


def test_extended_pydoc_corpus_leaves_out_the_jax_stack():
    got = teval.pydoc_corpus(extended=True)
    jax_stack = ("jax", "flax", "chex", "optax")
    assert not any(name.split(".")[0] in jax_stack for name, _t, _b in got)
    want = {(t, b) for _n, t, b in jeval.pydoc_corpus(extended=True)}
    assert {(t, b) for _n, t, b in got} <= want | {
        (t, b) for _n, t, b in got if _n.split(".")[0] == "scipy"}
    assert len(got) > len(teval.pydoc_corpus())


def test_pydoc_corpus_raises_what_is_not_an_import_error(monkeypatch):
    import importlib

    real = importlib.import_module

    def flaky(name, *a, **kw):
        if name == "json":
            raise RuntimeError("a module that fails while importing")
        if name == "csv":
            raise ModuleNotFoundError("not installed")
        return real(name, *a, **kw)

    monkeypatch.setattr(importlib, "import_module", flaky)
    with pytest.raises(RuntimeError, match="fails while importing"):
        teval.pydoc_corpus()
    monkeypatch.setattr(teval, "_PYDOC_MODULES", ("csv", "heapq"))
    assert [n.split(".")[0] for n, _t, _b in teval.pydoc_corpus()] == [
        "heapq"] * len(teval.pydoc_corpus())


def _minilm(tmp_path):
    from .test_retrieval_quality import _minilm_checkpoint

    return _minilm_checkpoint(tmp_path)


def test_torch_helpers_match_jax(tmp_path):
    import torch

    ckpt, model = _minilm(tmp_path)
    tok = tenc.TorchEncoder.from_hf(ckpt, device="cpu").tokenizer
    texts = TEXTS + ["x"]
    np.testing.assert_array_equal(
        teval.torch_reference_embedder(model, tok)(texts),
        jeval.torch_reference_embedder(model, tok)(texts))
    pairs = list(zip(QUERIES, TEXTS))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    out = []
    for mod in (jeval, teval):
        model.load_state_dict(state)
        torch.manual_seed(0)
        out.append(mod.train_contrastive_torch(model, tok, pairs, steps=2,
                                               batch=4, max_len=8))
    assert out[0] == out[1] and out[1]["steps"] == 2


def test_evaluate_retrieval_over_the_port_matches_jax(tmp_path):
    from pathway_tpu.stdlib.indexing.inner_index import BruteForceKnn as JKnn
    from pathway_tpu_torch.stdlib.indexing.inner_index import (
        BruteForceKnn as TKnn)

    ckpt, _model = _minilm(tmp_path)
    corpus, queries, qrels = teval.synthetic_beir_corpus(
        n_topics=20, docs_per_topic=5, n_queries_per_topic=2, seed=3)
    doc_ids = list(corpus)
    jenc_ = jenc.JaxEncoder.from_hf(ckpt, seq_buckets=(64,),
                                    batch_buckets=(1, 128))
    tenc_ = tenc.TorchEncoder.from_hf(ckpt, device="cpu")
    jindex = JKnn(jenc_.dimensions, device_threshold=1 << 30)
    tindex = TKnn(tenc_.dimensions, device="cpu")
    jvecs = jenc_.embed_batch([corpus[d] for d in doc_ids])
    tvecs = tenc_.embed_batch([corpus[d] for d in doc_ids])
    for i in range(len(doc_ids)):
        jindex.add(i, jvecs[i])
        tindex.add(i, tvecs[i])

    def jsearch(q, k):
        return [doc_ids[i] for i, _s in jindex.search(jenc_.embed(q), k)]

    def tsearch(q, k):
        return [doc_ids[i] for i, _s in tindex.search(tenc_.embed(q), k)]

    want = jeval.evaluate_retrieval(jsearch, queries, qrels, k=10)
    got = teval.evaluate_retrieval(tsearch, queries, qrels, k=10)
    assert got["queries"] == want["queries"] == len(queries)
    for m in ("recall", "ndcg", "mrr"):
        assert abs(got[m] - want[m]) <= 1e-4, (m, got, want)
    assert got["recall"] > 0.5


# -- chip_smoke.py's phase 4l, on the CPU at small sizes ----------------------

def test_chip_smoke_phase_4l_runs_on_the_cpu(fresh_port):  # noqa: F811
    """Phase 4l end to end on the CPU (every count divided by 16, small
    widths): every check of the phase passes; the index passes that make
    kernel #3's launches on the card are counted by variant."""
    import torch

    import chip_smoke as cs
    from pathway_tpu_torch.internals import config
    from pathway_tpu_torch.models import decoder as dec
    from pathway_tpu_torch.models.clip import (ClipConfig, ClipTextConfig,
                                               ClipVisionConfig)

    small = dict(d_model=32, n_layers=1, n_heads=2, d_ff=64)
    s = cs.rag_rest_inputs(
        torch, dec, "cpu", 0, device="cpu", scale=16,
        enc_cfg=tenc.EncoderConfig(vocab_size=2048, max_len=128,
                                   dtype=torch.float32, **small),
        clip_cfg=ClipConfig(
            vision=ClipVisionConfig(image_size=32, patch_size=8, **small),
            text=ClipTextConfig(vocab_size=2048, max_len=16, **small),
            projection_dim=16, dtype=torch.float32),
        chat_cfg=dec.DecoderConfig(vocab_size=512, max_len=1024,
                                   dtype=torch.float32, **small))
    s.sizes["page"] = (48, 27)
    key = config.pathway_config.license_key
    try:
        line, launches = cs.phase4l(torch, np, dec, s)
    finally:
        config.pathway_config.license_key = key
    z = s.sizes
    tiers, slides, serving = line["tiers"], line["slides"], line["serving"]
    assert tiers["chunks"] == z["topics"] * z["docs_per_topic"] == 64
    assert tiers["knn_passes"] == [1] * z["singles"] + [z["batch"]]
    assert (tiers["knn_gemm"], tiers["knn_gemv"]) == (0, z["singles"] + 1)
    assert slides["pages"] == z["decks"] * z["pages"]
    assert serving["read_connections"] == 2
    assert serving["read_rows"] == z["vs_queries"]
    assert serving["reranked_pairs"] == z["vs_queries"] * z["vs_k"]
    assert min(serving["llm_prompt_tokens"]) >= 256
    assert launches["knn_scores"] == 0  # no pass of 16+ at these sizes
    assert launches["knn_scores_q1"] == (tiers["knn_gemv"]
                                         + slides["knn_gemv"]
                                         + serving["knn_gemv"])
    assert launches["flash_attention"] == 0  # no kernel launches here
