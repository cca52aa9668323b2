"""The port's ``SentenceTransformerEmbedder`` stands in for the JAX one.

- the JAX package's ``EncoderReranker`` and ``CrossEncoderReranker`` run
  over the port's embedder with no wrapper, and score as they do over
  the JAX embedder on the same converted weights (f32, within 1e-5);
- ``cache_strategy=InMemoryCache()`` / ``DiskCache(dir)``: the second
  embedding of a text is a hit, under the JAX package's key; a
  ``DiskCache`` directory written by the JAX embedder serves the port's,
  and one written by the port's serves the JAX one;
- ``__call__`` on a string embeds it (a ``rag.embed`` span), on a
  column expression of the port's dataflow gives the ``ApplyExpression``
  over ``_embed_traced`` with ``batch_fn=_embed_many_traced``, and on
  anything else raises ``TypeError``; ``_embed_many`` gives handles or
  rows;
- the e2e flow of ``tests/test_e2e_rag.py``'s
  ``test_rag_answers_through_scheduler_with_429_on_overflow`` over the
  port's embedder inside the JAX dataflow: the JAX
  ``BaseEmbedder.__call__`` builds that dataflow's expressions over the
  port's own ``_embed_traced`` and ``_embed_many_traced``, and the server
  answers through the scheduler and sheds overflow with 429.
"""

import hashlib
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pathway_tpu as pw
from pathway_tpu.internals import udfs as judfs
from pathway_tpu.models import encoder as jenc
from pathway_tpu.stdlib.indexing import BruteForceKnnFactory
from pathway_tpu.xpacks.llm import embedders as jemb
from pathway_tpu.xpacks.llm.document_store import DocumentStore
from pathway_tpu.xpacks.llm.question_answering import BaseRAGQuestionAnswerer
from pathway_tpu.xpacks.llm.rerankers import (CrossEncoderReranker,
                                              EncoderReranker)
from pathway_tpu.xpacks.llm.servers import QARestServer
from pathway_tpu_torch import obs
from pathway_tpu_torch.internals import udfs as tudfs
from pathway_tpu_torch.models import encoder as tenc
from pathway_tpu_torch.models.convert import encoder_params_from_numpy
from pathway_tpu_torch.ops.device_store import DeviceVec
from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder

from .test_e2e_rag import _free_port, _poll_until, _post_raw
from .test_torch_encoder import _configs, _np_params

SCORE_TOL = dict(atol=1e-5, rtol=1e-5)
PAIRS = [("the quick brown fox", "a fox"),
         ("pathway indexes live data", "stream processing"),
         ("", "empty document"),
         ("keys and values of every request", "paged kv cache")]


@pytest.fixture(scope="module")
def weights():
    cfg_j, cfg_t = _configs("pre")
    return cfg_j, cfg_t, _np_params(21, post_ln=False)


def _jax_embedder(weights, **kw):
    cfg_j, _cfg_t, tree = weights
    emb = jemb.SentenceTransformerEmbedder(config=cfg_j, **kw)
    emb._enc = jenc.JaxEncoder(
        cfg_j, params=jax.tree_util.tree_map(jnp.asarray, tree))
    return emb


def _port_embedder(weights, **kw):
    _cfg_j, cfg_t, tree = weights
    emb = SentenceTransformerEmbedder(config=cfg_t, device="cpu", **kw)
    emb._enc = tenc.TorchEncoder(cfg_t, params=encoder_params_from_numpy(
        tree, cfg_t, device="cpu"), device="cpu")
    return emb


@pytest.mark.parametrize("reranker", [EncoderReranker, CrossEncoderReranker])
def test_jax_rerankers_run_over_the_port_embedder(weights, reranker):
    port = reranker(embedder=_port_embedder(weights))
    ref = reranker(embedder=_jax_embedder(weights))
    got = [port(doc, query) for doc, query in PAIRS]
    want = [ref(doc, query) for doc, query in PAIRS]
    assert all(isinstance(s, float) for s in got)
    np.testing.assert_allclose(got, want, **SCORE_TOL)


class _Counting:
    """Counts ``_embed_uncached`` calls of an embedder."""

    def __init__(self, emb):
        self.n = 0
        inner = emb._embed_uncached

        def counted(text):
            self.n += 1
            return inner(text)

        emb._embed_uncached = counted


@pytest.mark.parametrize("kind", ["memory", "disk"])
def test_cache_strategy_hits_on_the_second_call(weights, kind, tmp_path):
    cache = (tudfs.InMemoryCache() if kind == "memory"
             else tudfs.DiskCache(str(tmp_path)))
    emb = _port_embedder(weights, cache_strategy=cache)
    calls = _Counting(emb)
    first = emb._embed("a cached text")
    second = emb._embed("a cached text")
    assert calls.n == 1 and np.array_equal(first, second)
    emb.embed("another text")
    assert calls.n == 2
    assert np.array_equal(emb("a cached text"), first)  # __call__ too
    assert calls.n == 2
    # the JAX package's key, under the name emb:<model_name>
    key = judfs._cache_key(f"emb:{emb.model_name}", ("a cached text",), {})
    assert key == tudfs._cache_key(f"emb:{emb.model_name}",
                                   ("a cached text",), {})
    assert np.array_equal(cache.lookup(key)[0], first)
    if kind == "disk":
        assert len(os.listdir(tmp_path)) == 2


def test_a_disk_cache_is_shared_between_the_packages(weights, tmp_path):
    texts = ["written by jax", "written by the port"]
    j_emb = _jax_embedder(weights,
                          cache_strategy=judfs.DiskCache(str(tmp_path)))
    want = j_emb._embed(texts[0])
    t_emb = _port_embedder(weights,
                           cache_strategy=tudfs.DiskCache(str(tmp_path)))
    calls = _Counting(t_emb)
    assert np.array_equal(t_emb._embed(texts[0]), want)  # read, not computed
    assert calls.n == 0
    row = t_emb._embed(texts[1])
    assert calls.n == 1
    j_calls = []
    j_inner = j_emb._enc.embed
    j_emb._enc.embed = lambda t: j_calls.append(t) or j_inner(t)
    assert np.array_equal(j_emb._embed(texts[1]), row)
    assert not j_calls
    assert sorted(os.listdir(tmp_path)) == sorted(
        hashlib.sha256(judfs._cache_key(f"emb:{j_emb.model_name}", (t,),
                                        {}).encode()).hexdigest()
        for t in texts)


def test_call_embeds_a_string_and_refuses_anything_else(weights):
    emb = _port_embedder(weights)
    obs.recorder().clear()
    row = emb("a question")
    assert isinstance(row, np.ndarray)
    assert row.shape == (emb.encoder.dimensions,)
    np.testing.assert_allclose(row, emb._embed_uncached("a question"),
                               atol=0, rtol=0)
    spans = [s for s in obs.recorder().snapshot() if s.name == "rag.embed"]
    assert spans and spans[-1].attrs == {
        "n": 1, "embedder": "SentenceTransformerEmbedder"}
    for bad in (None, 3, ["a question"], b"bytes"):
        with pytest.raises(TypeError, match="a str or a column expression"):
            emb(bad)
    # a column expression of the port's dataflow: one row per text, one
    # update batch per call
    import pathway_tpu_torch as tpw
    from pathway_tpu_torch.internals import parse_graph as tpg
    from pathway_tpu_torch.internals.expression import ApplyExpression

    tpg.G.clear()
    t = tpw.debug.table_from_markdown("text\n1 | a")
    expr = emb(t.text)
    tpg.G.clear()
    assert isinstance(expr, ApplyExpression)
    assert expr._batch_fn == emb._embed_many_traced
    assert expr._fun == emb._embed_traced and expr._propagate_none


@pytest.mark.parametrize("resident", [False, True])
def test_embed_many_gives_rows_or_handles(weights, resident):
    emb = _port_embedder(weights, device_resident=resident)
    obs.recorder().clear()
    out = emb._embed_many_traced(["one", None, "three"])
    assert len(out) == 3
    if resident:
        assert all(isinstance(h, DeviceVec) for h in out)
        rows = [np.asarray(h) for h in out]
    else:
        assert all(isinstance(r, np.ndarray) for r in out)
        rows = out
    for text, r in zip(["one", "", "three"], rows):
        np.testing.assert_allclose(r, emb._embed_uncached(text), atol=1e-6)
    [span] = [s for s in obs.recorder().snapshot() if s.name == "rag.embed"]
    assert span.attrs["n"] == 3


def test_rag_answers_through_scheduler_with_429_over_the_port(weights,
                                                              tmp_path):
    """``tests/test_e2e_rag.py``'s scheduler flow, the port's embedder in
    the document store."""
    docs_dir = tmp_path / "docs"
    docs_dir.mkdir()
    (docs_dir / "a.txt").write_text("zeta compendium about request scheduling")
    emb = SentenceTransformerEmbedder(
        config=tenc.EncoderConfig(vocab_size=2048, d_model=48, n_layers=2,
                                  n_heads=4, d_ff=96, max_len=48),
        device="cpu")
    docs = pw.io.fs.read(str(docs_dir), format="binary", mode="streaming",
                         with_metadata=True)
    store = DocumentStore(docs, retriever_factory=BruteForceKnnFactory(
        dimensions=emb.get_embedding_dimension(),
        embedder=lambda col: jemb.BaseEmbedder.__call__(emb, col)))

    llm_gate = threading.Event()
    llm_gate.set()

    def gated_llm(msgs):
        llm_gate.wait(6.0)
        return "A[" + msgs[0]["content"][:16] + "]"

    rag = BaseRAGQuestionAnswerer(gated_llm, store, search_topk=1,
                                  llm_scheduler=True)
    port = _free_port()
    QARestServer("127.0.0.1", port, rag,
                 admission={"max_pending": 2, "retry_after_s": 2.0})
    results = {"overflow": []}

    def client():
        results["warm"] = _poll_until(
            lambda: (r := _post_raw(port, "/v1/pw_ai_answer",
                                    {"prompt": "what is zeta"}, timeout=10))
            and r[0] == 200 and r,
            deadline_s=10.0,
        )
        results["retrieve"] = _post_raw(port, "/v1/retrieve",
                                        {"query": "zeta scheduling", "k": 1})
        llm_gate.clear()
        threads, statuses = [], [None] * 6

        def fire(i):
            statuses[i] = _post_raw(port, "/v1/pw_ai_answer",
                                    {"prompt": f"storm {i}"}, timeout=15)

        for i in range(6):
            t = threading.Thread(target=fire, args=(i,))
            t.start()
            threads.append(t)
            time.sleep(0.05)
        time.sleep(0.3)
        llm_gate.set()
        for t in threads:
            t.join(timeout=20)
        results["overflow"] = statuses

    th = threading.Thread(target=client, daemon=True)
    th.start()
    pw.run(timeout_s=14.0, autocommit_duration_ms=40,
           monitoring_level=pw.MonitoringLevel.NONE)
    th.join(timeout=5)
    assert not th.is_alive()

    status, body, _hdrs = results["warm"]
    assert status == 200 and body.startswith("A["), results["warm"]
    assert rag._llm_scheduler.stats.completed >= 1
    status, hits, _hdrs = results["retrieve"]
    assert status == 200 and "zeta" in hits[0]["text"]
    statuses = [s for s in results["overflow"] if s is not None]
    shed = [s for s in statuses if s[0] == 429]
    assert shed, f"overflow must shed with 429, got {[s[0] for s in statuses]}"
    for _code, body, hdrs in shed:
        assert int(hdrs.get("Retry-After", 0)) >= 1 and "error" in body
    for _code, body, _hdrs in (s for s in statuses if s[0] == 200):
        assert body.startswith("A[")
