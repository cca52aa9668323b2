"""The port's question answerers in its own dataflow, against the JAX
package's in its own.

One set of decoder weights (the JAX ``init_decoder_params`` carried over
by ``models/convert.py``) and one encoder tree serve both packages:
``JaxChat`` against ``TorchChat(device="cpu")``, each behind its own
``DocumentStore``.  Static runs (no HTTP, no wall-clock pacing); greedy
f32 answers must be equal as strings.

- ``BaseRAGQuestionAnswerer(llm_scheduler=True)``: the port's scheduler
  over ``TorchChat.generate_batch`` (the paged engine), its batches
  sized from ``TorchChat.paged_engine()``;
- the answer column submits a whole update batch at once, so five
  questions of one time coalesce into one engine batch;
- ``AdaptiveRAGQuestionAnswerer`` (no scheduler: the dense tier), and
  the geometric strategy on host lists, growing its context while the
  llm says it found nothing;
- the context processors and ``RAGClient``'s addressing.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.engine import runner as jrunner
from pathway_tpu.internals import parse_graph as jpg
from pathway_tpu.models import decoder as jdec
from pathway_tpu.models import encoder as jenc
from pathway_tpu.stdlib.indexing import BruteForceKnnFactory as JFactory
from pathway_tpu.xpacks.llm import embedders as jemb
from pathway_tpu.xpacks.llm import question_answering as jqa
from pathway_tpu.xpacks.llm.document_store import DocumentStore as JStore
from pathway_tpu.xpacks.llm.llms import JaxChat
from pathway_tpu_torch.engine import runner as trunner
from pathway_tpu_torch.internals import parse_graph as tpg
from pathway_tpu_torch.models import decoder as tdec
from pathway_tpu_torch.models import encoder as tenc
from pathway_tpu_torch.models.convert import (decoder_params_from_numpy,
                                              encoder_params_from_numpy)
from pathway_tpu_torch.obs import costdb, planner
from pathway_tpu_torch.serve import RequestScheduler
from pathway_tpu_torch.stdlib.indexing import BruteForceKnnFactory as TFactory
from pathway_tpu_torch.xpacks.llm import embedders as temb
from pathway_tpu_torch.xpacks.llm import question_answering as tqa
from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore as TStore
from pathway_tpu_torch.xpacks.llm.llms import TorchChat

from .test_torch_encoder import _configs, _np_params

DEC = dict(vocab_size=512, d_model=64, n_layers=2, n_heads=4, d_ff=128,
           max_len=128)
NEW = 8
DOCS = """
        | data
      1 | "the quick brown fox jumps over the lazy dog"
      2 | "pathway is a stream processing framework for live data"
      3 | "tpus have a systolic array called the mxu"
      4 | "a paged kv cache holds the keys and values of every request"
    """
QUESTIONS = """
        | prompt
      1 | "what is the mxu"
      2 | "which animal jumps"
      3 | "what holds the keys and values"
      4 | "what processes live data"
      5 | "tell me about stream processing"
    """


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
    cfg_j, cfg_t = jdec.DecoderConfig(**DEC), tdec.DecoderConfig(**DEC)
    pj = jdec.init_decoder_params(cfg_j, jax.random.PRNGKey(3))
    pt = decoder_params_from_numpy(jax.tree_util.tree_map(np.asarray, pj),
                                   cfg_t, device="cpu")
    ecfg_j, ecfg_t = _configs("pre")
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, pj=pj, pt=pt, ecfg_j=ecfg_j,
                ecfg_t=ecfg_t, etree=_np_params(5, post_ln=False))


def _jax_store(w):
    emb = jemb.SentenceTransformerEmbedder(config=w["ecfg_j"])
    emb._enc = jenc.JaxEncoder(w["ecfg_j"], params=jax.tree_util.tree_map(
        jnp.asarray, w["etree"]))
    return JStore(jpw.debug.table_from_markdown(DOCS),
                  retriever_factory=JFactory(
                      dimensions=emb.get_embedding_dimension(), embedder=emb))


def _port_store(w):
    emb = temb.SentenceTransformerEmbedder(config=w["ecfg_t"], device="cpu",
                                           device_resident=True)
    emb._enc = tenc.TorchEncoder(w["ecfg_t"], params=encoder_params_from_numpy(
        w["etree"], w["ecfg_t"], device="cpu"), device="cpu")
    return TStore(tpw.debug.table_from_markdown(DOCS),
                  retriever_factory=TFactory(
                      dimensions=emb.get_embedding_dimension(), embedder=emb,
                      device="cpu"))


def _answers(pkg, rag) -> dict:
    pw, runner = (jpw, jrunner) if pkg == "jax" else (tpw, trunner)
    kw = {"device": "cpu"} if pkg == "torch" else {}
    [cap] = runner.run_tables(
        rag.answer_query(pw.debug.table_from_markdown(QUESTIONS)), **kw)
    return {k: row[0] for k, row in cap.squash().items()}


def _chats(w):
    """JaxChat held to its f32 fused tier (on the CPU its ``"auto"`` tier
    is the int8 host decoder), and the port's chat (``"auto"`` is the
    fused f32 tier there)."""
    jchat = JaxChat(w["cfg_j"], params=w["pj"], max_new_tokens=NEW)
    jchat._lm.generate = functools.partial(jchat._lm.generate, fused=True)
    return jchat, TorchChat(w["cfg_t"], params=w["pt"], max_new_tokens=NEW,
                            device="cpu")


@pytest.mark.parametrize("kind", ["base_scheduled", "adaptive"])
def test_answers_equal_the_jax_answerers(weights, kind):
    jchat, tchat = _chats(weights)
    if kind == "base_scheduled":
        jrag = jqa.BaseRAGQuestionAnswerer(jchat, _jax_store(weights),
                                           search_topk=2, llm_scheduler=True)
        trag = tqa.BaseRAGQuestionAnswerer(tchat, _port_store(weights),
                                           search_topk=2, llm_scheduler=True)
        # sized from the port's paged engine, which answers through it
        assert trag._llm_scheduler.max_batch_size == \
            tchat.paged_engine().max_batch_size
    else:
        kw = dict(n_starting_documents=1, factor=2, max_iterations=2)
        jrag = jqa.AdaptiveRAGQuestionAnswerer(jchat, _jax_store(weights), **kw)
        trag = tqa.AdaptiveRAGQuestionAnswerer(tchat, _port_store(weights),
                                               **kw)
    want = _answers("jax", jrag)
    got = _answers("torch", trag)
    assert len(got) == 5 and all(isinstance(a, str) and a for a in got.values())
    assert got == want
    if kind == "base_scheduled":
        eng = tchat.paged_engine()
        assert eng.rounds["mixed"] + eng.rounds.get("prefill", 0) > 0


def test_an_update_batch_of_questions_coalesces_into_one_engine_batch(
        weights):
    _jchat, tchat = _chats(weights)
    sched = RequestScheduler(tchat.generate_batch, name="t-rag-coalesce",
                             max_batch_size=8, batch_linger_ms=300.0)
    rag = tqa.BaseRAGQuestionAnswerer(tchat, _port_store(weights),
                                      search_topk=2, llm_scheduler=sched)
    got = _answers("torch", rag)
    sched.shutdown()
    assert sched.stats.batches == 1 and sched.stats.batched_requests == 5
    # the same answers as one question at a time through the engine
    tpg.G.clear()
    one = RequestScheduler(tchat.generate_batch, name="t-rag-one",
                           max_batch_size=1)
    alone = tqa.BaseRAGQuestionAnswerer(tchat, _port_store(weights),
                                        search_topk=2, llm_scheduler=one)
    assert _answers("torch", alone) == got
    one.shutdown()
    assert one.stats.batches == 5


def test_geometric_strategy_grows_the_context_until_an_answer():
    seen = []

    def llm(messages):
        prompt = messages[0]["content"]
        seen.append(prompt.count("doc"))
        return "No information found." if "doc3" not in prompt else "found"

    docs = [f"doc{i}" for i in range(8)]
    for mod in (tqa, jqa):
        seen.clear()
        ans = mod.answer_with_geometric_rag_strategy(
            "q", docs, llm, n_starting_documents=1, factor=2,
            max_iterations=4)
        assert (ans, seen) == ("found", [1, 2, 4])
    assert tqa.answer_with_geometric_rag_strategy(
        ["q", "q"], [docs[:2], docs], llm, 1, 2, 2) == \
        jqa.answer_with_geometric_rag_strategy(
            ["q", "q"], [docs[:2], docs], llm, 1, 2, 2)


def test_context_processor_and_client_addressing():
    docs = [{"text": "a", "metadata": {"path": "/x", "n": 1}},
            tpw.Json({"text": "b", "metadata": {}}), "c"]
    jdocs = [docs[0], jpw.Json({"text": "b", "metadata": {}}), "c"]
    got = tqa.SimpleContextProcessor()(docs)
    assert got == jqa.SimpleContextProcessor()(jdocs) == \
        "a {'path': '/x'}\n\nb\n\nc"
    for kw, url in ((dict(host="h", port=8000), "http://h:8000"),
                    (dict(host="h", port=443), "https://h:443"),
                    (dict(url="http://u"), "http://u")):
        assert tqa.RAGClient(**kw).url == jqa.RAGClient(**kw).url == url
    with pytest.raises(ValueError, match="not both"):
        tqa.RAGClient(host="h", url="http://u")
