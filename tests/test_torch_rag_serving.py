"""The port's chat and scheduled tiers inside the JAX package's RAG server.

- ``BaseRAGQuestionAnswerer`` (the JAX dataflow, static mode: no HTTP, no
  wall-clock pacing) answers the same questions over the same
  ``DocumentStore`` twice, on one set of decoder weights (the JAX
  ``init_decoder_params`` carried over by ``models/convert.py``): all JAX
  (``JaxChat``, ``llm_scheduler=True``), and with ``llm=TorchChat(...)``
  on the CPU behind the port's ``RequestScheduler`` over
  ``TorchChat.generate_batch``.  The answers must be equal.
- ``TorchChat`` answers one message list (the dense fused tier) as the
  JAX LM's f32 fused program does, and a batch as ``JaxChat``'s does.
- ``SentenceTransformerEmbedder(batch_scheduler=True)`` coalesces
  concurrent ``embed`` calls into fewer encoder forwards, each row equal
  to the unscheduled one; ``CompiledQueryEncoder.embed_scheduled`` gives
  ``embed``'s rows through one shared worker.
"""

import threading

import jax
import numpy as np
import pytest

from pathway_tpu.debug import table_from_markdown
from pathway_tpu.models import decoder as jdec
from pathway_tpu.models import encoder as jenc
from pathway_tpu.stdlib.indexing import BruteForceKnnFactory
from pathway_tpu.xpacks.llm import embedders as jemb
from pathway_tpu.xpacks.llm.document_store import DocumentStore
from pathway_tpu.xpacks.llm.llms import JaxChat
from pathway_tpu.xpacks.llm.question_answering import BaseRAGQuestionAnswerer
from pathway_tpu_torch.models import decoder as tdec
from pathway_tpu_torch.models import encoder as tenc
from pathway_tpu_torch.models.convert import decoder_params_from_numpy
from pathway_tpu_torch.serve import RequestScheduler
from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder
from pathway_tpu_torch.xpacks.llm.llms import TorchChat

from .utils import run_and_squash

DEC = dict(vocab_size=512, d_model=64, n_layers=2, n_heads=4, d_ff=128,
           max_len=128)
ENC = dict(vocab_size=512, d_model=32, n_layers=1, n_heads=2, d_ff=64,
           max_len=64)
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


@pytest.fixture(scope="module")
def weights():
    cfg_j = jdec.DecoderConfig(**DEC)
    cfg_t = tdec.DecoderConfig(**DEC)
    pj = jdec.init_decoder_params(cfg_j, jax.random.PRNGKey(3))
    pt = decoder_params_from_numpy(jax.tree_util.tree_map(np.asarray, pj),
                                   cfg_t, device="cpu")
    return cfg_j, cfg_t, pj, pt


def _store():
    emb = jemb.SentenceTransformerEmbedder(config=jenc.EncoderConfig(**ENC))
    return DocumentStore(table_from_markdown(DOCS),
                         retriever_factory=BruteForceKnnFactory(
                             dimensions=emb.get_embedding_dimension(),
                             embedder=emb))


def _answers(rag) -> list:
    state = run_and_squash(rag.answer_query(table_from_markdown(QUESTIONS)))
    return [row[0] for _k, row in sorted(state.items())]


def test_rag_answers_over_torch_chat_equal_the_jax_pipeline(weights):
    cfg_j, cfg_t, pj, pt = weights
    jax_rag = BaseRAGQuestionAnswerer(
        JaxChat(cfg_j, params=pj, max_new_tokens=NEW), _store(),
        search_topk=2, llm_scheduler=True)
    chat = TorchChat(cfg_t, params=pt, max_new_tokens=NEW, device="cpu")
    sched = RequestScheduler(chat.generate_batch, name="tt_llm",
                             max_batch_size=chat.paged_engine().max_batch_size,
                             batch_linger_ms=5.0)
    try:
        port_rag = BaseRAGQuestionAnswerer(chat, _store(), search_topk=2,
                                           llm_scheduler=sched)
        want = _answers(jax_rag)
        got = _answers(port_rag)
    finally:
        sched.shutdown()
        jax_rag._llm_scheduler.shutdown()
    assert len(got) == 5 and all(len(a.split()) == NEW for a in got)
    assert got == want
    assert sched.stats.completed == 5 and sched.stats.batches >= 1


def test_torch_chat_call_equals_jax_chat(weights):
    cfg_j, cfg_t, pj, pt = weights
    msgs = [{"role": "system", "content": "answer briefly"},
            {"role": "user", "content": "what is a paged kv cache"}]
    jchat = JaxChat(cfg_j, params=pj, max_new_tokens=NEW)
    # JaxChat's own call picks a host tier on the CPU (int8 by default);
    # the port's single-stream tier is the f32 fused program
    want = jchat._lm.generate("system: answer briefly\nuser: what is a "
                              "paged kv cache", NEW, fused=True)
    chat = TorchChat(cfg_t, params=pt, max_new_tokens=NEW, device="cpu")
    assert chat(msgs) == want
    assert chat("what is a paged kv cache") == chat(msgs[1:])
    assert chat.generate_batch([msgs]) == jchat.generate_batch([msgs]) == \
        [want]


def _concurrently(fn, items):
    out = [None] * len(items)
    errors = []

    def run(i):
        try:
            out[i] = fn(items[i])
        except Exception as exc:  # noqa: BLE001 - asserted empty
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(items))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert not errors, errors
    return out


def test_embedder_batch_scheduler_coalesces_forwards():
    cfg = tenc.EncoderConfig(**ENC)
    emb = SentenceTransformerEmbedder(config=cfg, device="cpu",
                                      batch_scheduler=True)
    plain = SentenceTransformerEmbedder(config=cfg, device="cpu")
    forwards = []
    inner = emb.encoder.embed_batch

    def counted(texts):
        forwards.append(len(texts))
        return inner(texts)

    emb.encoder.embed_batch = counted
    texts = [f"question {i} about live data" for i in range(24)]
    try:
        rows = _concurrently(emb.embed, texts)
    finally:
        emb._scheduler.shutdown()
    assert len(forwards) < len(texts)
    # padded up the size ladder: every forward has a bucket's width
    assert all(n in (1, 2, 4, 8, 16, 32, 64) for n in forwards), forwards
    want = np.stack([plain.embed(t) for t in texts])
    np.testing.assert_allclose(np.stack(rows), want, rtol=0, atol=1e-6)


def test_query_encoder_embed_scheduled_equals_embed():
    enc = tenc.TorchEncoder(tenc.EncoderConfig(**ENC), seed=5, device="cpu")
    cq = enc.compiled_query_encoder()
    texts = [f"query {i} on the card" for i in range(12)]
    sched = cq.serving_scheduler(batch_linger_ms=20.0)
    try:
        rows = _concurrently(cq.embed_scheduled, texts)
        assert cq.serving_scheduler() is sched
    finally:
        sched.shutdown()
    for r, t in zip(rows, texts):
        np.testing.assert_array_equal(r, cq.embed(t))
    assert sched.stats.batches < len(texts)
    assert sched.stats.completed == len(texts)
