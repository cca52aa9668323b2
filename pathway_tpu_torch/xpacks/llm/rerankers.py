"""Rerankers (the port of ``pathway_tpu/xpacks/llm/rerankers.py``;
reference: xpacks/llm/rerankers.py:60-296).

``EncoderReranker`` scores with the port's embedder (cosine of the query
and document embeddings); ``CrossEncoderReranker`` embeds the joint
``query [SEP] doc`` text with it; ``LLMReranker`` asks any chat (on the
card, ``TorchChat``) for a relevance score; ``FlashRankReranker`` raises,
as in the JAX package.  Without an ``embedder`` the encoder rerankers
build the port's ``SentenceTransformerEmbedder`` on ``device`` (default
``"cuda"``).  ``rerank_topk_filter`` mirrors the reference helper.
"""

from __future__ import annotations

import re

import numpy as np

from ...internals import dtype as dt
from ...internals.expression import ApplyExpression, ColumnExpression


class BaseReranker:
    def _score(self, doc: str, query: str) -> float:
        raise NotImplementedError

    def __call__(self, doc, query, **kwargs):
        if isinstance(doc, ColumnExpression) or isinstance(query, ColumnExpression):
            return ApplyExpression(
                lambda d, q: float(self._score(d or "", q or "")), dt.FLOAT,
                (doc, query), {}, propagate_none=True,
            )
        return self._score(doc, query)


class EncoderReranker(BaseReranker):
    """Bi-encoder cosine scoring (reference: EncoderReranker)."""

    def __init__(self, embedder=None, *, device="cuda", **kwargs):
        if embedder is None:
            from .embedders import SentenceTransformerEmbedder

            embedder = SentenceTransformerEmbedder(device=device)
        self.embedder = embedder

    def _score(self, doc: str, query: str) -> float:
        dv = np.asarray(self.embedder._embed(doc))
        qv = np.asarray(self.embedder._embed(query))
        return float(dv @ qv / ((np.linalg.norm(dv) * np.linalg.norm(qv)) + 1e-12))


class CrossEncoderReranker(BaseReranker):
    """Joint encoding of (query, doc) through the port's encoder; scores
    via the pooled-embedding interaction (reference: CrossEncoderReranker
    backed by sentence_transformers CrossEncoder)."""

    def __init__(self, model_name: str | None = None, embedder=None, *,
                 device="cuda", **kwargs):
        if embedder is None:
            from .embedders import SentenceTransformerEmbedder

            embedder = SentenceTransformerEmbedder(device=device)
        self.embedder = embedder

    def _score(self, doc: str, query: str) -> float:
        joint = np.asarray(self.embedder._embed(f"{query} [SEP] {doc}"))
        qv = np.asarray(self.embedder._embed(query))
        return float(joint @ qv)


class LLMReranker(BaseReranker):
    def __init__(self, llm, *, prompt_template: str | None = None, **kwargs):
        self.llm = llm
        self.template = prompt_template or (
            "Rate the relevance of the document to the query on a scale 1-5. "
            "Answer with a single number.\nQuery: {query}\nDocument: {doc}"
        )

    def _score(self, doc: str, query: str) -> float:
        out = self.llm([{"role": "user",
                         "content": self.template.format(query=query, doc=doc)}])
        m = re.search(r"\d+(\.\d+)?", str(out))
        return float(m.group()) if m else 0.0


class FlashRankReranker(BaseReranker):
    def __init__(self, model_name: str = "ms-marco-TinyBERT-L-2-v2", **kwargs):
        self.model_name = model_name

    def _score(self, doc, query):
        raise ImportError("FlashRankReranker requires flashrank")


def rerank_topk_filter(docs, scores, k: int = 5):
    """Expression helper: keep the top-k docs by score (reference:
    rerank_topk_filter)."""

    def fn(ds, ss):
        pairs = sorted(zip(ds, ss), key=lambda p: -p[1])[:k]
        return (tuple(p[0] for p in pairs), tuple(p[1] for p in pairs))

    return ApplyExpression(fn, dt.ANY, (docs, scores), {}, propagate_none=True)


__all__ = [
    "BaseReranker", "EncoderReranker", "CrossEncoderReranker", "LLMReranker",
    "FlashRankReranker", "rerank_topk_filter",
]
