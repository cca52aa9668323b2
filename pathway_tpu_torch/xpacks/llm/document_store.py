"""DocumentStore: live ingestion -> parse -> post-process -> split -> index,
plus query tables (the port of ``pathway_tpu/xpacks/llm/document_store.py``;
reference: xpacks/llm/document_store.py:54-572).

The retrieval path is the engine's index-as-a-join: retrieve_query uses
query_as_of_now so each query is answered exactly once (SURVEY.md §3.5).
Without a ``retriever_factory`` the store builds the port's
``SentenceTransformerEmbedder`` and ``BruteForceKnnFactory`` on
``device`` (default ``"cuda"``: without a card it raises unless
``device="cpu"``).  ``SlidesDocumentStore`` adds
``parsed_documents_query``: the parsed (pre-split) documents' metadata,
bulky fields dropped, optionally filtered by a jmespath expression.
"""

from __future__ import annotations

import enum
import json
from typing import Any, Callable, Iterable

from ... import apply, apply_with_type, this
from ...internals import dtype as dt
from ...internals import reducers as R
from ...internals.table import Table
from ...internals.value import Json
from ...stdlib.indexing import AbstractRetrieverFactory, BruteForceKnnFactory
from .parsers import Utf8Parser
from .splitters import NullSplitter


class IndexingStatus(str, enum.Enum):
    """Document indexing lifecycle (reference: document_store.py:49)."""

    INDEXED = "INDEXED"
    INGESTED = "INGESTED"


class DocumentStore:
    """docs: table(s) with `data` (bytes|str) and optional `_metadata`."""

    def __init__(
        self,
        docs: Table | Iterable[Table],
        retriever_factory: AbstractRetrieverFactory | None = None,
        parser=None,
        splitter=None,
        doc_post_processors: list[Callable[[str, dict], tuple[str, dict]]] | None = None,
        *,
        device="cuda",
    ):
        if isinstance(docs, Table):
            docs_list = [docs]
        else:
            docs_list = list(docs)
        self.docs = docs_list[0] if len(docs_list) == 1 else docs_list[0].concat_reindex(*docs_list[1:])
        if retriever_factory is None:
            from .embedders import SentenceTransformerEmbedder

            emb = SentenceTransformerEmbedder(device=device)
            retriever_factory = BruteForceKnnFactory(
                dimensions=emb.get_embedding_dimension(), embedder=emb,
                device=device,
            )
        self.retriever_factory = retriever_factory
        self.parser = parser or Utf8Parser()
        self.splitter = splitter or NullSplitter()
        self.doc_post_processors = doc_post_processors or []
        self.build_pipeline()

    # ------------------------------------------------------------------
    def build_pipeline(self) -> None:
        docs = self.docs
        has_meta = "_metadata" in docs.column_names()
        meta_expr = docs._metadata if has_meta else Json({})

        parsed = docs.select(
            _pw_chunks=self.parser(docs.data),
            _pw_meta=meta_expr,
        )
        parsed = parsed.flatten(parsed._pw_chunks)
        parsed = parsed.select(
            text=parsed._pw_chunks[0],
            metadata=apply_with_type(_merge_meta, dt.JSON, parsed._pw_meta, parsed._pw_chunks[1]),
        )
        for post in self.doc_post_processors:
            parsed = parsed.select(
                _pw_pp=apply(lambda t, m, _p=post: tuple(_p(t, m)), parsed.text, parsed.metadata)
            ).select(text=this._pw_pp[0], metadata=this._pw_pp[1])

        self.parsed_docs = parsed  # post-parse, pre-split
        chunked = parsed.select(
            _pw_pieces=self.splitter(parsed.text), metadata=parsed.metadata
        )
        chunked = chunked.flatten(chunked._pw_pieces)
        self.chunked_docs = chunked.select(
            text=chunked._pw_pieces[0],
            metadata=apply_with_type(
                _merge_meta, dt.JSON, chunked.metadata, chunked._pw_pieces[1]
            ),
        )
        self.index = self.retriever_factory.build_index(
            self.chunked_docs.text,
            self.chunked_docs,
            metadata_column=self.chunked_docs.metadata,
        )

    # ------------------------------------------------------------------
    # query tables (reference: retrieve_query / statistics_query / inputs_query)
    # ------------------------------------------------------------------
    class RetrieveQuerySchema:
        pass  # columns: query, k, metadata_filter, filepath_globpattern

    def retrieve_query(self, retrieval_queries: Table) -> Table:
        q = retrieval_queries
        cols = q.column_names()
        k_expr = q.k if "k" in cols else 3
        mf = q.metadata_filter if "metadata_filter" in cols else None
        reply = self.index.query_as_of_now(
            q.query, number_of_matches=k_expr, metadata_filter=mf
        )
        return reply.select(
            result=apply_with_type(
                _pack_results, dt.JSON,
                reply.text, reply.metadata, reply._pw_index_reply_score,
            )
        )

    def statistics_query(self, info_queries: Table) -> Table:
        stats = self.chunked_docs.reduce(
            count=R.count(),
        )
        joined = info_queries.asof_now_join(
            stats, how="left", id=info_queries.id
        ).select(
            result=apply_with_type(
                lambda c: Json({"file_count": c or 0, "chunk_count": c or 0}),
                dt.JSON, stats.count,
            )
        )
        return joined

    def inputs_query(self, input_queries: Table) -> Table:
        docs_meta = self.chunked_docs.reduce(
            metadatas=R.tuple(self.chunked_docs.metadata),
        )
        joined = input_queries.asof_now_join(
            docs_meta, how="left", id=input_queries.id
        ).select(
            result=apply_with_type(
                lambda ms: Json([m.value if isinstance(m, Json) else m for m in (ms or ())]),
                dt.JSON, docs_meta.metadatas,
            )
        )
        return joined


def _merge_meta(base, extra) -> Json:
    b = base.value if isinstance(base, Json) else (base or {})
    e = extra.value if isinstance(extra, Json) else (extra or {})
    if not isinstance(b, dict):
        b = {"value": b}
    out = dict(b)
    if isinstance(e, dict):
        out.update(e)
    return Json(out)


def _pack_results(texts, metas, scores) -> Json:
    out = []
    for t, m, s in zip(texts or (), metas or (), scores or ()):
        out.append(
            {
                "text": t,
                "metadata": m.value if isinstance(m, Json) else m,
                "dist": -float(s),
                "score": float(s),
            }
        )
    return Json(out)


class SlidesDocumentStore(DocumentStore):
    """Slide-search document store (reference: document_store.py:576).

    Adds ``parsed_documents_query``: the metadata of every document after
    the parsing / post-processing stages (pre-split), with the fields
    named in ``excluded_response_metadata`` (``b64_image``) dropped from
    the responses and an optional jmespath ``metadata_filter``."""

    excluded_response_metadata = ["b64_image"]

    def parsed_documents_query(self, parse_docs_queries: Table) -> Table:
        docs = self.parsed_docs
        all_metas = docs.reduce(metadatas=R.tuple(docs.metadata))
        cols = parse_docs_queries.column_names()
        mf = (parse_docs_queries.metadata_filter
              if "metadata_filter" in cols else None)
        excluded = list(self.excluded_response_metadata)

        def fmt(metadatas, metadata_filter) -> Json:
            metas = [m.value if isinstance(m, Json) else m
                     for m in (metadatas or ())]
            if metadata_filter:
                from ...stdlib.indexing.jmespath_filter import evaluate_filter

                metas = [m for m in metas
                         if evaluate_filter(metadata_filter, m)]
            out = []
            for m in metas:
                m = dict(m) if isinstance(m, dict) else {"value": m}
                for k in excluded:
                    m.pop(k, None)
                out.append(m)
            return Json(out)

        return parse_docs_queries.asof_now_join(
            all_metas, how="left", id=parse_docs_queries.id
        ).select(
            result=apply_with_type(fmt, dt.JSON, all_metas.metadatas, mf)
        )


class DocumentStoreClient:
    """HTTP client for a served DocumentStore (reference: document_store.py:637)."""

    def __init__(self, host: str, port: int, timeout: float = 30.0):
        self.base = f"http://{host}:{port}"
        self.timeout = timeout

    def _post(self, route: str, payload: dict) -> Any:
        import urllib.request

        req = urllib.request.Request(
            self.base + route, json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return json.loads(r.read())

    def retrieve(self, query: str, k: int = 3, metadata_filter: str | None = None):
        return self._post(
            "/v1/retrieve", {"query": query, "k": k, "metadata_filter": metadata_filter}
        )

    def statistics(self):
        return self._post("/v1/statistics", {})

    def list_documents(self):
        return self._post("/v1/inputs", {})

    query = retrieve
