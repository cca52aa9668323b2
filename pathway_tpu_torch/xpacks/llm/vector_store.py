"""VectorStoreServer / VectorStoreClient: the legacy embedder-centric
wrapper over DocumentStore (the port of
``pathway_tpu/xpacks/llm/vector_store.py``; reference:
xpacks/llm/vector_store.py:31,356).

Without an ``embedder`` the server builds the port's
``SentenceTransformerEmbedder`` on ``device`` (default ``"cuda"``), and
without an ``index_factory`` a ``BruteForceKnnFactory`` on the same
device.  ``run_server(threaded=True)`` runs ``pw.run`` (given the other
keyword arguments: ``device``, ``timeout_s``, ``idle_stop_s``) on a
thread and returns it; the thread's ``join()`` raises the run's error.
"""

from __future__ import annotations

import threading
from typing import Callable

from ...internals.table import Table
from ...stdlib.indexing import BruteForceKnnFactory
from .document_store import DocumentStore, DocumentStoreClient


class VectorStoreServer:
    def __init__(
        self,
        *docs: Table,
        embedder: Callable | None = None,
        parser=None,
        splitter=None,
        doc_post_processors=None,
        index_factory=None,
        device="cuda",
    ):
        if embedder is None:
            from .embedders import SentenceTransformerEmbedder

            embedder = SentenceTransformerEmbedder(device=device)
        self.embedder = embedder
        if index_factory is None:
            dim = (
                embedder.get_embedding_dimension()
                if hasattr(embedder, "get_embedding_dimension")
                else None
            )
            index_factory = BruteForceKnnFactory(dimensions=dim,
                                                 embedder=embedder,
                                                 device=device)
        self.document_store = DocumentStore(
            list(docs),
            retriever_factory=index_factory,
            parser=parser,
            splitter=splitter,
            doc_post_processors=doc_post_processors,
        )

    @classmethod
    def from_langchain_components(cls, *docs, embedder=None, splitter=None,
                                  **kwargs):
        """``embedder``: an object with ``embed_query(text)``;
        ``splitter``: one with ``split_text(text)`` (LangChain's
        interfaces; nothing of LangChain is imported)."""
        from ...internals import dtype as dt
        from ...internals.expression import ApplyExpression, ColumnExpression

        def split(text):
            if splitter is None:
                return [(text, {})]
            return [(c, {}) for c in splitter.split_text(text)]

        class _LCSplitter:
            def __call__(self, text):
                if isinstance(text, ColumnExpression):
                    return ApplyExpression(
                        lambda t: tuple(split(t or "")), dt.List(dt.ANY),
                        (text,), {})
                return split(text)

        emb = None
        if embedder is not None:
            import numpy as np

            from .embedders import BaseEmbedder

            class _LCEmbedder(BaseEmbedder):
                def _embed(self, t):
                    return np.asarray(embedder.embed_query(t),
                                      dtype=np.float32)

            # the bound call, without get_embedding_dimension: the store
            # does not probe the outside embedder for its width
            emb = _LCEmbedder().__call__
        return cls(*docs, embedder=emb, splitter=_LCSplitter(), **kwargs)

    def run_server(self, host: str, port: int, *, threaded: bool = False,
                   with_cache: bool = True, **kwargs):
        from .servers import DocumentStoreServer

        server = DocumentStoreServer(host, port, self.document_store)
        if threaded:
            thread = _RunThread(server.run, kwargs)
            thread.start()
            return thread
        server.run(**kwargs)


class _RunThread(threading.Thread):
    """A ``pw.run`` on its own thread; ``join`` re-raises its error."""

    def __init__(self, run, kwargs: dict):
        super().__init__(daemon=True, name="pw-vector-store")
        self._run_fn, self._run_kw = run, kwargs
        self.error: BaseException | None = None

    def run(self) -> None:
        try:
            self._run_fn(**self._run_kw)
        except BaseException as exc:  # noqa: BLE001 - re-raised by join
            self.error = exc

    def join(self, timeout: float | None = None) -> None:
        super().join(timeout)
        if self.error is not None:
            raise self.error


class VectorStoreClient(DocumentStoreClient):
    pass
