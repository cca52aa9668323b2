"""REST servers for RAG apps (the port of ``pathway_tpu/xpacks/llm/servers.py``;
reference: xpacks/llm/servers.py:92-250).

``run`` passes ``device`` (default ``"cuda"``) to ``pw.run``: without a
card it raises unless ``device="cpu"``.  Every server built before one
``run`` serves in that run.

Serving-at-scale wiring (serve/ subsystem): every server accepts an
``admission`` argument — an AdmissionController or a kwargs dict — that
bounds how many requests may be pending in the engine at once, rate-limits
per priority class (header ``X-Pathway-Priority``), and sheds overflow with
``429`` + ``Retry-After`` instead of queueing unboundedly.  Backpressure
counters (queue depth, sheds, completions) export through the engine's
``serve/metrics.py`` counters.
"""

from __future__ import annotations

from typing import Any, Callable

from ... import schema_from_types
from ...internals import dtype as dt
from ...internals.schema import SchemaMetaclass
from ...internals.table import Table
from ...io.http import PathwayWebserver, rest_connector


def _make_admission(admission, name: str):
    """None | AdmissionController | dict -> AdmissionController | None."""
    if admission is None:
        return None
    from ...serve.admission import AdmissionController

    if isinstance(admission, AdmissionController):
        return admission
    if isinstance(admission, dict):
        kwargs = dict(admission)
        kwargs.setdefault("name", name)
        return AdmissionController(**kwargs)
    raise TypeError(
        "admission must be an AdmissionController or a kwargs dict, "
        f"got {type(admission).__name__}"
    )


class BaseRestServer:
    """Shared REST host.

    Args:
        host, port: bind address.
        admission: optional admission control shared by every route of this
            server (AdmissionController instance or kwargs dict, e.g.
            ``{"max_pending": 32, "policy": "shed"}``).
        degrade_handler: optional ``(payload, meta) -> response`` cheap tier
            used for over-capacity requests instead of shedding them.
    """

    def __init__(self, host: str, port: int, *, admission=None,
                 degrade_handler: Callable | None = None, **kwargs):
        self.webserver = PathwayWebserver(host=host, port=port,
                                          with_cors=kwargs.get("with_cors", False))
        self.admission = _make_admission(
            admission, name=f"rest:{host}:{port}"
        )
        self.degrade_handler = degrade_handler

    def serve(self, route: str, schema: SchemaMetaclass,
              handler: Callable[[Table], Table], **kwargs) -> None:
        queries, writer = rest_connector(
            webserver=self.webserver, route=route, schema=schema,
            delete_completed_queries=True,
            admission_controller=kwargs.pop("admission_controller",
                                            self.admission),
            degrade_handler=kwargs.pop("degrade_handler",
                                       self.degrade_handler),
        )
        writer(handler(queries))

    def run(self, *, timeout_s: float | None = None, idle_stop_s: float | None = None,
            device="cuda", **kwargs) -> None:
        from ... import run

        run(timeout_s=timeout_s, idle_stop_s=idle_stop_s, device=device,
            **kwargs)


class QARestServer(BaseRestServer):
    """Routes: /v1/retrieve, /v1/statistics, /v1/inputs, /v1/pw_ai_answer
    (reference: servers.py:92)."""

    def __init__(self, host: str, port: int, rag_question_answerer, **kwargs):
        super().__init__(host, port, **kwargs)
        self.rag = rag_question_answerer
        self.serve(
            "/v1/pw_ai_answer",
            schema_from_types(prompt=str),
            self.rag.answer_query,
        )
        self.serve(
            "/v2/answer",
            schema_from_types(prompt=str),
            self.rag.answer_query,
        )
        store = self.rag.indexer
        self.serve(
            "/v1/retrieve",
            schema_from_types(query=str, k=int),
            store.retrieve_query,
        )
        self.serve(
            "/v1/statistics",
            schema_from_types(),
            store.statistics_query,
        )
        self.serve(
            "/v1/inputs",
            schema_from_types(),
            store.inputs_query,
        )


class QASummaryRestServer(QARestServer):
    """Adds /v1/pw_ai_summary (reference: servers.py:168)."""

    def __init__(self, host, port, rag_question_answerer, **kwargs):
        super().__init__(host, port, rag_question_answerer, **kwargs)
        self.serve(
            "/v1/pw_ai_summary",
            schema_from_types(text_list=list),
            self.rag.summarize_query,
        )


class DocumentStoreServer(BaseRestServer):
    """Standalone DocumentStore REST server (reference: servers.py:228)."""

    def __init__(self, host: str, port: int, document_store, **kwargs):
        super().__init__(host, port, **kwargs)
        self.store = document_store
        self.serve(
            "/v1/retrieve", schema_from_types(query=str, k=int), self.store.retrieve_query
        )
        self.serve("/v1/statistics", schema_from_types(), self.store.statistics_query)
        self.serve("/v1/inputs", schema_from_types(), self.store.inputs_query)


def serve_callable(route: str, schema: SchemaMetaclass | None = None, *,
                   host: str = "0.0.0.0", port: int = 8080,
                   webserver: PathwayWebserver | None = None,
                   admission=None, **kwargs):
    """Serve a python callable behind a REST route (reference: servers.py:250)."""

    def wrap(fn: Callable):
        from ... import apply_with_type
        from ...internals import dtype as dt

        nonlocal schema
        if schema is None:
            import inspect

            params = [
                p.name
                for p in inspect.signature(fn).parameters.values()
                if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)
            ]
            schema = schema_from_types(**{p: Any for p in params})
        ws = webserver or PathwayWebserver(host=host, port=port)
        queries, writer = rest_connector(
            webserver=ws, route=route, schema=schema,
            delete_completed_queries=True,
            admission_controller=_make_admission(
                admission, name=f"rest:{route}"
            ),
        )
        cols = [queries[c] for c in schema.column_names()]
        writer(queries.select(result=apply_with_type(fn, dt.ANY, *cols)))
        return fn

    return wrap
