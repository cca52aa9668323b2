"""RAG question answering, incl. adaptive RAG (the port of
``pathway_tpu/xpacks/llm/question_answering.py``; reference:
xpacks/llm/question_answering.py:184,303,442).

Adaptive RAG: start with a small number of documents; if the LLM refuses to
answer, geometrically grow the context until it answers or the limit is hit —
the reference's accuracy/cost tradeoff, unchanged, but with on-device
embedding+generation.

With ``llm_scheduler=True`` and an llm exposing ``paged_engine()``
(``TorchChat``), the scheduler's batches are sized from the engine that
call returns; a failure to build it raises (the JAX answerer logs it and
decodes serially).  The answer column of ``answer_query`` submits a whole
update batch of questions to the scheduler at once, so they coalesce
into engine batches; each answer is the one a lone call gives.
``DeckRetriever`` answers a prompt with the pages (text and metadata) a
slide document store retrieves for it; it calls no llm.
"""

from __future__ import annotations

import json
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable

from ... import apply_with_type
from ...internals import dtype as dt
from ...internals.expression import ApplyExpression
from ...internals.table import Table
from ...internals.value import Json
from .document_store import DocumentStore

_NO_ANSWER = "No information found."

_warned_serial: set = set()


def _warn_serial_decode(llm, why: str) -> None:
    """One warning per llm class when llm_scheduler=True cannot batch the
    decode tier (max_batch_size stays 1 / decode stays serial) — silent
    degradation here hides an 8x serving-throughput loss."""
    key = type(llm).__name__
    if key in _warned_serial:
        return
    _warned_serial.add(key)
    import logging

    logging.getLogger(__name__).warning(
        "llm_scheduler=True with %s: %s (see kvcache/engine.py for the "
        "batched paged-KV decode path)", key, why,
    )


def _prompt(docs: list[str], query: str) -> str:
    ctx = "\n\n".join(docs)
    return (
        "Use the below articles to answer the subsequent question. If the "
        f'answer cannot be found in the articles, write "{_NO_ANSWER}"\n\n'
        f"{ctx}\n\nQuestion: {query}\nAnswer:"
    )


def _is_no_answer(ans: str) -> bool:
    return not ans or _NO_ANSWER.lower().rstrip(".") in str(ans).lower()


def answer_with_geometric_rag_strategy(
    questions: list[str] | str,
    documents: list[list[str]] | list[str],
    llm: Callable,
    n_starting_documents: int = 2,
    factor: int = 2,
    max_iterations: int = 4,
    strict_prompt: bool = False,
) -> Any:
    """Host-side adaptive RAG over already-retrieved document lists
    (reference: question_answering.py:184)."""
    single = isinstance(questions, str)
    qs = [questions] if single else list(questions)
    ds = [documents] if single else list(documents)
    answers = []
    for q, docs in zip(qs, ds):
        n = n_starting_documents
        answer = _NO_ANSWER
        for _ in range(max_iterations):
            ans = llm([{"role": "user", "content": _prompt(list(docs[:n]), q)}])
            if not _is_no_answer(ans):
                answer = ans
                break
            if n >= len(docs):
                break
            n *= factor
        answers.append(answer)
    return answers[0] if single else answers


def answer_with_geometric_rag_strategy_from_index(
    questions,  # column expression
    index,
    documents_column: str,
    llm: Callable,
    n_starting_documents: int = 2,
    factor: int = 2,
    max_iterations: int = 4,
    strict_prompt: bool = False,
):
    """Column-level adaptive RAG (reference: question_answering.py:303)."""
    max_docs = n_starting_documents * (factor ** (max_iterations - 1))
    reply = index.query_as_of_now(questions, number_of_matches=max_docs)
    docs_col = reply[documents_column]

    def answer(q, docs):
        return answer_with_geometric_rag_strategy(
            q, list(docs or ()), llm, n_starting_documents, factor, max_iterations,
            strict_prompt=strict_prompt,
        )

    return apply_with_type(answer, dt.STR, questions, docs_col)


class BaseRAGQuestionAnswerer:
    """Standard RAG: retrieve k docs, answer with one LLM call
    (reference: question_answering.py:442)."""

    def __init__(
        self,
        llm,
        indexer: DocumentStore,
        *,
        default_llm_name: str | None = None,
        prompt_template: str | Callable[[list[str], str], str] | None = None,
        search_topk: int = 6,
        llm_scheduler=None,
    ):
        self.llm = llm
        self.indexer = indexer
        self.search_topk = search_topk
        # generation tier scheduling (serve/scheduler.py): concurrent answer
        # requests queue through ONE executor with priority/deadline/
        # admission semantics instead of dispatching per call.  When the llm
        # exposes a batch entry point (`generate_batch` or `batch`), a whole
        # coalesced batch is answered in one tier call.
        self._llm_scheduler = None
        if llm_scheduler:
            from ...serve.scheduler import RequestScheduler

            if llm_scheduler is True:
                batch = getattr(llm, "generate_batch", None) or getattr(
                    llm, "batch", None
                )
                if callable(batch):
                    batch_fn = batch
                    # a paged KV engine behind the batch entry point means
                    # the whole coalesced batch decodes in ONE device pass
                    # (kvcache/engine.py) — size the scheduler's batches to
                    # what the engine actually steps together
                    max_bs = 8
                    probe = getattr(llm, "paged_engine", None)
                    if callable(probe):
                        max_bs = max(int(probe().max_batch_size), 2)
                else:
                    # no batch entry point at all: the scheduler still
                    # provides admission/priority semantics, but each item
                    # is a separate llm call — don't pretend otherwise
                    batch_fn = lambda items: [llm(i) for i in items]  # noqa: E731
                    max_bs = 1
                    _warn_serial_decode(
                        llm, "it exposes no generate_batch/batch entry "
                        "point; falling back to serial decode"
                    )
                llm_scheduler = RequestScheduler(
                    batch_fn, name="llm", max_batch_size=max_bs,
                    batch_linger_ms=5.0,
                )
            self._llm_scheduler = llm_scheduler
        if isinstance(prompt_template, str):
            tmpl = prompt_template

            def fmt(docs, query):
                return tmpl.format(context="\n\n".join(docs), query=query)

            self.prompt_fn = fmt
        else:
            self.prompt_fn = prompt_template or _prompt

    def _call_llm(self, messages: list[dict]) -> str:
        if self._llm_scheduler is not None:
            return self._llm_scheduler.submit(messages)
        return self.llm(messages)

    def _call_llm_many(self, batch: list[list[dict]]) -> list[str]:
        """Answers of several message lists: all submitted to the
        scheduler at once (one thread each, so they coalesce into its
        batches), or one llm call after another without a scheduler."""
        if self._llm_scheduler is None or len(batch) < 2:
            return [self._call_llm(m) for m in batch]
        with ThreadPoolExecutor(max_workers=len(batch),
                                thread_name_prefix="pw-answer") as pool:
            return list(pool.map(self._call_llm, batch))

    def _messages(self, prompt, docs) -> list[dict]:
        doc_texts = [d for d in (docs or ())]
        return [{"role": "user", "content": self.prompt_fn(doc_texts, prompt)}]

    def answer_query(self, prompt_queries: Table) -> Table:
        q = prompt_queries
        reply = self.indexer.index.query_as_of_now(
            q.prompt, number_of_matches=self.search_topk
        )

        def run(prompt, docs):
            return self._call_llm(self._messages(prompt, docs))

        def run_many(rows):
            return self._call_llm_many([self._messages(p, d) for p, d in rows])

        return reply.select(result=ApplyExpression(
            run, dt.STR, (q.prompt, reply.text), {}, batch_fn=run_many))

    answer = answer_query

    def summarize_query(self, summarize_queries: Table) -> Table:
        q = summarize_queries

        def run(texts):
            joined = "\n\n".join(texts or ())
            return self._call_llm(
                [{"role": "user", "content": f"Summarize the following:\n\n{joined}"}]
            )

        return q.select(result=apply_with_type(run, dt.STR, q.text_list))

    def build_server(self, host: str, port: int, **kwargs):
        from .servers import QARestServer

        self._server = QARestServer(host, port, self, **kwargs)
        return self._server

    def run_server(self, host: str = "0.0.0.0", port: int = 8080, *,
                   timeout_s: float | None = None, idle_stop_s: float | None = None,
                   device="cuda", **kwargs):
        if not hasattr(self, "_server"):
            self.build_server(host, port, **kwargs)
        self._server.run(timeout_s=timeout_s, idle_stop_s=idle_stop_s,
                         device=device)


class AdaptiveRAGQuestionAnswerer(BaseRAGQuestionAnswerer):
    """Adaptive RAG serving class (reference: question_answering.py — the
    `AdaptiveRAGQuestionAnswerer` template behind demo-question-answering)."""

    def __init__(self, llm, indexer, *, n_starting_documents: int = 2,
                 factor: int = 2, max_iterations: int = 4, **kwargs):
        super().__init__(llm, indexer, **kwargs)
        self.n_starting_documents = n_starting_documents
        self.factor = factor
        self.max_iterations = max_iterations

    def answer_query(self, prompt_queries: Table) -> Table:
        q = prompt_queries
        ans = answer_with_geometric_rag_strategy_from_index(
            q.prompt,
            self.indexer.index,
            "text",
            self.llm,
            n_starting_documents=self.n_starting_documents,
            factor=self.factor,
            max_iterations=self.max_iterations,
        )
        return q.select(result=ans)

    answer = answer_query


class DeckRetriever(BaseRAGQuestionAnswerer):
    """Slide-deck retrieval app (reference: DeckRetriever): each prompt's
    ``search_topk`` pages, as ``{"text", "metadata"}`` dicts."""

    def answer_query(self, prompt_queries: Table) -> Table:
        q = prompt_queries
        reply = self.indexer.index.query_as_of_now(
            q.prompt, number_of_matches=self.search_topk
        )
        return reply.select(
            result=apply_with_type(
                lambda ts, ms: Json([
                    {"text": t, "metadata": m.value if isinstance(m, Json) else m}
                    for t, m in zip(ts or (), ms or ())
                ]),
                dt.JSON, reply.text, reply.metadata,
            )
        )

    answer = answer_query


# ---------------------------------------------------------------------------
# ABCs + context processors + client (reference: question_answering.py
# BaseQuestionAnswerer:388, SummaryQuestionAnswerer:427,
# BaseContextProcessor:39, SimpleContextProcessor:75, RAGClient:1070)
# ---------------------------------------------------------------------------


class BaseContextProcessor:
    """Formats retrieved documents into LLM context; subclasses implement
    docs_to_context(list[dict]) -> str."""

    def maybe_unwrap_docs(self, docs):
        if isinstance(docs, Json):
            docs = docs.value
        return [d.value if isinstance(d, Json) else d for d in (docs or ())]

    def docs_to_context(self, docs) -> str:
        raise NotImplementedError

    def __call__(self, docs) -> str:
        return self.docs_to_context(self.maybe_unwrap_docs(docs))


class SimpleContextProcessor(BaseContextProcessor):
    """Keeps the chosen metadata keys and joins document texts."""

    def __init__(self, context_metadata_keys=("path",),
                 context_joiner: str = "\n\n"):
        self.context_metadata_keys = list(context_metadata_keys)
        self.context_joiner = context_joiner

    def docs_to_context(self, docs) -> str:
        out = []
        for d in docs:
            if not isinstance(d, dict):
                out.append(str(d))
                continue
            text = d.get("text", "")
            meta = d.get("metadata", {}) or {}
            if isinstance(meta, Json):
                meta = meta.value
            kept = {k: meta.get(k) for k in self.context_metadata_keys
                    if isinstance(meta, dict) and meta.get(k) is not None}
            out.append(f"{text} {kept}" if kept else text)
        return self.context_joiner.join(out)


class BaseQuestionAnswerer:
    """Serving ABC: answer_query/retrieve/statistics/inputs over tables
    (reference: question_answering.py:388)."""

    def answer_query(self, pw_ai_queries: Table) -> Table:
        raise NotImplementedError

    def retrieve(self, queries: Table) -> Table:
        raise NotImplementedError

    def statistics(self, queries: Table) -> Table:
        raise NotImplementedError

    def list_documents(self, queries: Table) -> Table:
        raise NotImplementedError


class SummaryQuestionAnswerer(BaseQuestionAnswerer):
    """Adds summarize_query (reference: question_answering.py:427)."""

    def summarize_query(self, summarize_queries: Table) -> Table:
        raise NotImplementedError


def send_post_request(url: str, data: dict, headers: dict | None = None,
                      timeout: float | None = None):
    """POST JSON, raise on HTTP errors, return the parsed response
    (reference: question_answering.py:1062)."""
    import urllib.request

    req = urllib.request.Request(
        url, json.dumps(data).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


class RAGClient:
    """Client for a served RAG app (reference: question_answering.py:1070).
    Either (host and port) or url."""

    def __init__(self, host: str | None = None, port: int | None = None,
                 url: str | None = None, timeout: float | None = 90,
                 additional_headers: dict | None = None):
        err = "Either (`host` and `port`) or `url` must be provided, but not both."
        if url is not None:
            if host is not None or port is not None:
                raise ValueError(err)
            self.url = url
        else:
            if host is None:
                raise ValueError(err)
            port = port or 80
            protocol = "https" if port == 443 else "http"
            self.url = f"{protocol}://{host}:{port}"
        self.timeout = timeout
        self.additional_headers = additional_headers or {}

    def _post(self, route: str, payload: dict):
        return send_post_request(self.url + route, payload,
                                 self.additional_headers, self.timeout)

    def retrieve(self, query: str, k: int = 3,
                 metadata_filter: str | None = None,
                 filepath_globpattern: str | None = None):
        payload = {"query": query, "k": k, "metadata_filter": metadata_filter}
        if filepath_globpattern is not None:
            payload["filepath_globpattern"] = filepath_globpattern
        return self._post("/v1/retrieve", payload)

    def statistics(self):
        return self._post("/v1/statistics", {})

    def pw_list_documents(self, filters: str | None = None):
        payload = {"metadata_filter": filters} if filters else {}
        return self._post("/v1/inputs", payload)

    list_documents = pw_list_documents

    def answer(self, prompt: str, filters: str | None = None,
               model: str | None = None, return_context_docs=None) -> dict:
        payload: dict = {"prompt": prompt}
        if filters:
            payload["filters"] = filters
        if model:
            payload["model"] = model
        if return_context_docs is not None:
            payload["return_context_docs"] = return_context_docs
        return self._post("/v2/answer", payload)

    pw_ai_answer = answer
