"""LLM xpack (the port of ``pathway_tpu/xpacks/llm``; reference:
python/pathway/xpacks/llm/): the embedder, the chat, the parsers,
splitters and prompts, the document stores (``DocumentStore``,
``SlidesDocumentStore``), the question answerers and their REST servers,
the rerankers, the vector store, the MCP server and retrieval
evaluation.  Of the parsers, ``default_vision_llm``, ``AudioParser`` and
``TwelveLabsVideoParser`` are not ported: each drives an outside
service."""

from . import (
    document_store,
    embedders,
    evaluate,
    llms,
    mcp_server,
    parsers,
    prompts,
    question_answering,
    rerankers,
    servers,
    splitters,
    vector_store,
)
from .document_store import (DocumentStore, DocumentStoreClient,
                             SlidesDocumentStore)
from .vector_store import VectorStoreClient, VectorStoreServer


def token_count(text: str) -> int:
    from ...models.tokenizer import HashTokenizer

    return HashTokenizer().count_tokens(text)


__all__ = [
    "embedders", "llms", "parsers", "splitters", "rerankers", "prompts",
    "document_store", "vector_store", "question_answering", "servers",
    "mcp_server", "evaluate", "DocumentStore", "SlidesDocumentStore",
    "DocumentStoreClient", "VectorStoreServer", "VectorStoreClient",
    "token_count",
]
