"""LLM xpack (the port of ``pathway_tpu/xpacks/llm``; reference:
python/pathway/xpacks/llm/): the embedder, the chat, the parsers,
splitters and prompts, the document store, the question answerers and
their REST servers.  Rerankers, the vector store, the MCP server and
evaluation are not ported."""

from . import (
    document_store,
    embedders,
    llms,
    parsers,
    prompts,
    question_answering,
    servers,
    splitters,
)
from .document_store import DocumentStore, DocumentStoreClient

__all__ = [
    "embedders", "llms", "parsers", "splitters", "prompts",
    "document_store", "question_answering", "servers", "DocumentStore",
    "DocumentStoreClient",
]
