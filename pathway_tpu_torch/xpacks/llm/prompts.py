"""Prompt templates (the port of ``pathway_tpu/xpacks/llm/prompts.py``;
reference: xpacks/llm/prompts.py)."""

from __future__ import annotations


def prompt_qa(query: str, docs: list[str], info_not_found_response: str = "No information found.") -> str:
    ctx = "\n\n".join(docs)
    return (
        "Please provide an answer based solely on the provided sources. "
        f'If the sources do not contain the answer, say "{info_not_found_response}".\n\n'
        f"Sources:\n{ctx}\n\nQuestion: {query}\nAnswer:"
    )


def prompt_short_qa(query: str, docs: list[str]) -> str:
    return prompt_qa(query, docs) + " (answer in at most one sentence)"


def prompt_citing_qa(query: str, docs: list[str]) -> str:
    ctx = "\n\n".join(f"[{i + 1}] {d}" for i, d in enumerate(docs))
    return (
        "Answer using the sources below; cite sources as [n].\n\n"
        f"{ctx}\n\nQuestion: {query}\nAnswer:"
    )


def prompt_summarize(texts: list[str]) -> str:
    joined = "\n\n".join(texts)
    return f"Summarize the following texts into a single coherent summary:\n\n{joined}"


def prompt_query_rewrite_hyde(query: str) -> str:
    return (
        "Write a short hypothetical passage that would answer the question "
        f"below (HyDE retrieval).\nQuestion: {query}\nPassage:"
    )
