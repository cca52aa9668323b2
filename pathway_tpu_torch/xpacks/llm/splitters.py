"""Text splitters (the port of ``pathway_tpu/xpacks/llm/splitters.py``;
reference: xpacks/llm/splitters.py:21-177).  A splitter maps a text to
``[(chunk, metadata)]`` and is callable on column expressions."""

from __future__ import annotations

import re

from ...internals import dtype as dt
from ...internals.expression import ApplyExpression, ColumnExpression


class BaseSplitter:
    def _split(self, text: str) -> list[tuple[str, dict]]:
        raise NotImplementedError

    def __call__(self, text, **kwargs):
        if isinstance(text, ColumnExpression):
            return ApplyExpression(
                lambda t: tuple(self._split(t or "")), dt.List(dt.ANY),
                (text,), {}, propagate_none=True)
        return self._split(text)


class NullSplitter(BaseSplitter):
    def _split(self, text: str):
        return [(text, {})]


class TokenCountSplitter(BaseSplitter):
    """Chunks of ``max_tokens`` whitespace-separated words; a tail of
    fewer than ``min_tokens`` joins the chunk before it (reference
    TokenCountSplitter)."""

    def __init__(self, min_tokens: int = 50, max_tokens: int = 500,
                 encoding_name: str = "cl100k_base"):
        self.min_tokens = min_tokens
        self.max_tokens = max_tokens

    def _split(self, text: str):
        words = re.findall(r"\S+", text or "")
        out = []
        cur: list[str] = []
        for w in words:
            cur.append(w)
            if len(cur) >= self.max_tokens:
                out.append((" ".join(cur), {}))
                cur = []
        if cur:
            if out and len(cur) < self.min_tokens:
                last_text, meta = out[-1]
                out[-1] = (last_text + " " + " ".join(cur), meta)
            else:
                out.append((" ".join(cur), {}))
        return out or [("", {})]


class RecursiveSplitter(BaseSplitter):
    """Split on each separator in turn until every chunk has at most
    ``chunk_size`` words (reference RecursiveSplitter; langchain-style);
    ``chunk_overlap`` words of a chunk's predecessor are prepended."""

    def __init__(self, chunk_size: int = 500, chunk_overlap: int = 0,
                 separators: list[str] | None = None,
                 encoding_name: str = "cl100k_base",
                 model_name: str | None = None):
        self.chunk_size = chunk_size
        self.chunk_overlap = chunk_overlap
        self.separators = separators or ["\n\n", "\n", ". ", " "]

    def _length(self, text: str) -> int:
        return len(re.findall(r"\S+", text))

    def _split_rec(self, text: str, seps: list[str]) -> list[str]:
        if self._length(text) <= self.chunk_size or not seps:
            return [text]
        sep, rest = seps[0], seps[1:]
        out: list[str] = []
        cur = ""
        for p in text.split(sep):
            cand = (cur + sep + p) if cur else p
            if self._length(cand) <= self.chunk_size:
                cur = cand
            else:
                if cur:
                    out.append(cur)
                if self._length(p) > self.chunk_size:
                    out.extend(self._split_rec(p, rest))
                    cur = ""
                else:
                    cur = p
        if cur:
            out.append(cur)
        if self.chunk_overlap > 0 and len(out) > 1:
            overlapped = []
            for i, c in enumerate(out):
                if i > 0:
                    prev_words = re.findall(r"\S+", out[i - 1])[
                        -self.chunk_overlap:]
                    c = " ".join(prev_words) + " " + c
                overlapped.append(c)
            out = overlapped
        return out

    def _split(self, text: str):
        return [(c, {}) for c in self._split_rec(text or "", self.separators)]


__all__ = ["BaseSplitter", "NullSplitter", "TokenCountSplitter",
           "RecursiveSplitter"]
