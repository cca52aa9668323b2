"""Document parsers (the port of ``pathway_tpu/xpacks/llm/parsers.py``;
reference: xpacks/llm/parsers.py:55-1170).

A parser maps bytes to ``[(text, metadata)]`` and is callable on column
expressions.  ``Utf8Parser`` is ported; the parsers that need packages
from outside the repository (PDF, unstructured, docling, images, OCR,
audio and video) are not.
"""

from __future__ import annotations

from ...internals import dtype as dt
from ...internals.expression import ApplyExpression, ColumnExpression
from ...internals.value import Json


class ParserBase:
    def _parse(self, contents: bytes) -> list[tuple[str, dict]]:
        raise NotImplementedError

    def __call__(self, contents, **kwargs):
        if isinstance(contents, ColumnExpression):
            def fn(c):
                if isinstance(c, str):
                    c = c.encode()
                return tuple((t, Json(m)) for t, m in self._parse(c or b""))

            return ApplyExpression(fn, dt.List(dt.ANY), (contents,), {},
                                   propagate_none=True)
        return self._parse(contents)


class Utf8Parser(ParserBase):
    """Decode bytes as UTF-8 text (reference: Utf8Parser / ParseUtf8)."""

    def _parse(self, contents: bytes):
        return [(contents.decode("utf-8", errors="replace"), {})]


ParseUtf8 = Utf8Parser

__all__ = ["ParserBase", "Utf8Parser", "ParseUtf8"]
